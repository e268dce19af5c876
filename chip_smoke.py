#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA conflict engine on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--batches N]

Phases, each fatal on failure:

1. Device: the card's name and power limit; the kernel build, timed.
2. Per kernel: K1-K4, every launch of each, on inputs captured from the
   YCSB-A stream at its full shapes (B = 8192, R = 2, Q = 1, 12-byte keys,
   capacity 2^20), plus one forced fold and one report chunk; each output
   must equal the plain torch version's on the same card, bit for bit.
3. End to end: a 1M-txn YCSB-A stream (128 batches x 8192, scrambled
   Zipf-0.99 over 2^20 keys) through TorchConflictSet on cuda, with the
   Resolver's headroom fail-safe before each batch; every kernel's launch
   count must rise and the history must not overflow.
3b. Window path: the same stream in the resolver wire format through the
   bench's runner (``foundationdb_tpu_torch.bench``: window 8, 4 windows
   in flight, packing on a worker thread); per window K3 must launch k
   times and K1's insert at most once, and every kernel and the window
   program must launch. Then, each fatal: per-batch ``resolve_wire`` on
   cuda gives the same verdict hash; the first window on the CPU equals
   the card's; the mako and tpcc shapes, 16 batches at window 4, give
   equal verdicts on cuda and the CPU; one captured window program
   (A14, ``resolve_many_res``) equals its plain version in every verdict
   and state leaf.
4. Cross-check: the first 16 batches again on the CPU (plain versions),
   and 16 batches each of the mako and tpcc shapes on cuda against the
   CPU: the verdicts must be equal.
5. A ``kernels`` JSON line (K1-K4 and the window program), then the card
   line, then the result line.

Exits non-zero, printing no result, when no CUDA card is available or when
run without the rest of the repository.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SCALAR_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
N_KEYS = 1 << 20
REPLACES = {
    "dict_insert": "foundationdb_tpu/models/conflict_kernel.py:1948",
    "history_probe": "foundationdb_tpu/models/conflict_kernel.py:2161",
    "accept": "foundationdb_tpu/models/conflict_kernel.py:472",
    "step_compact": "foundationdb_tpu/models/conflict_kernel.py:2196",
    "resolve_many": "foundationdb_tpu/models/conflict_kernel.py:2291",
}
WINDOW_K, WINDOW_DEPTH = 8, 4  # window phase: batches per window, in flight


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def clone(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(clone(x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(clone(x) for x in tree)
    return tree


def leaves(tree, prefix=""):
    import torch

    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for f in tree._fields:
            out.update(leaves(getattr(tree, f), f"{prefix}.{f}"))
        return out
    out = {}
    for i, x in enumerate(tree):
        out.update(leaves(x, f"{prefix}[{i}]"))
    return out


MAX_ABS_ERR: dict[str, int] = {}


def assert_equal(name: str, got, want) -> None:
    """Every output leaf of the kernel equals the plain version's; records
    the largest absolute difference under the kernel's name (0 or fail)."""
    g, w = leaves(got), leaves(want)
    if g.keys() != w.keys():
        fail(f"{name}: output structure differs")
    kernel = name.split(".")[0]
    for k in g:
        a, b = g[k], w[k]
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"{name}{k}: shape/dtype {a.shape} {a.dtype} vs "
                 f"{b.shape} {b.dtype}")
        diff = (a.long() - b.long()).abs().reshape(-1)
        err = int(diff.max()) if diff.numel() else 0
        MAX_ABS_ERR[kernel] = max(MAX_ABS_ERR.get(kernel, 0), err)
        if err:
            i = int((diff != 0).nonzero()[0, 0])
            fail(f"{name}{k}: kernel differs from its plain version at flat "
                 f"index {i}: {a.reshape(-1)[i].item()} vs "
                 f"{b.reshape(-1)[i].item()} ({int((diff != 0).sum())} "
                 f"differ)")


def bound(nbytes: float, ops: float = 0.0) -> tuple[float, str]:
    """(least ms, what bounds it): the larger of bytes over the memory
    rate and operations over the scalar rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_ms(fn, setup=None, reps: int = 10) -> float:
    """Mean device time of ``fn`` (CUDA events; inputs made outside)."""
    import torch

    args = setup() if setup else ()
    fn(*args)  # warm-up
    total = 0.0
    for _ in range(reps):
        args = setup() if setup else ()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn(*args)
        e.record()
        torch.cuda.synchronize()
        total += s.elapsed_time(e)
    return total / reps


def make_engine(mode, device):
    from foundationdb_tpu_torch import TorchConflictSet
    from foundationdb_tpu_torch.loadgen.ycsb import KEY_BYTES, WINDOW

    return TorchConflictSet(
        capacity=1 << 20, batch_size=mode.batch,
        max_read_ranges=mode.n_reads, max_write_ranges=mode.n_writes,
        max_key_bytes=KEY_BYTES, window_versions=WINDOW, device=device)


def kernel_phase(stream, mode) -> dict:
    """Capture one mid-stream batch and hold every kernel launch against
    its plain version; returns per-kernel timings and bounds."""
    import torch

    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.loadgen.ycsb import batch_versions, build_txns
    from foundationdb_tpu_torch.models import conflict_kernel as ck
    from foundationdb_tpu_torch.models.conflict_set import upload
    from foundationdb_tpu_torch.ops.rmq import sparse_table

    cs = make_engine(mode, "cuda")
    warm = 6
    for i in range(warm):
        cv, old = batch_versions(i)
        cs.resolve(build_txns(*stream, i, mode), cv, old)
    cv, old = batch_versions(warm)
    txns = build_txns(*stream, warm, mode)
    for t in txns[::97]:
        t.report_conflicting_keys = True
    cs._begin_resolve(cv, old)
    cvr, oldr = cs._rel(cv), cs._rel(cs.oldest_version)
    batch, _ = cs._pack(txns)
    hb = cs._pack_resident(batch)
    rb = upload(hb, cs.device)
    res = cs.state
    if hb.n_new == 0:
        fail("captured batch has an empty dictionary delta")
    b, r = rb.ranks.read_begin.shape
    q = rb.ranks.write_begin.shape[1]
    c = res.hist.base.keys.shape[0]
    cd = res.hist.delta.keys.shape[0]
    d1, w = res.dict_keys.shape
    m = rb.delta_keys.shape[0]
    timings = {}

    # K1: insert + rank shift, remap rewrite, version rebase.
    def k1(res_):
        return ck.apply_delta(res_, rb.delta_keys, hb.n_new)

    def k1_plain(res_):
        nd, nn, shift = ck._dict_insert_plain(res_.dict_keys, res_.n_keys,
                                              rb.delta_keys)
        h = res_.hist
        ranks = ck._rewrite_ranks_plain(
            [h.base.keys, h.delta.keys, res_.shard_lo, res_.shard_hi], shift,
            False)
        return ck.ResState(nd, nn, ck.HistState(
            h.base._replace(keys=ranks[0]), h.base_st,
            h.delta._replace(keys=ranks[1])), ranks[2], ranks[3])

    assert_equal("dict_insert", k1(clone(res)), k1_plain(clone(res)))
    out, shift = K.dict_insert(res.dict_keys, rb.delta_keys)
    nd, _, shift_p = ck._dict_insert_plain(res.dict_keys, res.n_keys,
                                           rb.delta_keys)
    assert_equal("dict_insert.shift", (out, shift), (nd, shift_p))
    remap = (torch.arange(d1, dtype=torch.int32, device=shift.device)
             + shift).contiguous()
    arrays = [res.hist.base.keys, res.hist.delta.keys]
    got = [a.clone() for a in arrays]
    K.rewrite_ranks(got, remap, True)
    assert_equal("dict_insert.remap", got,
                 ck._rewrite_ranks_plain(arrays, remap, True))
    vers = [res.hist.base.versions, res.hist.delta.versions]
    got = [v.clone() for v in vers]
    K.rebase_versions(got, 5)
    assert_equal("dict_insert.rebase", got,
                 [ck._rebase_versions_plain(v, 5) for v in vers])
    timings["dict_insert"] = (
        time_ms(k1, lambda: (clone(res),)),
        time_ms(k1_plain, lambda: (clone(res),), reps=3))
    bytes_k1 = 4 * (2 * d1 * w + m * w + 2 * (c + cd))

    res1 = ck.apply_delta(clone(res), rb.delta_keys, hb.n_new)
    floor, _ = ck.too_old_mask_packed(res1.hist.delta, rb.ranks, oldr)

    # K4 fold (the forced fold of advance_hist and the gated one).
    def fold(hist):
        return ck.advance_hist(hist, cvr, oldr)

    def fold_plain(hist):
        nb = ck._merge_delta_plain(hist.base, hist.delta, floor)
        return ck.HistState(nb, sparse_table(nb.versions),
                            ck._reset_delta(hist.delta, floor))

    assert_equal("step_compact.fold", fold(clone(res1.hist)),
                 fold_plain(clone(res1.hist)))
    hist2 = ck._maybe_merge(clone(res1.hist), hb.demand, floor)
    assert_equal("step_compact.maybe_merge", hist2,
                 ck._maybe_merge_plain(clone(res1.hist), hb.demand, floor))
    fold_ms = (time_ms(fold, lambda: (clone(res1.hist),), reps=5),
               time_ms(fold_plain, lambda: (clone(res1.hist),), reps=2))

    # K2: delta table + probe; the base table alone.
    def k2(hist):
        return ck.history_probe(hist, rb.ranks, floor)

    def k2_plain(hist):
        return ck.history_probe_plain(hist, rb.ranks, floor)

    too_old, hist_mask, cand = k2(hist2)
    assert_equal("history_probe", (too_old, hist_mask, cand), k2_plain(hist2))
    assert_equal("history_probe.table", K.build_table(hist2.base.versions),
                 sparse_table(hist2.base.versions))
    timings["history_probe"] = (time_ms(k2, lambda: (hist2,)),
                                time_ms(k2_plain, lambda: (hist2,), reps=3))
    table_ms = (time_ms(lambda: K.build_table(hist2.base.versions)),
                time_ms(lambda: sparse_table(hist2.base.versions), reps=3))
    bytes_k2 = (b * r * 9 + b * 5 + cd * 8
                + b * r * 4 * (2 * math.ceil(math.log2(c + 1)) + 2)
                + b * r + 2 * b)

    # K3: acceptance + verdicts; the report launch.
    ranks = ck.endpoint_ranks_live_packed(rb.ranks)
    tm = rb.ranks.txn_mask
    accepted, verdicts = ck.accept(cand, too_old, tm, ranks)
    assert_equal("accept", (accepted, verdicts),
                 ck.accept_plain(cand, too_old, tm, ranks))
    losers = ck.loser_mask(hist_mask, ranks, accepted, verdicts)
    assert_equal("accept.losers", losers,
                 ck.loser_mask_plain(hist_mask, ranks, accepted, verdicts))
    timings["accept"] = (
        time_ms(lambda: ck.accept(cand, too_old, tm, ranks)),
        time_ms(lambda: ck.accept_plain(cand, too_old, tm, ranks), reps=2))
    loser_ms = (
        time_ms(lambda: ck.loser_mask(hist_mask, ranks, accepted, verdicts)),
        time_ms(lambda: ck.loser_mask_plain(hist_mask, ranks, accepted,
                                            verdicts), reps=2))
    idx = torch.nonzero(cand).flatten().double()
    ops_k3 = float(3 * r * q * idx.sum())
    bytes_k3 = 3 * b + b * r * 9 + b * q * 9 + 2 * b

    # K4: paint; compaction alone.
    def k4(delta):
        return ck._paint_and_compact_res(delta, rb.ranks, accepted, cvr,
                                         floor)

    def k4_plain(delta):
        return ck._paint_and_compact_res_plain(delta, rb.ranks, accepted,
                                               cvr, floor)

    assert_equal("step_compact.paint", k4(clone(hist2.delta)),
                 k4_plain(clone(hist2.delta)))
    timings["step_compact"] = (
        time_ms(k4, lambda: (clone(hist2.delta),)),
        time_ms(k4_plain, lambda: (clone(hist2.delta),), reps=3))
    skeys = torch.cat([hist2.base.keys, hist2.delta.keys]).sort(0).values
    gen = np.random.default_rng(1)
    newv = torch.from_numpy(gen.integers(0, 4, skeys.shape[0]).astype(
        np.int32)).cuda()
    prior = torch.zeros((), dtype=torch.bool, device="cuda")
    assert_equal("step_compact.compact",
                 ck._dedup_compact(skeys.contiguous(), newv, c, prior),
                 ck._dedup_compact_plain(skeys, newv, c, prior))
    bytes_k4 = cd * 8 * 2 + b * q * 9 + b + 2 * b * q * 4
    torch.cuda.synchronize()

    # Bounds of the other launches. Forced fold (advance_hist): base and
    # delta read, base written, the base table's L levels written, the
    # delta reset. Table rebuild: values read, L levels written. Loser
    # mask: its inputs read, one int32 per txn written; operations are
    # the two compares of each CONFLICT txn's live read slot against each
    # accepted live write.
    levels = K.table_levels(c)
    fold_bound = bound(8 * c + 8 * cd + 8 * c + 4 * levels * c + 8 * cd)
    table_bound = bound(4 * c + 4 * levels * c)
    conf = verdicts == ck.V_CONFLICT
    loser_ops = 2.0 * float((ranks[2] & conf[:, None]).sum()) * float(
        (ranks[5] & accepted[:, None]).sum())
    loser_bound = bound(b * r * 10 + 2 * b + b * q * 9 + 4 * b, loser_ops)

    bounds = {"dict_insert": (bytes_k1, 0.0), "history_probe": (bytes_k2, 0.0),
              "accept": (bytes_k3, ops_k3), "step_compact": (bytes_k4, 0.0)}
    for name, (ms, plain) in timings.items():
        print(f"kernel {name}: {ms:.4f} ms (plain {plain:.4f} ms)")
    for label, (ms, plain), (lo, by) in (
            (f"step_compact fold (forced, C={c})", fold_ms, fold_bound),
            (f"history_probe base table (C={c})", table_ms, table_bound),
            ("accept losers (report chunk)", loser_ms, loser_bound)):
        print(f"kernel {label}: {ms:.4f} ms (plain {plain:.4f} ms, "
              f"bound {lo:.6f} ms by {by})")
    return {"timings": timings, "bounds": bounds}


def run_stream(stream, mode, n_batches: int, device, label: str):
    """Resolve n_batches of the stream with the Resolver's fail-safe;
    returns (verdict int8 array, per-batch latency ms, engine)."""
    import torch

    from foundationdb_tpu_torch.loadgen.ycsb import batch_versions, build_txns

    cs = make_engine(mode, device)
    out, lat = [], []
    fail_safe = 0
    for i in range(n_batches):
        txns = build_txns(*stream, i, mode)
        cv, old = batch_versions(i)
        t0 = time.perf_counter()
        if cs.headroom() < cs.worst_case_growth(len(txns)):
            cs.advance(cv, old)
            v = [1] * len(txns)  # Verdict.CONFLICT for the whole batch
            fail_safe += 1
        else:
            v = [int(x) for x in cs.resolve(txns, cv, old)]
        if cs.device.type == "cuda":
            torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        out.append(np.asarray(v, np.int8))
    if fail_safe:
        print(f"{label}: {fail_safe} batches took the fail-safe")
    return np.concatenate(out), lat, cs


def window_phase(stream, mode, n_batches: int, seed: int, card: str,
                 object_sha: str) -> dict:
    """Phase 3b: the window path through the bench's runner, counted, then
    its cross-checks and the window program held against its plain
    version. Returns the resolve_many row's measurements."""
    import torch

    from foundationdb_tpu_torch import bench
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.loadgen.ycsb import (
        MODES,
        build_wire_stream,
        gen_workload,
    )
    from foundationdb_tpu_torch.models import conflict_kernel as ck
    from foundationdb_tpu_torch.models.conflict_set import (
        TorchConflictSet,
        _RepackPlan,
        upload,
    )

    cap = 1 << 20
    b = mode.batch
    n_windows = n_batches // WINDOW_K
    n_batches = n_windows * WINDOW_K
    blob, ends = build_wire_stream(*(a[: n_batches * b] for a in stream),
                                   n_batches, mode)
    # Warm-up outside the counted run: the packer's build, first launches.
    bench.make_engine(mode, cap, "cuda").resolve_wire_window(
        *bench.window_wire(blob, ends, mode, WINDOW_K, 0), b)

    per_window: list[dict] = []
    dispatch = TorchConflictSet.dispatch_window

    def counted(self, prepared):
        before = dict(K.ENTRY_LAUNCHES)
        out = dispatch(self, prepared)
        per_window.append({k: n - before.get(k, 0)
                           for k, n in K.ENTRY_LAUNCHES.items()})
        return out

    TorchConflictSet.dispatch_window = counted
    try:
        K.reset_launches()
        ck.reset_launches()
        rec, verdicts, cs = bench.run_wire(
            blob, ends, mode, n_batches, cap, "cuda", window=WINDOW_K,
            pipeline_depth=WINDOW_DEPTH, repeats=1, threaded=True,
            warmup=False)
        launches = dict(K.LAUNCHES)
        windows = ck.LAUNCHES["resolve_many"]
    finally:
        TorchConflictSet.dispatch_window = dispatch
    if rec["overflowed"]:
        fail("history overflowed on the window path")
    for k, n in {**launches, "resolve_many": windows}.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the window path")
    if len(per_window) != n_windows or windows != n_windows:
        fail(f"{len(per_window)} dispatches, {windows} window programs for "
             f"{n_windows} windows")
    for i, pw in enumerate(per_window):
        if pw.get("ac_accept", 0) != WINDOW_K or pw.get("di_insert", 0) > 1:
            fail(f"window {i}: K3 launched {pw.get('ac_accept', 0)} times "
                 f"(want {WINDOW_K}), K1 insert {pw.get('di_insert', 0)} "
                 "(want <= 1)")

    # (a) Per-batch resolve_wire on cuda at the same commit versions.
    one = bench.make_engine(mode, cap, "cuda")
    rows = []
    t0 = time.perf_counter()
    for i in range(n_batches):
        lo, hi = int(ends[i * b]), int(ends[(i + 1) * b])
        rows.append(one.resolve_wire_async(blob[lo:hi], i + 1, count=b,
                                           as_array=True)())
    per_batch_s = time.perf_counter() - t0
    per_batch_sha = hashlib.sha256(np.concatenate(rows).tobytes()).hexdigest()
    if per_batch_sha != rec["verdicts_sha256"]:
        fail("window path and per-batch resolve_wire verdicts differ")
    print(json.dumps({
        "phase": "window", "stream": "ycsb-a", **rec,
        "launches_per_window": {k: n / n_windows
                                for k, n in launches.items()},
        "window_programs": windows,
        "per_batch_wire_txns_per_s": n_batches * b / per_batch_s,
        "per_batch_wire_verdicts_sha256": per_batch_sha,
        "object_path_sha_equal": per_batch_sha == object_sha,
        "card": card}))

    # (b) The first window on the CPU plain path.
    cpu0 = bench.make_engine(mode, cap, "cpu").resolve_wire_window(
        *bench.window_wire(blob, ends, mode, WINDOW_K, 0), b)
    if not np.array_equal(cpu0, verdicts[0]):
        fail("window 0: cuda and cpu verdicts differ")
    print(f"cross-check window 0: {cpu0.size} txns equal on cuda and cpu")

    # (c) mako and tpcc through the window path on cuda and the CPU.
    for mname in ("mako", "tpcc"):
        m = MODES[mname]
        n_cross = 16
        mb, me = build_wire_stream(
            *gen_workload(n_cross * m.batch, N_KEYS, seed, m), n_cross, m)
        got = {dev: bench.run_wire(mb, me, m, n_cross, cap, dev, window=4,
                                   pipeline_depth=WINDOW_DEPTH, repeats=1,
                                   warmup=False)
               for dev in ("cuda", "cpu")}
        if (not np.array_equal(got["cuda"][1], got["cpu"][1])
                or got["cuda"][0]["overflowed"]):
            fail(f"{mname} window path: cuda and cpu verdicts differ")
        r = got["cuda"][0]
        print(f"cross-check {mname} window path: {r['txns']} txns equal on "
              f"cuda and cpu (committed {r['committed']}, conflict "
              f"{r['conflict']}, too_old {r['too_old']})")

    # The window program (A14) held against its plain version on a
    # captured warm window at the stream's full shapes: the first after
    # window 0 that brings a dictionary delta (no deferred repack), so K1
    # inserts inside it.
    cs = bench.make_engine(mode, cap, "cuda")
    cs.resolve_wire_window(*bench.window_wire(blob, ends, mode, WINDOW_K, 0),
                           b)
    for wi in range(1, n_windows):
        prepared = cs.pack_wire_window(
            *bench.window_wire(blob, ends, mode, WINDOW_K, wi), b)
        hb = prepared.batch
        if not isinstance(hb, _RepackPlan) and hb.n_new:
            break
        cs.dispatch_window(prepared)()
    else:
        fail("no window of the stream brings a dictionary delta")
    if prepared.rebase_delta:
        fail("unexpected rebase in the captured window")
    rb = upload(hb, cs.device)
    cvs, olds = prepared.cvs_rel, prepared.olds_rel
    state = cs.state

    def many(res):
        return ck.resolve_many_res(res, rb, cvs, olds, hb.n_new, hb.demand)

    def many_plain(res):
        return ck.resolve_many_res_plain(res, rb, cvs, olds)

    assert_equal("resolve_many", many(clone(state)), many_plain(clone(state)))
    torch.cuda.synchronize()
    ms = time_ms(many, lambda: (clone(state),), reps=5)
    plain = time_ms(many_plain, lambda: (clone(state),), reps=2)
    print(f"kernel resolve_many (window of {WINDOW_K}, n_new {hb.n_new}): "
          f"{ms:.4f} ms (plain {plain:.4f} ms)")
    return {"launches": windows, "ms": ms, "plain_ms": plain,
            "k": WINDOW_K}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=128)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    try:
        from foundationdb_tpu_torch import kernels as K
        from foundationdb_tpu_torch.bench import card_line
        from foundationdb_tpu_torch.loadgen.ycsb import MODES, gen_workload
    except ImportError as e:
        print(f"chip_smoke: the repository is missing ({e})", file=sys.stderr)
        return 2

    # 1. Device.
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {name} | nvidia-smi: {card}")
    t0 = time.perf_counter()
    K.ensure_built()
    print(f"kernel build: {time.perf_counter() - t0:.3f} s")

    ycsb = MODES["ycsb"]
    stream = gen_workload(args.batches * ycsb.batch, N_KEYS, args.seed, ycsb)

    # 2. Per kernel.
    kp = kernel_phase(stream, ycsb)

    # 3. End to end, counting launches of this run only.
    K.reset_launches()
    t0 = time.perf_counter()
    verdicts, lat, cs = run_stream(stream, ycsb, args.batches, "cuda",
                                   "ycsb cuda")
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    if cs.overflowed:
        fail("history overflowed on the YCSB-A stream")
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the main path")
    counts = np.bincount(verdicts, minlength=3)
    n_txns = len(verdicts)
    object_sha = hashlib.sha256(verdicts.tobytes()).hexdigest()
    print(json.dumps({
        "stream": "ycsb-a", "txns": n_txns, "batches": args.batches,
        "txns_per_s": n_txns / wall,
        "batch_ms_p50": float(np.percentile(lat, 50)),
        "batch_ms_p99": float(np.percentile(lat, 99)),
        "committed": int(counts[0]), "conflict": int(counts[1]),
        "too_old": int(counts[2]),
        "verdicts_sha256": object_sha,
        "host_syncs_per_batch": cs.host_syncs / args.batches,
        "launches_per_batch": {k: n / args.batches
                               for k, n in launches.items()},
        "dict_stats": cs.dict_stats, "card": card}))

    # 3b. The window path, counted on its own, and its cross-checks.
    wp = window_phase(stream, ycsb, args.batches, args.seed, card,
                      object_sha)

    # 4. Cross-checks against the plain versions on the CPU.
    n_cross = min(16, args.batches)
    cpu_v, _, _ = run_stream(stream, ycsb, n_cross, "cpu", "ycsb cpu")
    if not np.array_equal(cpu_v, verdicts[: len(cpu_v)]):
        fail("ycsb: cuda and cpu verdicts differ")
    print(f"cross-check ycsb: {len(cpu_v)} txns equal on cuda and cpu")
    for mname in ("mako", "tpcc"):
        mode = MODES[mname]
        s = gen_workload(n_cross * mode.batch, N_KEYS, args.seed, mode)
        gv, _, gcs = run_stream(s, mode, n_cross, "cuda", f"{mname} cuda")
        cvv, _, _ = run_stream(s, mode, n_cross, "cpu", f"{mname} cpu")
        if not np.array_equal(gv, cvv) or gcs.overflowed:
            fail(f"{mname}: cuda and cpu verdicts differ")
        c = np.bincount(gv, minlength=3)
        print(f"cross-check {mname}: {len(gv)} txns equal on cuda and cpu "
              f"(committed {c[0]}, conflict {c[1]}, too_old {c[2]})")

    # 5. The kernels line, the card line, the result line.
    rows = []
    for k in K.LAUNCHES:
        ms, plain = kp["timings"][k]
        lo, by = bound(*kp["bounds"][k])
        rows.append({
            "name": k, "route": "cuda",
            "source": f"foundationdb_tpu_torch/kernels/csrc/{k}.cu",
            "replaces": REPLACES[k], "launches": launches[k],
            "max_abs_err": MAX_ABS_ERR[k], "ms": ms, "plain_ms": plain,
            "bound_ms": lo, "bound_by": by,
            "library_ms": None})
    # The window program's bound: K1 once plus k steps of K2, K3 and K4,
    # each at the per-batch bound above; bound by what most of it is.
    share = {"bytes": 0.0, "operations": 0.0}
    for r in rows:
        share[r["bound_by"]] += r["bound_ms"] * (
            1 if r["name"] == "dict_insert" else wp["k"])
    rows.append({
        "name": "resolve_many", "route": "cuda",
        "source": "foundationdb_tpu_torch/models/conflict_kernel.py",
        "replaces": REPLACES["resolve_many"], "launches": wp["launches"],
        "max_abs_err": MAX_ABS_ERR["resolve_many"], "ms": wp["ms"],
        "plain_ms": wp["plain_ms"],
        "bound_ms": sum(share.values()),
        "bound_by": max(share, key=share.get), "library_ms": None})
    print(json.dumps({"kernels": rows}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
