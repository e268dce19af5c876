"""K1-K4 of one source tree against another's, on inputs captured once.

    python3 foundationdb_tpu_torch/kernel_ab.py capture IN.pt
    python3 foundationdb_tpu_torch/kernel_ab.py time IN.pt [--tree DIR]

``capture`` runs this tree's engine on the smoke's YCSB-A stream
(``chip_smoke.capture_batch``: the 7th batch of 8192 txns over 2^20 keys)
and saves, on the CPU, the inputs K2 and K3 take there, plus three more
acceptance batches: the dense worst case at B = 8192 and B = 32,768
(every txn reads and writes one key, so every row has an edge) and a
32,768-txn batch of the same stream. It prints the captured batch's
acceptance counts (candidate rows, rows with a candidate predecessor,
their bits, the words the block scan's demotion reads, the rows left
for the settle after the first pass). For K1 and K4 it saves the
batch's state before K1 with its dictionary delta, the history after K1,
the floor, the fold's demand, the commit and oldest versions and the
batch's acceptance (the paint's inputs).

``time`` imports ``foundationdb_tpu_torch`` from ``DIR`` (default: the
tree holding this file), holds that tree's K1-K4 against its own plain
versions on the saved inputs, and prints one JSON line of CUDA-event
times (the mean of 20 launches after a warm-up; a call that rewrites its
state in place gets a fresh copy made outside the timed span) and, from
``torch.profiler``, the device time of each kernel function by name and
the CUDA kernels one call launches. K1: the insert with its rank rewrite
(``apply_delta``), the insert alone; K4: one paint, one gated fold step
whose fold is not needed and one whose fold is, one forced fold
(``advance_hist``). Run it on two trees in turns (A, B, B, A) in one call
to compare them on one card. Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def _inputs(args) -> dict:
    cand, too_old, txn_mask, ranks = args
    return {"cand": cand, "too_old": too_old, "txn_mask": txn_mask,
            "ranks": ranks}


def capture(path: str) -> None:
    import chip_smoke
    import torch

    from foundationdb_tpu_torch.loadgen.ycsb import MODES, gen_workload
    from foundationdb_tpu_torch.models import conflict_kernel as ck

    ycsb = MODES["ycsb"]
    stream = gen_workload(128 * ycsb.batch, chip_smoke.N_KEYS, 0, ycsb)
    cap = chip_smoke.capture_batch(stream, ycsb, wave=False)
    rbk, hist = cap.rb.ranks, cap.hist
    accepted, _ = ck.accept(cap.cand, cap.too_old, rbk.txn_mask, cap.ranks)
    res = cap.res
    out = _to_cpu({
        "a14": _a14_window(chip_smoke, stream, ycsb),
        "k1": {"res": _res_dict(res), "delta_keys": cap.rb.delta_keys,
               "n_new": int(cap.hb.n_new)},
        "k4": {"hist1": _hist_dict(cap.res1.hist), "demand": int(
            cap.hb.demand), "cv": int(cap.cvr), "oldest": int(cap.oldr),
            "accepted": accepted},
        "smoke": {"cand": cap.cand, "too_old": cap.too_old,
                  "txn_mask": rbk.txn_mask, "ranks": cap.ranks},
        "hist": {"base": hist.base._asdict(), "base_st": hist.base_st,
                 "delta": hist.delta._asdict()},
        "rbk": rbk._asdict(), "floor": cap.floor,
        "dense_8192": _inputs(chip_smoke.dense_batch(8192, "cpu")),
        "dense_32768": _inputs(chip_smoke.dense_batch(32768, "cpu")),
        "stream_32768": _inputs(chip_smoke.big_seq_batch(stream, 32768)),
    })
    torch.save(out, path)
    counts = ck.accept_counts(*(out["smoke"][k] for k in (
        "cand", "too_old", "txn_mask")), out["smoke"]["ranks"])
    print(json.dumps({"captured": path, "smoke_batch": counts}))


def _a14_window(chip_smoke, stream, mode) -> dict:
    """The window the smoke's A14 check runs (``chip_smoke.window_phase``):
    the first window after window 0 that brings a dictionary delta, with
    the state before it."""
    from foundationdb_tpu_torch import bench
    from foundationdb_tpu_torch.models.conflict_set import _RepackPlan, upload

    k, b = chip_smoke.WINDOW_K, mode.batch
    blob, ends, n = chip_smoke.wire_stream(stream, mode, 128)
    cs = bench.make_engine(mode, chip_smoke.CAP, "cuda")
    cs.resolve_wire_window(*bench.window_wire(blob, ends, mode, k, 0), b)
    for wi in range(1, n // k):
        prepared = cs.pack_wire_window(
            *bench.window_wire(blob, ends, mode, k, wi), b)
        hb = prepared.batch
        if not isinstance(hb, _RepackPlan) and hb.n_new:
            break
        cs.dispatch_window(prepared)()
    rb = upload(hb, cs.device)
    return {"res": _res_dict(cs.state), "delta_keys": rb.delta_keys,
            "ranks": rb.ranks._asdict(),
            "cvs": [int(x) for x in prepared.cvs_rel],
            "olds": [int(x) for x in prepared.olds_rel],
            "n_new": int(hb.n_new), "demand": [int(x) for x in hb.demand]}


def _hist_dict(hist) -> dict:
    return {"base": hist.base._asdict(), "base_st": hist.base_st,
            "delta": hist.delta._asdict()}


def _res_dict(res) -> dict:
    return {"dict_keys": res.dict_keys, "n_keys": res.n_keys,
            "hist": _hist_dict(res.hist), "shard_lo": res.shard_lo,
            "shard_hi": res.shard_hi}


def _to_cpu(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_cpu(x) for x in tree)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def _ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def _ms_fresh(fn, setup, reps: int = 20) -> float:
    """Mean CUDA-event ms of ``fn(*setup())``, each call on a fresh copy
    made before its timed span."""
    import torch

    fn(*setup())
    total = 0.0
    for _ in range(reps):
        args = setup()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn(*args)
        e.record()
        torch.cuda.synchronize()
        total += s.elapsed_time(e)
    return total / reps


def _kernel_ms(fn, reps: int = 10, setup=None) -> dict:
    """Device ms of each kernel function by name, per call of ``fn`` (on
    copies made by ``setup`` before the profiled span, when given)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    args = [setup() if setup else () for _ in range(reps + 1)]
    fn(*args[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for a in args[1:]:
            fn(*a)
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        if us:
            out[ev.key] = {"ms": us / 1e3 / reps, "calls": ev.count / reps}
    return out


def _device(kernels: dict) -> dict:
    """The device ms and the CUDA kernel launches of one call, summed over
    the profiler's kernels (copies and fills of device memory apart)."""
    ms = launches = 0.0
    for name, k in kernels.items():
        if not name.startswith(("Memcpy", "Memset")):
            ms += k["ms"]
            launches += k["calls"]
    return {"device_ms": ms, "launches": launches}


def _entry(fn, setup=None) -> dict:
    wall = _ms_fresh(fn, setup) if setup else _ms(fn)
    kernels = _kernel_ms(fn, setup=setup)
    return {"ms": wall, **_device(kernels), "kernels": kernels}


def _same(name: str, got, want) -> None:
    import torch

    def flat(x):
        if isinstance(x, torch.Tensor):
            return [x]
        if isinstance(x, dict):
            return [t for v in x.values() for t in flat(v)]
        return [t for v in x for t in flat(v)]

    g, w = flat(got), flat(want)
    if len(g) != len(w) or not all(torch.equal(a, b) for a, b in zip(g, w)):
        raise SystemExit(f"kernel_ab: {name} differs from its plain version")


def time_k1_k4(data, on, ck, K) -> dict:
    """K1 and K4 of the imported tree on the captured batch: each checked
    against its plain version, then timed (wall and device)."""
    import copy

    import torch

    def clone(tree):
        if isinstance(tree, torch.Tensor):
            return tree.clone()
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(clone(x) for x in tree))
        return copy.deepcopy(tree)

    def hist_of(h):
        return ck.HistState(ck.ConflictState(**h["base"]), h["base_st"],
                            ck.ConflictState(**h["delta"]))

    def res_of(r):
        return ck.ResState(r["dict_keys"], r["n_keys"], hist_of(r["hist"]),
                           r["shard_lo"], r["shard_hi"])

    res = res_of(on(data["k1"]["res"]))
    dk = on(data["k1"]["delta_keys"])
    n_new = data["k1"]["n_new"]
    _same("K1 insert", ck.apply_delta(clone(res), dk, n_new),
          ck._apply_delta_plain(clone(res), dk))
    out = {"k1_insert_rewrite": _entry(
        lambda r: ck.apply_delta(r, dk, n_new), lambda: (clone(res),)),
        "k1_insert": _entry(lambda: K.dict_insert(res.dict_keys, dk))}
    k4 = data["k4"]
    hist1 = hist_of(on(k4["hist1"]))
    hist = hist_of(on(data["hist"]))
    rbk = ck.RankBatch(**on(data["rbk"]))
    floor, acc = on(data["floor"]), on(k4["accepted"])
    demand, cv, old = k4["demand"], k4["cv"], k4["oldest"]
    _same("K4 paint", ck._paint_and_compact_res(clone(hist.delta), rbk, acc,
                                                 cv, floor),
          ck._paint_and_compact_res_plain(clone(hist.delta), rbk, acc, cv,
                                          floor))
    out["k4_paint"] = _entry(
        lambda d: ck._paint_and_compact_res(d, rbk, acc, cv, floor),
        lambda: (clone(hist.delta),))
    # The gated step: the history after this batch's step (its delta just
    # painted or reset, nothing expired since) does not need the fold; the
    # history before it is given a demand that does.
    for label, h, dem in (("k4_gated_fold_not_needed", hist, demand),
                          ("k4_gated_fold_needed", hist1,
                           hist1.delta.keys.shape[0] + 1)):
        want = ck._maybe_merge_plain(clone(h), dem, floor)
        _same(label, ck._maybe_merge(clone(h), dem, floor), want)
        out[label] = _entry(lambda x, d=dem: ck._maybe_merge(x, d, floor),
                            lambda h=h: (clone(h),))
    base, delta = hist.base, hist.delta
    reclaim = int(((base.versions <= floor)
                   & (base.versions > ck.NEG_VERSION)).sum())
    if (int(delta.n_used) + demand > delta.keys.shape[0]
            or reclaim >= max(base.keys.shape[0] // 8, 1)):
        raise SystemExit("kernel_ab: the captured step's fold is needed")
    kept = clone(hist)
    out["k4_gated_fold_not_needed"]["in_place_ms"] = _ms(
        lambda: ck._maybe_merge(hist, demand, floor))
    _same("K4 gated fold (state kept)", hist, kept)
    _same("K4 forced fold", ck.advance_hist(clone(hist1), cv, old),
          _forced_fold_plain(ck, clone(hist1), old))
    out["k4_forced_fold"] = _entry(lambda x: ck.advance_hist(x, cv, old),
                                   lambda: (clone(hist1),))
    # The A14 window program (k = 8) on the smoke's captured window.
    w = on(data["a14"])
    wres = res_of(w["res"])
    wrb = ck.ResidentBatch(w["delta_keys"], ck.RankBatch(**w["ranks"]))
    args = (wrb, w["cvs"], w["olds"])
    _same("A14", ck.resolve_many_res(clone(wres), *args, w["n_new"],
                                     w["demand"]),
          ck.resolve_many_res_plain(clone(wres), *args))
    out["a14_window_program"] = _entry(
        lambda r: ck.resolve_many_res(r, *args, w["n_new"], w["demand"]),
        lambda: (clone(wres),))
    return out


def _forced_fold_plain(ck, hist, old):
    import torch

    from foundationdb_tpu_torch.ops.rmq import sparse_table

    floor = torch.maximum(hist.delta.oldest, torch.full_like(
        hist.delta.oldest, old))
    nb = ck._merge_delta_plain(hist.base, hist.delta, floor)
    return ck.HistState(nb, sparse_table(nb.versions),
                        ck._reset_delta(hist.delta, floor))


def time_tree(path: str, tree: str) -> None:
    import torch

    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.bench import card_line
    from foundationdb_tpu_torch.models import conflict_kernel as ck

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    data = torch.load(path)
    dev = torch.device("cuda")

    def on(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if isinstance(x, (tuple, list)):
            return type(x)(on(y) for y in x)
        if isinstance(x, dict):
            return {k: on(v) for k, v in x.items()}
        return x

    result = {"tree": str(Path(tree).resolve()), "card": card_line(),
              "package": str(Path(K.__file__).resolve().parent.parent)}
    for name in ("smoke", "dense_8192", "dense_32768", "stream_32768"):
        a = on(data[name])
        args = (a["cand"], a["too_old"], a["txn_mask"], a["ranks"])
        got = ck.accept(*args)
        want = ck.accept_plain(*args)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"kernel_ab: K3 differs from accept_plain on "
                             f"{name}")
        result[f"k3_{name}"] = {"ms": _ms(lambda: ck.accept(*args)),
                                "kernels": _kernel_ms(lambda: ck.accept(
                                    *args))}
        if hasattr(K, "ACCEPT_CLOCKS"):  # the stats build's counters
            clk = torch.zeros(len(K.ACCEPT_CLOCKS), dtype=torch.int64,
                              device=dev)
            K.accept(*args[:3], *args[3], clocks=clk)
            result[f"k3_{name}"]["clocks"] = dict(zip(K.ACCEPT_CLOCKS,
                                                      clk.tolist()))
    h = on(data["hist"])
    hist = ck.HistState(ck.ConflictState(**h["base"]), h["base_st"],
                        ck.ConflictState(**h["delta"]))
    rbk = ck.RankBatch(**on(data["rbk"]))
    floor = on(data["floor"])
    got = ck.history_probe(hist, rbk, floor)
    want = ck.history_probe_plain(hist, rbk, floor)
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise SystemExit("kernel_ab: K2 differs from history_probe_plain")
    dv = hist.delta.versions
    st = K.build_table(dv)
    tail = (rbk.read_begin, rbk.read_end, rbk.read_mask, rbk.read_version,
            rbk.txn_mask, floor)
    probe = (hist.base.keys, hist.base_st, hist.delta.keys, st)
    base_v = hist.base.versions
    out = hist.base_st.clone()
    no = torch.zeros((), dtype=torch.bool, device=dev)
    yes = torch.ones((), dtype=torch.bool, device=dev)
    result["k2"] = {
        "table_and_probe_ms": _ms(lambda: ck.history_probe(hist, rbk,
                                                           floor)),
        "delta_table_ms": _ms(lambda: K.build_table(dv)),
        "probe_ms": _ms(lambda: K.history_probe(*probe, *tail)),
        "base_table_gated_off_ms": _ms(lambda: K.build_table(
            base_v, out=out, need=no)),
        "base_table_ms": _ms(lambda: K.build_table(base_v, out=out,
                                                   need=yes)),
        "kernels": _kernel_ms(lambda: ck.history_probe(hist, rbk, floor)),
        "base_table_kernels": _kernel_ms(lambda: K.build_table(
            base_v, out=out, need=yes)),
        "base_table_gated_off_kernels": _kernel_ms(lambda: K.build_table(
            base_v, out=out, need=no)),
    }
    if "k1" in data:
        result.update(time_k1_k4(data, on, ck, K))
    print(json.dumps(result))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("capture", "time"))
    ap.add_argument("path")
    ap.add_argument("--tree", default=str(HERE))
    args = ap.parse_args()
    # Import the package (and chip_smoke) from the tree asked for, never
    # from this file's directory.
    sys.path[0] = str(Path(args.tree).resolve())
    if args.mode == "capture":
        capture(args.path)
    else:
        time_tree(args.path, args.tree)


if __name__ == "__main__":
    main()
