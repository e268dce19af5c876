"""K1-K5, K12, K13's sorted paint and K14 of one source tree against
another's, on inputs captured once.

    python3 foundationdb_tpu_torch/kernel_ab.py capture IN.pt [--seed S]
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
batch's acceptance (the paint's inputs). For K13 and K14 it saves the
smoke's phase 3h capture: window 1 of the non-resident 4-shard engine
(``ShardedConflictSet(resident=False)``) after window 0, with its state,
bounds, commit and oldest versions, and for its first step the
acceptance and the fullest shard's history, clipped batch and floor. For
K12 and K5 it saves phase 3g's first step (the packed non-resident
engine's history after its gated fold and the step's dictionary), the
query rows of the first dispatch of phase 3j's read stream (``--seed``,
the smoke's) over the 2^20-key mirror, and the smoke's wave batch
(``capture_batch`` on a wave engine: candidates and live endpoint ranks).

``time`` imports ``foundationdb_tpu_torch`` from ``DIR`` (default: the
tree holding this file), holds that tree's K1-K4 against its own plain
versions on the saved inputs, and prints one JSON line of CUDA-event
times (the mean of 20 launches after a warm-up; a call that rewrites its
state in place gets a fresh copy made outside the timed span) and, from
``torch.profiler``, the device time of each kernel function by name and
the CUDA kernels one call launches. K1: the insert with its rank rewrite
(``apply_delta``), the insert alone; K4: one paint, one gated fold step
whose fold is not needed and one whose fold is, one forced fold
(``advance_hist``). K14: the ranks of the step's endpoint rows, one
shard's paint sort (2BQ rows, 2 payloads); K13: the sorted paint of that
shard, at its capacity C = 2^20 and on a copy cut to C = 2^18 with the
same live rows; one shard's whole unpacked paint; the window program (k
= 8). K12: the engine's search of base and delta, one dispatch's
read-plane search, the cross-rank search of that shard's paint (each with
the live counts where the tree's ``word_search`` takes them); K5 on the
wave batch. Run it on two trees in turns (A, B, B, A) in one call to
compare them on one card. Needs a CUDA card; imports no JAX.
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


def capture(path: str, seed: int) -> None:
    import chip_smoke
    import torch

    from foundationdb_tpu_torch.loadgen.ycsb import MODES, gen_workload
    from foundationdb_tpu_torch.models import conflict_kernel as ck

    ycsb = MODES["ycsb"]
    stream = gen_workload(128 * ycsb.batch, chip_smoke.N_KEYS, 0, ycsb)
    cap = chip_smoke.capture_batch(stream, ycsb, wave=False)
    wave = chip_smoke.capture_batch(stream, ycsb, wave=True)
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
        "nrs": _nrs_window(chip_smoke, stream, ycsb),
        "k12": {**_nr_step(chip_smoke, stream, ycsb),
                "reads": _read_dispatch(chip_smoke, seed)},
        "k5": {"cand": wave.cand, "ranks": wave.ranks},
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


def _nrs_window(chip_smoke, stream, mode) -> dict:
    """Phase 3h's captured window (``chip_smoke.nr_sharded_phase`` (d)):
    window 1 of the non-resident sharded engine after window 0, and its
    first step's paint of the fullest shard."""
    import torch

    from foundationdb_tpu_torch import bench
    from foundationdb_tpu_torch.models import conflict_kernel as ck
    from foundationdb_tpu_torch.models.conflict_set import upload_keys

    k, b = chip_smoke.WINDOW_K, mode.batch
    blob, ends, _ = chip_smoke.wire_stream(stream, mode, 128)
    engine = {**chip_smoke.sharded_engine(stream, mode), "resident": False}
    cs = bench.make_engine(mode, chip_smoke.CAP, "cuda", **engine)
    cs.resolve_wire_window(*bench.window_wire(blob, ends, mode, k, 0), b)
    prepared = cs.pack_wire_window(*bench.window_wire(blob, ends, mode, k,
                                                      1), b)
    bt = upload_keys(prepared.batch, cs.device)
    state, lo, hi = cs.state, cs._lo_dev, cs._hi_dev
    olds = [int(x) for x in prepared.olds_rel]
    step = ck._step_batch(bt, 0)
    floor = torch.maximum(state.oldest, torch.full_like(state.oldest,
                                                        olds[0]))
    too_old, _, _, cand = ck.word_shard_probe(state, step, lo, hi, floor[0])
    accepted, _ = ck.accept(cand, too_old, step.txn_mask,
                            ck.endpoint_ranks_live(step))
    clip = ck.word_clip(step, lo, hi, False)
    big = int(torch.argmax(state.n_used))
    return {"state": state._asdict(), "batch": bt._asdict(), "lo": lo,
            "hi": hi, "cvs": [int(x) for x in prepared.cvs_rel],
            "olds": olds, "accepted": accepted,
            "hs": ck._shard_hist(state, big)._asdict(),
            "view": ck.clip_view(step, clip, big)._asdict(),
            "floor": floor[big]}


def _nr_step(chip_smoke, stream, mode) -> dict:
    """Phase 3g's captured step (``chip_smoke.nonresident_phase`` (e)):
    the packed non-resident engine after window 0, its history after the
    first step's gated fold, and that step's dictionary rows."""
    from foundationdb_tpu_torch import bench
    from foundationdb_tpu_torch.models import conflict_kernel as ck
    from foundationdb_tpu_torch.models.conflict_set import upload

    k, b = chip_smoke.WINDOW_K, mode.batch
    blob, ends, _ = chip_smoke.wire_stream(stream, mode, 128)
    cs = bench.make_engine(mode, chip_smoke.CAP, "cuda", resident=False)
    cs.resolve_wire_window(*bench.window_wire(blob, ends, mode, k, 0), b)
    prepared = cs.pack_wire_window(*bench.window_wire(blob, ends, mode, k,
                                                      1), b)
    pb = ck._step_packed(upload(prepared.batch, cs.device, packed=True), 0)
    floor, _ = ck.too_old_mask_packed(cs.state.delta, pb.ranks,
                                      int(prepared.olds_rel[0]))
    hist = ck._maybe_merge(cs.state, prepared.batch.demand[0], floor)
    return {"hist": _hist_dict(hist), "dict_keys": pb.dict_keys}


def _read_dispatch(chip_smoke, seed: int) -> dict:
    """Phase 3j's mirror (the 2^20 read keys packed by the read set's
    codec) and the query rows of its first dispatch: the point keys of the
    first READ_CLIENTS ops of ``read_stream``, its generator advanced past
    ``read_store``'s draws as the smoke's is."""
    import random

    import torch

    from foundationdb_tpu_torch.core.keypack import KeyCodec

    rng = random.Random(seed)
    for _ in range(chip_smoke.READ_VERSIONS * 32):
        rng.paretovariate(1.5)
    stream = chip_smoke.read_stream(rng)
    first = [k for op in stream[:chip_smoke.READ_CLIENTS]
             if op[0] == "points" for k in op[1]]
    codec = KeyCodec()
    mirror = codec.pack([chip_smoke.read_key(i)
                         for i in range(chip_smoke.READ_KEYS)])
    return {"mirror": torch.from_numpy(mirror),
            "queries": torch.from_numpy(codec.pack(first))}


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


def time_k13_k14(data, on, ck, K) -> dict:
    """K14's ranks and paint sort, K13's sorted paint (at C = 2^20 and cut
    to 2^18), one shard's whole unpacked paint and the window program of
    the imported tree on phase 3h's capture: each checked against its
    plain version, then timed (wall and device)."""
    import torch

    from foundationdb_tpu_torch.ops.lex import sort_keys_with_payload

    def clone(st):
        return ck.ConflictState(*(x.clone() for x in st))

    d = on(data["nrs"])
    state = ck.ConflictState(**d["state"])
    bt = ck.BatchTensors(**d["batch"])
    step = ck._step_batch(bt, 0)
    hs = ck.ConflictState(**d["hs"])
    view = ck.BatchTensors(**d["view"])
    acc, floor, cv = d["accepted"], d["floor"], d["cvs"][0]
    _same("K14 ranks", ck.endpoint_ranks_live(step),
          ck.endpoint_ranks_live_plain(step))
    out = {"k14_ranks": _entry(lambda: ck.endpoint_ranks_live(step))}
    keys, delta = K.word_paint_keys(view.write_begin, view.write_end,
                                    view.write_mask, acc)
    cross = K.word_search(hs.keys, keys)[1]
    _same("K14 paint sort", K.word_sort(keys, (delta, cross)),
          sort_keys_with_payload(keys, delta, cross))
    out["k14_paint_sort"] = _entry(lambda: K.word_sort(keys, (delta, cross)))
    out["k14_paint_sort"]["rows"] = keys.shape[0]
    c18 = 1 << 18
    if int(hs.n_used) >= c18:
        raise SystemExit("kernel_ab: the captured shard fills 2^18 rows")
    for label, h in (("k13_sorted_paint", hs),
                     ("k13_sorted_paint_c18", ck.ConflictState(
                         hs.keys[:c18].clone(), hs.versions[:c18].clone(),
                         *hs[2:]))):
        x = K.word_search(h.keys, keys)[1]
        snew, (sd, sx) = K.word_sort(keys, (delta, x))
        soldv = h.versions[(sx - 1).clamp(min=0).long()]
        got = clone(h)
        K.word_paint_sorted(got, snew, sd, sx, cv, floor)
        _same(label, got, ck._paint_tail(h, snew, sd, soldv, sx, cv, floor))
        out[label] = _entry(
            lambda g, a=(snew, sd, sx): K.word_paint_sorted(g, *a, cv, floor),
            lambda h=h: (clone(h),))
        out[label].update(capacity=h.keys.shape[0], n_used=int(h.n_used),
                          new_rows=snew.shape[0])
    _same("unpacked paint", ck._paint_and_compact(clone(hs), view, acc, cv,
                                                  floor),
          ck._paint_and_compact_plain(hs, view, acc, cv, floor))
    out["unpacked_paint"] = _entry(
        lambda h: ck._paint_and_compact(h, view, acc, cv, floor),
        lambda: (clone(hs),))
    lo, hi, cvs, olds = d["lo"], d["hi"], d["cvs"], d["olds"]

    def many(st, plain=False):
        v, _, _, h = ck.sharded_resolve_many(st, bt, cvs, olds, lo, hi,
                                             plain=plain)
        return v, h

    _same("window program", many(clone(state)), many(clone(state), True))
    out["nr_sharded_window_program"] = _entry(many, lambda: (clone(state),))
    return out


def _search(K, keys0, q, keys1=None, live0=None, live1=None):
    """``K.word_search`` with the live counts where the tree's wrapper
    takes them (a tree before them searches every row)."""
    import inspect

    if "live0" in inspect.signature(K.word_search).parameters:
        return K.word_search(keys0, q, keys1, live0, live1)
    return K.word_search(keys0, q, keys1)


def time_k12_k5(data, on, ck, K) -> dict:
    """K12's engine search (phase 3g's step), read-plane search (one
    dispatch of phase 3j) and one shard's paint cross-rank search (phase
    3h's capture), and K5 on the smoke's wave batch, of the imported tree:
    each checked against its plain version, then timed (wall and
    device)."""
    from foundationdb_tpu_torch.ops.lex import searchsorted_words_2sided_fp

    d = on(data["k12"])
    base = ck.ConflictState(**d["hist"]["base"])
    delta = ck.ConflictState(**d["hist"]["delta"])
    dk = d["dict_keys"]

    def engine():
        return _search(K, base.keys, dk, delta.keys, base.n_used,
                       delta.n_used)

    _same("K12 engine search", engine(), ck.dict_history_search(
        base.keys, dk, delta.keys, plain=True))
    out = {"k12_engine_search": _entry(engine)}
    out["k12_engine_search"].update(
        rows=dk.shape[0], base_live=int(base.n_used),
        delta_live=int(delta.n_used))
    mirror, q = d["reads"]["mirror"], d["reads"]["queries"]
    _same("K12 read-plane search", K.word_search(mirror, q)[:2],
          searchsorted_words_2sided_fp(mirror, q))
    out["k12_read_plane_search"] = _entry(lambda: K.word_search(mirror, q))
    out["k12_read_plane_search"]["rows"] = q.shape[0]
    n = on(data["nrs"])
    hs, view = ck.ConflictState(**n["hs"]), ck.BatchTensors(**n["view"])
    keys, _ = K.word_paint_keys(view.write_begin, view.write_end,
                                view.write_mask, n["accepted"])

    def cross():
        return _search(K, hs.keys, keys, live0=hs.n_used)[1]

    _same("K12 paint cross ranks", cross(),
          searchsorted_words_2sided_fp(hs.keys, keys)[1])
    out["k12_paint_cross_ranks"] = _entry(cross)
    out["k12_paint_cross_ranks"].update(rows=keys.shape[0],
                                        live=int(hs.n_used))
    w = on(data["k5"])
    cand, ranks = w["cand"], tuple(w["ranks"])
    _same("K5", ck.wave_pred_matrix(cand, ranks),
          ck.wave_pred_matrix_plain(cand, ranks))
    out["k5_pred_matrix"] = _entry(lambda: ck.wave_pred_matrix(cand, ranks))
    out["k5_pred_matrix"]["batch"] = cand.shape[0]
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
    if "nrs" in data:
        result.update(time_k13_k14(data, on, ck, K))
    if "k12" in data:
        result.update(time_k12_k5(data, on, ck, K))
    print(json.dumps(result))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("capture", "time"))
    ap.add_argument("path")
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--seed", type=int, default=0,
                    help="capture: phase 3j's read stream seed")
    args = ap.parse_args()
    # Import the package (and chip_smoke) from the tree asked for, never
    # from this file's directory.
    sys.path[0] = str(Path(args.tree).resolve())
    if args.mode == "capture":
        capture(args.path, args.seed)
    else:
        time_tree(args.path, args.tree)


if __name__ == "__main__":
    main()
