"""K1-K5, K7, K8, K10, K11, K12, K13's sorted paint, K14-K16 and K17 of
one source tree against another's, on inputs captured once.

    python3 foundationdb_tpu_torch/kernel_ab.py capture IN.pt [--seed S]
        [--only k7]
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
K12, K13's packed paint and fold, and K5 it saves phase 3g's first step
whole (the packed non-resident engine's history before and after its
gated fold, the step's dictionary, rank batch, floor, demand, the
delta's cross ranks and the acceptance, a full base of 2^20 rows from
``chip_smoke.full_base``, and window 1's batch), window 1 of phase 3i's
packed flat arm with its flat history, the query rows of the first
dispatch of phase 3j's read stream (``--seed``, the smoke's) over the
2^20-key mirror, and the smoke's wave batch (``capture_batch`` on a wave
engine: candidates and live endpoint ranks).
For K8 it saves phase 3e's captured step (the resident 4-shard engine's
history after K1, its first step's rank batch, the shard bounds and the
floor), and for K8 and K16 the same shapes over full shards
(``chip_smoke.full_shards``: every n_used = C = 2^20). For K17 it saves
phase 3i's flat blocked arm's captured step (``chip_smoke.arm_program``
with ``rmq="blocked", history="batch"``: the flat [2^20, 1] history and
its first step's rank batch); K17's sharded probes run on K8's and K16's
captures. For K11 it saves 4 banks of 2^20 bits with 3,132 random slots
set (a record's m·k, the smoke's) and another 3,132 slots to set. For
K10, the sharded wave exchange, it saves the first step of a captured
window of phase 3e(c)'s resident 4-shard wave engine (the first window
after window 0 that brings a dictionary delta: the candidates and the
batch clipped to each shard with its reads) and of phase 3h(c)'s
non-resident one (window 1: the candidates, the step's key rows and
their clip); K15 runs on 3h's capture. For K7 it saves the first
demotion event of phase 3d's tiered run (``chip_smoke.TIER``, the
speculative engine at depth 2 on the unthreaded runner): the resident
state before it, the event's sorted order of evicted ranks (rebuilt from
the tree's ``apply_evict`` calls, chunked or not), the mirror's key count
and the evict chunk. ``--only k7`` captures that alone.

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
wave batch. Phase 3g's step: K13's packed paint, the gated fold step
(``_maybe_merge``) whose fold is not needed and one whose fold is, the
forced fold (``advance_hist``) of the step's history and of the full
base, K12's probe with the table each tree builds (``packed_probe``: the
delta's, and the packed flat arm's over its 2^20-row history), and the
non-resident and packed flat window programs. K8 and K16 (with the
table each tree builds for them: K2's over all S·C rows, or the live
table) at the captured steps and at full shards. K17 (``rmq="blocked"``): the flat blocked step (its build, K12's
two rank searches and its probe) and the blocked sharded probes at 3e's
and 3h's captured steps and at full shards. K11: its set (the filter's
call) and ``index_fill_`` of the same slots on bool banks, in turns.
K15 on 3h's captured step (writes; and with the reads, as a wave engine
clips): through its checked entry (``word_clip``: checks and allocates
every call) and, where the tree has it, as the window program launches
it (``WordWindowClip.step``: into buffers checked and allocated once a
window). K10: the exchange of 3e(c)'s and 3h(c)'s captured wave steps
as the tree runs it (the S K5 matrices into an [S, BP, BP/32] buffer and
K10's OR, or K5's OR mode into one matrix; the K14 ranks of each shard's
clipped rows at 3h), with the bytes it allocates (``peak_alloc_bytes``:
the CUDA caching allocator's peak over one call) and the device ms of
each kernel by name (K10's own, K5's plain store and its OR mode).
K7: K7 alone on the event (the tree's entry, with the live count where
it takes one) and the whole demotion as the tree's ``_demote_now`` runs
it on the card: the upload of the evict vector, then one
``apply_evict`` a chunk of e ranks, each rebased by the count already
gone (a tree without K7's tile twin), or one ``apply_evict`` of the
whole order padded to whole chunks (a tree with it), at the captured
chunk (one chunk) and at a quarter of the event (four chunks), each with
its CUDA kernels, device ms and the bytes one call allocates. Each
tree's demotion is held against the plain version of the whole event.
Run it on two trees in turns (A, B, B, A) in one call to compare them on
one card. Needs a CUDA card; imports no JAX.
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


def capture(path: str, seed: int, only: str | None = None) -> None:
    import chip_smoke
    import torch

    from foundationdb_tpu_torch.loadgen.ycsb import MODES, gen_workload
    from foundationdb_tpu_torch.models import conflict_kernel as ck

    if only == "k7":
        out = {"k7": _to_cpu(_k7_event(chip_smoke))}
        torch.save(out, path)
        print(json.dumps({"captured": path, "k7": {
            k: out["k7"][k] for k in ("n_live", "e", "n_ev")}}))
        return
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
        "nr_flat": _nr_flat_window(chip_smoke, stream, ycsb),
        "k5": {"cand": wave.cand, "ranks": wave.ranks},
        **_k8_k16_inputs(chip_smoke, stream, ycsb),
        "k17_flat": _k17_flat(chip_smoke, stream, ycsb),
        "k11": _k11_inputs(seed),
        "k10": _k10_inputs(chip_smoke, stream, ycsb),
        "k7": _k7_event(chip_smoke),
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


def _k8_k16_inputs(chip_smoke, stream, mode) -> dict:
    """K8's input at phase 3e's captured step (``chip_smoke.sharded_phase``
    (d): the first window after window 0 that brings a dictionary delta,
    after K1, its first step), that window's program input (the state
    before K1, its batch, versions and delta count), and K8's and K16's
    inputs at full shards (every shard's n_used = C,
    ``chip_smoke.full_shards``) with the captured steps' shapes; K16's
    captured step and window are phase 3h's (``nrs``)."""
    import torch

    from foundationdb_tpu_torch import bench
    from foundationdb_tpu_torch.models import conflict_kernel as ck
    from foundationdb_tpu_torch.models.conflict_set import _RepackPlan, upload

    k, b = chip_smoke.WINDOW_K, mode.batch
    blob, ends, n = chip_smoke.wire_stream(stream, mode, 128)
    cs = bench.make_engine(mode, chip_smoke.CAP, "cuda",
                           **chip_smoke.sharded_engine(stream, mode))
    cs.resolve_wire_window(*bench.window_wire(blob, ends, mode, k, 0), b)
    for wi in range(1, n // k):
        prepared = cs.pack_wire_window(
            *bench.window_wire(blob, ends, mode, k, wi), b)
        hb = prepared.batch
        if not isinstance(hb, _RepackPlan) and hb.n_new:
            break
        cs.dispatch_window(prepared)()
    rb = upload(hb, cs.device)
    res1 = ck.apply_delta(chip_smoke.clone(cs.state), rb.delta_keys,
                          hb.n_new)
    rbk = ck._step(rb.ranks, 0)
    h = res1.hist
    floor = torch.maximum(h.oldest, torch.full_like(
        h.oldest, int(prepared.olds_rel[0])))[0]
    s, c = h.keys.shape[0], h.keys.shape[1]
    r = rbk.read_begin.shape[1]
    fh, frb, fre, fm, frv, ftm, flo, fhi = chip_smoke.full_shards(
        s, c, 0, b, r, 0)
    res = cs.state
    out = {"k8": {"hist": h._asdict(), "rbk": rbk._asdict(),
                  "lo": res1.shard_lo, "hi": res1.shard_hi, "floor": floor},
           "k8_window": {
               "res": {**res._asdict(), "hist": res.hist._asdict()},
               "delta_keys": rb.delta_keys, "ranks": rb.ranks._asdict(),
               "cvs": [int(x) for x in prepared.cvs_rel],
               "olds": [int(x) for x in prepared.olds_rel],
               "n_new": int(hb.n_new)},
           "k8_full": {"hist": fh._asdict(), "rbk": rbk._replace(
               read_begin=frb, read_end=fre, read_mask=fm,
               read_version=frv, txn_mask=ftm)._asdict(), "lo": flo,
               "hi": fhi, "floor": floor}}
    fh, frb, fre, fm, frv, ftm, flo, fhi = chip_smoke.full_shards(
        s, c, 4, b, r, 0)
    out["k16_full"] = {"hist": fh._asdict(), "reads": {
        "read_begin": frb, "read_end": fre, "read_mask": fm,
        "read_version": frv, "txn_mask": ftm}, "lo": flo, "hi": fhi,
        "floor": floor}
    return out


def _k10_inputs(chip_smoke, stream, mode) -> dict:
    """The exchange's inputs at the first step of a captured window of
    the smoke's 4-shard wave engines: 3e(c)'s resident engine (the first
    window after window 0 that brings a dictionary delta, after K1: the
    candidates and the rank batch clipped to each shard, reads included)
    and 3h(c)'s non-resident one (window 1 after window 0: the
    candidates, the step's key rows, their clip and the bounds)."""
    import torch

    from foundationdb_tpu_torch import bench
    from foundationdb_tpu_torch.models import conflict_kernel as ck
    from foundationdb_tpu_torch.models.conflict_set import (
        _RepackPlan,
        upload,
        upload_keys,
    )

    k, b = chip_smoke.WINDOW_K, mode.batch
    blob, ends, n = chip_smoke.wire_stream(stream, mode, 128)
    engine = chip_smoke.sharded_engine(stream, mode)
    cs = bench.make_engine(mode, chip_smoke.CAP, "cuda", True, **engine)
    cs.resolve_wire_window(*bench.window_wire(blob, ends, mode, k, 0), b)
    for wi in range(1, n // k):
        prepared = cs.pack_wire_window(
            *bench.window_wire(blob, ends, mode, k, wi), b)
        hb = prepared.batch
        if not isinstance(hb, _RepackPlan) and hb.n_new:
            break
        cs.dispatch_window(prepared)()
    rb = upload(hb, cs.device)
    res1 = ck.apply_delta(chip_smoke.clone(cs.state), rb.delta_keys,
                          hb.n_new)
    rbk = ck._step(rb.ranks, 0)
    h, lo, hi = res1.hist, res1.shard_lo, res1.shard_hi
    floor = torch.maximum(h.oldest, torch.full_like(
        h.oldest, int(prepared.olds_rel[0])))
    _, _, cand = ck.shard_probe(h, rbk, lo, hi, floor[0])
    out = {"resident": {"cand": cand, "clip": ck.shard_clip(
        rbk, lo, hi, True)._asdict()}}
    cs = bench.make_engine(mode, chip_smoke.CAP, "cuda", True,
                           **{**engine, "resident": False})
    cs.resolve_wire_window(*bench.window_wire(blob, ends, mode, k, 0), b)
    prepared = cs.pack_wire_window(*bench.window_wire(blob, ends, mode, k,
                                                      1), b)
    step = ck._step_batch(upload_keys(prepared.batch, cs.device), 0)
    state, lo, hi = cs.state, cs._lo_dev, cs._hi_dev
    floor = torch.maximum(state.oldest, torch.full_like(
        state.oldest, int(prepared.olds_rel[0])))
    _, _, _, cand = ck.word_shard_probe(state, step, lo, hi, floor[0])
    out["keys"] = {"cand": cand, "step": step._asdict(), "lo": lo, "hi": hi,
                   "clip": ck.word_clip(step, lo, hi, True)._asdict()}
    return out


def _k17_flat(chip_smoke, stream, mode) -> dict:
    """Phase 3i's flat blocked arm (``rmq="blocked", history="batch"``):
    its captured window's state and first step (``chip_smoke.arm_program``)."""
    from foundationdb_tpu_torch.models import conflict_kernel as ck

    blob, ends, _ = chip_smoke.wire_stream(stream, mode, 128)
    _, _, state, _, rb, _ = chip_smoke.arm_program(
        blob, ends, mode, {"rmq": "blocked", "history": "batch"})
    return {"hist": state.hist._asdict(),
            "rbk": ck._step(rb.ranks, 0)._asdict()}


def _k7_event(chip_smoke) -> dict:
    """The first demotion event of phase 3d's tiered run: the state before
    it, its sorted order of evicted ranks, the mirror's key count and the
    evict chunk e (``dict_demote_batch``)."""
    import torch

    from foundationdb_tpu_torch import bench
    from foundationdb_tpu_torch.loadgen.ycsb import MODES, gen_workload
    from foundationdb_tpu_torch.models import conflict_kernel as ck
    from foundationdb_tpu_torch.sched.packing import PipelinedWindowRunner

    mode = MODES["ycsb"]
    stream = gen_workload(128 * mode.batch, chip_smoke.TIER_KEYS, 0, mode)
    blob, ends, n = chip_smoke.wire_stream(stream, mode, 128)
    cs = bench.make_engine(mode, chip_smoke.CAP, "cuda", spec_resolve=True,
                           spec_depth=2, **chip_smoke.TIER)
    event: dict = {}
    demote, apply_evict = cs._demote_now, ck.apply_evict

    def first_event(incoming, protect=None):
        if event:
            return demote(incoming, protect)
        before, n_live, calls = _clone(cs.state), cs._mirror.n, []

        def spy(res, ev, n_ev=None, *rest):
            calls.append(ev[:n_ev].clone())
            return apply_evict(res, ev, n_ev, *rest)

        ck.apply_evict = spy
        try:
            got = demote(incoming, protect)
        finally:
            ck.apply_evict = apply_evict
        if got:
            done, order = 0, []
            for chunk in calls:  # a chunk's ranks are rebased by `done`
                order.append(chunk + done)
                done += chunk.numel()
            event.update(res=_res_dict(before), n_live=n_live,
                         order=torch.cat(order), n_ev=done,
                         e=cs.dict_demote_batch)
        return got

    cs._demote_now = first_event
    runner = PipelinedWindowRunner(cs, threaded=False)
    try:
        for wi in range(n // chip_smoke.WINDOW_K):
            runner.submit(*bench.window_wire(blob, ends, mode,
                                             chip_smoke.WINDOW_K, wi),
                          mode.batch)
            runner.collect_next()
            if event:
                break
    finally:
        runner.close()
    if not event:
        raise SystemExit("kernel_ab: phase 3d's stream never demoted")
    return event


def _k11_inputs(seed: int) -> dict:
    """4 packed banks of 2^20 bits with 3,132 random slots set in each, and
    3,132 more slots (int64) to set into bank 1: a record's m·k at the
    smoke's phase 3f geometry."""
    import torch

    from foundationdb_tpu_torch.admission import filter as af

    g = torch.Generator().manual_seed(seed)
    nbits = 1 << 20
    bits = torch.zeros((4, nbits), dtype=torch.bool)
    for b in range(4):
        bits[b, torch.randint(0, nbits, (3132,), generator=g)] = True
    return {"words": af.pack_banks(bits), "nbits": nbits, "bank": 1,
            "idx": torch.randint(0, nbits, (3132,), generator=g)}


def _nr_step(chip_smoke, stream, mode) -> dict:
    """Phase 3g's captured step whole (``chip_smoke.nonresident_phase``
    (e)): the packed non-resident engine after window 0 (``hist0``, the
    history before the first step's gated fold), window 1's batch (its
    dictionaries, rank batches, commit and oldest versions and write
    demands: the window program's input), and for its first step the
    dictionary, the rank batch, the floor, the demand, the history after
    the fold (``hist``), the delta's cross ranks ``rs_d`` and the
    acceptance (the paint's inputs); and the forced fold's full-size
    input (``chip_smoke.full_base``: a base of n_used = C = 2^20 rows)."""
    from foundationdb_tpu_torch import bench
    from foundationdb_tpu_torch.models import conflict_kernel as ck
    from foundationdb_tpu_torch.models.conflict_set import upload

    k, b = chip_smoke.WINDOW_K, mode.batch
    blob, ends, _ = chip_smoke.wire_stream(stream, mode, 128)
    cs = bench.make_engine(mode, chip_smoke.CAP, "cuda", resident=False)
    cs.resolve_wire_window(*bench.window_wire(blob, ends, mode, k, 0), b)
    prepared = cs.pack_wire_window(*bench.window_wire(blob, ends, mode, k,
                                                      1), b)
    rb = upload(prepared.batch, cs.device, packed=True)
    pb = ck._step_packed(rb, 0)
    floor, _ = ck.too_old_mask_packed(cs.state.delta, pb.ranks,
                                      int(prepared.olds_rel[0]))
    hist0 = _clone(cs.state)
    demand = int(prepared.batch.demand[0])
    hist = ck._maybe_merge(cs.state, demand, floor)
    s = ck.dict_history_search(hist.base.keys, pb.dict_keys, hist.delta.keys,
                               live_b=hist.base.n_used,
                               live_d=hist.delta.n_used)
    too_old, _, cand = ck.packed_probe(pb.ranks, floor, s, hist.base_st,
                                       hist.delta.versions, hist.delta.n_used)
    accepted, _ = ck.accept(cand, too_old, pb.ranks.txn_mask,
                            ck.endpoint_ranks_live_packed(pb.ranks))
    full = chip_smoke.full_base(hist, hist.base.keys.shape[0])
    return {"hist": _hist_dict(hist), "dict_keys": pb.dict_keys,
            "hist0": _hist_dict(hist0), "rbk": pb.ranks._asdict(),
            "floor": floor, "demand": demand, "rs_d": s.rs_d,
            "accepted": accepted, "cv": int(prepared.cvs_rel[0]),
            "oldest": int(prepared.olds_rel[0]),
            "full_base": full.base._asdict(),
            "window": _window_dict(rb, prepared)}


def _window_dict(rb, prepared) -> dict:
    return {"dict_keys": rb.dict_keys, "ranks": rb.ranks._asdict(),
            "cvs": [int(x) for x in prepared.cvs_rel],
            "olds": [int(x) for x in prepared.olds_rel],
            "demands": [int(x) for x in prepared.batch.demand]}


def _nr_flat_window(chip_smoke, stream, mode) -> dict:
    """Phase 3i's packed flat arm (``resident=False, history="batch"``):
    its flat [2^20, W] history after window 0 and window 1's batch."""
    from foundationdb_tpu_torch import bench
    from foundationdb_tpu_torch.models.conflict_set import upload

    k, b = chip_smoke.WINDOW_K, mode.batch
    blob, ends, _ = chip_smoke.wire_stream(stream, mode, 128)
    cs = bench.make_engine(mode, chip_smoke.CAP, "cuda", resident=False,
                           history="batch")
    cs.resolve_wire_window(*bench.window_wire(blob, ends, mode, k, 0), b)
    prepared = cs.pack_wire_window(*bench.window_wire(blob, ends, mode, k,
                                                      1), b)
    rb = upload(prepared.batch, cs.device, packed=True)
    return {"state": cs.state._asdict(), "window": _window_dict(rb,
                                                                prepared)}


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


def _clone(tree):
    """A copy of a state (a named tuple of tensors and named tuples)."""
    if hasattr(tree, "clone"):
        return tree.clone()
    return type(tree)(*(_clone(x) for x in tree))


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


def _counted(K, table: str, key: str):
    """A count the tree's wrappers keep of the CUDA kernels their last call
    launched (None in a tree without it)."""
    return getattr(K, table, {}).get(key)


def time_k12_k13_packed(data, on, ck, K) -> dict:
    """Phase 3g's step of the packed non-resident engine, of the imported
    tree, each call checked against its plain version, then timed (wall
    and device, CUDA kernels a call): K13's packed paint; the gated fold
    step (``_maybe_merge``: the decision, the fold, the reset, K2's base
    table) whose fold is not needed (the captured demand) and one whose
    fold is (a demand of Cd); the forced fold (``advance_hist``) of the
    step's history and of a full base (n_used = C = 2^20, W = 4); K12's
    probe with the table the tree builds for the delta; the probe of the
    packed flat arm's step over its flat 2^20-row history; the
    non-resident window program (k = 8) and the packed flat one."""
    import torch

    d = on(data["k12"])

    def hist_of(h):
        return ck.HistState(ck.ConflictState(**h["base"]), h["base_st"],
                            ck.ConflictState(**h["delta"]))

    def packed(w):
        return ck.PackedBatch(w["dict_keys"], ck.RankBatch(**w["ranks"]))

    hist0, hist = hist_of(d["hist0"]), hist_of(d["hist"])
    rbk, dk, floor = ck.RankBatch(**d["rbk"]), d["dict_keys"], d["floor"]
    acc, rs_d, cv, old = d["accepted"], d["rs_d"], d["cv"], d["oldest"]
    demand, cd = d["demand"], hist0.delta.keys.shape[0]
    out = {}

    def paint(delta, plain=False):
        return ck._paint_and_compact_packed(delta, dk, rbk, acc, cv, floor,
                                            rs_d, plain=plain)

    _same("K13 packed paint", paint(_clone(hist.delta)),
          paint(_clone(hist.delta), plain=True))
    out["k13_packed_paint"] = _entry(paint, lambda: (_clone(hist.delta),))
    out["k13_packed_paint"].update(
        counted=_counted(K, "WORD_COMPACT_KERNELS", "wc_paint"),
        delta_live=int(hist.delta.n_used), new_rows=2 * acc.shape[0]
        * rbk.write_begin.shape[1])
    for label, dem in (("not_needed", demand), ("needed", cd)):
        need = bool(ck.fold_need_plain(hist0, dem, floor))
        _same(f"K13 gated fold step ({label})",
              ck._maybe_merge(_clone(hist0), dem, floor),
              ck._maybe_merge_plain(_clone(hist0), dem, floor))
        e = _entry(lambda h: ck._maybe_merge(h, dem, floor),
                   lambda: (_clone(hist0),))
        e.update(need=need, counted=_counted(K, "WORD_COMPACT_KERNELS",
                                             "wc_fold_step"))
        out[f"k13_gated_fold_step_{label}"] = e
    full = ck.HistState(ck.ConflictState(**d["full_base"]), None,
                        hist.delta)
    full = full._replace(base_st=K.build_table(full.base.versions))
    for label, h in (("step_history", hist), ("full_base", full)):
        want = ck.advance_hist(_clone(h), cv, old)
        f = torch.maximum(h.delta.oldest, torch.full_like(h.delta.oldest,
                                                          old))
        _same(f"K13 forced fold ({label})", want, _forced_fold_plain(
            ck, _clone(h), old))
        e = _entry(lambda x: ck.advance_hist(x, cv, old),
                   lambda: (_clone(h),))
        e.update(base_live=int(h.base.n_used), delta_live=int(
            h.delta.n_used), counted=_counted(K, "WORD_COMPACT_KERNELS",
                                              "wc_fold"), floor=int(f))
        out[f"k13_forced_fold_{label}"] = e
    s = ck.DictSearch(*_search(K, hist.base.keys, dk, hist.delta.keys,
                               hist.base.n_used, hist.delta.n_used))

    def probe(plain=False):
        return ck.packed_probe(rbk, floor, s, hist.base_st,
                               hist.delta.versions, hist.delta.n_used,
                               plain=plain)

    _same("K12 probe", probe(), probe(plain=True))
    out["k12_probe_with_table"] = _entry(probe)
    out["k12_probe_with_table"].update(
        counted=_counted(K, "WORD_PROBE_KERNELS", "last"),
        delta_live=int(hist.delta.n_used), slots=rbk.read_mask.numel())
    f = on(data["nr_flat"])
    flat = ck.ConflictState(**f["state"])
    fw = packed(f["window"])
    fpb = ck._step_packed(fw, 0)
    ffloor, _ = ck.too_old_mask_packed(flat, fpb.ranks,
                                       int(f["window"]["olds"][0]))
    fs = ck.DictSearch(*_search(K, flat.keys, fpb.dict_keys,
                                live0=flat.n_used))

    def flat_probe(plain=False):
        return ck.packed_probe(fpb.ranks, ffloor, fs, None, flat.versions,
                               flat.n_used, plain=plain)

    _same("K12 flat probe", flat_probe(), flat_probe(plain=True))
    out["k12_flat_probe_with_table"] = _entry(flat_probe)
    out["k12_flat_probe_with_table"].update(
        counted=_counted(K, "WORD_PROBE_KERNELS", "last"),
        live=int(flat.n_used), rows=flat.keys.shape[0])
    for label, st, win in (("nonresident_window", hist0, d["window"]),
                           ("packed_flat_window", flat, f["window"])):
        pbw = packed(win)
        args = (pbw, win["cvs"], win["olds"])

        def many(x, plain=False):
            if plain:
                return ck.resolve_many_hist_packed_plain(x, *args)
            return ck.resolve_many_hist_packed(x, *args,
                                               demands=win["demands"])

        _same(f"the {label} program", many(_clone(st)),
              many(_clone(st), plain=True))
        out[label] = _entry(many, lambda: (_clone(st),))
    return out


def time_k8_k16(data, on, ck, K) -> dict:
    """K8 (the sharded probe, with whatever table the imported tree builds
    for it) at phase 3e's captured step and at full shards, 3e's window
    program (k = 8), and K16 at phase 3h's captured step and at full
    shards: each checked against its plain version, then timed (wall and
    device), with the shards' live rows."""
    import torch

    out = {}
    for label in ("k8", "k8_full"):
        d = on(data[label])
        h, rbk = ck.ConflictState(**d["hist"]), ck.RankBatch(**d["rbk"])
        args = (h, rbk, d["lo"], d["hi"], d["floor"])
        _same(label, ck.shard_probe(*args), ck.shard_probe_plain(*args))
        out[f"{label}_probe"] = _entry(lambda a=args: ck.shard_probe(*a))
        out[f"{label}_probe"].update(live=h.n_used.tolist(),
                                     capacity=h.keys.shape[1])
    w = on(data["k8_window"])
    wres = ck.ResState(**{**w["res"],
                          "hist": ck.ConflictState(**w["res"]["hist"])})
    wrb = ck.ResidentBatch(w["delta_keys"], ck.RankBatch(**w["ranks"]))

    def window(r, plain=False):
        if plain:
            return ck.sharded_resolve_res_many_plain(r, wrb, w["cvs"],
                                                     w["olds"])[::3]
        return ck.sharded_resolve_res_many(r, wrb, w["cvs"], w["olds"],
                                           w["n_new"])[::3]

    _same("sharded window program", window(_clone(wres)),
          window(_clone(wres), True))
    out["sharded_window_program"] = _entry(window, lambda: (_clone(wres),))
    n = on(data["nrs"])
    state = ck.ConflictState(**n["state"])
    step = ck._step_batch(ck.BatchTensors(**n["batch"]), 0)
    floor = torch.maximum(state.oldest, torch.full_like(
        state.oldest, n["olds"][0]))[0]
    d = on(data["k16_full"])
    fh = ck.ConflictState(**d["hist"])
    for label, args in (
            ("k16", (state, step, n["lo"], n["hi"], floor)),
            ("k16_full", (fh, step._replace(**d["reads"]), d["lo"], d["hi"],
                          d["floor"]))):
        _same(label, ck.word_shard_probe(*args),
              ck.word_shard_probe_plain(*args))
        out[f"{label}_probe"] = _entry(
            lambda a=args: ck.word_shard_probe(*a))
        out[f"{label}_probe"].update(live=args[0].n_used.tolist(),
                                     capacity=args[0].keys.shape[1])
    return out


def time_k17_k11(data, on, ck, K) -> dict:
    """K17 under ``rmq="blocked"`` of the imported tree: the flat blocked
    step (``history_probe``: its build, K12's rank searches and its probe)
    on phase 3i's capture, and the blocked sharded probes on K8's and
    K16's captures (3e's and 3h's steps, full shards), each checked
    against its plain version, then timed (wall and device); K11's set
    against ``index_fill_`` of the same slots on bool banks, alternating."""
    import torch

    from foundationdb_tpu_torch.admission import filter as af

    out = {}
    d = on(data["k17_flat"])
    h, rbk = ck.ConflictState(**d["hist"]), ck.RankBatch(**d["rbk"])
    args = (h, rbk, h.oldest, "blocked")
    _same("K17 flat step", ck.history_probe(*args),
          ck.history_probe_plain(*args))
    out["k17_flat_step"] = _entry(lambda: ck.history_probe(*args))
    out["k17_flat_step"].update(live=int(h.n_used), capacity=h.keys.shape[0])
    for label in ("k8", "k8_full"):
        d = on(data[label])
        h, rbk = ck.ConflictState(**d["hist"]), ck.RankBatch(**d["rbk"])
        args = (h, rbk, d["lo"], d["hi"], d["floor"], "blocked")
        _same(f"K17 {label}", ck.shard_probe(*args),
              ck.shard_probe_plain(*args))
        key = "k17_shard" + label[2:]
        out[key] = _entry(lambda a=args: ck.shard_probe(*a))
        out[key].update(live=h.n_used.tolist(), capacity=h.keys.shape[1])
    n = on(data["nrs"])
    state = ck.ConflictState(**n["state"])
    step = ck._step_batch(ck.BatchTensors(**n["batch"]), 0)
    floor = torch.maximum(state.oldest, torch.full_like(
        state.oldest, n["olds"][0]))[0]
    d = on(data["k16_full"])
    fh = ck.ConflictState(**d["hist"])
    for key, args in (
            ("k17_word_shard", (state, step, n["lo"], n["hi"], floor)),
            ("k17_word_shard_full", (fh, step._replace(**d["reads"]),
                                     d["lo"], d["hi"], d["floor"]))):
        _same(key, ck.word_shard_probe(*args, rmq="blocked"),
              ck.word_shard_probe_plain(*args, "blocked"))
        out[key] = _entry(lambda a=args: ck.word_shard_probe(
            *a, rmq="blocked"))
        out[key].update(live=args[0].n_used.tolist(),
                        capacity=args[0].keys.shape[1])
    d = on(data["k11"])
    words, nbits, bank, idx = d["words"], d["nbits"], d["bank"], d["idx"]
    bits = af.unpack_banks(words, nbits)
    want = bits.clone()
    af.banks_set_plain(want, bank, idx)
    runs = {"k11_set": lambda w: K.admission_set(w, bank, idx, nbits),
            "k11_index_fill": lambda x: x[bank].index_fill_(0, idx, True)}
    for key, fn in runs.items():
        base = bits if key == "k11_index_fill" else words
        got = base.clone()
        fn(got)
        got = got if key == "k11_index_fill" else af.unpack_banks(got, nbits)
        if not torch.equal(got, want):
            raise SystemExit(f"kernel_ab: {key} differs from the plain set")
    for turn in range(2):  # K11, index_fill_, in turns, twice
        for key, fn in runs.items():
            base = bits if key == "k11_index_fill" else words
            out[f"{key}_{turn}"] = _entry(fn, lambda b=base: (b.clone(),))
    out["k11_slots"] = idx.shape[0]
    return out


def _peak_alloc(fn) -> int:
    """Bytes the CUDA caching allocator's peak rises by over one call."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def time_k15_k10(data, on, ck, K) -> dict:
    """K15 on phase 3h's captured step (writes, and writes and reads)
    through its checked entry and, where the imported tree has it, into
    the window program's buffers (``WordWindowClip``); and the sharded
    wave exchange of 3e(c)'s and 3h(c)'s captured steps as the tree runs
    it (``shard_pred_matrices`` + ``wave_exchange``, or
    ``shard_pred_exchange``; at 3h ``word_pred_matrices`` +
    ``wave_exchange``, or ``word_pred_exchange``): each checked against
    the plain versions, then timed (wall and device, kernels by name), the
    exchange with the bytes one call allocates."""
    import torch

    def real(x):
        return [t for t in x if t is not None]

    out = {}
    n = on(data["nrs"])
    bt = ck.BatchTensors(**n["batch"])
    step = ck._step_batch(bt, 0)
    lo, hi = n["lo"], n["hi"]
    for reads in (False, True):
        tag = "_reads" if reads else ""
        want = real(ck.word_clip_plain(step, lo, hi, reads))
        _same(f"K15 checked{tag}", real(ck.word_clip(step, lo, hi, reads)),
              want)
        out[f"k15_checked{tag}"] = _entry(
            lambda r=reads: ck.word_clip(step, lo, hi, r))
        if hasattr(ck, "WordWindowClip"):
            wc = ck.WordWindowClip.of(bt, lo, hi, reads)
            _same(f"K15 window step{tag}", real(wc.step(step)), want)
            out[f"k15_window_step{tag}"] = _entry(lambda w=wc: w.step(step))
    d = on(data["k10"])
    r, x = d["resident"], d["keys"]
    rclip = ck.ShardClip(**r["clip"])
    xstep, xclip = ck.BatchTensors(**x["step"]), ck.WordClip(**x["clip"])
    s_n = rclip.write_begin.shape[0]
    cases = {
        "resident": (r["cand"], [ck._clip_live(rclip, s)
                                 for s in range(s_n)]),
        "keys": (x["cand"], [ck.endpoint_ranks_live_plain(
            ck.clip_view(xstep, xclip, s)) for s in range(s_n)])}
    fused = hasattr(ck, "shard_pred_exchange")
    for label, (cand, ranks) in cases.items():
        want = ck.wave_exchange_plain(torch.stack(
            [ck.wave_pred_matrix_plain(cand, q) for q in ranks]))
        if label == "resident":
            fn = ((lambda c=cand: ck.shard_pred_exchange(c, rclip)) if fused
                  else (lambda c=cand: ck.wave_exchange(
                      ck.shard_pred_matrices(c, rclip))))
        else:
            fn = ((lambda c=cand: ck.word_pred_exchange(c, xstep, xclip))
                  if fused else (lambda c=cand: ck.wave_exchange(
                      ck.word_pred_matrices(c, xstep, xclip))))
        _same(f"K10 exchange ({label})", fn(), want)
        e = _entry(fn)
        e.update(peak_alloc_bytes=_peak_alloc(fn), batch=cand.shape[0],
                 shards=s_n, fused=fused)
        out[f"k10_exchange_{label}"] = e
    return out


def _demotion(ck, res, order, n_live: int, e: int):
    """The device half of a demotion event as the imported tree's
    ``_demote_now`` runs it: with K7's tile twin (one launch an event),
    the whole order padded to whole chunks of e ranks in one
    ``apply_evict``; without, one ``apply_evict`` a chunk, each rebased by
    the count already gone. ``order`` is a sorted int32 numpy array."""
    import numpy as np
    import torch

    dev = res.dict_keys.device
    if hasattr(ck, "dict_evict_tiles_plain"):
        ev = np.full(-(-len(order) // e) * e, ck.INT32_MAX, np.int32)
        ev[:len(order)] = order
        return ck.apply_evict(res, torch.from_numpy(ev).to(dev), len(order),
                              n_live)
    for done in range(0, len(order), e):
        chunk = order[done:done + e] - done
        ev = np.full(e, ck.INT32_MAX, np.int32)
        ev[:len(chunk)] = chunk
        res = ck.apply_evict(res, torch.from_numpy(ev).to(dev), len(chunk))
    return res


def time_k7(data, on, ck, K) -> dict:
    """K7 alone on the captured demotion event, and the whole demotion
    (``_demotion``) at the captured chunk and at a quarter of the event
    (four chunks): each checked against the plain version of the whole
    event, then timed (wall and device, CUDA kernels a call, bytes one
    call allocates)."""
    import inspect

    import torch

    d = on(data["k7"])
    r, h = d["res"], d["res"]["hist"]
    res = ck.ResState(r["dict_keys"], r["n_keys"], ck.HistState(
        ck.ConflictState(**h["base"]), h["base_st"],
        ck.ConflictState(**h["delta"])), r["shard_lo"], r["shard_hi"])
    order = d["order"].cpu().numpy()
    n_live, n_ev, e = d["n_live"], d["n_ev"], d["e"]
    ev = torch.full((e * -(-n_ev // e),), ck.INT32_MAX, dtype=torch.int32,
                    device=res.dict_keys.device)
    ev[:n_ev] = d["order"]
    nd, nn, shift = ck._dict_evict_plain(res.dict_keys, res.n_keys, ev)
    h = res.hist
    bk, dk, lo, hi = ck._rewrite_ranks_plain(
        [h.base.keys, h.delta.keys, res.shard_lo, res.shard_hi], shift, False)
    want = ck.ResState(nd, nn, ck.HistState(h.base._replace(keys=bk),
                                             h.base_st,
                                             h.delta._replace(keys=dk)),
                       lo, hi)
    takes_live = "n_live" in inspect.signature(K.dict_evict).parameters
    live = (n_live,) if takes_live else ()
    got = K.dict_evict(res.dict_keys, res.n_keys, ev, n_ev, *live)
    _same("K7", got, (nd, nn, shift))
    fn = (lambda: K.dict_evict(res.dict_keys, res.n_keys, ev, n_ev, *live))
    out = {"k7": {**_entry(fn), "peak_alloc_bytes": _peak_alloc(fn),
                  "d1": res.dict_keys.shape[0], "w": res.dict_keys.shape[1],
                  "n_live": n_live, "n_ev": n_ev, "e": e,
                  "takes_n_live": takes_live}}
    for label, chunk in (("one_chunk", e), ("four_chunks", -(-n_ev // 4))):
        _same(f"K7 demotion ({label})",
              _demotion(ck, _clone(res), order, n_live, chunk), want)
        run = (lambda r, c=chunk: _demotion(ck, r, order, n_live, c))
        entry = _entry(run, lambda: (_clone(res),))
        copy = _clone(res)
        entry.update(peak_alloc_bytes=_peak_alloc(lambda: run(copy)),
                     chunk=chunk, chunks=-(-n_ev // chunk))
        out[f"k7_demotion_{label}"] = entry
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
    if "k7" in data:
        result.update(time_k7(data, on, ck, K))
    if "smoke" not in data:  # a capture of K7 alone
        print(json.dumps(result))
        return
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
    if "nr_flat" in data:
        result.update(time_k12_k13_packed(data, on, ck, K))
    if "k8" in data:
        result.update(time_k8_k16(data, on, ck, K))
    if "k17_flat" in data:
        result.update(time_k17_k11(data, on, ck, K))
    if "k10" in data:
        result.update(time_k15_k10(data, on, ck, K))
    print(json.dumps(result))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("capture", "time"))
    ap.add_argument("path")
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--seed", type=int, default=0,
                    help="capture: phase 3j's read stream seed")
    ap.add_argument("--only", choices=("k7",),
                    help="capture: the K7 demotion event alone")
    args = ap.parse_args()
    # Import the package (and chip_smoke) from the tree asked for, never
    # from this file's directory.
    sys.path[0] = str(Path(args.tree).resolve())
    if args.mode == "capture":
        capture(args.path, args.seed, args.only)
    else:
        time_tree(args.path, args.tree)


if __name__ == "__main__":
    main()
