"""Resolve-stream bench of the port: the wire window path on one card.

    python -m foundationdb_tpu_torch.bench [--mode ycsb|mako|tpcc]
        [--txns N] [--keys N] [--capacity N] [--seed N] [--window 32]
        [--pipeline-depth 4] [--repeats 3] [--device cuda|cpu] [--inline]
        [--wave-commit 0|1] [--dict-hot-capacity N] [--dict-delta-slots N]
        [--spec-resolve 0|1] [--spec-depth N] [--shifting-hotspot]
        [--resolvers N] [--resident 0|1] [--baseline 0|1] [--profile]

A YCSB-A, mako or TPC-C shaped stream (``loadgen/ycsb.py``) is encoded in
the resolver wire format and resolved through
``TorchConflictSet.pack_wire_window``/``dispatch_window``, ``--window``
batches per dispatch, with ``--pipeline-depth`` windows in flight (the
way a proxy caps outstanding resolver requests) and the host pack of the
next window on a worker thread (``sched/packing.py``; ``--inline`` packs
on the dispatching thread). Each window's latency is its submit-to-
verdicts time, so the percentiles come from the same run as the
throughput. The best of ``--repeats`` runs is reported, with the SHA-256
of its verdict stream in window order. ``--profile`` adds the CUDA-event
time of each kernel launch of one warm window, with the host pack and the
two copies. ``--wave-commit 1`` resolves with a wave-commit engine
(reorder, don't abort) and adds the reordered and cycle-aborted counts
and K6's rounds and victims per batch to the record.
``--dict-hot-capacity N`` makes the engine's device dictionary a hot tier
of N keys over a host cold store (demotions by K7 instead of full
repacks; ``--dict-delta-slots`` sets the delta slots, 0 the default);
``--spec-resolve 1`` dispatches windows speculatively, at most
``--spec-depth`` unconfirmed (every window confirms). The record carries
``dict_stats`` (the tier counters among them) and ``spec_metrics``.
``--shifting-hotspot`` replaces the Zipf draw by a walking hotspot, the
tiered dictionary's regime. ``--resolvers N`` (N > 1) resolves with a
``ShardedConflictSet`` of N keyspace shards on the card, split at the
quantiles of a key sample drawn from the stream (the first eight
batches' write keys, as the repository's ``bench.py`` draws it), with
auto-reshard off; the record adds ``shard_occupancy`` and, on a wave
engine, ``exchange_stats``. ``--resident 0`` resolves with the packed
non-resident engine (a [C, W] word-key history and a dictionary per
batch: K12 and K13 in place of K1, K2's probe and K4); its record has no
``dict_stats`` (null). ``--resident 0 --resolvers N`` resolves with the
non-resident sharded engine (full-key batches, N flat [C, W] shard
histories: K2's table, K14, K15, K16, K3 or K5 in its OR mode (K10) and
K6, and the unpacked paint of K12, K13 and K14). ``--baseline 1`` (the
default, as the repository's ``bench.py`` always races it) also resolves
the same stream, marshalled to the C ABI outside the timed loop, through
the CPU SkipList engine (``models/cpu_conflict_set.py``) one batch a
call, and adds its txns/s, per-batch p50/p99, ``vs_baseline`` (the
card's txns/s over the skiplist's), ``p99_vs_cpu`` (the card's window
p99 over the skiplist's batch p99: the units differ and are named in
``latency_units``), ``verdict_parity`` (the two verdict streams equal
byte for byte) and the host's ``machine_state`` to the record.
``run_pinned_cpu_baseline`` runs the skiplist alone on the pinned
configuration ``CPU_BASELINE_PIN``. Prints one JSON line.

The run is on the card (``--device cuda``, the default, raises without
one); ``--device cpu`` runs the plain torch versions.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

from foundationdb_tpu_torch import kernels as K
from foundationdb_tpu_torch.loadgen.ycsb import (
    KEY_BYTES,
    MODES,
    WINDOW,
    ModeConfig,
    build_wire_stream,
    gen_workload,
)
from foundationdb_tpu_torch.models import conflict_kernel as ck
from foundationdb_tpu_torch.models.cpu_conflict_set import (
    CPUSkipListConflictSet,
)
from foundationdb_tpu_torch.models.conflict_set import (
    TorchConflictSet,
    _RepackPlan,
    resolve_device,
    upload,
)
from foundationdb_tpu_torch.parallel.sharded_resolver import (
    ShardedConflictSet,
    density_splits,
)
from foundationdb_tpu_torch.sched.packing import PipelinedWindowRunner


def pct(lat_ms: list[float], q: float) -> float:
    return float(np.percentile(lat_ms, q)) if lat_ms else 0.0


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def make_engine(mode: ModeConfig, capacity: int, device, wave: bool = False,
                **engine) -> TorchConflictSet:
    """The mode's engine; ``engine`` holds further constructor arguments
    (dict_hot_capacity, dict_delta_slots, spec_resolve, spec_depth,
    resident, window_versions in place of WINDOW; with
    ``n_shards`` a ShardedConflictSet, and its splits and auto_reshard)."""
    cls = ShardedConflictSet if "n_shards" in engine else TorchConflictSet
    return cls(**{
        "capacity": capacity, "batch_size": mode.batch,
        "max_read_ranges": mode.n_reads, "max_write_ranges": mode.n_writes,
        "max_key_bytes": KEY_BYTES, "window_versions": WINDOW,
        "device": device, "wave_commit": wave, **engine})


def density_sample(write_ids: np.ndarray, mode: ModeConfig) -> list[bytes]:
    """The split sample of a sharded run: the first 16,384 write keys of
    the stream's first eight batches (what a proxy observed before it
    split), as the repository's ``bench.py`` draws it."""
    n = min(len(write_ids), 8 * mode.batch)
    return [int(k).to_bytes(8, "big")
            for k in write_ids[:n].reshape(-1)[:16384]]


def sharded_engine(n_shards: int, sample: list[bytes] | None) -> dict:
    """Constructor arguments of an n-shard engine split at the density
    quantiles of ``sample`` (None: uniform), with auto-reshard off: the
    bench compares split policies itself."""
    return {"n_shards": n_shards, "auto_reshard": False,
            "splits": None if sample is None
            else density_splits(n_shards, sample)}


def make_stream(mode: ModeConfig, n_batches: int, n_keys: int, seed: int,
                shifting_hotspot: bool = False):
    """(blob, txn_ends) of ``n_batches`` batches of the mode's stream."""
    stream = gen_workload(n_batches * mode.batch, n_keys, seed, mode,
                          shifting_hotspot)
    return build_wire_stream(*stream, n_batches, mode)


def window_wire(blob, txn_ends, mode: ModeConfig, window: int, wi: int):
    """(wire bytes, commit versions) of window ``wi``: batches
    [wi·window, (wi+1)·window) at commit versions 1 + batch index."""
    b = mode.batch
    lo = int(txn_ends[wi * window * b])
    hi = int(txn_ends[(wi + 1) * window * b])
    return blob[lo:hi], list(range(wi * window + 1, (wi + 1) * window + 1))


def drive(cs: TorchConflictSet, blob, txn_ends, mode: ModeConfig,
          n_windows: int, window: int, depth: int, threaded: bool = True,
          reshard: tuple | None = None):
    """Resolve ``n_windows`` windows as a bounded pipeline: window i+depth
    is submitted, then window i is collected. Returns (verdicts int8
    [n_windows, window, B], levels int32 [n_windows, window, B] of a wave
    engine or None, window latency ms, host pack ms per window, seconds,
    seconds packs waited behind deferred repacks, the shard occupancy
    just before the reshard or None). ``reshard`` = (window index, split
    keys) re-splits a sharded engine before that window is submitted,
    once every earlier window is collected (nothing packed ahead)."""
    runner = PipelinedWindowRunner(cs, threaded=threaded)
    verdicts = [None] * n_windows
    levels = [None] * n_windows
    submit_t = [0.0] * n_windows
    lat_ms = [0.0] * n_windows
    done = 0
    occ_before = None
    try:
        t0 = time.perf_counter()
        for wi in range(n_windows):
            if reshard is not None and wi == reshard[0]:
                while done < wi:
                    verdicts[done] = runner.collect_next()
                    levels[done] = cs.last_wave_window
                    lat_ms[done] = (time.perf_counter()
                                    - submit_t[done]) * 1e3
                    done += 1
                occ_before = cs.shard_occupancy()
                cs.reshard(reshard[1])
            submit_t[wi] = time.perf_counter()
            runner.submit(*window_wire(blob, txn_ends, mode, window, wi),
                          mode.batch)
            runner.dispatch_ready()
            if wi >= depth:
                verdicts[done] = runner.collect_next()
                levels[done] = cs.last_wave_window
                lat_ms[done] = (time.perf_counter() - submit_t[done]) * 1e3
                done += 1
        while done < n_windows:
            verdicts[done] = runner.collect_next()
            levels[done] = cs.last_wave_window
            lat_ms[done] = (time.perf_counter() - submit_t[done]) * 1e3
            done += 1
        seconds = time.perf_counter() - t0
    finally:
        runner.close()
    return (np.stack(verdicts), np.stack(levels) if cs.wave_commit else None,
            lat_ms, [s * 1e3 for s in runner.pack_s], seconds,
            runner.gate_wait_s, occ_before)


def run_wire(blob, txn_ends, mode: ModeConfig, n_batches: int,
             capacity: int, device, window: int = 32, pipeline_depth: int = 4,
             repeats: int = 3, threaded: bool = True, warmup: bool = True,
             wave: bool = False, engine: dict | None = None,
             reshard: tuple | None = None):
    """The resolve stream through the window path. Returns (record,
    verdicts of the best repeat [n_windows, window, B], its levels of the
    same shape on a wave engine or None, its engine). ``engine`` holds
    further constructor arguments of ``make_engine``; ``reshard`` is
    ``drive``'s (window index, split keys) for a sharded engine.

    ``warmup`` first resolves window 0 on a throwaway engine (builds the
    kernels and the packer). The record's ``launches_per_window`` is the
    best repeat's kernel launches (on the card) per window."""
    engine = engine or {}
    window = max(1, min(window, n_batches))
    n_windows = n_batches // window
    depth = max(1, min(pipeline_depth, n_windows))
    if warmup:
        wire, cvs = window_wire(blob, txn_ends, mode, window, 0)
        make_engine(mode, capacity, device, wave, **engine
                    ).resolve_wire_window(wire, cvs, mode.batch)
    best = None
    for _ in range(repeats):
        cs = make_engine(mode, capacity, device, wave, **engine)
        before = dict(K.LAUNCHES)
        verdicts, levels, lat, pack, sec, wait, occ = drive(
            cs, blob, txn_ends, mode, n_windows, window, depth, threaded,
            reshard)
        launches = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
        if best is None or sec < best[3]:
            best = (verdicts, lat, pack, sec, cs, launches, wait, levels, occ)
    verdicts, lat, pack, sec, cs, launches, wait, levels, occ = best
    counts = np.bincount(verdicts.reshape(-1), minlength=3)
    n_txns = verdicts.size
    record = {
        "txns": n_txns, "batches": n_windows * window, "window": window,
        "pipeline_depth": depth, "threaded": threaded,
        "seconds": sec, "txns_per_s": n_txns / sec,
        "window_ms_p50": pct(lat, 50), "window_ms_p99": pct(lat, 99),
        "committed": int(counts[0]), "conflict": int(counts[1]),
        "too_old": int(counts[2]),
        "verdicts_sha256": hashlib.sha256(verdicts.tobytes()).hexdigest(),
        "host_pack_s": sum(pack) / 1e3,
        "pack_gate_wait_s": wait,
        "host_pack_ms_per_window": sum(pack) / n_windows,
        # Window 0 brings most of the key population (a deferred full
        # repack); the steady state is the median of the others.
        "host_pack_ms_cold": pack[0],
        "host_pack_ms_warm": (float(np.median(pack[1:]))
                              if n_windows > 1 else None),
        "host_syncs_per_window": cs.host_syncs / n_windows,
        "launches_per_window": {k: n / n_windows
                                for k, n in launches.items()},
        "overflowed": cs.overflowed,
        "dict_stats": cs.dict_stats,
        "spec_metrics": cs.spec_metrics(),
    }
    if isinstance(cs, ShardedConflictSet):
        record["shard_occupancy"] = cs.shard_occupancy()
        if reshard is not None:
            record["reshard"] = {"at_window": reshard[0],
                                 "occupancy_before": occ,
                                 "moved_shards": cs.reshard_moved_shards}
        if wave:
            record["exchange_stats"] = cs.exchange_stats()
    if wave:
        st = cs.wave_stats
        record.update({
            "wave_commit": True,
            "reordered": int((levels > 0).sum()),
            "cycle_aborted": int((levels == ck.LEVEL_CYCLE).sum()),
            "levels_sha256": hashlib.sha256(levels.tobytes()).hexdigest(),
            "k6_rounds_per_batch": st["rounds"] / st["batches"],
            "k6_victims_per_batch": st["victims"] / st["batches"],
            "k6_max_rounds": st["max_rounds"],
            "k6_max_victims": st["max_victims"],
        })
    return record, verdicts, levels, cs


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_clone(x) for x in tree))
    return tree


def profile_window(blob, txn_ends, mode: ModeConfig, capacity: int,
                   window: int, warm_windows: int = 2,
                   wave: bool = False, engine: dict | None = None) -> dict:
    """CUDA-event times (ms) of each kernel launch of one warm window,
    summed over its k steps, with the host pack (host clock), the
    host-to-device and the device-to-host copy, and the whole window
    program timed alone on a copy of the same state. The replayed
    phases must give the window program's verdicts (and levels). A wave
    engine's acceptance is K5 and K6 in place of K3; a sharded engine's
    step is K9, K8 (its live table and probe), then K3 (or the exchange,
    ``k10_exchange``: K5 in its OR mode per shard, and K6) and K4 per
    shard. A flat history (``history="batch"``) has no fold and
    its K2 probe builds the table over all C versions; ``rmq="blocked"``
    times K17's build (``k17_build``) and its probe with K12's rank search
    (``k17_probe``) in place of K2's. ``engine`` holds further
    constructor arguments."""
    dev = torch.device("cuda")
    n_windows = (len(txn_ends) - 1) // mode.batch // window
    if n_windows <= warm_windows:
        raise ValueError(f"--profile needs more than {warm_windows} "
                         "windows of batches")
    cs = make_engine(mode, capacity, dev, wave, **(engine or {}))
    sharded = isinstance(cs, ShardedConflictSet)
    for wi in range(warm_windows):
        cs.resolve_wire_window(*window_wire(blob, txn_ends, mode, window, wi),
                               mode.batch)
    out: dict = {"warm_windows": warm_windows, "window": window}
    t0 = time.perf_counter()
    prepared = cs.pack_wire_window(
        *window_wire(blob, txn_ends, mode, window, warm_windows), mode.batch)
    out["host_pack_ms"] = (time.perf_counter() - t0) * 1e3
    if prepared.rebase_delta:
        cs.state = ck.rebase_res(cs.state, prepared.rebase_delta)
    hb = prepared.batch
    out["deferred_repack"] = isinstance(hb, _RepackPlan)
    if out["deferred_repack"]:
        t0 = time.perf_counter()
        hb = cs._repack_and_rank(hb)
        torch.cuda.synchronize()
        out["repack_ms"] = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()

    spans: dict[str, list] = {}

    def timed(label, fn, *args, **kw):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        r = fn(*args, **kw)
        e.record()
        spans.setdefault(label, []).append((s, e))
        return r

    rb = timed("h2d", upload, hb, dev)
    cvs, olds = prepared.cvs_rel, prepared.olds_rel
    res0 = _clone(cs.state)
    if sharded:
        want = timed("window_program", ck.sharded_resolve_res_many, res0, rb,
                     cvs, olds, hb.n_new, wave=wave)[:2 if wave else 1]
    else:
        want = timed("window_program", ck.resolve_many_res, res0, rb, cvs,
                     olds, hb.n_new, hb.demand, wave=wave, rmq=cs.rmq)[:-1]

    res = cs.state
    if hb.n_new:
        nd, nn, shift = timed("k1_insert", ck._dict_insert, res.dict_keys,
                              res.n_keys, rb.delta_keys, hb.n_new)
        res = timed("k1_rewrite", ck._rewrite_res_ranks, res, shift, False,
                    nd, nn)
    hist = res.hist
    k, b = rb.ranks.txn_mask.shape
    got = ck.window_out(k, b, dev, wave)
    for i in range(k):
        rbk = ck._step(rb.ranks, i)
        if sharded:
            hist = _replay_sharded_step(timed, hist, res, rbk, int(cvs[i]),
                                        int(olds[i]), wave, got, i)
            continue
        two = isinstance(hist, ck.HistState)
        level = hist.delta if two else hist
        floor, _ = ck.too_old_mask_packed(level, rbk, int(olds[i]))
        if two:
            hist = timed("k4_fold", ck._maybe_merge, hist,
                         int(hb.demand[i]), floor)
            level = hist.delta
        if cs.rmq == "blocked":
            table = timed("k17_build", K.blocked_build, level.versions,
                          level.n_used)
            too_old, _, cand = timed("k17_probe", ck.history_probe, hist,
                                     rbk, floor, "blocked", table=table)
        else:
            too_old, _, cand = timed("k2_probe", ck.history_probe, hist,
                                     rbk, floor)
        ranks = ck.endpoint_ranks_live_packed(rbk)
        if wave:
            p = timed("k5_pred", ck.wave_pred_matrix, cand, ranks)
            accepted, _, _ = timed(
                "k6_level", ck.wave_level, cand, p, too_old, rbk.txn_mask,
                level_out=got.levels[i], verdicts_out=got.verdicts[i])
        else:
            accepted, _ = timed("k3_accept", ck.accept, cand, too_old,
                                rbk.txn_mask, ranks, got.verdicts[i])
        painted = timed("k4_paint", ck._paint_and_compact_res, level, rbk,
                        accepted, int(cvs[i]), floor)
        hist = ck.HistState(hist.base, hist.base_st, painted) if two \
            else painted
    timed("d2h", lambda t: t.to("cpu"), got.raw)
    torch.cuda.synchronize()
    replayed = [got.verdicts] + ([got.levels] if wave else [])
    if not all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(replayed, want)):
        raise RuntimeError("profiled phases disagree with the window program")
    for label, ev in spans.items():
        out[f"{label}_ms"] = sum(s.elapsed_time(e) for s, e in ev)
    out["phase_sum_ms"] = sum(
        out[f"{p}_ms"] for p in ("k1_insert", "k1_rewrite", "k4_fold",
                                 "k2_probe", "k17_build", "k17_probe",
                                 "k9_clip",
                                 "k8_probe", "k3_accept", "k5_pred",
                                 "k10_exchange", "k6_level", "k4_paint")
        if f"{p}_ms" in out)
    return out


def _replay_sharded_step(timed, hist, res, rbk, cv: int, old: int,
                         wave: bool, got, i: int):
    """One sharded step launch by launch under ``timed`` (the profile's
    CUDA-event spans), its verdicts (and levels) into row i of ``got``."""
    floor = torch.maximum(hist.oldest, torch.full(
        (), old, dtype=torch.int32, device=hist.oldest.device))
    clip = timed("k9_clip", ck.shard_clip, rbk, res.shard_lo, res.shard_hi,
                 wave)
    too_old, _, cand = timed(
        "k8_probe", K.shard_probe, hist.keys, hist.versions, hist.n_used,
        rbk.read_begin, rbk.read_end, rbk.read_mask, rbk.read_version,
        rbk.txn_mask, res.shard_lo, res.shard_hi, floor[0])
    if wave:
        p, _ = timed("k10_exchange", ck.shard_pred_exchange, cand, clip)
        accepted, _, _ = timed("k6_level", ck.wave_level, cand, p, too_old,
                               rbk.txn_mask, level_out=got.levels[i],
                               verdicts_out=got.verdicts[i])
    else:
        accepted, _ = timed("k3_accept", ck.accept, cand, too_old,
                            rbk.txn_mask, ck.endpoint_ranks_live_packed(rbk),
                            got.verdicts[i])
    return timed("k4_paint", ck._paint_shards, hist, rbk, clip, accepted, cv,
                 floor)


# ---------------------------------------------------------------------------
# CPU baseline path
# ---------------------------------------------------------------------------


def marshal_cpu_batches(n_batches, read_ids, write_ids, write_mask, lag,
                        mode: ModeConfig = MODES["ycsb"]):
    """Pre-marshal every batch to the skiplist's C ABI (outside the timed
    loop): (blob, ranges, read counts, write counts, read versions, commit
    version, oldest version) a batch.

    Blob layout: one 9-byte record per range (8-byte BE key + 0x00); the
    begin endpoint is bytes [9i, 9i+8), the end endpoint [9i, 9i+9).
    Ranges are emitted in per-txn order: reads then the optional writes.
    """
    B, R, Q = mode.batch, mode.n_reads, mode.n_writes
    out = []
    for b in range(n_batches):
        s = slice(b * B, (b + 1) * B)
        r_ids, w_ids, wm = read_ids[s], write_ids[s], write_mask[s]
        slots = np.concatenate([r_ids, w_ids], axis=1)
        live = np.ones((B, R + Q), bool)
        live[:, R:] = wm[:, None]
        ids = slots[live]
        m = ids.size
        recs = np.zeros((m, 9), np.uint8)
        recs[:, :8] = ids.astype(">u8").view(np.uint8).reshape(m, 8)
        blob = recs.tobytes()
        off = 9 * np.arange(m, dtype=np.int64)
        ranges = np.stack(
            [off, np.full(m, 8, np.int64), off, np.full(m, 9, np.int64)],
            axis=1)
        rc = np.full(B, R, np.int32)
        wc = (wm * Q).astype(np.int32)
        cv = b + 1
        rv = np.maximum(cv - 1 - lag[s], 0).astype(np.int64)
        out.append((blob, np.ascontiguousarray(ranges), rc, wc, rv,
                    cv, max(0, cv - WINDOW)))
    return out


def run_cpu(batches, mode: ModeConfig = MODES["ycsb"]):
    """The marshalled batches through one CPU SkipList engine, a batch a
    call. Returns (seconds, conflicts, per-batch latency ms, verdicts int8
    [n_batches, B]): the dispatch-to-verdict latency of each batch, for
    the equal-p99 comparison of the north-star metric."""
    cs = CPUSkipListConflictSet()
    verdicts = np.zeros((len(batches), mode.batch), np.int8)
    lat_ms = []
    t0 = time.perf_counter()
    for i, (blob, ranges, rc, wc, rv, cv, oldest) in enumerate(batches):
        tb = time.perf_counter()
        cs.oldest_version = max(cs.oldest_version, oldest)
        cs.resolve_marshalled(blob, ranges, rc, wc, rv, cv, out=verdicts[i])
        lat_ms.append((time.perf_counter() - tb) * 1e3)
    dt = time.perf_counter() - t0
    return dt, int((verdicts == 1).sum()), lat_ms, verdicts


# The pinned CPU-baseline configuration of the repository's bench.py: one
# fixed txn count, key count and seed, so that the baseline's txns/s is
# comparable across runs whatever size the card's run has.
CPU_BASELINE_PIN = {
    "mode": "ycsb",
    "txns": 262_144,
    "keys": 1 << 16,
    "seed": 20260729,
}


def machine_state() -> dict:
    """The host's cores and 1-minute load (the skiplist's number is
    host-sensitive: a loaded host skews it)."""
    import os

    try:
        load1 = os.getloadavg()[0]
    except (OSError, AttributeError):
        load1 = None
    return {"cpu_count": os.cpu_count(), "loadavg_1m": load1}


def cpu_record(n_txns: int, dt: float, conflicts: int, lat: list,
               verdicts: np.ndarray) -> dict:
    """A skiplist run's record: txns/s, per-batch p50/p99, its verdict
    hash (batch order, as the card's ``verdicts_sha256``)."""
    return {"txns_per_sec": n_txns / dt, "elapsed_s": dt,
            "conflicts": conflicts, "p50_ms": pct(lat, 50),
            "p99_ms": pct(lat, 99), "latency_samples": len(lat),
            "verdicts_sha256": hashlib.sha256(verdicts.tobytes()).hexdigest(),
            "machine_state": machine_state()}


def pinned_stream():
    """(mode, batches, stream) of ``CPU_BASELINE_PIN``."""
    mode = MODES[CPU_BASELINE_PIN["mode"]]
    n_batches = max(1, CPU_BASELINE_PIN["txns"] // mode.batch)
    stream = gen_workload(n_batches * mode.batch, CPU_BASELINE_PIN["keys"],
                          CPU_BASELINE_PIN["seed"], mode)
    return mode, n_batches, stream


def run_pinned_cpu_baseline() -> dict:
    """The fixed-configuration CPU SkipList baseline, with the machine
    state it ran under."""
    mode, n_batches, stream = pinned_stream()
    dt, conf, lat, verdicts = run_cpu(
        marshal_cpu_batches(n_batches, *stream, mode), mode)
    return {"config": dict(CPU_BASELINE_PIN),
            **cpu_record(n_batches * mode.batch, dt, conf, lat, verdicts)}


def baseline_fields(record: dict, cpu: dict) -> dict:
    """The baseline fields of a card record beside a ``cpu_record`` of
    the same stream."""
    return {
        "cpu_baseline_txns_per_sec": cpu["txns_per_sec"],
        "cpu_p50_ms": cpu["p50_ms"], "cpu_p99_ms": cpu["p99_ms"],
        "vs_baseline": record["txns_per_s"] / cpu["txns_per_sec"],
        "p99_vs_cpu": (record["window_ms_p99"] / cpu["p99_ms"]
                       if cpu["p99_ms"] else None),
        "latency_units": {"window_ms": f"ms a window of "
                                       f"{record['window']} batches",
                          "cpu_ms": "ms a batch"},
        "verdict_parity": cpu["verdicts_sha256"]
        == record["verdicts_sha256"],
        "cpu_verdicts_sha256": cpu["verdicts_sha256"],
        "machine_state": cpu["machine_state"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=sorted(MODES), default="ycsb")
    ap.add_argument("--txns", type=int, default=1_000_000)
    ap.add_argument("--keys", type=int, default=1 << 16)
    ap.add_argument("--capacity", type=int, default=1 << 18)
    ap.add_argument("--seed", type=int, default=20260729)
    ap.add_argument("--window", type=int, default=32)
    ap.add_argument("--pipeline-depth", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--inline", action="store_true",
                    help="pack on the dispatching thread")
    ap.add_argument("--wave-commit", choices=("0", "1"), default="0",
                    help="1: wave-commit engine (reorder, don't abort)")
    ap.add_argument("--dict-hot-capacity", type=int, default=0,
                    help="N > 0: a tiered dictionary, N hot keys on the card")
    ap.add_argument("--dict-delta-slots", type=int, default=0,
                    help="dictionary delta slots per dispatch (0: default)")
    ap.add_argument("--spec-resolve", choices=("0", "1"), default="0",
                    help="1: speculative window resolve")
    ap.add_argument("--spec-depth", type=int, default=2,
                    help="unconfirmed windows a speculative engine keeps")
    ap.add_argument("--shifting-hotspot", action="store_true",
                    help="a walking hotspot in place of the Zipf draw")
    ap.add_argument("--resolvers", type=int, default=1,
                    help="N > 1: N keyspace shards on the card, split at "
                         "the stream sample's density quantiles")
    ap.add_argument("--resident", choices=("0", "1"), default="1",
                    help="0: the packed non-resident engine")
    ap.add_argument("--history", choices=("window", "batch"),
                    default="window",
                    help="batch: one flat history, its table rebuilt every "
                         "batch (the JAX FDB_TPU_HISTORY)")
    ap.add_argument("--rmq", choices=("sparse", "blocked"), default="sparse",
                    help="blocked: per-batch range-max tables as the blocked "
                         "structure, K17 (FDB_TPU_RMQ)")
    ap.add_argument("--accept", choices=("wave", "seq"), default="wave",
                    help="the in-block acceptance design (FDB_TPU_ACCEPT; "
                         "K3 computes both)")
    ap.add_argument("--packed", choices=("0", "1"), default="1",
                    help="0: the unpacked engine, full key rows to the card "
                         "(FDB_TPU_PACKED)")
    ap.add_argument("--baseline", choices=("0", "1"), default="1",
                    help="1: also resolve the stream through the CPU "
                         "SkipList engine and add the baseline fields")
    ap.add_argument("--profile", action="store_true",
                    help="also time each kernel launch of one warm window "
                         "(needs the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.profile and dev.type != "cuda":
        raise SystemExit("--profile times kernel launches on the card; "
                         "it needs --device cuda")
    if args.profile and (args.resident == "0" or args.packed == "0"):
        raise SystemExit("--profile replays the resident window program; "
                         "it needs --resident 1 --packed 1")
    mode = MODES[args.mode]
    window = max(1, min(args.window, max(1, args.txns // mode.batch)))
    n_batches = max(1, args.txns // mode.batch) // window * window
    stream = gen_workload(n_batches * mode.batch, args.keys, args.seed, mode,
                          args.shifting_hotspot)
    blob, ends = build_wire_stream(*stream, n_batches, mode)
    engine = {"dict_hot_capacity": args.dict_hot_capacity,
              "dict_delta_slots": args.dict_delta_slots,
              "spec_resolve": args.spec_resolve == "1",
              "spec_depth": args.spec_depth,
              "resident": args.resident == "1", "history": args.history,
              "rmq": args.rmq, "accept": args.accept,
              "packed": args.packed == "1"}
    if args.resolvers > 1:
        engine.update(sharded_engine(args.resolvers,
                                     density_sample(stream[1], mode)))
    record, *_ = run_wire(
        blob, ends, mode, n_batches, args.capacity, dev, window=window,
        pipeline_depth=args.pipeline_depth, repeats=args.repeats,
        threaded=not args.inline, wave=args.wave_commit == "1",
        engine=engine)
    out = {"bench": "resolve_stream", "mode": args.mode, "device": str(dev),
           "workload": "shifting_hotspot" if args.shifting_hotspot
           else "zipf", "resolvers": args.resolvers,
           "resident": args.resident == "1",
           "design": {k: engine[k] for k in ("history", "packed", "rmq",
                                              "accept")}, **record}
    if args.baseline == "1":
        dt, conf, lat, verdicts = run_cpu(
            marshal_cpu_batches(n_batches, *stream, mode), mode)
        out.update(baseline_fields(record, cpu_record(
            n_batches * mode.batch, dt, conf, lat, verdicts)))
    if dev.type == "cuda":
        out["card"] = card_line()
        out["kind"] = torch.cuda.get_device_name(0)
    if args.profile:
        out["profile"] = profile_window(blob, ends, mode, args.capacity,
                                        window, wave=args.wave_commit == "1",
                                        engine=engine)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
