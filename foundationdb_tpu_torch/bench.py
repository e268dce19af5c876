"""Resolve-stream bench of the port: the wire window path on one card.

    python -m foundationdb_tpu_torch.bench [--mode ycsb|mako|tpcc]
        [--txns N] [--keys N] [--capacity N] [--seed N] [--window 32]
        [--pipeline-depth 4] [--repeats 3] [--device cuda|cpu] [--inline]
        [--profile]

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
two copies. Prints one JSON line.

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
from foundationdb_tpu_torch.models.conflict_set import (
    TorchConflictSet,
    _RepackPlan,
    resolve_device,
    upload,
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


def make_engine(mode: ModeConfig, capacity: int, device) -> TorchConflictSet:
    return TorchConflictSet(
        capacity=capacity, batch_size=mode.batch,
        max_read_ranges=mode.n_reads, max_write_ranges=mode.n_writes,
        max_key_bytes=KEY_BYTES, window_versions=WINDOW, device=device)


def make_stream(mode: ModeConfig, n_batches: int, n_keys: int, seed: int):
    """(blob, txn_ends) of ``n_batches`` batches of the mode's stream."""
    stream = gen_workload(n_batches * mode.batch, n_keys, seed, mode)
    return build_wire_stream(*stream, n_batches, mode)


def window_wire(blob, txn_ends, mode: ModeConfig, window: int, wi: int):
    """(wire bytes, commit versions) of window ``wi``: batches
    [wi·window, (wi+1)·window) at commit versions 1 + batch index."""
    b = mode.batch
    lo = int(txn_ends[wi * window * b])
    hi = int(txn_ends[(wi + 1) * window * b])
    return blob[lo:hi], list(range(wi * window + 1, (wi + 1) * window + 1))


def drive(cs: TorchConflictSet, blob, txn_ends, mode: ModeConfig,
          n_windows: int, window: int, depth: int, threaded: bool = True):
    """Resolve ``n_windows`` windows as a bounded pipeline: window i+depth
    is submitted, then window i is collected. Returns (verdicts int8
    [n_windows, window, B], window latency ms, host pack ms per window,
    seconds, seconds packs waited behind deferred repacks)."""
    runner = PipelinedWindowRunner(cs, threaded=threaded)
    verdicts = [None] * n_windows
    submit_t = [0.0] * n_windows
    lat_ms = [0.0] * n_windows
    done = 0
    try:
        t0 = time.perf_counter()
        for wi in range(n_windows):
            submit_t[wi] = time.perf_counter()
            runner.submit(*window_wire(blob, txn_ends, mode, window, wi),
                          mode.batch)
            runner.dispatch_ready()
            if wi >= depth:
                verdicts[done] = runner.collect_next()
                lat_ms[done] = (time.perf_counter() - submit_t[done]) * 1e3
                done += 1
        while done < n_windows:
            verdicts[done] = runner.collect_next()
            lat_ms[done] = (time.perf_counter() - submit_t[done]) * 1e3
            done += 1
        seconds = time.perf_counter() - t0
    finally:
        runner.close()
    return (np.stack(verdicts), lat_ms, [s * 1e3 for s in runner.pack_s],
            seconds, runner.gate_wait_s)


def run_wire(blob, txn_ends, mode: ModeConfig, n_batches: int,
             capacity: int, device, window: int = 32, pipeline_depth: int = 4,
             repeats: int = 3, threaded: bool = True, warmup: bool = True):
    """The resolve stream through the window path. Returns (record,
    verdicts of the best repeat [n_windows, window, B], its engine).

    ``warmup`` first resolves window 0 on a throwaway engine (builds the
    kernels and the packer). The record's ``launches_per_window`` is the
    best repeat's kernel launches (on the card) per window."""
    window = max(1, min(window, n_batches))
    n_windows = n_batches // window
    depth = max(1, min(pipeline_depth, n_windows))
    if warmup:
        wire, cvs = window_wire(blob, txn_ends, mode, window, 0)
        make_engine(mode, capacity, device).resolve_wire_window(
            wire, cvs, mode.batch)
    best = None
    for _ in range(repeats):
        cs = make_engine(mode, capacity, device)
        before = dict(K.LAUNCHES)
        verdicts, lat, pack, sec, wait = drive(cs, blob, txn_ends, mode,
                                               n_windows, window, depth,
                                               threaded)
        launches = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
        if best is None or sec < best[3]:
            best = (verdicts, lat, pack, sec, cs, launches, wait)
    verdicts, lat, pack, sec, cs, launches, wait = best
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
    }
    return record, verdicts, cs


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_clone(x) for x in tree))
    return tree


def profile_window(blob, txn_ends, mode: ModeConfig, capacity: int,
                   window: int, warm_windows: int = 2) -> dict:
    """CUDA-event times (ms) of each kernel launch of one warm window,
    summed over its k steps, with the host pack (host clock), the
    host-to-device and the device-to-host copy, and the whole window
    program timed alone on a copy of the same state. The replayed
    phases must give the window program's verdicts."""
    dev = torch.device("cuda")
    n_windows = (len(txn_ends) - 1) // mode.batch // window
    if n_windows <= warm_windows:
        raise ValueError(f"--profile needs more than {warm_windows} "
                         "windows of batches")
    cs = make_engine(mode, capacity, dev)
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

    def timed(label, fn, *args):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        r = fn(*args)
        e.record()
        spans.setdefault(label, []).append((s, e))
        return r

    rb = timed("h2d", upload, hb, dev)
    cvs, olds = prepared.cvs_rel, prepared.olds_rel
    res0 = _clone(cs.state)
    want, _ = timed("window_program", ck.resolve_many_res, res0, rb, cvs,
                    olds, hb.n_new, hb.demand)

    res = cs.state
    if hb.n_new:
        nd, nn, shift = timed("k1_insert", ck._dict_insert, res.dict_keys,
                              res.n_keys, rb.delta_keys, hb.n_new)
        res = timed("k1_rewrite", ck._rewrite_res_ranks, res, shift, False,
                    nd, nn)
    hist = res.hist
    k, b = rb.ranks.txn_mask.shape
    verdicts = torch.empty((k, b), dtype=torch.int8, device=dev)
    for i in range(k):
        rbk = ck._step(rb.ranks, i)
        floor, _ = ck.too_old_mask_packed(hist.delta, rbk, int(olds[i]))
        hist = timed("k4_fold", ck._maybe_merge, hist, int(hb.demand[i]),
                     floor)
        too_old, _, cand = timed("k2_probe", ck.history_probe, hist, rbk,
                                 floor)
        ranks = ck.endpoint_ranks_live_packed(rbk)
        accepted, _ = timed("k3_accept", ck.accept, cand, too_old,
                            rbk.txn_mask, ranks, verdicts[i])
        delta = timed("k4_paint", ck._paint_and_compact_res, hist.delta, rbk,
                      accepted, int(cvs[i]), floor)
        hist = ck.HistState(hist.base, hist.base_st, delta)
    host = timed("d2h", lambda v: v.to("cpu"), verdicts)
    torch.cuda.synchronize()
    if not torch.equal(host, want.cpu()):
        raise RuntimeError("profiled phases disagree with the window program")
    for label, ev in spans.items():
        out[f"{label}_ms"] = sum(s.elapsed_time(e) for s, e in ev)
    out["phase_sum_ms"] = sum(
        out[f"{p}_ms"] for p in ("k1_insert", "k1_rewrite", "k4_fold",
                                 "k2_probe", "k3_accept", "k4_paint")
        if f"{p}_ms" in out)
    return out


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
    ap.add_argument("--profile", action="store_true",
                    help="also time each kernel launch of one warm window "
                         "(needs the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.profile and dev.type != "cuda":
        raise SystemExit("--profile times kernel launches on the card; "
                         "it needs --device cuda")
    mode = MODES[args.mode]
    window = max(1, min(args.window, max(1, args.txns // mode.batch)))
    n_batches = max(1, args.txns // mode.batch) // window * window
    blob, ends = make_stream(mode, n_batches, args.keys, args.seed)
    record, _, _ = run_wire(
        blob, ends, mode, n_batches, args.capacity, dev, window=window,
        pipeline_depth=args.pipeline_depth, repeats=args.repeats,
        threaded=not args.inline)
    out = {"bench": "resolve_stream", "mode": args.mode, "device": str(dev),
           **record}
    if dev.type == "cuda":
        out["card"] = card_line()
        out["kind"] = torch.cuda.get_device_name(0)
    if args.profile:
        out["profile"] = profile_window(blob, ends, mode, args.capacity,
                                        window)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
