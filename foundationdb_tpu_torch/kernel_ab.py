"""K2 and K3 of one source tree against another's, on inputs captured once.

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
for the settle after the first pass).

``time`` imports ``foundationdb_tpu_torch`` from ``DIR`` (default: the
tree holding this file), holds that tree's K2 and K3 against its own
plain versions on the saved inputs, and prints one JSON line of CUDA-event
times (the mean of 20 launches after a warm-up) and, from
``torch.profiler``, the device time of each kernel function by name. Run
it on two trees in turns (A, B, B, A) in one call to compare them on one
card. Needs a CUDA card; imports no JAX.
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
    out = _to_cpu({
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


def _kernel_ms(fn, reps: int = 10) -> dict:
    """Device ms of each kernel function by name, per call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        if us:
            out[ev.key] = {"ms": us / 1e3 / reps, "calls": ev.count / reps}
    return out


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
        return {k: on(v) for k, v in x.items()}

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
