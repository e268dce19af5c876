"""Simulation spec runner: every TOML spec × N seeds, one command.

A copy of ``foundationdb_tpu/sim/run.py`` for the port, its imports
rewritten to the port's modules; names and behaviour are the JAX module's,
with these differences:

- **The card by default.** ``run_one`` builds each test's ``SimCluster`` on
  its defaults, the torch engine with every recruited engine and the read
  plane on ``cuda`` (no card: it raises). ``--device cpu`` and ``--engine
  {torch,oracle}`` (``run_one``'s ``device`` and ``engine``) are the
  port's only additions, so that a caller can ask for the CPU; a spec's
  own cluster table wins over them. The JAX module pins JAX to the host.
  Worker processes start by ``spawn``, so each opens its own CUDA context.
- **One test at a time.** ``run_one`` parses each ``[[test]]`` of a file
  on its own (``specs.load_test``): a test whose workload or cluster arm
  the port does not have (its parse or its ``SimCluster`` raises
  ``NotImplementedError``) is reported as a failure whose detail names the
  module, and the file's other tests still run. The JAX module parses the
  whole file first.
- **Campaigns are refused.** ``[[campaign]]`` specs and ``--campaigns``
  raise ``NotImplementedError`` naming sim/campaigns.py and
  sim/nemesis.py. What serves only campaigns is not here: no
  ``_run_one_campaign``, no ``--artifacts``, and ``run_one`` returns
  (spec_path, seed, [(title, ok, detail), ...]) without the campaign flag
  and the per-test campaign result.
- **The summary line.** Every run prints one summary JSON line last on
  stdout (the JAX module prints it under ``--campaigns`` only).

Reference: the TestHarness/Joshua loop around `fdbserver -r simulation` —
run a spec under many seeds, report the failing (spec, seed) pairs with
an exact replay command (same seed → same trace, including the fault and
clog schedules).

    python -m foundationdb_tpu_torch.sim.run tests/specs --seeds 50
    python -m foundationdb_tpu_torch.sim.run tests/specs --seeds 2 \\
        --device cpu --engine oracle                        # on the host
    python -m foundationdb_tpu_torch.sim.run tests/specs/Cycle.toml \\
        --seeds 1 --seed-base 1234 --buggify --clog 0.7   # replay one

Each (spec-file, seed) runs in a fresh process (seeds fan out over
--jobs workers); --buggify arms the in-role BUGGIFY sites, --clog adds
slow-but-alive link injection on top of whatever the spec asks for, and
--fail-fast stops the fleet at the first failure (CI).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import traceback
from concurrent.futures import FIRST_COMPLETED, ProcessPoolExecutor, wait

try:
    import tomllib
except ModuleNotFoundError:  # python 3.10: API-compatible backport
    import tomli as tomllib

CAMPAIGNS_UNPORTED = ("campaign specs need sim/campaigns.py (run_campaign) "
                      "and sim/nemesis.py, which are not ported yet")


def is_campaign_spec(path: str) -> bool:
    """True iff the TOML holds [[campaign]] blocks (vs [[test]])."""
    with open(path, "rb") as f:
        return bool(tomllib.load(f).get("campaign"))


def run_one(spec_path: str, seed: int, buggify: bool,
            clog: float | None,
            aggressive: bool = False,
            engine: str | None = None,
            device: str | None = None,
            ) -> tuple[str, int, list[tuple[str, bool, str]]]:
    """Run every [[test]] of one spec file at one seed in THIS process.
    Returns (spec_path, seed, [(title, ok, detail), ...]); a [[campaign]]
    file raises ``NotImplementedError``. ``engine`` and
    ``device`` (None: ``SimCluster``'s defaults, the card) build every
    test's cluster unless its table names its own."""
    if is_campaign_spec(spec_path):
        raise NotImplementedError(f"{spec_path}: {CAMPAIGNS_UNPORTED}")

    from foundationdb_tpu_torch.client.ryw import open_database
    from foundationdb_tpu_torch.sim.cluster import SimCluster
    from foundationdb_tpu_torch.sim.specs import (
        cluster_kwargs, load_doc, load_test, run_spec_test,
    )

    base = {k: v for k, v in (("engine", engine), ("device", device))
            if v is not None}
    out: list[tuple[str, bool, str]] = []
    for test in load_doc(spec_path).get("test", []):
        try:
            spec = load_test(test)
            if buggify:
                spec.buggify = True
            if aggressive:
                spec.buggify = True
                spec.buggify_aggressive = True
            if clog is not None and spec.clog_interval is None:
                spec.clog_interval = clog
            c = SimCluster(seed=seed, **{**base, **cluster_kwargs(spec)})
        except NotImplementedError as e:
            out.append((test.get("testTitle", "untitled"), False,
                        f"NotImplementedError: {e}"))
            continue
        db = open_database(c)
        try:
            r = c.loop.run(run_spec_test(spec, c, db), timeout=3000)
            detail = ", ".join(
                f"{name}={m.txns_committed}tx" for name, m in r.metrics.items()
            )
            if r.kills:
                detail += f" kills={r.kills}"
            out.append((spec.title, True, detail))
        except Exception:
            out.append((spec.title, False, traceback.format_exc(limit=8)))
    return spec_path, seed, out


def replay_line(spec_path: str, seed: int, buggify: bool = False,
                aggressive: bool = False, clog: float | None = None,
                engine: str | None = None, device: str | None = None) -> str:
    """The fully-reproducing one-liner: the seed IS the entire schedule
    (workload interleaving, fault and clog timing), so spec+seed+flags
    replay the failure bit-identically."""
    flags = ""
    if buggify:
        flags += " --buggify"
    if aggressive:
        flags += " --buggify-aggressive"
    if clog is not None:
        flags += f" --clog {clog}"
    if engine is not None:
        flags += f" --engine {engine}"
    if device is not None:
        flags += f" --device {device}"
    return (f"python -m foundationdb_tpu_torch.sim.run {spec_path} "
            f"--seeds 1 --seed-base {seed}{flags}")


def collect_specs(paths: list[str]) -> list[str]:
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            files += sorted(
                os.path.join(p, f) for f in os.listdir(p) if f.endswith(".toml")
            )
        else:
            files.append(p)
    if not files:
        raise SystemExit(f"no .toml specs under {paths}")
    return files


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m foundationdb_tpu_torch.sim.run",
        description="Run every TOML spec × N seeds (TestHarness analogue).",
    )
    ap.add_argument("specs", nargs="*",
                    help="spec .toml files or directories ([[test]] kind)")
    ap.add_argument("--campaigns", choices=("fast",), default=None,
                    help="the campaign battery (not ported: refused)")
    ap.add_argument("--seeds", type=int, default=None,
                    help="seeds per spec (default 10)")
    ap.add_argument("--seed-base", type=int, default=0,
                    help="first seed (failing seeds replay with "
                         "--seeds 1 --seed-base SEED)")
    ap.add_argument("--buggify", action="store_true",
                    help="arm in-role BUGGIFY sites in every test")
    ap.add_argument("--buggify-aggressive", action="store_true",
                    help="every BUGGIFY site active, firing >= 50% "
                         "(maximum perturbation; implies --buggify)")
    ap.add_argument("--clog", type=float, default=None, metavar="INTERVAL",
                    help="add slow-link clogging at this mean interval (s)")
    ap.add_argument("--fail-fast", action="store_true",
                    help="stop the fleet at the first failing (spec, seed)")
    ap.add_argument("--jobs", type=int, default=min(8, os.cpu_count() or 1))
    ap.add_argument("--engine", choices=("torch", "oracle"), default=None,
                    help="every cluster's conflict engine (default: "
                         "SimCluster's, the torch engine)")
    ap.add_argument("--device", default=None,
                    help="the engines' and read plane's device (default: "
                         "cuda; 'cpu' runs the plain versions on the host)")
    args = ap.parse_args(argv)

    if args.campaigns:
        raise NotImplementedError(f"--campaigns: {CAMPAIGNS_UNPORTED}")
    if not args.specs:
        ap.error("specs required")
    if args.seeds is None:
        args.seeds = 10

    files = collect_specs(args.specs)
    for f in files:
        if is_campaign_spec(f):
            raise NotImplementedError(f"{f}: {CAMPAIGNS_UNPORTED}")
    jobs = [(f, args.seed_base + s) for f in files for s in range(args.seeds)]
    print(f"campaign: {len(files)} specs x {args.seeds} seeds = "
          f"{len(jobs)} runs on {args.jobs} workers", flush=True)

    def replay(f, seed):
        return replay_line(f, seed, args.buggify, args.buggify_aggressive,
                           args.clog, args.engine, args.device)

    failures: list[tuple[str, int, str, str]] = []
    done = 0
    stopped_early = False
    with ProcessPoolExecutor(
            max_workers=args.jobs,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futs = {
            pool.submit(run_one, f, seed, args.buggify, args.clog,
                        args.buggify_aggressive, args.engine,
                        args.device): (f, seed)
            for f, seed in jobs
        }
        pending = set(futs)
        while pending:
            finished, pending = wait(pending, return_when=FIRST_COMPLETED)
            for fut in finished:
                f, seed = futs[fut]
                done += 1
                try:
                    _, _, results = fut.result()
                except Exception as e:  # worker crash counts as failure
                    results = [("<worker>", False,
                                f"{type(e).__name__}: {e}")]
                for title, ok, detail in results:
                    if ok:
                        print(f"[{done}/{len(jobs)}] ok   {f}:{title} "
                              f"seed={seed} {detail}", flush=True)
                    else:
                        failures.append((f, seed, title, detail))
                        print(f"[{done}/{len(jobs)}] FAIL {f}:{title} "
                              f"seed={seed}", flush=True)
            if failures and args.fail_fast and pending:
                stopped_early = True
                for fut in pending:
                    fut.cancel()
                pending = set()

    if failures:
        print(f"\n{len(failures)} FAILURES"
              + (" (--fail-fast: fleet stopped early)" if stopped_early
                 else "") + ":", flush=True)
        for f, seed, title, detail in failures:
            print(f"--- {f}:{title} seed={seed}\n{detail}\n"
                  f"replay: " + replay(f, seed), flush=True)
    else:
        print("all green", flush=True)
    # ONE summary line, LAST on stdout.
    print(json.dumps({
        "metric": "sim_specs",
        "specs": len(files),
        "seeds": args.seeds,
        "runs": len(jobs),
        "completed": done,
        "ok": not failures,
        "failures": [
            {"spec": f, "seed": seed, "title": title,
             "replay": replay(f, seed)}
            for f, seed, title, _detail in failures[:10]
        ],
    }), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
