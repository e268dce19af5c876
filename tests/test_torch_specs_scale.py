"""A known fault of the port's sim engine, held on the CPU so that it stays
visible until it is fixed (ROADMAP Queue 3, "the sim engine's range
budget").

The sim engine (``sim/cluster.new_conflict_set``: ``TorchConflictSet`` at
capacity 2^14, batch 256) resolves at most ``max_read_ranges`` = 8 read
ranges a transaction; its pack widens a transaction with more
(``models/conflict_set._coalesce``), so mako's 9 point reads become 5
ranges over about 40% of its rows and conflict with writes the
transaction never read. That is conservative, never wrong, but under
``chip_smoke.py`` phase 3o's run (b) at the transaction counts first asked
(mako and YCSB 4,096, TPC-C and Cycle 2,048; the smoke runs a quarter of
each, for time) a mako transaction retries past the client's limit of 100
and gives up with ``FdbError`` 1021, while the same run over the oracle on
each transaction's own ranges passes.

- The engine's verdicts on mako's transactions are those of the oracle
  given the engine's ranges (``chip_smoke.engine_range_oracle``), which
  rejects transactions the exact oracle commits.
- Run (b) at the full counts, seed 0: over the oracle given the engine's
  ranges a mako transaction gives up with 1021; over the exact oracle
  every workload commits all its transactions and passes its check. When
  the range budget is fixed, the first half is to require the pass too.
"""

import numpy as np
import pytest
import torch

import chip_smoke as smoke
from foundationdb_tpu_torch import TorchConflictSet
from foundationdb_tpu_torch.core.errors import FdbError
from foundationdb_tpu_torch.core.types import (
    TxnConflictInfo,
    Verdict,
    single_key_range,
)
from foundationdb_tpu_torch.sim import workloads
from foundationdb_tpu_torch.sim.oracle import OracleConflictSet

#: Run (b)'s transaction counts as first asked.
FULL_COUNTS = {k: v for k, v in smoke.SPEC_B_CUT_FROM.items()
               if k.endswith("_txns")}


@pytest.fixture
def torch_threads():
    """``specs_run`` off the card sets one torch thread; put it back."""
    n = torch.get_num_threads()
    yield
    torch.set_num_threads(n)


def mako_batches(seed: int, n_batches: int = 24, batch: int = 32,
                 rows: int = 16_384) -> list:
    """mako's 90/10 transactions (9 point reads, 1 point write over the
    smoke's 16,384 rows), each reading at the commit version two batches
    back, so that it races the writes of the two batches before it."""
    rng = np.random.default_rng(seed)

    def key(i) -> bytes:
        return b"mako%08d" % int(i)

    out = []
    for b in range(n_batches):
        version = 10 * (b + 1)
        out.append(([TxnConflictInfo(
            read_version=max(0, version - 20),
            read_ranges=[single_key_range(key(i))
                         for i in rng.integers(0, rows, 9)],
            write_ranges=[single_key_range(key(rng.integers(0, rows)))])
            for _ in range(batch)], version))
    return out


def test_engine_widens_mako_reads_as_the_range_oracle():
    probe = smoke.SpecProbe(on_card=False)
    probe.cur = {"widened": 0}
    engines = {
        "engine": TorchConflictSet(capacity=1 << 14, batch_size=256,
                                   device="cpu"),
        "widened": smoke.engine_range_oracle(probe, widen=True)(),
        "exact": OracleConflictSet()}
    got = {name: [] for name in engines}
    for txns, version in mako_batches(3):
        for name, cs in engines.items():
            got[name] += [Verdict(v) for v in cs.resolve(txns, version)]
    assert got["engine"] == got["widened"]
    assert probe.cur["widened"] == len(got["engine"])
    only_widened = [i for i, (w, x) in enumerate(zip(got["widened"],
                                                     got["exact"]))
                    if w == Verdict.CONFLICT and x == Verdict.COMMITTED]
    assert len(only_widened) > got["exact"].count(Verdict.CONFLICT), (
        "the engine's widening rejects more mako transactions than the "
        "exact oracle does in all")


def test_spec_b_at_full_counts_gives_up_on_widened_reads(monkeypatch,
                                                         torch_threads):
    gave_up = []
    run_txn = workloads.Workload._run_txn

    async def noted(self, db, fn, max_retries=100):
        try:
            return await run_txn(self, db, fn, max_retries)
        except FdbError as e:
            gave_up.append((self.name, e.code))
            raise

    monkeypatch.setattr(workloads.Workload, "_run_txn", noted)
    widened = smoke.specs_run("b", "oracle", 0, sizes=FULL_COUNTS)
    (rec,) = widened["records"]
    assert not rec["ok"]
    assert gave_up == [("mako", 1021)]
    assert widened["tests"][0]["widened_txns"] > 0

    exact = smoke.specs_run("b", "oracle-exact", 0, sizes=FULL_COUNTS)
    (rec,) = exact["records"]
    assert gave_up == [("mako", 1021)]
    assert rec["ok"], rec
    want = {"mako": FULL_COUNTS["mako_txns"], "ycsb": FULL_COUNTS["ycsb_txns"],
            "tpcc_new_order": FULL_COUNTS["tpcc_txns"],
            "cycle": FULL_COUNTS["cycle_txns"]}
    for name, (committed, _, failed, _, _) in rec["metrics"].items():
        assert failed == 0 and committed >= want[name], (name, committed)
