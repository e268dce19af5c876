"""The port's CPU SkipList engine, oracle and bench baseline arm against the
JAX package's, on the CPU.

``foundationdb_tpu_torch.models.cpu_conflict_set.CPUSkipListConflictSet``
(its own build of ``native/skiplist.cpp``) against the JAX package's
engine and oracle on ``tests/test_cpu_conflict_set.py``'s cases;
``foundationdb_tpu_torch.sim.oracle`` (``OracleConflictSet``,
``ReplayCheckedOracle``, ``replay_wave_schedule``) against the JAX
oracle, sequentially, in wave mode and through the two-phase protocol;
the bench's ``marshal_cpu_batches`` against the repository's ``bench.py``
byte for byte; and the skiplist's verdicts on a YCSB-A wire stream
against ``TorchConflictSet(device="cpu")``'s window path.
"""

import hashlib

import numpy as np
import pytest

import bench as root_bench
from foundationdb_tpu.core import wavemesh as jwm
from foundationdb_tpu.core.types import KeyRange, TxnConflictInfo
from foundationdb_tpu.models.cpu_conflict_set import (
    CPUSkipListConflictSet as JaxSkipList,
)
from foundationdb_tpu.sim import oracle as joracle
from foundationdb_tpu_torch import bench, native
from foundationdb_tpu_torch.core import types as tt
from foundationdb_tpu_torch.core import wavemesh as twm
from foundationdb_tpu_torch.loadgen.ycsb import MODES, gen_workload
from foundationdb_tpu_torch.models.cpu_conflict_set import (
    CPUSkipListConflictSet,
)
from foundationdb_tpu_torch.sim import oracle as toracle
from tests.test_conflict_oracle import rand_txn
from tests.test_conflict_wave import rmw_clique
from tests.test_torch_conflict_set import port_txn
from tests.test_torch_wave import two_phase


def ints(verdicts):
    return [int(v) for v in verdicts]


# ------------------------------------------------------------ the skiplist


def test_skiplist_library_is_the_ports_own_build():
    lib = native.skiplist()
    assert lib._name == str(native.library_path("skiplist"))
    assert "foundationdb_tpu_torch" in lib._name
    assert "-march=native" in native._flags("skiplist")


@pytest.mark.parametrize("seed", [11, 12, 13, 14])
def test_skiplist_matches_jax_and_oracles(seed):
    """``test_cpu_conflict_set.py::test_matches_oracle``'s stream through
    the port's and the JAX skiplist and both oracles."""
    rng = np.random.default_rng(seed)
    port, jax_cs = CPUSkipListConflictSet(), JaxSkipList()
    toc, joc = toracle.OracleConflictSet(), joracle.OracleConflictSet()
    cv = 1000
    for batch_i in range(15):
        cv += int(rng.integers(1, 50))
        txns = [
            rand_txn(rng, read_version=int(rng.integers(max(0, cv - 300), cv)))
            for _ in range(int(rng.integers(1, 50)))
        ]
        oldest = cv - 200
        got = port.resolve([port_txn(t) for t in txns], cv, oldest)
        want = jax_cs.resolve(txns, cv, oldest_version=oldest)
        toc.oldest_version = max(toc.oldest_version, oldest)
        joc.oldest_version = max(joc.oldest_version, oldest)
        assert ints(got) == ints(want), batch_i
        assert ints(got) == ints(toc.resolve([port_txn(t) for t in txns], cv))
        assert ints(got) == ints(joc.resolve(txns, cv)), batch_i
        assert all(isinstance(v, tt.Verdict) for v in got)
        assert port.node_count == jax_cs.node_count, batch_i


def test_skiplist_basic_sweep_and_version_guard():
    """The sweep bounds the nodes as in the JAX engine, and a commit
    version that does not advance is refused."""
    pt = lambda k: tt.KeyRange(k, k + b"\x00")  # noqa: E731
    jpt = lambda k: KeyRange(k, k + b"\x00")  # noqa: E731
    port, jax_cs = CPUSkipListConflictSet(), JaxSkipList()
    t, jt = tt.TxnConflictInfo, TxnConflictInfo
    assert port.resolve([t(5, [], [pt(b"a")])], 10) == [tt.Verdict.COMMITTED]
    got = port.resolve([t(5, [pt(b"a")], []), t(15, [pt(b"a")], [])], 20)
    assert got == [tt.Verdict.CONFLICT, tt.Verdict.COMMITTED]
    jax_cs.resolve([jt(5, [], [jpt(b"a")])], 10)
    jax_cs.resolve([jt(5, [jpt(b"a")], []), jt(15, [jpt(b"a")], [])], 20)
    cv = 100
    for i in range(200):
        cv += 10
        for cs, tx, p in ((port, t, pt), (jax_cs, jt, jpt)):
            cs.resolve([tx(cv - 1, [], [p(b"k%05d" % (i * 4 + j))])
                        for j in range(4)], cv, oldest_version=cv - 100)
        assert port.node_count == jax_cs.node_count
    assert port.node_count < 400, port.node_count
    with pytest.raises(ValueError, match="advance"):
        port.resolve([], cv)


def test_skiplist_range_paint_and_restore():
    """A wide paint, a narrow interior repaint, and reads on both sides
    of it: the port's verdicts equal the JAX engine's and the oracle's."""
    t, jt = tt.TxnConflictInfo, TxnConflictInfo
    k, jk = tt.KeyRange, KeyRange
    port, jax_cs = CPUSkipListConflictSet(), JaxSkipList()
    oracle = toracle.OracleConflictSet()
    for cs, tx, r in ((port, t, k), (jax_cs, jt, jk)):
        cs.resolve([tx(5, [], [r(b"b", b"y")])], 10)
        cs.resolve([tx(15, [], [r(b"g", b"h")])], 20)
    oracle.resolve([t(5, [], [k(b"b", b"y")])], 10)
    oracle.resolve([t(15, [], [k(b"g", b"h")])], 20)
    reads = [(15, b"g", b"g\x00"), (15, b"c", b"d"), (15, b"h", b"i"),
             (5, b"c", b"d")]
    got = port.resolve([t(rv, [k(a, b)], []) for rv, a, b in reads], 30)
    want = jax_cs.resolve([jt(rv, [jk(a, b)], []) for rv, a, b in reads], 30)
    assert ints(got) == ints(want) == [1, 0, 0, 1]
    assert ints(oracle.resolve([t(rv, [k(a, b)], []) for rv, a, b in reads],
                               30)) == ints(got)


# ------------------------------------------------------------ the oracle


@pytest.mark.parametrize("wave", [False, True])
@pytest.mark.parametrize("cls", ["OracleConflictSet", "ReplayCheckedOracle"])
def test_oracle_equals_jax(cls, wave):
    """Verdicts, conflicting ranges, levels and the reorder count of the
    port's oracle equal the JAX oracle's, batch by batch, with stale
    reads, reports and read-modify-write cliques (cycles in wave mode)."""
    rng = np.random.default_rng(7 + wave)
    port = getattr(toracle, cls)(wave_commit=wave)
    jax_o = getattr(joracle, cls)(wave_commit=wave)
    assert port.wave_global_capable == jax_o.wave_global_capable == wave
    cv = 1000
    for step in range(10):
        cv += int(rng.integers(2, 40))
        txns = [rand_txn(rng, read_version=int(rng.integers(cv - 250, cv)))
                for _ in range(int(rng.integers(2, 30)))]
        txns += rmw_clique(3, key=int(rng.integers(0, 20)), rv=cv - 1)
        for t in txns[::3]:
            t.report_conflicting_keys = True
        oldest = cv - 200
        got = port.resolve([port_txn(t) for t in txns], cv, oldest)
        want = jax_o.resolve(txns, cv, oldest)
        assert ints(got) == ints(want), step
        assert port.last_wave == jax_o.last_wave, step
        assert port.last_reordered == jax_o.last_reordered, step
        assert {i: [(r.begin, r.end) for r in v]
                for i, v in port.last_conflicting.items()} == {
            i: [(r.begin, r.end) for r in v]
            for i, v in jax_o.last_conflicting.items()}, step
        assert [(w.begin, w.end, v) for w, v in port.history] == [
            (w.begin, w.end, v) for w, v in jax_o.history], step


@pytest.mark.parametrize("cls", ["OracleConflictSet", "ReplayCheckedOracle"])
def test_oracle_two_phase_equals_jax(cls):
    """``resolve_edges`` / ``combine_edges`` / ``resolve_apply`` over two
    and three keyspace shards: the edges and graph on the wire, verdicts
    and levels equal the JAX oracle's and the single wave oracle's."""
    rng = np.random.default_rng(3)
    for bounds in ([(b"", b"\x14"), (b"\x14", b"\xff\xff")],
                   [(b"", b"\x0e"), (b"\x0e", b"\x1c"),
                    (b"\x1c", b"\xff\xff")]):
        single = getattr(toracle, cls)(wave_commit=True)
        tsh = [getattr(toracle, cls)(wave_commit=True) for _ in bounds]
        jsh = [getattr(joracle, cls)(wave_commit=True) for _ in bounds]
        cv = 1000
        for step in range(6):
            cv += int(rng.integers(2, 30))
            txns = [rand_txn(rng, read_version=int(rng.integers(cv - 150,
                                                                cv)))
                    for _ in range(int(rng.integers(2, 13)))]
            txns += rmw_clique(2, key=int(rng.integers(0, 20)), rv=cv - 1)
            oldest = cv - 120
            ptx = [port_txn(t) for t in txns]
            want = ints(single.resolve(ptx, cv, oldest))
            te, tg, tv = two_phase(tsh, bounds, ptx, cv, oldest, twm)
            je, jg, jv = two_phase(jsh, bounds, txns, cv, oldest, jwm)
            for a, b in zip(te, je):
                assert a.to_wire() == b.to_wire(), step
            assert tg.to_wire() == jg.to_wire(), step
            for s, j, got, jgot in zip(tsh, jsh, tv, jv):
                assert ints(got) == want == ints(jgot), step
                assert s.last_wave == single.last_wave == j.last_wave, step
    with pytest.raises(ValueError, match="wave-commit"):
        toracle.OracleConflictSet().resolve_edges([], 1)
    with pytest.raises(ValueError, match="without a pending"):
        toracle.OracleConflictSet(wave_commit=True).resolve_apply(None)


def test_replay_wave_schedule_refuses_a_wrong_schedule():
    """The port's ``replay_wave_schedule`` accepts the oracle's schedule
    and, as the JAX one does, raises on a committed txn ordered after a
    write it read."""
    rv = 99
    txns = rmw_clique(2, key=3, rv=rv)
    ptx = [port_txn(t) for t in txns]
    o = toracle.OracleConflictSet(wave_commit=True)
    verdicts = o.resolve(ptx, 100)
    toracle.replay_wave_schedule(ptx, verdicts, o.last_wave, [], 0)
    joracle.replay_wave_schedule(txns, verdicts, o.last_wave, [], 0)
    # Both committed at one level: each read the other's write.
    bad = [tt.Verdict.COMMITTED] * 2
    for mod, tx in ((toracle, ptx), (joracle, txns)):
        with pytest.raises(AssertionError):
            mod.replay_wave_schedule(tx, bad, [0, 0], [], 0)


# ------------------------------------------------------------ the bench


def test_marshal_cpu_batches_equals_root_bench():
    mode = MODES["ycsb"]
    stream = gen_workload(3 * mode.batch, 4096, 5, mode)
    got = bench.marshal_cpu_batches(3, *stream, mode)
    want = root_bench.marshal_cpu_batches(3, *stream, root_bench.MODES["ycsb"])
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g[0] == w[0]  # the blob
        for a, b in zip(g[1:5], w[1:5]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        assert g[5:] == w[5:]
    assert bench.CPU_BASELINE_PIN == root_bench.CPU_BASELINE_PIN


def test_skiplist_verdicts_equal_the_window_path():
    """A YCSB-A wire stream (8 batches of 8192 over 4096 keys, window 2)
    through ``TorchConflictSet(device="cpu")``'s window path and the
    marshalled stream through the skiplist (``run_cpu``): the same
    verdicts txn for txn, and the bench record's baseline fields."""
    mode = MODES["ycsb"]
    n = 8
    stream = gen_workload(n * mode.batch, 4096, 20260729, mode)
    blob, ends = bench.build_wire_stream(*stream, n, mode)
    rec, verdicts, _, _ = bench.run_wire(blob, ends, mode, n, 1 << 16, "cpu",
                                         window=2, repeats=1, warmup=False)
    dt, conf, lat, cpu_v = bench.run_cpu(
        bench.marshal_cpu_batches(n, *stream, mode), mode)
    assert cpu_v.shape == (n, mode.batch) and cpu_v.dtype == np.int8
    assert np.array_equal(cpu_v, verdicts.reshape(n, mode.batch))
    assert conf == rec["conflict"] > 0 and len(lat) == n
    cpu = bench.cpu_record(n * mode.batch, dt, conf, lat, cpu_v)
    assert cpu["verdicts_sha256"] == rec["verdicts_sha256"] == hashlib.sha256(
        verdicts.tobytes()).hexdigest()
    fields = bench.baseline_fields(rec, cpu)
    assert fields["verdict_parity"] is True
    assert fields["vs_baseline"] == rec["txns_per_s"] / cpu["txns_per_sec"]
    assert fields["cpu_p99_ms"] == cpu["p99_ms"] >= cpu["p50_ms"] > 0
    assert set(fields) >= {"cpu_baseline_txns_per_sec", "cpu_p50_ms",
                           "cpu_p99_ms", "vs_baseline", "p99_vs_cpu",
                           "verdict_parity", "machine_state"}


def test_pinned_cpu_baseline_record():
    """The pinned configuration's record: 32 batches of 8192 YCSB-A txns
    over 2^16 keys, its verdict hash that of the skiplist run of the same
    stream, the machine state beside it."""
    rec = bench.run_pinned_cpu_baseline()
    assert rec["config"] == bench.CPU_BASELINE_PIN
    assert rec["latency_samples"] == 32 and rec["txns_per_sec"] > 0
    mode, n_batches, stream = bench.pinned_stream()
    _, conf, _, v = bench.run_cpu(
        bench.marshal_cpu_batches(n_batches, *stream, mode), mode)
    assert rec["conflicts"] == conf
    assert rec["verdicts_sha256"] == hashlib.sha256(v.tobytes()).hexdigest()
    assert set(rec["machine_state"]) == {"cpu_count", "loadavg_1m"}
