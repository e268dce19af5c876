"""Wave commit in the port vs the JAX package and the oracle, on the CPU.

K5's plain version (``wave_pred_matrix``) must equal JAX
``wave_pred_matrix`` bit for bit; K6's plain leveling must equal JAX
``_wave_level_packed`` / ``wave_level_from_graph`` and the host replay
``wavemesh.level_wave_graph`` on cyclic and acyclic graphs; the wave
engine (``TorchConflictSet(wave_commit=True)``) must equal
``TPUConflictSet(resident=True, wave_commit=True)`` and the oracle in
verdicts, levels, reordered counts and reports on the object, wire and
window paths; and the two-phase protocol must give the JAX engine's
``WaveEdges`` payloads byte for byte, and its schedules.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.core import wavemesh as jwm
from foundationdb_tpu.models import conflict_kernel as jck
from foundationdb_tpu.models.conflict_set import TPUConflictSet
from foundationdb_tpu.models.conflict_set import encode_resolve_batch as jenc
from foundationdb_tpu.sim.oracle import OracleConflictSet, ReplayCheckedOracle
from foundationdb_tpu_torch import TorchConflictSet, bench, convert
from foundationdb_tpu_torch.core import wavemesh as twm
from foundationdb_tpu_torch.loadgen import ycsb
from foundationdb_tpu_torch.models import conflict_kernel as tck
from foundationdb_tpu_torch.models.conflict_set import (
    encode_resolve_batch as tenc,
)
from tests.test_conflict_oracle import rand_txn
from tests.test_conflict_wave import _txn, chain, ring, rmw_clique
from tests.test_torch_conflict_kernel import T, t_ranks, t_res
from tests.test_torch_conflict_set import jax_snapshot, port_txn
from tests.test_torch_window import capture_window, same_state

# Small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the CPU.
torch.set_num_threads(1)

KW = dict(capacity=512, batch_size=16, max_read_ranges=4,
          max_write_ranges=4, max_key_bytes=8)


def u32(p: torch.Tensor) -> np.ndarray:
    return p.numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# K5: the predecessor matrix
# ---------------------------------------------------------------------------


def random_ranks(rng, b, r, q, space, live=0.85):
    rb = rng.integers(0, space, (b, r)).astype(np.int32)
    re_ = rb + rng.integers(0, 4, (b, r)).astype(np.int32)  # 0: dead slot
    wb = rng.integers(0, space, (b, q)).astype(np.int32)
    we = wb + rng.integers(0, 4, (b, q)).astype(np.int32)
    read_live = (rng.random((b, r)) < live) & (rb < re_)
    write_live = (rng.random((b, q)) < live) & (wb < we)
    return rb, re_, read_live, wb, we, write_live


@pytest.mark.parametrize("b,r,q,space", [(100, 2, 1, 40), (64, 3, 2, 30),
                                         (33, 2, 2, 10), (256, 4, 4, 60),
                                         (1, 1, 1, 4)])
def test_pred_matrix_equals_jax(b, r, q, space):
    rng = np.random.default_rng(b * 7 + r + q)
    ranks = random_ranks(rng, b, r, q, space)
    base = rng.random(b) < 0.7
    want = np.asarray(jax.jit(jck.wave_pred_matrix)(
        jnp.asarray(base), tuple(jnp.asarray(x) for x in ranks)))
    got = tck.wave_pred_matrix(torch.from_numpy(base),
                               tuple(torch.from_numpy(x) for x in ranks))
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert u32(got).tobytes() == want.tobytes()
    dense = np.unpackbits(want.view(np.uint8), bitorder="little").reshape(
        want.shape[0], -1)[:b, :b]
    assert not dense[:, ~base].any()  # candidate columns only
    if b > 1:
        assert dense[~base].any()  # non-candidate rows keep their bits


# ---------------------------------------------------------------------------
# K6: the leveling
# ---------------------------------------------------------------------------


def graph_clique(n):
    return {j: set(range(n)) - {j} for j in range(n)}


def graph_ring(n):
    return {j: {(j + 1) % n} for j in range(n)}


def graph_cycle_with_tail():
    """A 5-ring 10..14, upstream txns 0..3 that must precede it, and a
    downstream chain 20..25 behind it: only the ring's victim aborts."""
    pred = graph_ring(5)
    pred = {j + 10: {i + 10 for i in p} for j, p in pred.items()}
    for u in range(4):
        pred.setdefault(10 + u, set()).add(u)
    pred[20] = {12}
    for d in range(21, 26):
        pred[d] = {d - 1, 11}
    return pred


def graph_disjoint_cycles():
    pred = {}
    for c in range(6):
        base = 7 * c
        for k in range(c + 2):
            pred[base + k] = {base + (k + 1) % (c + 2)}
    return pred


def graph_random(n, density, seed):
    rng = np.random.default_rng(seed)
    m = rng.random((n, n)) < density
    np.fill_diagonal(m, False)
    return {j: set(np.nonzero(m[j])[0].tolist()) for j in range(n)}


GRAPHS = {
    "clique17": (17, graph_clique(17)),
    "ring31": (31, graph_ring(31)),
    "ring64": (64, graph_ring(64)),
    "cycle_with_tail": (26, graph_cycle_with_tail()),
    "disjoint_cycles": (42, graph_disjoint_cycles()),
    "random_dense": (90, graph_random(90, 0.3, 1)),
    "random_sparse": (128, graph_random(128, 0.02, 2)),
    "dag": (70, {j: {i for i in range(j + 1, 70) if (i * j) % 7 == 1}
                 for j in range(70)}),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_leveling_equals_jax_and_host_replay(name):
    n, pred = GRAPHS[name]
    rng = np.random.default_rng(len(name))
    cand = np.ones(n, bool)
    cand[rng.random(n) < 0.1] = False
    p = jwm.pack_pred_rows({j: s for j, s in pred.items() if s}, n)
    bp = p.shape[0]
    candp = np.pad(cand, (0, bp - n))
    pm = p & np.packbits(candp, bitorder="little").view(np.uint32)[None, :]
    want = np.asarray(jax.jit(jck._wave_level_packed)(jnp.asarray(candp),
                                                      jnp.asarray(pm)))
    stats = torch.zeros(5, dtype=torch.int64)
    got = tck._wave_level_packed_plain(torch.from_numpy(candp),
                                       torch.from_numpy(pm.view(np.int32)),
                                       stats)
    assert got.numpy().tolist() == want.tolist()
    cands = set(np.nonzero(candp)[0].tolist())
    dense = twm.unpack_pred_rows(pm, bp)
    assert twm.level_wave_graph(bp, cands, dense) == want.tolist()
    assert jwm.level_wave_graph(bp, cands, dense) == want.tolist()
    assert int(stats[0]) == 1
    assert int(stats[2]) == int((want == tck.LEVEL_CYCLE).sum())
    # The global-graph entry: columns of non-candidates carry bits, which
    # the JAX function re-masks and the port's leveling never reads.
    pt_ = torch.from_numpy(p.view(np.int32))
    ja, jl = jax.jit(jck.wave_level_from_graph)(jnp.asarray(cand),
                                                jnp.asarray(p))
    ta, tl = tck.wave_level_from_graph(torch.from_numpy(cand), pt_)
    assert tl.numpy().tolist() == np.asarray(jl).tolist()
    assert ta.numpy().tolist() == np.asarray(ja).tolist()
    acc, lv, verdicts = tck.wave_level(
        torch.from_numpy(cand), pt_, torch.zeros(n, dtype=torch.bool),
        torch.ones(n, dtype=torch.bool))
    assert verdicts.numpy().tolist() == np.where(
        np.asarray(ja), 0, 1).tolist()


def test_wavemesh_copy_equals_jax():
    rng = np.random.default_rng(3)
    n = 37
    pred = {j: {int(i) for i in rng.integers(0, n, 4) if int(i) != j}
            for j in range(n)}
    pred = {j: s for j, s in pred.items() if s}
    p = twm.pack_pred_rows(pred, n)
    assert p.tobytes() == jwm.pack_pred_rows(pred, n).tobytes()
    assert twm.unpack_pred_rows(p, n) == jwm.unpack_pred_rows(p, n) == pred
    assert twm.ceil32(n) == jwm.ceil32(n) == 64
    assert twm.level_wave_graph(n, set(range(n)), pred) == \
        jwm.level_wave_graph(n, set(range(n)), pred)
    txns = [rand_txn(rng, read_version=5) for _ in range(6)]
    for lo, hi in [(b"", b"\x0e"), (b"\x0e", b"\xff")]:
        a = twm.clip_txns([port_txn(t) for t in txns], lo, hi)
        b = jwm.clip_txns(txns, lo, hi)
        assert [[(r.begin, r.end) for r in t.read_ranges + t.write_ranges]
                for t in a] == [[(r.begin, r.end) for r in
                                 t.read_ranges + t.write_ranges] for t in b]
    shards = []
    for mod in (twm, jwm):
        shards.append([mod.WaveEdges(count=n, too_old=rng.random(n) < 0.1,
                                     hist_conflict=rng.random(n) < 0.1,
                                     chunks=[(n, p)])
                       for _ in range(2)])
    shards[1] = [jwm.WaveEdges.from_wire(s.to_wire()) for s in shards[0]]
    gt, gj = twm.combine_edges(shards[0]), jwm.combine_edges(shards[1])
    assert gt.to_wire() == gj.to_wire()
    assert twm.schedule_graph(gt) == jwm.schedule_graph(gj)
    sched = twm.schedule_graph(gt)[0]
    assert [int(v) for v in twm.verdicts_from_schedule(gt, sched)] == \
        [int(v) for v in jwm.verdicts_from_schedule(gj, sched)]
    assert twm.WaveGraph.from_wire(gt.to_wire()).to_wire() == gj.to_wire()


# ---------------------------------------------------------------------------
# The kernel module's wave entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 3])
def test_resolve_many_res_wave_equals_jax(k):
    state, batch, prep = capture_window(k)
    jv, jl, jres = jax.jit(functools.partial(jck.resolve_many_res,
                                             wave=True))(
        state, batch, prep.cvs_rel, prep.olds_rel)
    tb = tck.ResidentBatch(T(batch.delta_keys), t_ranks(batch.ranks))
    stats = torch.zeros(5, dtype=torch.int64)
    tv, tl, tres = tck.resolve_many_res(t_res(state), tb, prep.cvs_rel,
                                        prep.olds_rel, wave=True,
                                        stats=stats)
    assert tv.numpy().tobytes() == np.asarray(jv).tobytes()
    assert tl.numpy().tobytes() == np.asarray(jl).tobytes()
    assert tl.shape == (k, KW["batch_size"]) and tl.dtype == torch.int32
    same_state(tres, jres)
    assert int(stats[0]) == k
    # One batch of the window through resolve_batch_res, report included.
    one = jax.tree.map(lambda x: x[0], batch.ranks)
    jrb = jck.ResidentBatch(batch.delta_keys, one)
    want = jax.jit(functools.partial(jck.resolve_batch_res, report=True,
                                     wave=True))(
        state, jrb, prep.cvs_rel[0], prep.olds_rel[0])
    out = tck.window_out(1, KW["batch_size"], "cpu", True)
    got = tck.resolve_batch_res(
        t_res(state), tck.ResidentBatch(T(batch.delta_keys), t_ranks(one)),
        int(prep.cvs_rel[0]), int(prep.olds_rel[0]), report=True, wave=True,
        out=out)
    for g, w in zip(got[:3], want[:3]):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()
    same_state(got[3], want[3])
    v, lv = tck.read_out(out)
    assert v[0].tobytes() == np.asarray(want[0]).tobytes()
    assert lv[0].tobytes() == np.asarray(want[1]).tobytes()


# ---------------------------------------------------------------------------
# The engine: object, report, wire and window paths
# ---------------------------------------------------------------------------


class WaveTrio:
    """The JAX wave engine, the port's and the oracle, in lockstep."""

    def __init__(self, **kw):
        cfg = dict(KW, **kw)
        self.jax = TPUConflictSet(resident=True, wave_commit=True, **cfg)
        self.port = TorchConflictSet(device="cpu", wave_commit=True, **cfg)
        self.oracle = ReplayCheckedOracle(wave_commit=True)

    def resolve(self, txns, cv, oldest=0, what=""):
        want = [int(v) for v in self.jax.resolve(txns, cv, oldest)]
        got = [int(v) for v in self.port.resolve([port_txn(t) for t in txns],
                                                 cv, oldest)]
        assert got == want, f"{what}: port vs jax"
        assert self.port.last_wave == self.jax.last_wave, what
        assert self.port.last_reordered == self.jax.last_reordered, what
        assert ranges(self.port.last_conflicting) == ranges(
            self.jax.last_conflicting), what
        if len(txns) <= KW["batch_size"]:
            oracle = [int(v) for v in self.oracle.resolve(txns, cv, oldest)]
            assert got == oracle, f"{what}: port vs oracle"
            assert self.port.last_wave == self.oracle.last_wave, what
        same_state(self.port.state, self.jax.state, what)
        return got


def ranges(lc):
    return {i: [(r.begin, r.end) for r in v] for i, v in lc.items()}


def test_engine_random_stream_with_reports():
    rng = np.random.default_rng(17)
    trio = WaveTrio()
    cv = 1000
    for i in range(10):
        cv += int(rng.integers(1, 50))
        txns = [rand_txn(rng, read_version=int(rng.integers(cv - 300, cv)))
                for _ in range(int(rng.integers(1, 17)))]
        for t in txns[::2]:
            t.report_conflicting_keys = True
        trio.resolve(txns, cv, cv - 200, f"batch {i}")


@pytest.mark.parametrize("kind", ["chain", "clique", "ring", "downstream",
                                  "disjoint"])
def test_engine_adversarial_windows(kind):
    txns = {
        "chain": chain(16),
        "clique": rmw_clique(16),
        "ring": ring(13),
        "downstream": rmw_clique(2) + [_txn([5], [0], report=True),
                                       _txn([0], [9], report=True)],
        "disjoint": [t for c in range(6) for t in rmw_clique(2, key=c)]
        + [_txn([100 + i], [200 + i]) for i in range(4)],
    }[kind]
    trio = WaveTrio()
    got = trio.resolve(txns, 10, what=kind)
    committed = {"chain": 16, "clique": 1, "ring": 12, "downstream": 3,
                 "disjoint": 10}[kind]
    assert got.count(0) == committed


def test_engine_chunked_resolve_offsets():
    """Chunks serialize in order: the port's coherent last_wave and its
    reordered count (offsets excluded) equal the JAX engine's."""
    rng = np.random.default_rng(13)
    trio = WaveTrio()
    cv = 100
    for i in range(3):
        txns = [rand_txn(rng, read_version=cv - 1) for _ in range(40)]
        txns += chain(8, rv=cv - 1)
        trio.resolve(txns, cv, what=f"round {i}")
        cv += 10
    indep = [_txn([2 * i], [2 * i + 1], rv=cv - 1) for i in range(40)]
    trio.resolve(indep, cv)
    assert max(trio.port.last_wave) > 0 and trio.port.last_reordered == 0


def test_engine_wire_and_window_paths():
    trio = WaveTrio()
    rng = np.random.default_rng(29)
    cv = 100
    for n in (16, 40, 16):  # per-batch wire path; 40 txns take 3 chunks
        cv += 10
        txns = [rand_txn(rng, read_version=cv - 3) for _ in range(n)]
        want = trio.jax.resolve_wire_async(jenc(txns), cv, as_array=True)()
        got = trio.port.resolve_wire_async(
            tenc([port_txn(t) for t in txns]), cv, as_array=True)()
        assert np.array_equal(got, want)
        assert trio.port.last_wave == trio.jax.last_wave
        assert trio.port.last_reordered == trio.jax.last_reordered
    batches = [chain(16, rv=cv), rmw_clique(16, rv=cv),
               [_txn([300 + i], [400 + i], rv=cv) for i in range(16)]]
    cvs = [cv + 10, cv + 20, cv + 30]
    wire = b"".join(jenc(b) for b in batches)
    want = trio.jax.resolve_wire_window(wire, cvs, 16)
    got = trio.port.resolve_wire_window(
        b"".join(tenc([port_txn(t) for t in b]) for b in batches), cvs, 16)
    assert np.array_equal(got, want)
    assert trio.port.last_wave_window.dtype == np.int32
    assert np.array_equal(trio.port.last_wave_window,
                          trio.jax.last_wave_window)
    same_state(trio.port.state, trio.jax.state)
    oracle = OracleConflictSet(wave_commit=True)
    for i, (c, b) in enumerate(zip(cvs, batches)):
        assert [int(v) for v in got[i]] == [int(v) for v in
                                            oracle.resolve(b, c)]
        assert trio.port.last_wave_window[i].tolist() == oracle.last_wave
    assert trio.port.host_syncs == 5 + 1  # one read per chunk and window


def test_engine_from_snapshot_continues_a_jax_wave_stream():
    rng = np.random.default_rng(5)
    jcs = TPUConflictSet(resident=True, wave_commit=True, **KW)

    def batch(cv):
        return [rand_txn(rng, read_version=int(rng.integers(cv - 300, cv)))
                for _ in range(16)]

    cv = 1000
    for _ in range(4):
        cv += int(rng.integers(1, 50))
        jcs.resolve(batch(cv), cv, cv - 200)
    port = convert.engine_from_snapshot(jax_snapshot(jcs), device="cpu")
    assert port.wave_commit and convert.snapshot(port)["config"][
        "wave_commit"]
    for _ in range(4):
        cv += int(rng.integers(1, 50))
        txns = batch(cv) + rmw_clique(3, rv=cv - 1)
        want = [int(v) for v in jcs.resolve(txns, cv, cv - 200)]
        got = [int(v) for v in port.resolve([port_txn(t) for t in txns], cv,
                                            cv - 200)]
        assert got == want and port.last_wave == jcs.last_wave
    same_state(port.state, jcs.state)


def test_bench_wave_stream_equals_jax():
    """The port bench's wave run over a 4-window stream: verdicts and
    levels equal JAX resolve_wire_window's on a wave engine."""
    mode = ycsb.ModeConfig(2, 1, 0.5, 0.99, 64)
    n_batches, window, cap = 8, 2, 1 << 12
    blob, ends = bench.make_stream(mode, n_batches, 128, seed=7)
    rec, verdicts, levels, _ = bench.run_wire(
        blob, ends, mode, n_batches, cap, "cpu", window=window,
        pipeline_depth=2, repeats=1, warmup=False, wave=True)
    jcs = TPUConflictSet(
        resident=True, wave_commit=True, capacity=cap, batch_size=mode.batch,
        max_read_ranges=mode.n_reads, max_write_ranges=mode.n_writes,
        max_key_bytes=ycsb.KEY_BYTES, window_versions=ycsb.WINDOW)
    want_v, want_l = [], []
    for wi in range(n_batches // window):
        want_v.append(jcs.resolve_wire_window(
            *bench.window_wire(blob, ends, mode, window, wi), mode.batch))
        want_l.append(jcs.last_wave_window)
    assert np.array_equal(verdicts, np.stack(want_v))
    assert np.array_equal(levels, np.stack(want_l))
    assert rec["reordered"] == int((levels > 0).sum())
    assert rec["cycle_aborted"] == int((levels == -2).sum()) > 0
    assert rec["k6_victims_per_batch"] == rec["cycle_aborted"] / n_batches


# ---------------------------------------------------------------------------
# The two-phase global wave protocol
# ---------------------------------------------------------------------------


def two_phase(shards, bounds, txns, cv, oldest, mod):
    edges = [s.resolve_edges(mod.clip_txns(txns, lo, hi), cv, oldest)
             for s, (lo, hi) in zip(shards, bounds)]
    graph = mod.combine_edges(edges)
    return edges, graph, [s.resolve_apply(graph) for s in shards]


@pytest.mark.parametrize("bounds", [
    [(b"", b"\x14"), (b"\x14", b"\xff\xff")],
    [(b"", b"\x0e"), (b"\x0e", b"\x1c"), (b"\x1c", b"\xff\xff")],
], ids=["2shards", "3shards"])
def test_two_phase_equals_single_and_jax(bounds):
    rng = np.random.default_rng(len(bounds))
    single = TorchConflictSet(device="cpu", wave_commit=True, **KW)
    tsh = [TorchConflictSet(device="cpu", wave_commit=True, **KW)
           for _ in bounds]
    jsh = [TPUConflictSet(resident=True, wave_commit=True, **KW)
           for _ in bounds]
    cv = 1000
    for step in range(6):
        cv += int(rng.integers(2, 30))
        txns = [rand_txn(rng, read_version=int(rng.integers(cv - 150, cv)))
                for _ in range(int(rng.integers(2, 13)))]
        txns += rmw_clique(2, key=int(rng.integers(0, 20)), rv=cv - 1)
        oldest = cv - 120
        want = [int(v) for v in single.resolve([port_txn(t) for t in txns],
                                               cv, oldest)]
        te, tg, tv = two_phase(tsh, bounds, [port_txn(t) for t in txns], cv,
                               oldest, twm)
        je, jg, jv = two_phase(jsh, bounds, txns, cv, oldest, jwm)
        for a, b in zip(te, je):
            assert a.to_wire() == b.to_wire(), step
        assert tg.to_wire() == jg.to_wire(), step
        for s, j, got, jgot in zip(tsh, jsh, tv, jv):
            assert [int(v) for v in got] == want == [int(v) for v in jgot]
            assert s.last_wave == single.last_wave == j.last_wave, step
            assert s.last_reordered == single.last_reordered
            same_state(s.state, j.state, step)


def test_two_phase_errors_and_guards():
    cs = TorchConflictSet(device="cpu", wave_commit=True, **KW)
    g = twm.WaveGraph(count=0, too_old=np.zeros(0, bool),
                      cand=np.zeros(0, bool), chunks=[])
    with pytest.raises(ValueError, match="without a pending"):
        cs.resolve_apply(g)
    assert cs.resolve_edges([], 10).count == 0
    with pytest.raises(ValueError, match="apply outstanding"):
        cs.resolve_edges([], 11)
    cs.resolve_abandon()
    cs.resolve_edges([], 12)  # abandoned: a new window may open
    assert cs.resolve_apply(g) == []
    txns = [port_txn(rand_txn(np.random.default_rng(1), read_version=5))
            for _ in range(17)]
    with pytest.raises(ValueError, match="one schedule domain"):
        cs.resolve_edges(txns, 20)
    seq = TorchConflictSet(device="cpu", **KW)
    assert cs.wave_global_capable and not seq.wave_global_capable
    with pytest.raises(ValueError, match="wave-commit"):
        seq.resolve_edges([], 10)
    assert seq.wave_stats is None and seq.last_wave is None


@pytest.mark.parametrize("kw", [dict(resident=False),
                                dict(resident=False, dict_hot_capacity=32),
                                dict(resident=False, spec_resolve=True)],
                         ids=lambda kw: "+".join(kw))
def test_wave_with_unported_design_raises(kw):
    """A wave engine of the non-resident design (tiering inert, or
    speculative) equals the JAX one on the ring, chain and clique graphs
    of ``tests/test_conflict_wave.py`` and a random stream: verdicts,
    ``last_wave``, ``last_reordered`` and every history leaf."""
    cfg = dict(KW, wave_commit=True, **kw)
    port = TorchConflictSet(device="cpu", **cfg)
    jcs = TPUConflictSet(**cfg)
    assert not port.resident and not port.tiered
    rng = np.random.default_rng(len(kw))
    batches = [ring(5), chain(6), rmw_clique(4)] + [
        [rand_txn(rng, read_version=90 + 10 * i) for _ in range(12)]
        for i in range(3)]
    for i, txns in enumerate(batches):
        cv = 100 + 10 * i
        want = [int(v) for v in jcs.resolve(txns, cv)]
        got = [int(v) for v in port.resolve([port_txn(t) for t in txns], cv)]
        assert got == want, i
        assert port.last_wave == jcs.last_wave, i
        assert port.last_reordered == jcs.last_reordered, i
    for k, v in convert.state_leaves(jcs.state).items():
        assert convert.state_leaves(port.state)[k].numpy().tobytes() == \
            np.asarray(v).tobytes(), k


def stress_graph(kind: str):
    """(B, candidates, {j: predecessors}) of a graph that stresses K6's
    bookkeeping (the in-degrees, the ready list, the lazy witnesses and
    the reused walk prefix): predecessors are candidates only."""
    rng = np.random.default_rng(len(kind))
    if kind == "chain300":  # one wave per txn, B not a multiple of 32
        return 300, list(range(300)), {j: {j + 1} for j in range(299)}
    if kind == "nested_cycles":  # rings inside rings, tails into them
        pred = {j: {(j + 1) % 60} for j in range(60)}
        for a_, b_ in ((0, 20), (20, 40), (5, 15), (25, 35), (41, 59)):
            pred[b_].add(a_)
        pred.update({j: {j - 1, int(rng.integers(0, 60))}
                     for j in range(61, 97)})
        pred[60] = {7}
        return 97, list(range(97)), pred
    if kind == "overlapping_cycles":  # rings sharing txns, a chain after
        pred = {}
        for start, size in ((0, 9), (4, 11), (10, 7), (13, 23), (30, 5)):
            ring_ = list(range(start, start + size))
            for x, y in zip(ring_, ring_[1:] + ring_[:1]):
                pred.setdefault(y, set()).add(x)
        pred.update({j: {j - 1} for j in range(36, 130)})
        return 130, list(range(130)), pred
    if kind == "strongly_connected":  # one SCC over every candidate
        n = 200
        pred = {j: {(j + 1) % n} for j in range(n)}
        for _ in range(120):
            i, j = (int(x) for x in rng.integers(0, n, 2))
            if i != j:
                pred[j].add(i)
        return n, list(range(n)), pred
    # "padded_32768": a full-size padded batch, a few hundred candidates
    # spread over it: chains up to 30 waves long and small cycles with
    # tails, so that a row, its witness and its successors sit far apart.
    b = 32768
    cand = sorted(rng.choice(b, 320, replace=False).tolist())
    pred = {}
    for c0 in range(0, 240, 30):
        for x, y in zip(cand[c0:c0 + 30], cand[c0 + 1:c0 + 30]):
            pred.setdefault(x, set()).add(y)
    for c0 in range(240, 320, 10):
        ring_ = cand[c0:c0 + 4]
        for x, y in zip(ring_, ring_[1:] + ring_[:1]):
            pred.setdefault(y, set()).add(x)
        for x, y in zip(cand[c0 + 3:c0 + 10], cand[c0 + 4:c0 + 10]):
            pred.setdefault(y, set()).add(x)
    return b, cand, pred


@pytest.mark.parametrize("kind", ["chain300", "nested_cycles",
                                  "overlapping_cycles", "strongly_connected",
                                  "padded_32768"])
def test_plain_leveling_on_stress_graphs_equals_jax_and_host_replay(kind):
    """K6's plain twin against JAX ``wave_level_from_graph`` (the global
    matrix entry, B not a multiple of 32 included) and the host replay
    ``wavemesh.level_wave_graph``: levels, victims and the round count
    (waves plus victims); a cuda wave engine takes any batch size, so the
    port's leveling is held at a padded 32,768-txn batch too."""
    b, cands, pred = stress_graph(kind)
    cand = np.zeros(b, bool)
    cand[cands] = True
    p = jwm.pack_pred_rows({j: s for j, s in pred.items() if s}, b)
    bp = p.shape[0]
    ja, jl = jax.jit(jck.wave_level_from_graph)(jnp.asarray(cand),
                                                jnp.asarray(p))
    want = np.asarray(jl).tolist()
    stats = torch.zeros(5, dtype=torch.int64)
    acc, got, _ = tck.wave_level_plain(torch.from_numpy(cand),
                                       torch.from_numpy(p.view(np.int32)),
                                       stats=stats)
    assert got.numpy().tolist() == want
    assert acc.numpy().tolist() == np.asarray(ja).tolist()
    replay = twm.level_wave_graph(bp, set(cands), pred)[:b]
    assert replay == want
    victims = want.count(tck.LEVEL_CYCLE)
    waves = max(want) + 1
    assert stats.tolist() == [1, waves + victims, victims, waves + victims,
                              victims]
    if kind == "chain300":
        assert waves == 300 and victims == 0
    else:
        assert victims > 0


@pytest.mark.parametrize("name", sorted(GRAPHS) + [
    "chain300", "nested_cycles", "overlapping_cycles", "strongly_connected",
    "padded_32768"])
def test_edge_list_replay_equals_level_wave_graph(name):
    """``wavemesh.level_wave_edges`` (the host replay the smoke runs on
    32,768-txn batches) against ``level_wave_graph`` of the port and of
    the JAX package, on the same graphs: edges touching a non-candidate
    and repeated edges are ignored."""
    if name in GRAPHS:
        n, pred = GRAPHS[name]
        rng = np.random.default_rng(len(name))
        cands = [j for j in range(n) if rng.random() >= 0.1]
    else:
        n, cands, pred = stress_graph(name)
    rows = [j for j, s in pred.items() for _ in s]
    cols = [i for s in pred.values() for i in s]
    noise = np.random.default_rng(5).integers(0, n, (2, 40))
    rows += rows[:7] + noise[0].tolist()  # repeats, and edges that the
    cols += cols[:7] + noise[1].tolist()  # candidate filter must drop
    cset = set(cands)
    keep = [(r, c) for r, c in zip(noise[0], noise[1])
            if r in cset and c in cset and r != c]
    full = {j: set(s) & cset for j, s in pred.items()}
    for r, c in keep:
        full.setdefault(int(r), set()).add(int(c))
    want = twm.level_wave_graph(n, cset, full)
    assert jwm.level_wave_graph(n, cset, full) == want
    rows_k = [r for r, c in zip(rows, cols) if r != c]
    cols_k = [c for r, c in zip(rows, cols) if r != c]
    assert twm.level_wave_edges(n, cands, rows_k, cols_k) == want
