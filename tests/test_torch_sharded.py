"""The port's sharded engine vs the JAX ShardedConflictSet, on the CPU.

The JAX engine runs on conftest's 8-device CPU mesh; the port keeps its S
shards as the leading axis of one state (``device="cpu"``: the plain
versions). Exact tolerance throughout: verdicts, ``last_wave``, every
state leaf after every batch (the [S, C, 1] keys, versions, n_used,
oldest, overflow, shard bounds, dictionary and key count), the mirror's
arrays and ``dict_stats``, ``reshard_moved_shards``, ``auto_reshards``,
``shard_occupancy`` and ``exchange_stats``; and against
``sim/oracle.OracleConflictSet``. The plain versions of K8 (the flat
probe with the cross-shard OR, at B % 32 == 0 and != 0), K9
(``clip_ranks``) and K10 (the matrix OR, ``wave_occupied_tiles``) are
held against their JAX functions on seeded inputs. Streams, seeds and
shapes are those of ``tests/test_sharded_resolver.py``,
``test_resident.py::TestResidentMesh``, ``test_wave_mesh.py::TestMeshWave``
and the tiered mesh run of ``test_tiered_dict.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.core.types import KeyRange, TxnConflictInfo
from foundationdb_tpu.models import conflict_kernel as jck
from foundationdb_tpu.models.conflict_set import encode_resolve_batch as jenc
from foundationdb_tpu.ops.bitset import pack_bits_u32 as jpack
from foundationdb_tpu.parallel import sharded_resolver as jsr
from foundationdb_tpu.sim.oracle import OracleConflictSet
from foundationdb_tpu_torch import TorchConflictSet, convert
from foundationdb_tpu_torch.models import conflict_kernel as tck
from foundationdb_tpu_torch.models.conflict_set import (
    encode_resolve_batch as tenc,
)
from foundationdb_tpu_torch.parallel import sharded_resolver as tsr
from tests.test_conflict_oracle import rand_txn
from tests.test_torch_conflict_kernel import T, same
from tests.test_torch_conflict_set import JAX_CONFIG, port_txn
from tests.test_torch_window import same_state

# Small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the CPU.
torch.set_num_threads(1)

MIRROR = ("u64", "rows", "pinned", "id_at", "rank_of_id", "hot_by_id",
          "last_used_by_id")
KW = dict(capacity=256, batch_size=32, max_read_ranges=4, max_write_ranges=4,
          max_key_bytes=8)


def pt(k: bytes) -> KeyRange:
    return KeyRange(k, k + b"\x00")


def same_engine(port, jax, what=""):
    """Every state leaf, the mirror's arrays, dict_stats and the sharded
    engine's host counters."""
    same_state(port.state, jax.state, what)
    for f in MIRROR:
        a, b = getattr(port._mirror, f), getattr(jax._mirror, f)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        assert a.tobytes() == b.tobytes(), (what, f)
    assert port.dict_stats == jax.dict_stats, what
    assert port.reshard_moved_shards == jax.reshard_moved_shards, what
    assert port.auto_reshards == jax.auto_reshards, what
    assert port._interior_splits == jax._interior_splits, what
    assert port.shard_occupancy() == jax.shard_occupancy(), what


class Pair:
    """A JAX and a port sharded engine of one configuration (and the
    oracle), in lockstep."""

    def __init__(self, n_shards, oracle=True, **kw):
        self.jax = jsr.ShardedConflictSet(n_shards=n_shards, **kw)
        self.port = tsr.ShardedConflictSet(n_shards=n_shards, device="cpu",
                                           **kw)
        self.oracle = (OracleConflictSet(wave_commit=self.port.wave_commit)
                       if oracle else None)

    def resolve(self, txns, cv, oldest=None, what=""):
        want = [int(v) for v in self.jax.resolve(txns, cv, oldest)]
        got = [int(v) for v in self.port.resolve([port_txn(t) for t in txns],
                                                 cv, oldest)]
        assert got == want, f"{what}: port vs jax"
        if self.oracle is not None:
            if oldest is not None:
                self.oracle.oldest_version = max(self.oracle.oldest_version,
                                                 oldest)
            assert got == [int(v) for v in self.oracle.resolve(txns, cv)], \
                f"{what}: port vs oracle"
        if self.port.wave_commit:
            assert self.port.last_wave == self.jax.last_wave, what
            assert self.port.last_reordered == self.jax.last_reordered, what
        assert self.port.last_conflicting == self.jax.last_conflicting == {}
        same_engine(self.port, self.jax, what)
        return got


# ------------------------------------------------------------ plain kernels


@pytest.fixture(scope="module")
def jax_mesh():
    """A mid-stream JAX 4-shard state (histories populated in every shard)
    and the packed rank batch of its next dispatch."""
    rng = np.random.default_rng(7)
    cs = jsr.ShardedConflictSet(n_shards=4, auto_reshard=False, **KW)
    cv = 1000
    for _ in range(6):
        cv += 10
        cs.resolve([rand_txn(rng, read_version=cv - 30, alphabet=256,
                             max_len=4) for _ in range(28)], cv, cv - 100)
    txns = [rand_txn(rng, read_version=cv - 25, alphabet=256, max_len=4)
            for _ in range(30)]
    cs._begin_resolve(cv + 10, cv - 90)
    rb = cs._dev_batch(cs._pack(txns))
    return cs.state, rb.ranks


def rank_batch(rng, b, r, q, space):
    """A random RankBatch (numpy leaves), ranks in [0, space), +inf pads."""
    def ranks(n):
        lo = rng.integers(0, space, (b, n)).astype(np.int32)
        hi = lo + rng.integers(0, 6, (b, n)).astype(np.int32)
        m = rng.random((b, n)) < 0.8
        return (np.where(m, lo, jck.INT32_MAX).astype(np.int32),
                np.where(m, hi, jck.INT32_MAX).astype(np.int32), m)

    rb, re_, rm = ranks(r)
    wb, we, wm = ranks(q)
    paint = np.argsort(np.concatenate([wb.reshape(-1), we.reshape(-1)]))
    return jck.RankBatch(
        read_begin=rb, read_end=re_, read_mask=rm, write_begin=wb,
        write_end=we, write_mask=wm,
        read_version=rng.integers(0, 40, b).astype(np.int32),
        txn_mask=rng.random(b) < 0.9, paint_src=paint.astype(np.int32))


@pytest.mark.parametrize("b", [32, 30])
def test_clip_ranks_equal_jax(b):
    rng = np.random.default_rng(b)
    jrb = rank_batch(rng, b, 3, 2, 60)
    lo = np.array([0, 13, 13, 40], np.int32)  # an empty shard at [13, 13)
    hi = np.array([13, 13, 40, jck.INT32_MAX], np.int32)
    trb = tck.RankBatch(*(T(x) for x in jrb))
    clip = tck.shard_clip_plain(trb, T(lo), T(hi), reads=True)
    assert tck.shard_clip_plain(trb, T(lo), T(hi), reads=False).read_begin \
        is None
    for s in range(4):
        want = jck.clip_ranks(jrb, jnp.int32(lo[s]), jnp.int32(hi[s]))
        got = tck.clip_ranks(trb, T(lo[s]), T(hi[s]))
        view = tck.shard_ranks(trb, clip, s)
        for f in ("read_begin", "read_end", "read_mask", "write_begin",
                  "write_end", "write_mask"):
            same(getattr(got, f), getattr(want, f), f"{s}.{f}")
            same(getattr(view, f), getattr(want, f), f"clip {s}.{f}")


@pytest.mark.parametrize("reads", [False, True])
def test_window_clip_equals_jax_every_step(reads):
    """K9 as the window program runs it (``tck.WindowClip``: one set of
    buffers and one check a window, each step clipped into them) equals
    JAX ``clip_ranks`` of every shard at every step on the CPU, and
    ``kernels.shard_clip_out`` carves K9's six outputs, of the plain
    version's shapes and dtypes, from one allocation, the int32 ones
    first."""
    from foundationdb_tpu_torch import kernels as K

    rng = np.random.default_rng(7 + reads)
    steps = [rank_batch(rng, 30, 3, 2, 60) for _ in range(3)]
    lo = np.array([0, 13, 13, 40], np.int32)
    hi = np.array([13, 13, 40, jck.INT32_MAX], np.int32)
    window = tck.RankBatch(*(T(np.stack(x)) for x in zip(*steps)))
    wclip = tck.WindowClip.of(window, T(lo), T(hi), reads)
    for i, jrb in enumerate(steps):
        clip = wclip.step(tck._step(window, i))
        assert (clip.read_begin is None) == (not reads)
        for s in range(4):
            want = jck.clip_ranks(jrb, jnp.int32(lo[s]), jnp.int32(hi[s]))
            view = tck.shard_ranks(tck._step(window, i), clip, s)
            for f in (("read_begin", "read_end", "read_mask") * reads
                      + ("write_begin", "write_end", "write_mask")):
                same(getattr(view, f), getattr(want, f), f"{i}.{s}.{f}")
    out = K.shard_clip_out(4, 30, 3, 2, reads, "cpu")
    want = tck.shard_clip_plain(tck._step(window, 1), T(lo), T(hi), reads)
    for o, w in zip(out, want):
        assert (o is None) == (w is None)
        assert w is None or (o.shape == w.shape and o.dtype == w.dtype)
    base = out[0].data_ptr()
    spans = sorted((t.data_ptr() - base, t.numel() * t.element_size())
                   for t in out if t is not None)
    assert all(a + n <= b for (a, n), (b, _) in zip(spans, spans[1:]))
    assert [t.dtype for t in out if t is not None] == \
        [torch.int32, torch.int32, torch.bool] * (2 if reads else 1)
    assert all((t.data_ptr() - base) % 16 == 0 for t in out
               if t is not None and t.dtype == torch.int32)


@pytest.mark.parametrize("b", [32, 30])
def test_flat_probe_and_or_equal_jax(jax_mesh, b):
    """K8's plain version vs the JAX per-shard probe + the mesh's OR: the
    packed all_gather at B % 32 == 0, the psum otherwise."""
    jres, jrb = jax_mesh
    jrb = jck.RankBatch(*(np.asarray(x)[:b] for x in jrb[:-1]),
                        paint_src=np.asarray(jrb.paint_src))
    hist = jres.hist
    lo, hi = np.asarray(jres.shard_lo), np.asarray(jres.shard_hi)
    new_oldest = jnp.int32(300)
    per, floors = [], []
    for s in range(4):
        hs = jck.ConflictState(*(np.asarray(x)[s] for x in hist))
        floor, too_old = jck.too_old_mask_packed(hs, jrb, new_oldest)
        local = jck.clip_ranks(jrb, jnp.int32(lo[s]), jnp.int32(hi[s]))
        per.append(np.asarray(jck._history_conflicts_res(hs, local)))
        floors.append((int(floor), np.asarray(too_old)))
    hit = np.stack(per)
    if b % 32 == 0:
        want_h = np.asarray(jck.unpack_bits_u32(
            jnp.stack([jpack(jnp.asarray(x)) for x in hit]), b)).any(0)
    else:
        want_h = hit.astype(np.int32).sum(0) > 0
    too_old = floors[0][1]
    want_c = np.asarray(jrb.txn_mask) & ~too_old & ~want_h
    th = tck.ConflictState(*(T(x) for x in hist))
    trb = tck.RankBatch(*(T(x) for x in jrb))
    got = tck.shard_probe_plain(th, trb, T(lo), T(hi),
                                T(np.int32(floors[0][0])))
    for g, w, name in zip(got, (too_old, want_h, want_c),
                          ("too_old", "hist_conflict", "cand")):
        same(g, w, name)
    assert want_h.any() and not want_h.all()


def test_wave_exchange_and_occupied_tiles_equal_jax():
    rng = np.random.default_rng(11)
    s, bp = 3, 96
    ps = np.zeros((s, bp, bp // 32), np.uint32)
    for i in range(s):  # sparse rows: some tiles empty in every shard
        rows = rng.choice(bp, 10, replace=False)
        ps[i, rows] = rng.integers(0, 2**32, (10, bp // 32), dtype=np.uint64
                                   ).astype(np.uint32)
        ps[i, rows[:3], 0] = 0
    p, stats = tck.wave_exchange_plain(T(ps.view(np.int32)))
    same(p, np.bitwise_or.reduce(ps, axis=0), "or")
    occ = [int(jck.wave_occupied_tiles(jnp.asarray(x))) for x in ps]
    same(stats, np.array([sum(occ), s * (bp // 32) * (bp // 32)], np.int32),
         "stats")
    for i in range(s):
        same(tck.wave_occupied_tiles(T(ps[i].view(np.int32))),
             jck.wave_occupied_tiles(jnp.asarray(ps[i])), f"occ {i}")


# ------------------------------------------------------------ engines


def oracle_stream(rng, cv):
    cv += int(rng.integers(1, 40))
    txns = [rand_txn(rng, read_version=int(rng.integers(max(0, cv - 250),
                                                        cv)),
                     alphabet=256, max_len=5)
            for _ in range(int(rng.integers(1, 40)))]
    return cv, txns


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_matches_jax_and_oracle(n_shards):
    """tests/test_sharded_resolver.py:22 (8 shards there too), every leaf
    after every batch; chunks of 32 so a 40-txn batch takes two."""
    rng = np.random.default_rng(5)
    pair = Pair(n_shards, **KW)
    cv = 1000
    for i in range(8):
        cv, txns = oracle_stream(rng, cv)
        pair.resolve(txns, cv, cv - 150, what=f"batch {i}")
    assert not pair.port.overflowed


def test_cross_shard_range_reads():
    pair = Pair(8, **KW)
    t = TxnConflictInfo
    pair.resolve([t(5, [], [KeyRange(b"\xb0x", b"\xb0x\x00")])], 10)
    got = pair.resolve([t(5, [KeyRange(b"", b"\xff\xff")], []),
                        t(15, [KeyRange(b"", b"\xff\xff")], []),
                        t(5, [KeyRange(b"\x10", b"\x20")], [])], 20)
    assert got == [1, 0, 0]


def test_sharded_equals_single():
    """tests/test_sharded_resolver.py:62: the port's 4-shard engine, its
    single engine and the JAX sharded engine agree."""
    rng = np.random.default_rng(17)
    pair = Pair(4, oracle=False, **KW)
    single = TorchConflictSet(device="cpu", capacity=1024, batch_size=32,
                              max_read_ranges=4, max_write_ranges=4,
                              max_key_bytes=8)
    cv = 50
    for i in range(6):
        cv += int(rng.integers(1, 30))
        txns = [rand_txn(rng, read_version=int(rng.integers(max(0, cv - 100),
                                                            cv)),
                         alphabet=256, max_len=4) for _ in range(24)]
        got = pair.resolve(txns, cv, what=f"batch {i}")
        assert got == [int(v) for v in single.resolve(
            [port_txn(t) for t in txns], cv)], i


def test_window_path():
    """tests/test_sharded_resolver.py:79: resolve_wire_window on both
    sharded engines (and per-batch resolve), every leaf after the window."""
    rng = np.random.default_rng(23)
    kw = dict(KW, capacity=512, batch_size=16)
    jw = jsr.ShardedConflictSet(n_shards=4, **kw)
    tw = tsr.ShardedConflictSet(n_shards=4, device="cpu", **kw)
    seq = tsr.ShardedConflictSet(n_shards=4, device="cpu", **kw)
    k, count = 4, 16
    cvs = [10, 21, 35, 36]
    batches = [[rand_txn(rng, read_version=int(rng.integers(0, cv)),
                         alphabet=64, max_len=3) for _ in range(count)]
               for cv in cvs]
    wire = b"".join(jenc(txns) for txns in batches)
    want = jw.resolve_wire_window(wire, cvs, count)
    got = tw.resolve_wire_window(
        b"".join(tenc([port_txn(t) for t in txns]) for txns in batches),
        cvs, count)
    assert got.shape == (k, count) and np.array_equal(got, want)
    same_engine(tw, jw, "window")
    for i, (cv, txns) in enumerate(zip(cvs, batches)):
        assert [int(v) for v in seq.resolve([port_txn(t) for t in txns],
                                            cv)] == got[i].tolist(), i


def test_scoped_reshard():
    """test_resident.py TestResidentMesh: an explicit reshard mid-stream
    inserts and pins the new bound keys, moves the shards it changed, and
    keeps verdicts oracle-exact; every leaf equals JAX's throughout."""
    rng = np.random.default_rng(33)
    pair = Pair(4, capacity=512, batch_size=32, max_read_ranges=4,
                max_write_ranges=4, max_key_bytes=8, auto_reshard=False)
    cv = 1000
    keys_seen = []
    for i in range(10):
        cv += 20
        ks = [bytes([97 + int(rng.integers(0, 26))]) + b"x"
              for _ in range(16)]
        keys_seen += ks
        txns = [TxnConflictInfo(cv - 10, [pt(k)], [pt(k)]) for k in ks]
        pair.resolve(txns, cv, cv - 500, what=f"batch {i}")
        if i == 4:
            splits = jsr.density_splits(4, keys_seen)
            assert tsr.density_splits(4, keys_seen) == splits
            pair.jax.reshard(splits)
            pair.port.reshard(splits)
            assert pair.port.reshard_moved_shards > 0
            assert int(pair.port._mirror.pinned.sum()) >= 4
            same_engine(pair.port, pair.jax, "after reshard")
    assert all(o >= 1 for o in pair.port.shard_occupancy())


def test_auto_reshard():
    """test_resident.py TestResidentMesh: the default policy splits at
    live boundary keys (no dictionary insert)."""
    rng = np.random.default_rng(35)
    pair = Pair(2, capacity=512, batch_size=32, max_read_ranges=4,
                max_write_ranges=4, max_key_bytes=8, auto_reshard=True,
                reshard_interval=3, reshard_skew=1.5)
    cv = 1000
    for i in range(9):
        cv += 20
        ks = [b"\x00" + bytes([int(rng.integers(0, 200))])
              for _ in range(16)]
        txns = [TxnConflictInfo(cv - 10, [pt(k)], [pt(k)]) for k in ks]
        pair.resolve(txns, cv, cv - 500, what=f"batch {i}")
    assert pair.port.auto_reshards >= 1


def test_auto_reshard_on_the_window_path_waits_for_packed_deltas():
    """dispatch_window runs the policy after the dispatch; a window packed
    ahead with a dictionary delta not yet on the device defers it, and the
    verdicts stay the oracle's."""
    rng = np.random.default_rng(37)
    kw = dict(capacity=512, batch_size=16, max_read_ranges=2,
              max_write_ranges=2, max_key_bytes=8)
    cs = tsr.ShardedConflictSet(n_shards=2, device="cpu", auto_reshard=True,
                                reshard_interval=1, reshard_skew=1.0, **kw)
    oracle = OracleConflictSet()
    cv = 0
    windows = []
    for _ in range(4):
        cvs = [cv + 1, cv + 2]
        cv += 2
        txns = [[TxnConflictInfo(
            c - 1, [pt(b"\x00" + bytes([int(rng.integers(0, 200))]))],
            [pt(b"\x00" + bytes([int(rng.integers(0, 200))]))])
            for _ in range(16)] for c in cvs]
        windows.append((cvs, txns))
    packed = [cs.pack_wire_window(b"".join(tenc(t) for t in txns), cvs, 16)
              for cvs, txns in windows[:2]]
    got = [cs.dispatch_window(p)() for p in packed]  # window 1 packed ahead
    assert cs.auto_reshards == 1  # only after window 1's dispatch
    got += [cs.resolve_wire_window(b"".join(tenc(t) for t in txns), cvs, 16)
            for cvs, txns in windows[2:]]
    for (cvs, txns), v in zip(windows, got):
        for c, t, row in zip(cvs, txns, v):
            assert row.tolist() == [int(x) for x in oracle.resolve(t, c)]
    assert cs.auto_reshards >= 2 and not cs.overflowed


@pytest.mark.parametrize("seed", [37, 41, 45])
def test_jax_auto_reshard_ahead_of_the_device_keeps_the_oracles_verdicts(
        seed):
    """The hazard of the JAX window path (ROADMAP.md Queue 3): JAX
    ``ShardedConflictSet.dispatch_window`` runs the auto-reshard policy
    BEFORE the dispatch, so with a window packed ahead (its dictionary
    delta in the host mirror, not yet on the device) and an interval of 1,
    ``_reshard_resident`` maps device history ranks through a mirror that
    is ahead of them. Settled here: the JAX verdicts stay the oracle's on
    every window (the mis-mapped ranks only move the split to another
    resident key: a load-balance departure, never a wrong verdict), the
    port's too, and the two engines end at different splits (the port
    runs the policy after the dispatch, with the device caught up)."""
    rng = np.random.default_rng(seed)
    kw = dict(capacity=512, batch_size=16, max_read_ranges=2,
              max_write_ranges=2, max_key_bytes=8, auto_reshard=True,
              reshard_interval=1, reshard_skew=1.0)
    jcs = jsr.ShardedConflictSet(n_shards=2, **kw)
    tcs = tsr.ShardedConflictSet(n_shards=2, device="cpu", **kw)
    oracle = OracleConflictSet()
    cv, windows = 0, []
    for _ in range(4):
        cvs = [cv + 1, cv + 2]
        cv += 2
        windows.append((cvs, [[TxnConflictInfo(
            c - 1, [pt(b"\x00" + bytes([int(rng.integers(0, 200))]))],
            [pt(b"\x00" + bytes([int(rng.integers(0, 200))]))])
            for _ in range(16)] for c in cvs]))
    jw = [b"".join(jenc(t) for t in txns) for _, txns in windows]
    tw = [b"".join(tenc([port_txn(x) for x in t]) for t in txns)
          for _, txns in windows]
    # Windows 0 and 1 packed before either dispatches: window 1's delta
    # is in the mirror while the policy runs before its dispatch.
    jp = [jcs.pack_wire_window(w, cvs, 16)
          for w, (cvs, _) in zip(jw[:2], windows)]
    tp = [tcs.pack_wire_window(w, cvs, 16)
          for w, (cvs, _) in zip(tw[:2], windows)]
    jgot = [np.asarray(jcs.dispatch_window(p)()) for p in jp]
    tgot = [tcs.dispatch_window(p)() for p in tp]
    for w, jwire, twire in zip(windows[2:], jw[2:], tw[2:]):
        jgot.append(np.asarray(jcs.resolve_wire_window(jwire, w[0], 16)))
        tgot.append(tcs.resolve_wire_window(twire, w[0], 16))
    for i, (cvs, txns) in enumerate(windows):
        want = [[int(x) for x in oracle.resolve(t, c)]
                for c, t in zip(cvs, txns)]
        assert jgot[i].tolist() == want, f"JAX window {i}"
        assert tgot[i].tolist() == want, f"port window {i}"
    assert jcs.auto_reshards >= 2 and tcs.auto_reshards >= 2
    assert jcs._interior_splits != tcs._interior_splits
    assert not jcs.overflowed and not tcs.overflowed


@pytest.mark.parametrize("n_shards", [2, 4])
def test_wave_mesh(n_shards):
    """test_wave_mesh.py TestMeshWave: verdicts and last_wave equal JAX's
    and the oracle's, and exchange_stats equal JAX's."""
    rng = np.random.default_rng(n_shards)
    kw = dict(capacity=512, batch_size=16, max_read_ranges=4,
              max_write_ranges=4, max_key_bytes=8, wave_commit=True,
              auto_reshard=False)
    pair = Pair(n_shards, **kw)
    cv = 1000
    for step in range(8):
        cv += int(rng.integers(2, 30))
        txns = [rand_txn(rng, read_version=int(rng.integers(max(0, cv - 150),
                                                            cv)),
                         alphabet=256, max_len=5)
                for _ in range(int(rng.integers(2, 17)))]
        pair.resolve(txns, cv, cv - 120, what=f"step {step}")
    stats = pair.port.exchange_stats()
    assert stats == pair.jax.exchange_stats()
    assert stats["wave_batches"] == 8
    assert 0 < stats["tiles_occupied"] <= stats["tiles_total"]


def test_wave_mesh_auto_reshard():
    rng = np.random.default_rng(9)
    kw = dict(capacity=512, batch_size=16, max_read_ranges=4,
              max_write_ranges=4, max_key_bytes=8, wave_commit=True,
              auto_reshard=True, reshard_interval=2, reshard_skew=1.0)
    pair = Pair(2, **kw)
    cv = 1000
    for step in range(10):
        cv += int(rng.integers(2, 30))
        txns = [rand_txn(rng, read_version=int(rng.integers(max(0, cv - 150),
                                                            cv)),
                         alphabet=256, max_len=5)
                for _ in range(int(rng.integers(2, 17)))]
        pair.resolve(txns, cv, cv - 120, what=f"step {step}")
    assert pair.port.exchange_stats() == pair.jax.exchange_stats()


def test_tiered_mesh():
    """test_tiered_dict.py:279-320: a 2-shard tiered engine over a walking
    hotspot with a scoped reshard at step 24: demotions, promotions, no
    full repack; dict_stats equal JAX's after every step."""
    rng = np.random.default_rng(17)
    kw = dict(capacity=512, batch_size=32, max_read_ranges=4,
              max_write_ranges=4, max_key_bytes=8, auto_reshard=False,
              dict_hot_capacity=384, dict_delta_slots=128)
    pair = Pair(2, oracle=False, **kw)
    assert pair.port.tiered

    def txn(center, rv):
        ks = [b"k%05d" % (center + int(rng.integers(0, 40)))
              for _ in range(3)]
        return TxnConflictInfo(rv, [pt(k) for k in ks[:2]], [pt(ks[2])])

    cv, touched = 1000, []
    for step in range(55):
        cv += 10
        center = 0 if step >= 40 else (step // 5) * 150
        txns = [txn(center, max(0, cv - 60)) for _ in range(12)]
        touched.extend(r.begin for t in txns for r in t.write_ranges)
        if step == 24:
            splits = jsr.density_splits(2, touched[-256:])
            pair.jax.reshard(splits)
            pair.port.reshard(splits)
        pair.resolve(txns, cv, cv - 100, what=f"step {step}")
    st = pair.port.dict_stats
    assert st["tiered"] and st["demotions"] > 0 and st["promotions"] > 0
    assert st["full_repacks"] == 0 and st["cold_tier_keys"] > 0


def test_advance_headroom_overflow():
    """advance (an empty batch resolved), headroom, overflowed and
    clear_overflow equal JAX's on a history that overflows its shard."""
    rng = np.random.default_rng(3)
    pair = Pair(2, oracle=False, capacity=16, batch_size=16,
                max_read_ranges=2, max_write_ranges=2, max_key_bytes=8,
                auto_reshard=False)
    cv = 100
    for i in range(4):
        cv += 5
        # Blind point writes spread over the keyspace: up to 64 new
        # boundaries a batch against 16 slots per shard.
        txns = [TxnConflictInfo(cv - 1, [], [
            pt(bytes(rng.integers(0, 256, 2).tolist())) for _ in range(2)])
            for _ in range(16)]
        pair.resolve(txns, cv, what=f"batch {i}")
        assert pair.port.headroom() == pair.jax.headroom()
        assert pair.port.overflowed == pair.jax.overflowed
    assert pair.port.overflowed
    pair.port.clear_overflow()
    pair.jax.clear_overflow()
    assert not pair.port.overflowed and not pair.jax.overflowed
    for step in range(3):
        cv += 40
        pair.jax.advance(cv, cv - 10)
        pair.port.advance(cv, cv - 10)
        same_engine(pair.port, pair.jax, f"advance {step}")
        assert pair.port.headroom() == pair.jax.headroom()


def test_wave_advance_counts_an_exchange():
    kw = dict(capacity=64, batch_size=16, max_read_ranges=2,
              max_write_ranges=2, max_key_bytes=8, wave_commit=True,
              auto_reshard=False)
    pair = Pair(2, oracle=False, **kw)
    pair.resolve([TxnConflictInfo(5, [pt(b"a")], [pt(b"b")])], 10)
    pair.jax.advance(20)
    pair.port.advance(20)
    same_engine(pair.port, pair.jax, "advance")
    assert pair.port.exchange_stats() == pair.jax.exchange_stats()
    assert pair.port.exchange_stats()["wave_batches"] == 2


def test_report_txns_leave_last_conflicting_empty():
    """No report launch on a sharded engine (as in JAX): a txn that asks
    for its conflicting keys gets its verdict and no report."""
    rng = np.random.default_rng(13)
    pair = Pair(2, **KW)
    cv = 500
    for i in range(4):
        cv += 20
        txns = [rand_txn(rng, read_version=cv - 30, alphabet=8, max_len=2)
                for _ in range(24)]
        for t in txns[::3]:
            object.__setattr__(t, "report_conflicting_keys", True)
        got = pair.resolve(txns, cv, what=f"batch {i}")
        assert 1 in got or i == 0


def jax_snapshot(cs) -> dict:
    """The convert.py snapshot dict of a JAX sharded engine."""
    mir = cs._mirror
    cs._fold_exchange()
    return {
        "config": {f: JAX_CONFIG[f](cs) if f in JAX_CONFIG else getattr(cs, f)
                   for f in convert.CONFIG_FIELDS}
        | {"max_key_bytes": cs.codec.max_key_bytes},
        "state": {k: np.array(v) for k, v in
                  convert.state_leaves(cs.state).items()},
        "mirror": {f: np.array(getattr(mir, f))
                   for f in convert.MIRROR_FIELDS} | {"stats": mir.stats},
        "base_version": cs.base_version,
        "oldest_version": cs.oldest_version,
        "last_commit": cs._last_commit,
        "sharded": {
            "n_shards": cs.n_shards, "splits": cs._interior_splits,
            "auto_reshard": cs.auto_reshard,
            "reshard_interval": cs.reshard_interval,
            "reshard_skew": cs.reshard_skew,
            "reshard_moved_shards": cs.reshard_moved_shards,
            "auto_reshards": cs.auto_reshards, "dispatches": cs._dispatches,
            "exchange": list(cs._exchange_acc)},
    }


def test_engine_from_snapshot_of_a_jax_sharded_engine():
    """A JAX wave sharded engine captured mid-stream (after a reshard)
    continues in the port: verdicts, levels, every leaf and the exchange
    account equal the JAX engine's own continuation."""
    rng = np.random.default_rng(19)
    kw = dict(capacity=512, batch_size=16, max_read_ranges=4,
              max_write_ranges=4, max_key_bytes=8, wave_commit=True,
              auto_reshard=True, reshard_interval=3, reshard_skew=1.5)
    jcs = jsr.ShardedConflictSet(n_shards=4, **kw)
    cv = 100

    def batch(cv):
        return [rand_txn(rng, read_version=int(rng.integers(cv - 60, cv)),
                         alphabet=256, max_len=4) for _ in range(14)]

    for _ in range(4):
        cv += 10
        jcs.resolve(batch(cv), cv, cv - 80)
    jcs.reshard(jsr.density_splits(4, [bytes([i]) for i in range(0, 250, 3)]))
    snap = jax_snapshot(jcs)
    port = convert.engine_from_snapshot(snap, device="cpu")
    assert isinstance(port, tsr.ShardedConflictSet)
    mine = convert.snapshot(port)
    for k, v in snap["state"].items():
        assert mine["state"][k].tobytes() == v.tobytes(), k
    assert mine["sharded"] == snap["sharded"]
    for i in range(5):
        cv += 10
        txns = batch(cv)
        want = [int(v) for v in jcs.resolve(txns, cv, cv - 80)]
        got = [int(v) for v in port.resolve([port_txn(t) for t in txns], cv,
                                            cv - 80)]
        assert got == want and port.last_wave == jcs.last_wave, i
        same_engine(port, jcs, f"batch {i}")
    assert port.exchange_stats() == jcs.exchange_stats()


def test_paint_only_window_equals_the_resolve():
    """The flat (sharded) branch of paint_many_res: re-painting a window
    from its pre-window state with the accept mask its resolve produced
    gives the resolve's state, leaf for leaf (plain and dispatching)."""
    rng = np.random.default_rng(29)
    kw = dict(capacity=128, batch_size=16, max_read_ranges=2,
              max_write_ranges=2, max_key_bytes=8, auto_reshard=False,
              dict_capacity=2048, dict_delta_slots=512)
    cs = tsr.ShardedConflictSet(n_shards=4, device="cpu", **kw)
    for w in range(3):
        cvs = [10 * w + 1, 10 * w + 2, 10 * w + 3]
        txns = [[rand_txn(rng, read_version=c - 2, n_ranges=2, alphabet=256,
                          max_len=3) for _ in range(16)] for c in cvs]
        prepared = cs.pack_wire_window(
            b"".join(tenc([port_txn(t) for t in b]) for b in txns), cvs, 16)
        before = tck.snapshot_res(cs.state)
        hb = prepared.batch
        rb = tck.ResidentBatch(T(hb.delta_keys),
                               tck.RankBatch(*(T(x) for x in hb.ranks)))
        verdicts = cs.dispatch_window(prepared)()
        acc = np.zeros((3, 16), bool)
        acc[:, :16] = (verdicts == 0) & hb.ranks[7]
        for fn in (tck.paint_many_res, tck.paint_many_res_plain):
            got = fn(tck.snapshot_res(before), rb, T(acc), prepared.cvs_rel,
                     prepared.olds_rel)
            for k, v in convert.state_leaves(got).items():
                assert torch.equal(v, convert.state_leaves(cs.state)[k]), \
                    (w, fn.__name__, k)


def test_constructor_refusals():
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item"):
        tsr.ShardedConflictSet(n_shards=2, device="cpu", spec_resolve=True,
                               **KW)
    with pytest.raises(ValueError, match="divisible"):
        tsr.ShardedConflictSet(n_shards=3, device="cpu", **KW)
    with pytest.raises(ValueError, match="interior splits"):
        tsr.ShardedConflictSet(n_shards=2, device="cpu", splits=[], **KW)
    cs = tsr.ShardedConflictSet(n_shards=2, device="cpu", wave_commit=True,
                                **KW)
    assert not cs.wave_global_capable
    with pytest.raises(ValueError, match="wave"):
        cs.resolve_edges([TxnConflictInfo(5, [], [pt(b"a")])], 10)


def test_split_helpers_equal_jax():
    from foundationdb_tpu_torch.core.keypack import KeyCodec

    from foundationdb_tpu.core.keypack import KeyCodec as JKeyCodec
    rng = np.random.default_rng(3)
    ids = np.minimum(rng.geometric(0.01, 4096), 4000)
    sample = [int(i).to_bytes(8, "big") for i in ids]
    for n in (1, 2, 4, 8):
        assert tsr.interior_uniform(n) == jsr.interior_uniform(n)
        if n > 1:
            assert tsr.density_splits(n, sample) == jsr.density_splits(
                n, sample)
        assert np.array_equal(tsr.uniform_splits(KeyCodec(12), n),
                              jsr.uniform_splits(JKeyCodec(12), n))
    assert tsr.density_splits(4, [b"k"] * 100) == tsr.interior_uniform(4)
