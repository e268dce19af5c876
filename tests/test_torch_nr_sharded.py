"""The port's non-resident sharded engine and the flat programs it runs,
against the JAX package on the CPU.

The JAX ``ShardedConflictSet(resident=False)`` runs on conftest's 8-device
CPU mesh; the port keeps its S flat [C, W] shard histories as the leading
axis of one state (``device="cpu"``: the plain versions). Exact tolerance
throughout (integers): verdicts, ``last_wave``, every state leaf after
every batch (keys [S, C, W], versions, n_used, oldest, overflow),
``shard_occupancy``, ``auto_reshards`` and ``exchange_stats``; and against
``sim/oracle.OracleConflictSet``. The plain versions of K14 (the stable
W-word sort and the endpoint ranks), K15 (``clip_batch``) and K16 (the
too-old mask, the per-shard flat probe and the cross-shard OR) and every
B5 flat function (``_paint_and_compact``, ``resolve_batch`` with
``report`` and ``wave``, ``resolve_many``) are held against their JAX
lines on seeded inputs.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.core import wavemesh as jwm
from foundationdb_tpu.core.keypack import KeyCodec as JKeyCodec
from foundationdb_tpu.core.types import KeyRange, TxnConflictInfo
from foundationdb_tpu.models import conflict_kernel as jck
from foundationdb_tpu.models.conflict_set import TPUConflictSet
from foundationdb_tpu.models.conflict_set import _coalesce as jcoalesce
from foundationdb_tpu.models.conflict_set import encode_resolve_batch as jenc
from foundationdb_tpu.ops import lex as jlex
from foundationdb_tpu.parallel import sharded_resolver as jsr
from foundationdb_tpu.sim.oracle import OracleConflictSet
from foundationdb_tpu_torch import bench, convert
from foundationdb_tpu_torch.models import conflict_kernel as tck
from foundationdb_tpu_torch.models.conflict_set import (
    encode_resolve_batch as tenc,
)
from foundationdb_tpu_torch.ops import lex as tlex
from foundationdb_tpu_torch.parallel import sharded_resolver as tsr
from tests.test_conflict_oracle import rand_txn
from tests.test_torch_conflict_kernel import T, same
from tests.test_torch_conflict_set import port_txn
from tests.test_torch_nonresident import KW as NR_KW
from tests.test_torch_nonresident import make_txns

# Small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the CPU.
torch.set_num_threads(1)

I32MAX = tck.INT32_MAX
I32MIN = -(2**31)
KW = dict(capacity=256, batch_size=32, max_read_ranges=4, max_write_ranges=4,
          max_key_bytes=8, resident=False)

# The JAX flat lines under test, jitted once per static configuration.
J = {
    "resolve": jax.jit(jck.resolve_batch, static_argnames=("report", "wave")),
    "many": jax.jit(jck.resolve_many, static_argnames=("wave",)),
    "paint": jax.jit(jck._paint_and_compact),
    "ranges": jax.jit(jck._history_conflict_ranges),
    "ranks": jax.jit(jck._endpoint_ranks),
}


def pt(k: bytes) -> KeyRange:
    return KeyRange(k, k + b"\x00")


def same_leaves(port_state, jax_state, what=""):
    want = convert.state_leaves(jax_state)
    got = convert.state_leaves(port_state)
    assert got.keys() == want.keys(), what
    for k, v in want.items():
        same(got[k], np.asarray(v), f"{what}: {k}")


def same_engine(port, jax_cs, what=""):
    same_leaves(port.state, jax_cs.state, what)
    assert port.shard_occupancy() == jax_cs.shard_occupancy(), what
    assert port.auto_reshards == jax_cs.auto_reshards, what
    assert port._interior_splits == jax_cs._interior_splits, what
    assert port.overflowed == jax_cs.overflowed, what


class Pair:
    """A JAX and a port non-resident sharded engine (and the oracle), in
    lockstep."""

    def __init__(self, n_shards, oracle=True, **kw):
        kw = dict(KW, **kw)
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


def oracle_stream(rng, cv, n_max=40, alphabet=256, max_len=5, back=250):
    cv += int(rng.integers(1, 40))
    txns = [rand_txn(rng, read_version=int(rng.integers(max(0, cv - back),
                                                        cv)),
                     alphabet=alphabet, max_len=max_len)
            for _ in range(int(rng.integers(1, n_max)))]
    return cv, txns


# ------------------------------------------------------------- K14 plain


def sort_rows(kind: str, rng) -> np.ndarray:
    """[N, 4] int32 rows for the sort cases (N not a power of two)."""
    n = 301
    if kind == "random":
        return rng.integers(I32MIN, I32MAX, (n, 4), dtype=np.int64).astype(
            np.int32)
    if kind == "all_equal":
        return np.full((n, 4), 7, np.int32)
    if kind == "extremes":
        return rng.choice(np.array([I32MIN, I32MIN + 1, -1, 0, 1, I32MAX - 1,
                                    I32MAX], np.int64), (n, 4)).astype(
            np.int32)
    if kind == "long_runs":
        base = rng.integers(-3, 3, (5, 4)).astype(np.int32)
        return base[np.sort(rng.integers(0, 5, n))[::-1]]
    assert kind == "inf_padded"  # packed keys with +inf pad rows
    codec = JKeyCodec(12)
    keys = [bytes(rng.integers(0, 3, int(rng.integers(0, 5))).tolist())
            for _ in range(n)]
    rows = codec.pack(keys, "begin")
    rows[rng.random(n) < 0.3] = I32MAX
    return rows


@pytest.mark.parametrize("kind", ["random", "all_equal", "extremes",
                                  "long_runs", "inf_padded"])
def test_word_sort_and_ranks_equal_jax(kind):
    """K14's plain version vs lax.sort(is_stable=True) and the JAX
    ``_endpoint_ranks``: keys and payloads byte for byte (equal rows keep
    their input order), ranks and liveness."""
    rng = np.random.default_rng(len(kind))
    rows = sort_rows(kind, rng)
    n, w = rows.shape
    idx = np.arange(n, dtype=np.int32)
    pay = rng.integers(-50, 50, n).astype(np.int32)
    want = jlex.sort_keys_with_payload(jnp.asarray(rows), jnp.asarray(idx),
                                       jnp.asarray(pay))
    got = tlex.sort_keys_with_payload(T(rows), T(idx), T(pay))
    for g, x in zip(got, want):
        same(g, x, kind)
    # The same rows as a batch's four endpoint sections (B = 25, R = 3,
    # Q = 3: 2·25·6 = 300 rows; row 300 dropped).
    b, r, q = 25, 3, 3
    secs = rows[:300].reshape(4, -1, w)
    masks = rng.random((2, b, max(r, q))) < 0.8
    jb = jck.BatchTensors(
        read_begin=secs[0].reshape(b, r, w), read_end=secs[1].reshape(b, r, w),
        read_mask=masks[0, :, :r], write_begin=secs[2].reshape(b, q, w),
        write_end=secs[3].reshape(b, q, w), write_mask=masks[1, :, :q],
        read_version=np.zeros(b, np.int32), txn_mask=np.ones(b, bool))
    tb = tck.BatchTensors(*(T(x) for x in jb))
    for g, x in zip(tck._endpoint_ranks(tb), J["ranks"](jb)):
        same(g, x, f"{kind} ranks")
    for g, x in zip(tck.endpoint_ranks_live(tb),
                    jck.endpoint_ranks_live(jb)):
        same(g, x, f"{kind} live")


# ------------------------------------------------------------- K15 plain


def test_word_clip_equals_clip_batch():
    """K15's plain version vs ``clip_batch`` of every shard: ranges that
    straddle a bound, fall inside, or empty after the clamp; lo = the
    minimum key (shard 0) and hi = +inf (the last shard)."""
    rng = np.random.default_rng(4)
    codec = JKeyCodec(8)
    bounds = jsr.pack_splits(codec, [b"\x30", b"\x80", b"\x80\x01"])
    b, r, q = 20, 3, 2

    def rows(n):
        ks = [bytes(rng.integers(0x20, 0x90, int(rng.integers(0, 3)))
                    .tolist()) for _ in range(2 * n)]
        ks.sort()
        p = codec.pack(ks, "begin").reshape(n, 2, -1)
        return p[:, 0], p[:, 1]

    rb, re_ = rows(b * r)
    wb, we = rows(b * q)
    w = codec.width
    jb = jck.BatchTensors(
        read_begin=rb.reshape(b, r, w), read_end=re_.reshape(b, r, w),
        read_mask=rng.random((b, r)) < 0.9,
        write_begin=wb.reshape(b, q, w), write_end=we.reshape(b, q, w),
        write_mask=rng.random((b, q)) < 0.9,
        read_version=np.arange(b, dtype=np.int32), txn_mask=np.ones(b, bool))
    tb = tck.BatchTensors(*(T(x) for x in jb))
    lo, hi = bounds[:-1], bounds[1:]
    clip = tck.word_clip_plain(tb, T(lo), T(hi), reads=True)
    assert tck.word_clip_plain(tb, T(lo), T(hi), reads=False).read_begin \
        is None
    emptied = 0
    for s in range(len(lo)):
        want = jck.clip_batch(jb, jnp.asarray(lo[s]), jnp.asarray(hi[s]))
        got = tck.clip_batch(tb, T(lo[s]), T(hi[s]))
        view = tck.clip_view(tb, clip, s)
        for f in tck.BatchTensors._fields:
            same(getattr(got, f), getattr(want, f), f"{s}.{f}")
            same(getattr(view, f), getattr(want, f), f"clip {s}.{f}")
        emptied += int((jb.write_mask & ~np.asarray(want.write_mask)).sum())
    assert emptied > 0


# ------------------------------------------------------- flat streams


def jax_batch(jcs, txns, cv, oldest):
    """(BatchTensors numpy, relative cv, relative floor) of one batch
    packed by a JAX engine, with its version bookkeeping advanced."""
    jcs._begin_resolve(cv, oldest)
    return (jcs._pack(txns), cv - jcs.base_version,
            jcs.oldest_version - jcs.base_version)


@pytest.fixture(scope="module")
def flat_steps():
    """[(jax flat state before, BatchTensors, cv, floor)] of a JAX flat
    stream (capacity 96, 8-byte keys), every fourth txn reporting."""
    rng = np.random.default_rng(12)
    jcs = TPUConflictSet(resident=False, capacity=96, batch_size=24,
                         max_read_ranges=3, max_write_ranges=2,
                         max_key_bytes=8, window_versions=300)
    state = jck.init_state(96, jcs.codec.width, jcs.codec.min_key)
    out, cv = [], 1000
    for _ in range(7):
        cv += int(rng.integers(5, 40))
        txns = make_txns(rng, int(rng.integers(8, 24)), cv)
        bt, cvr, oldr = jax_batch(jcs, txns, cv, cv - 150)
        out.append((state, bt, cvr, oldr))
        state = J["resolve"](state, bt, jnp.int32(cvr), jnp.int32(oldr))[-1]
    return out


def t_flat(js):
    return tck.ConflictState(*(T(getattr(js, f))
                               for f in convert.STATE_FIELDS))


def t_batch(bt):
    return tck.BatchTensors(*(T(x) for x in bt))


def test_too_old_and_flat_probe_equal_jax(flat_steps):
    """K16's plain version at S = 1 unclipped vs ``too_old_mask`` and
    ``_history_conflict_ranges``."""
    hits = 0
    for i, (js, bt, _cv, old) in enumerate(flat_steps):
        floor, too_old = jck.too_old_mask(js, bt, jnp.int32(old))
        ranges = J["ranges"](js, bt)
        th, tb = t_flat(js), t_batch(bt)
        tfloor, ttoo = tck.too_old_mask(th, tb, old)
        same(tfloor, floor, f"{i} floor")
        same(ttoo, too_old, f"{i} too_old")
        got = tck.word_shard_probe_plain(tck._as_shards(th), tb, None, None,
                                         tfloor)
        same(got[0], too_old, f"{i} probe too_old")
        same(got[1], ranges, f"{i} hist_mask")
        same(got[2], np.asarray(ranges).any(1), f"{i} hist_conflict")
        same(tck._history_conflicts(th, tb), jck._history_conflicts(js, bt),
             f"{i} conflicts")
        want_c = np.asarray(bt.txn_mask) & ~np.asarray(too_old) \
            & ~np.asarray(ranges).any(1)
        same(got[3], want_c, f"{i} cand")
        hits += int(np.asarray(ranges).sum())
    assert hits > 0


@pytest.mark.parametrize("report", [False, True])
@pytest.mark.parametrize("wave", [False, True])
def test_resolve_batch_and_many_equal_jax(flat_steps, wave, report):
    """The flat ``resolve_batch`` (sequential or wave, with the report)
    and ``resolve_many`` vs JAX: verdicts, levels, loser masks and every
    state leaf."""
    for i, (js, bt, cv, old) in enumerate(flat_steps):
        want = J["resolve"](js, bt, jnp.int32(cv), jnp.int32(old),
                            report=report, wave=wave)
        got = tck.resolve_batch(t_flat(js), t_batch(bt), cv, old,
                                report=report, wave=wave)
        same(got[0], want[0], f"{i} verdicts")
        if wave:
            same(got[1], want[1], f"{i} levels")
        if report:
            same(got[-2], tck.pack_loser_mask(T(np.asarray(want[-2]))),
                 f"{i} losers")
        same_leaves(got[-1], want[-1], f"step {i}")
    js0 = flat_steps[2][0]
    steps = flat_steps[2:6]
    batches = jck.BatchTensors(*(np.stack(x) for x in zip(
        *(s[1] for s in steps))))
    cvs = np.array([s[2] for s in steps], np.int32)
    olds = np.array([s[3] for s in steps], np.int32)
    want = J["many"](js0, batches, jnp.asarray(cvs), jnp.asarray(olds),
                     wave=wave)
    got = tck.resolve_many(t_flat(js0), t_batch(batches), cvs, olds,
                           wave=wave)
    for g, x in zip(got[:-1], want[:-1]):
        same(g, x, "many")
    same_leaves(got[-1], want[-1], "many")


def test_paint_with_clamped_endpoints_at_lo():
    """The unpacked paint on a shard whose boundary 0 is its lower bound
    lo (not b""), with writes that start below lo in every shard, so the
    clipped begins sit exactly at lo (delta-0 duplicates of the boundary
    that the min-key rule must not keep twice)."""
    codec = JKeyCodec(12)
    w = codec.width
    splits = [b"\x40", b"\x80", b"\xc0"]
    bounds = jsr.pack_splits(codec, splits)
    lo, hi = bounds[:-1], bounds[1:]
    b, q = 6, 2
    begins = [b"\x10", b"\x50", b"\x90", b"\x00", b"\x3f\xff", b"\x7f"]
    ends = [b"\x45", b"\x85", b"\xc5", b"\xff", b"\x41", b"\xc0\x01"]
    wb = codec.pack(begins * 2, "begin").reshape(2, b, w).transpose(1, 0, 2)
    we = codec.pack(ends * 2, "end").reshape(2, b, w).transpose(1, 0, 2)
    wb, we = np.ascontiguousarray(wb), np.ascontiguousarray(we)
    wm = np.ones((b, q), bool)
    wm[2, 1] = False
    bt = jck.BatchTensors(
        read_begin=np.full((b, 1, w), I32MAX, np.int32),
        read_end=np.full((b, 1, w), I32MAX, np.int32),
        read_mask=np.zeros((b, 1), bool), write_begin=wb, write_end=we,
        write_mask=wm, read_version=np.zeros(b, np.int32),
        txn_mask=np.ones(b, bool))
    accepted = np.array([1, 1, 0, 1, 1, 1], bool)
    cap = 16
    for s in range(4):
        js = jck.init_state(cap, w, lo[s])
        local = jck.clip_batch(bt, jnp.asarray(lo[s]), jnp.asarray(hi[s]))
        for step, (cv, floor) in enumerate(((10, 0), (20, 0), (30, 15))):
            want = J["paint"](js, local, jnp.asarray(accepted),
                              jnp.int32(cv), jnp.int32(floor))
            got = tck._paint_and_compact(t_flat(js), t_batch(local),
                                         T(accepted), cv, T(np.int32(floor)))
            same_leaves(got, want, f"shard {s} step {step}")
            js = want
        keys = np.asarray(js.keys)[: int(js.n_used)]
        assert (keys[0] == lo[s]).all()
        assert len({k.tobytes() for k in keys}) == len(keys)


# ------------------------------------------------------------- K16 plain


def test_sharded_probe_equals_jax_per_shard_or():
    """K16's plain version vs ``too_old_mask`` + each shard's
    ``_history_conflicts`` of its clipped batch, OR-ed, on a mid-stream
    JAX 4-shard state."""
    rng = np.random.default_rng(7)
    jcs = jsr.ShardedConflictSet(n_shards=4, auto_reshard=False,
                                 **dict(KW, capacity=128))
    cv = 1000
    for _ in range(6):
        cv += 10
        jcs.resolve([rand_txn(rng, read_version=cv - 30, alphabet=256,
                              max_len=4) for _ in range(28)], cv, cv - 100)
    bt, _, old = jax_batch(
        jcs, [rand_txn(rng, read_version=cv - 25, alphabet=256, max_len=4)
              for _ in range(30)], cv + 10, cv - 90)
    st = jcs.state
    lo, hi = np.asarray(jcs._lo), np.asarray(jcs._hi)
    per = []
    for s in range(4):
        hs = jck.ConflictState(*(np.asarray(x)[s] for x in st))
        floor, too_old = jck.too_old_mask(hs, bt, jnp.int32(old))
        local = jck.clip_batch(bt, jnp.asarray(lo[s]), jnp.asarray(hi[s]))
        per.append(np.asarray(J["ranges"](hs, local)))
        if s == 0:
            floor0, too_old0 = int(floor), np.asarray(too_old)
    want_m = np.stack(per).any(0)
    want_h = want_m.any(1)
    th = tck.ConflictState(*(T(x) for x in st))
    got = tck.word_shard_probe_plain(th, t_batch(bt), T(lo), T(hi),
                                     T(np.int32(floor0)))
    same(got[0], too_old0, "too_old")
    same(got[1], want_m, "hist_mask")
    same(got[2], want_h, "hist_conflict")
    same(got[3], np.asarray(bt.txn_mask) & ~too_old0 & ~want_h, "cand")
    assert want_h.any() and not want_h.all()


# ------------------------------------------------------------- engines


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_nr_sharded_matches_jax_and_oracle(n_shards):
    """tests/test_sharded_resolver.py:22's stream on the non-resident
    engine, every leaf after every batch; chunks of 32 (a 40-txn batch
    takes two)."""
    rng = np.random.default_rng(5)
    pair = Pair(n_shards, auto_reshard=False)
    cv = 1000
    for i in range(8):
        cv, txns = oracle_stream(rng, cv)
        pair.resolve(txns, cv, cv - 150, what=f"batch {i}")
    assert not pair.port.overflowed
    assert sum(pair.port.shard_occupancy()) > 2 * n_shards


def test_nr_cross_shard_range_reads():
    pair = Pair(8)
    t = TxnConflictInfo
    pair.resolve([t(5, [], [KeyRange(b"\xb0x", b"\xb0x\x00")])], 10)
    got = pair.resolve([t(5, [KeyRange(b"", b"\xff\xff")], []),
                        t(15, [KeyRange(b"", b"\xff\xff")], []),
                        t(5, [KeyRange(b"\x10", b"\x20")], [])], 20)
    assert got == [1, 0, 0]


def test_nr_writes_below_lo_in_every_shard():
    """Write ranges that start below a shard's lower bound in every shard
    (their clipped begins sit at lo) and reads across the bounds: leaves
    equal JAX's, every shard keeps exactly one boundary at its lo."""
    pair = Pair(4, auto_reshard=False, capacity=64)
    t = TxnConflictInfo
    cv = 100
    for i in range(5):
        cv += 10
        txns = [t(cv - 5, [KeyRange(bytes([0x3f + i]), bytes([0x41 + i]))],
                  [KeyRange(bytes([0x40 * s - 0x10]) if s else b"",
                            bytes([0x40 * s + 0x10 - i]))])
                for s in range(4)]
        txns.append(t(cv - 5, [], [KeyRange(b"\x01", b"\xfe")]))
        txns.append(t(cv - 15, [KeyRange(b"", b"\xff")], []))
        pair.resolve(txns, cv, cv - 25, what=f"batch {i}")
        keys = pair.port.state.keys.numpy()
        n_used = pair.port.state.n_used.numpy()
        for s in range(4):
            rows = keys[s, : n_used[s]]
            assert (rows[0] == pair.port._lo[s]).all()
            assert len({r.tobytes() for r in rows}) == len(rows)


def test_nr_window_path():
    """resolve_wire_window on both engines (and per-batch resolve on the
    port), every leaf after each window, on the sequential and wave
    engines."""
    rng = np.random.default_rng(23)
    for wave in (False, True):
        kw = dict(capacity=512, batch_size=16, wave_commit=wave,
                  auto_reshard=False)
        pair = Pair(4, oracle=False, **kw)
        seq = tsr.ShardedConflictSet(n_shards=4, device="cpu",
                                     **dict(KW, **kw))
        cv = 0
        for wi in range(3):
            cvs = [cv + 10, cv + 21, cv + 35, cv + 36]
            cv = cvs[-1]
            batches = [[rand_txn(rng, read_version=int(rng.integers(0, c)),
                                 alphabet=64, max_len=3) for _ in range(16)]
                       for c in cvs]
            want = pair.jax.resolve_wire_window(
                b"".join(jenc(b) for b in batches), cvs, 16)
            got = pair.port.resolve_wire_window(
                b"".join(tenc([port_txn(t) for t in b]) for b in batches),
                cvs, 16)
            assert got.shape == (4, 16) and np.array_equal(got, want)
            if wave:
                assert np.array_equal(pair.port.last_wave_window,
                                      pair.jax.last_wave_window)
            same_engine(pair.port, pair.jax, f"window {wi}")
            for i, (c, txns) in enumerate(zip(cvs, batches)):
                assert [int(v) for v in seq.resolve(
                    [port_txn(t) for t in txns], c)] == got[i].tolist()
        if wave:
            assert pair.port.exchange_stats() == pair.jax.exchange_stats()


def test_nr_reshard_into_an_almost_full_shard():
    """An explicit reshard that moves every boundary into one shard of a
    small capacity: the redistributed histories, the sticky per-shard
    overflow and later batches equal JAX's; then a density reshard."""
    rng = np.random.default_rng(8)
    pair = Pair(4, oracle=False, capacity=24, batch_size=16,
                max_read_ranges=2, max_write_ranges=2, auto_reshard=False)
    cv, seen = 100, []
    for i in range(10):
        cv += 5
        ks = [bytes(rng.integers(0, 256, 2).tolist()) for _ in range(8)]
        seen += ks
        pair.resolve([TxnConflictInfo(cv - 3, [pt(k)], [pt(k)]) for k in ks],
                     cv, what=f"batch {i}")
        if i == 4:
            splits = [b"\x10", b"\x11", b"\x12"]
            pair.jax.reshard(splits)
            pair.port.reshard(splits)
            same_engine(pair.port, pair.jax, "reshard")
            assert pair.port.overflowed
            assert pair.port.shard_occupancy()[3] == 24
        if i == 7:
            splits = jsr.density_splits(4, seen)
            assert tsr.density_splits(4, seen) == splits
            pair.jax.reshard(splits)
            pair.port.reshard(splits)
            same_engine(pair.port, pair.jax, "density reshard")
    over = pair.port.state.overflow.numpy()
    assert over.any() and not over.all()
    pair.port.clear_overflow()
    pair.jax.clear_overflow()
    assert not pair.port.overflowed and not pair.jax.overflowed


@pytest.mark.parametrize("path", ["object", "window"])
def test_nr_auto_reshard(path):
    """The default policy on the object path and on the window path (where
    JAX reshards before the dispatch): leaves and the reshard count equal
    JAX's after every call, verdicts the oracle's."""
    rng = np.random.default_rng(35)
    pair = Pair(2, capacity=512, batch_size=16, max_read_ranges=2,
                max_write_ranges=2, auto_reshard=True, reshard_interval=2,
                reshard_skew=1.5)
    cv = 1000
    for i in range(9):
        cvs = [cv + 10, cv + 20]
        cv = cvs[-1]
        batches = [[TxnConflictInfo(
            c - 10, [pt(b"\x00" + bytes([int(rng.integers(0, 200))]))],
            [pt(b"\x00" + bytes([int(rng.integers(0, 200))]))])
            for _ in range(16)] for c in cvs]
        if path == "object":
            for c, txns in zip(cvs, batches):
                pair.resolve(txns, c, c - 500, what=f"call {i}")
            continue
        want = pair.jax.resolve_wire_window(
            b"".join(jenc(b) for b in batches), cvs, 16)
        got = pair.port.resolve_wire_window(
            b"".join(tenc([port_txn(t) for t in b]) for b in batches), cvs,
            16)
        assert np.array_equal(got, want), i
        for c, txns, row in zip(cvs, batches, got):
            assert row.tolist() == [int(v) for v in pair.oracle.resolve(txns,
                                                                        c)]
        same_engine(pair.port, pair.jax, f"window {i}")
    assert pair.port.auto_reshards >= 1


@pytest.mark.parametrize("n_shards", [2, 4])
def test_nr_wave_mesh(n_shards):
    """test_wave_mesh.py TestMeshWave's stream on the non-resident engine:
    verdicts and last_wave equal JAX's and the oracle's, exchange_stats
    equal JAX's."""
    rng = np.random.default_rng(n_shards)
    pair = Pair(n_shards, capacity=512, batch_size=16, wave_commit=True,
                auto_reshard=False)
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


def test_nr_advance_headroom_and_wave_advance():
    """advance (an empty batch resolved), headroom, overflowed and
    clear_overflow equal JAX's on a history that overflows a shard; a
    wave engine's advance counts an exchange."""
    rng = np.random.default_rng(3)
    pair = Pair(2, oracle=False, capacity=16, batch_size=16,
                max_read_ranges=2, max_write_ranges=2, auto_reshard=False)
    cv = 100
    for i in range(4):
        cv += 5
        txns = [TxnConflictInfo(cv - 1, [], [
            pt(bytes(rng.integers(0, 256, 2).tolist())) for _ in range(2)])
            for _ in range(16)]
        pair.resolve(txns, cv, what=f"batch {i}")
        assert pair.port.headroom() == pair.jax.headroom()
    assert pair.port.overflowed
    pair.port.clear_overflow()
    pair.jax.clear_overflow()
    for step in range(3):
        cv += 40
        pair.jax.advance(cv, cv - 10)
        pair.port.advance(cv, cv - 10)
        same_engine(pair.port, pair.jax, f"advance {step}")
        assert pair.port.headroom() == pair.jax.headroom()
    wave = Pair(2, oracle=False, capacity=64, batch_size=16,
                max_read_ranges=2, max_write_ranges=2, wave_commit=True,
                auto_reshard=False)
    wave.resolve([TxnConflictInfo(5, [pt(b"a")], [pt(b"b")])], 10)
    wave.jax.advance(20)
    wave.port.advance(20)
    same_engine(wave.port, wave.jax, "wave advance")
    assert wave.port.exchange_stats() == wave.jax.exchange_stats()
    assert wave.port.exchange_stats()["wave_batches"] == 2


def test_nr_rebase_equals_jax():
    """A version jump past the rebase threshold rebases every shard's
    versions and floors as JAX does."""
    pair = Pair(2, oracle=False, capacity=64, batch_size=16,
                max_read_ranges=2, max_write_ranges=2, auto_reshard=False,
                window_versions=100)
    cv = 500
    for i in range(3):
        cv += 10
        pair.resolve([TxnConflictInfo(cv - 5, [pt(b"k")], [pt(b"k%d" % i)])],
                     cv, what=f"batch {i}")
    cv += (1 << 30) + 7
    pair.resolve([TxnConflictInfo(cv - 5, [pt(b"k1")], [pt(b"z")])], cv,
                 what="jump")
    assert pair.port.base_version == pair.jax.base_version > 0


def jax_snapshot(cs) -> dict:
    """The convert.py snapshot dict of a JAX non-resident sharded engine."""
    cs._fold_exchange()
    return {
        "config": {f: getattr(cs, f, 0) for f in convert.CONFIG_FIELDS}
        | {"max_key_bytes": cs.codec.max_key_bytes, "spec_resolve": cs.spec},
        "state": {k: np.array(v) for k, v in
                  convert.state_leaves(cs.state).items()},
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


@pytest.mark.parametrize("wave", [False, True])
def test_engine_from_snapshot_of_a_jax_nr_sharded_engine(wave):
    """A JAX non-resident sharded engine captured mid-stream (after a
    reshard) continues in the port: verdicts, levels, every leaf and the
    exchange account equal the JAX engine's own continuation."""
    rng = np.random.default_rng(19)
    kw = dict(KW, capacity=512, batch_size=16, wave_commit=wave,
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
    assert isinstance(port, tsr.ShardedConflictSet) and not port.resident
    state = convert.flat_shards_from_leaves(snap["state"])
    for f in convert.STATE_FIELDS:
        assert torch.equal(getattr(state, f), getattr(port.state, f)), f
    mine = convert.snapshot(port)
    for k, v in snap["state"].items():
        assert mine["state"][k].tobytes() == v.tobytes(), k
    assert mine["sharded"] == snap["sharded"] and "mirror" not in mine
    for i in range(5):
        cv += 10
        txns = batch(cv)
        want = [int(v) for v in jcs.resolve(txns, cv, cv - 80)]
        got = [int(v) for v in port.resolve([port_txn(t) for t in txns], cv,
                                            cv - 80)]
        assert got == want and port.last_wave == jcs.last_wave, i
        same_engine(port, jcs, f"batch {i}")
    assert port.exchange_stats() == jcs.exchange_stats()


def test_two_phase_question_settled_by_the_oracle():
    """The stream of test_torch_nonresident.py::test_two_phase_wave_equals_
    jax, batch 2, txn 5 (reads ``adc`` at rv 1018): the oracle's wave
    replay COMMITS it, as the two-phase protocol does; the JAX single wave
    engine, the JAX non-resident sharded wave engine (the fused exchange)
    and the port's say CONFLICT. The cause is the packer's range
    coalescing: batch 1's txn 9 writes three point keys, which the fused
    and single engines widen to two ranges (``_coalesce``), the first of
    them ['', 'ccca\\x00') over ``adc``, while the two-phase shards see
    the txn clipped first, at most two ranges each, so unwidened. A false
    conflict, never a missed one."""
    rng = np.random.default_rng(16)
    cfg = dict(NR_KW, wave_commit=True)
    split = [b"\x62"]
    jcs = jsr.ShardedConflictSet(n_shards=2, splits=split, resident=False,
                                 auto_reshard=False, **cfg)
    tcs = tsr.ShardedConflictSet(n_shards=2, splits=split, resident=False,
                                 auto_reshard=False, device="cpu", **cfg)
    bounds = [(b"", b"\x62"), (b"\x62", b"\xff")]
    two = [TPUConflictSet(resident=False, **cfg) for _ in bounds]
    oracle = OracleConflictSet(wave_commit=True)
    cv = 1000
    for i in range(3):
        cv += 10
        txns = make_txns(rng, 20, cv)
        graph = jwm.combine_edges([
            s.resolve_edges(jwm.clip_txns(txns, lo, hi), cv)
            for s, (lo, hi) in zip(two, bounds)])
        two_v = [int(v) for v in two[0].resolve_apply(graph)]
        two[1].resolve_apply(graph)
        want = [int(v) for v in jcs.resolve(txns, cv)]
        got = [int(v) for v in tcs.resolve([port_txn(t) for t in txns], cv)]
        orc = [int(v) for v in oracle.resolve(txns, cv)]
        assert got == want and tcs.last_wave == jcs.last_wave, i
        same_leaves(tcs.state, jcs.state, f"batch {i}")
        if i == 1:
            w9 = txns[9].write_ranges
            assert len(w9) == 3
            assert jcoalesce(w9, cfg["max_write_ranges"])[0] == KeyRange(
                b"", b"ccca\x00")
        if i < 2:
            assert got == orc == two_v, i
    assert orc[5] == two_v[5] == 0 and got[5] == want[5] == 1
    assert [k for k in range(20) if got[k] != orc[k]] == [5]


def test_bench_resident0_resolvers_equals_resident(capsys):
    """``bench --resident 0 --resolvers 4`` on the CPU runs this engine
    and prints the resident sharded engine's verdict hash."""
    args = ["--device", "cpu", "--txns", "8192", "--window", "1",
            "--repeats", "1", "--capacity", "65536", "--keys", "65536",
            "--resolvers", "4"]
    bench.main([*args, "--resident", "0"])
    nr = capsys.readouterr().out
    bench.main(args)
    res = capsys.readouterr().out
    nr, res = json.loads(nr), json.loads(res)
    assert nr["resident"] is False and nr["resolvers"] == 4
    assert nr["verdicts_sha256"] == res["verdicts_sha256"]
    assert nr["dict_stats"] is None and len(nr["shard_occupancy"]) == 4


def test_spec_resolve_still_refused():
    with pytest.raises(NotImplementedError, match="item 15"):
        tsr.ShardedConflictSet(n_shards=2, device="cpu", spec_resolve=True,
                               **KW)
    cs = tsr.ShardedConflictSet(n_shards=2, device="cpu", **KW)
    assert not cs.resident and cs._mirror is None and not cs.can_report
    assert tuple(cs.state.keys.shape) == (2, 256, 3)


def test_plain_flag_equals_the_default_on_the_cpu(flat_steps):
    """On the CPU the plain versions run either way: a flat step with
    ``plain`` equals one without it."""
    js, bt, cv, old = flat_steps[3]
    a = tck.resolve_batch(t_flat(js), t_batch(bt), cv, old)
    b = tck.resolve_batch(t_flat(js), t_batch(bt), cv, old, plain=True)
    for x, y in zip(convert.state_leaves(a[-1]).values(),
                    convert.state_leaves(b[-1]).values()):
        assert torch.equal(x, y)
    assert torch.equal(a[0], b[0])

