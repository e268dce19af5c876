"""K15's window clip and the fused wave exchange (K5's OR mode, K10) of the
port's sharded engines, against the JAX package on the CPU.

``WordWindowClip`` is the non-resident sharded window program's clip: its
buffers are allocated and checked once a window and each step clips into
them (on the CPU, through ``word_clip_plain``). The fused exchange builds
the OR of the shards' predecessor matrices and the exchange stats shard by
shard into one matrix (``wave_pred_or_plain``, the twin of K5's OR mode).
Both are held against the JAX ``clip_batch`` and
``parallel/sharded_resolver._wave_exchange_and_level`` (under ``shard_map``
on conftest's 8-device CPU mesh). Exact tolerance throughout (integers).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from foundationdb_tpu.core.keypack import KeyCodec as JKeyCodec
from foundationdb_tpu.models import conflict_kernel as jck
from foundationdb_tpu.parallel import sharded_resolver as jsr
from foundationdb_tpu_torch import kernels as K
from foundationdb_tpu_torch.models import conflict_kernel as tck
from tests.test_torch_conflict_kernel import T, same

# Small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the CPU.
torch.set_num_threads(1)

SPLITS = [b"\x30", b"\x80", b"\x80\x01"]


def key_window(rng, codec, k, b, r, q):
    """k JAX BatchTensors (numpy) of full key rows: keys of 0-2 random
    bytes, the split keys themselves and the split keys with one more
    byte (rows equal to a bound, or differing from it only in a later
    word); step 2 has every mask false."""
    pool = [bytes(rng.integers(0x20, 0x90, int(rng.integers(0, 3)))
                  .tolist()) for _ in range(64)]
    pool += SPLITS + [s + b"\x00" for s in SPLITS] + [b""]
    w = codec.width
    steps = []
    for i in range(k):
        def rows(n):
            ks = sorted(pool[j] for j in rng.integers(0, len(pool), 2 * n))
            pairs = [ks[2 * j:2 * j + 2] for j in rng.permutation(n)]
            p = codec.pack([x for pr in pairs for x in pr],
                           "begin").reshape(n, 2, w)
            return p[:, 0], p[:, 1]

        rb, re_ = rows(b * r)
        wb, we = rows(b * q)
        masks = [rng.random((b, n)) < (0.0 if i == 2 else 0.85)
                 for n in (r, q)]
        steps.append(jck.BatchTensors(
            read_begin=rb.reshape(b, r, w), read_end=re_.reshape(b, r, w),
            read_mask=masks[0], write_begin=wb.reshape(b, q, w),
            write_end=we.reshape(b, q, w), write_mask=masks[1],
            read_version=np.arange(b, dtype=np.int32),
            txn_mask=np.ones(b, bool)))
    return steps


@pytest.mark.parametrize("reads", [False, True])
def test_word_window_clip_equals_clip_batch_every_step(reads):
    """``WordWindowClip.step`` over every step of a seeded 8-step window
    equals the JAX ``clip_batch`` of every shard (lo the minimum key, hi
    +inf at the ends); the reads only with ``reads``."""
    rng = np.random.default_rng(18 + reads)
    codec = JKeyCodec(8)
    bounds = jsr.pack_splits(codec, SPLITS)
    lo, hi = bounds[:-1], bounds[1:]
    k, b, r, q = 8, 21, 3, 2
    steps = key_window(rng, codec, k, b, r, q)
    window = tck.BatchTensors(*(T(np.stack(x)) for x in zip(*steps)))
    wclip = tck.WordWindowClip.of(window, T(lo), T(hi), reads)
    assert wclip.out is None  # the CPU clips through the plain version
    emptied = 0
    for i, jb in enumerate(steps):
        step = tck._step_batch(window, i)
        clip = wclip.step(step)
        assert (clip.read_begin is None) == (not reads)
        for s in range(len(lo)):
            want = jck.clip_batch(jb, jnp.asarray(lo[s]), jnp.asarray(hi[s]))
            view = tck.clip_view(step, clip, s)
            for f in tck.BatchTensors._fields:
                if f in ("read_begin", "read_end", "read_mask") and not reads:
                    continue  # the view keeps the unclipped reads
                same(getattr(view, f), getattr(want, f), f"{i}.{s}.{f}")
            emptied += int((jb.write_mask
                            & ~np.asarray(want.write_mask)).sum())
    assert emptied > 0


@pytest.mark.parametrize("reads", [False, True])
def test_word_clip_out_is_one_allocation(reads):
    """``kernels.word_clip_out`` carves K15's six outputs, of the plain
    version's shapes and dtypes, from one allocation, the int32 ones first
    and 16-byte aligned at W = 4 (K15's vector path)."""
    s, b, r, q, w = 4, 30, 3, 2, 4
    out = K.word_clip_out(s, b, r, q, w, reads, "cpu")
    rng = np.random.default_rng(5)
    batch = tck.BatchTensors(
        *(T(rng.integers(-9, 9, shape).astype(np.int32))
          for shape in ((b, r, w), (b, r, w))),
        T(rng.random((b, r)) < 0.5),
        *(T(rng.integers(-9, 9, (b, q, w)).astype(np.int32))
          for _ in range(2)),
        T(rng.random((b, q)) < 0.5), T(np.zeros(b, np.int32)),
        T(np.ones(b, bool)))
    lo = T(np.full((s, w), -5, np.int32))
    hi = T(np.full((s, w), 5, np.int32))
    want = tck.word_clip_plain(batch, lo, hi, reads)
    for o, x in zip(out, want):
        assert (o is None) == (x is None)
        assert x is None or (o.shape == x.shape and o.dtype == x.dtype)
    base = out[0].data_ptr()
    spans = sorted((t.data_ptr() - base, t.numel() * t.element_size())
                   for t in out if t is not None)
    assert all(a + n <= c for (a, n), (c, _) in zip(spans, spans[1:]))
    kinds = [t.dtype for t in out if t is not None]
    assert kinds == [torch.int32, torch.int32, torch.bool] * (1 + reads)
    ints = [t for t in out if t is not None and t.dtype == torch.int32]
    assert all((t.data_ptr() - base) % 16 == 0 for t in ints)
    assert max(t.data_ptr() for t in ints) < min(
        t.data_ptr() for t in out if t is not None and t.dtype == torch.bool)


def shard_ranks(rng, b, r, q, space, kind):
    """One shard's clipped endpoint ranks and live masks (numpy): random,
    no live write, or every read and write on one key (every candidate
    bit of every row set)."""
    def ranks(n):
        lo = rng.integers(0, space, (b, n)).astype(np.int32)
        hi = lo + rng.integers(0, 4, (b, n)).astype(np.int32)
        return lo, hi, (rng.random((b, n)) < 0.8) & (lo < hi)

    rb, re_, rm = ranks(r)
    wb, we, wm = ranks(q)
    if kind == "none":
        wm[:] = False
    elif kind == "dense":
        rb[:], re_[:], rm[:] = 0, 5, True
        wb[:], we[:], wm[:] = 0, 5, True
    return rb, re_, rm, wb, we, wm


KINDS = {1: ["random"], 2: ["none", "dense"],
         4: ["random", "none", "random", "dense"]}


@pytest.mark.parametrize("s", [1, 2, 4])
@pytest.mark.parametrize("b", [31, 40])
def test_incremental_exchange_equals_jax(s, b):
    """The fused exchange's plain twin, shard by shard into one matrix
    (``wave_pred_or_plain``, from a matrix and stats full of garbage), and
    ``shard_pred_exchange`` equal the JAX ``_wave_exchange_and_level`` on
    S mesh devices: the OR of the shards' matrices, the stats (occupied
    tiles summed over the shards, S·(BP/32)²) and the levels of the OR;
    and ``wave_exchange_plain`` of the stacked matrices."""
    rng = np.random.default_rng(100 * s + b)
    cand = rng.random(b) < 0.85
    shards = [shard_ranks(rng, b, 2, 1, 30, kind) for kind in KINDS[s]]
    bp = (b + 31) // 32 * 32
    p = torch.full((bp, bp // 32), -1, dtype=torch.int32)
    stats = torch.full((2,), 12345, dtype=torch.int32)
    for i, ranks in enumerate(shards):
        tck.wave_pred_or_plain(T(cand), tuple(T(x) for x in ranks), p, stats,
                               i, s)
    mesh = Mesh(np.asarray(jax.devices()[:s]), (jsr.AXIS,))

    def body(base, *ranks):
        return jsr._wave_exchange_and_level(base, tuple(x[0] for x in ranks))

    fn = jax.jit(jsr._shard_map(
        body, mesh=mesh, in_specs=(P(),) + (P(jsr.AXIS),) * 6,
        out_specs=(P(), P(), P()), **jsr._SHARD_MAP_KW))
    stacked = [jnp.asarray(np.stack([r[j] for r in shards])) for j in range(6)]
    accepted, levels, jstats = fn(jnp.asarray(cand), *stacked)
    same(stats, jstats, "stats")
    want_p = functools.reduce(np.bitwise_or, [
        np.asarray(jck.wave_pred_matrix(jnp.asarray(cand),
                                        tuple(jnp.asarray(x) for x in r)))
        for r in shards])
    same(p, want_p, "or")
    got_a, got_l = tck.wave_level_from_graph(T(cand), p)
    same(got_a, accepted, "accepted")
    same(got_l, levels, "levels")
    assert int(stats[0]) > 0
    clip = tck.ShardClip(*(T(np.stack([r[j] for r in shards]))
                           for j in (3, 4, 5, 0, 1, 2)))
    out = torch.full((2,), -7, dtype=torch.int32)
    p2, st2 = tck.shard_pred_exchange(T(cand), clip, out)
    assert st2 is out
    same(p2, want_p, "shard_pred_exchange")
    same(st2, jstats, "shard_pred_exchange stats")
    p3, st3 = tck.wave_exchange_plain(torch.stack([
        tck.wave_pred_matrix_plain(T(cand), tuple(T(x) for x in r))
        for r in shards]))
    same(p3, want_p, "wave_exchange_plain")
    same(st3, jstats, "wave_exchange_plain stats")
