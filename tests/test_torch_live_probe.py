"""K8's and K16's live-prefix probe (``kernels/csrc/live_probe.cuh``),
its plain twin against the JAX package on the CPU.

The kernels read each shard's rows [0, n_used[s]) only: fences of evenly
spaced live rows, a binary search between them, and a range max from a
table over the live rows (levels 1..LIVE_LEVELS of the windowed max and a
sparse table over blocks of 2^LIVE_LEVELS rows).
``tck.live_probe_plain`` does the same steps; here it is held equal to the
JAX probe halves of ``_res_shard_step`` (``too_old_mask_packed``,
``clip_ranks`` and ``_history_conflict_ranges_res`` per shard, OR-ed: K8)
and of ``_sharded_resolve`` (``too_old_mask``, ``clip_batch`` and
``_history_conflict_ranges`` per shard, OR-ed: K16), at the kernel's
fences and levels and at settings that force every branch at small C (no
fences, one, three; levels 1 and 2, so that ranges of 4 or 8 rows read
the top). States: random live counts, shards with n_used = 1 and = C, an
empty shard (lo = hi); reads of all INT32_MAX words, spanning every shard
or one shard whole, ending at +inf, begin = end, below every shard
(clipped empty); S = 1 without bounds; B = 30, 33 and 64. Exact tolerance
(integers). On the card, ``tests/test_torch_cuda.py`` holds the kernels
to the plain versions on the same cases.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.models import conflict_kernel as jck
from foundationdb_tpu_torch import kernels as K
from foundationdb_tpu_torch.models import conflict_kernel as tck
from tests.test_torch_conflict_kernel import T, same
from tests.test_torch_cuda import (
    live_counts,
    rank_reads,
    rank_shards,
    word_reads,
    word_shards,
)

torch.set_num_threads(1)

I32MAX, NEG = tck.INT32_MAX, tck.NEG_VERSION
J = {"res": jax.jit(jck._history_conflict_ranges_res),
     "words": jax.jit(jck._history_conflict_ranges)}
# (fences, levels) of the twin: the kernel's, then settings that force the
# unfenced search, a single fence, uneven fence groups and the top.
PLANS = [(None, K.LIVE_LEVELS), (0, K.LIVE_LEVELS), (1, 1), (3, 2)]
C = 64


# ------------------------------------------------------------------ K8


@pytest.mark.parametrize("s,b,kind", [(4, 30, "random"), (4, 64, "edge"),
                                      (1, 33, "random")])
def test_k8_live_twin_equals_jax_res_shard_step(s, b, kind):
    """K8's twin (``shard_probe_live_plain``) against the probe half of
    the JAX ``_res_shard_step`` on every shard, OR-ed, and against the
    port's reference ``shard_probe_plain``."""
    rng = np.random.default_rng(s * b)
    span = 3 * C
    keys, vers, lo, hi = rank_shards(rng, live_counts(rng, kind, s, C), C,
                                     span)
    n_used = (keys[..., 0] != I32MAX).sum(1).astype(np.int32)
    if kind == "edge":
        hi[1] = lo[1]  # an empty shard: every read clips to nothing there
    r = 3
    rb, re_, mask = rank_reads(rng, b, r, lo, hi, s * span + 5)
    rv = rng.integers(0, 60, b).astype(np.int32)
    txn = rng.random(b) < 0.9
    jrb = jck.RankBatch(rb, re_, mask, rb, re_, np.zeros((b, r), bool), rv,
                        txn, np.zeros(2 * b * r, np.int32))
    hit = np.zeros(b, bool)
    for d in range(s):
        hs = jck.ConflictState(keys[d], vers[d], np.int32(n_used[d]),
                               np.int32(4), np.bool_(False))
        floor, too_old = jck.too_old_mask_packed(hs, jrb, jnp.int32(9))
        local = jck.clip_ranks(jrb, jnp.int32(lo[d]), jnp.int32(hi[d]))
        hit |= np.asarray(J["res"](hs, local)).any(1)
        if d == 0:
            floor0, too_old0 = np.int32(floor), np.asarray(too_old)
    assert hit.any() and not hit.all()
    want = (too_old0, hit, txn & ~too_old0 & ~hit)
    hist = tck.ConflictState(T(keys), T(vers), T(n_used),
                             T(np.full(s, 4, np.int32)), T(np.zeros(s, bool)))
    trb = tck.RankBatch(*(T(x) for x in jrb))
    for fences, levels in PLANS:
        got = tck.shard_probe_live_plain(hist, trb, T(lo), T(hi), T(floor0),
                                         fences, levels)
        for g, w, name in zip(got, want, ("too_old", "hit", "cand")):
            same(g, w, f"{name} at {fences} fences, {levels} levels")
    for g, w in zip(tck.shard_probe_plain(hist, trb, T(lo), T(hi),
                                          T(floor0)), want):
        same(g, w, "shard_probe_plain")


# ----------------------------------------------------------------- K16


@pytest.mark.parametrize("s,b,kind", [(3, 30, "random"), (3, 64, "edge"),
                                      (1, 33, "flat")])
def test_k16_live_twin_equals_jax_sharded_resolve(s, b, kind):
    """K16's twin (``word_shard_probe_live_plain``) against the probe half
    of the JAX ``_sharded_resolve`` on every shard, OR-ed (S = 1 without
    bounds: the single flat engine's ``_history_conflict_ranges``), and
    against the port's reference ``word_shard_probe_plain``."""
    rng = np.random.default_rng(s * b + 1)
    w, r = 3, 3
    keys, vers, lo, hi = word_shards(rng, live_counts(rng, kind, s, C), C, w)
    n_used = (keys[..., 0] != I32MAX).sum(1).astype(np.int32)
    if kind == "edge":
        hi[1] = lo[1]
    rb, re_, mask = word_reads(rng, b, r, w, s, lo, hi)
    rv = rng.integers(0, 60, b).astype(np.int32)
    txn = rng.random(b) < 0.9
    bt = jck.BatchTensors(rb, re_, mask, rb, re_, np.zeros((b, r), bool), rv,
                          txn)
    hist_mask = np.zeros((b, r), bool)
    for d in range(s):
        hs = jck.ConflictState(keys[d], vers[d], np.int32(n_used[d]),
                               np.int32(4), np.bool_(False))
        floor, too_old = jck.too_old_mask(hs, bt, jnp.int32(9))
        local = bt if kind == "flat" else jck.clip_batch(
            bt, jnp.asarray(lo[d]), jnp.asarray(hi[d]))
        hist_mask |= np.asarray(J["words"](hs, local))
        if d == 0:
            floor0, too_old0 = np.int32(floor), np.asarray(too_old)
    hit = hist_mask.any(1)
    assert hit.any() and not hit.all()
    want = (too_old0, hist_mask, hit, txn & ~too_old0 & ~hit)
    hist = tck.ConflictState(T(keys), T(vers), T(n_used),
                             T(np.full(s, 4, np.int32)), T(np.zeros(s, bool)))
    tb = tck.BatchTensors(*(T(x) for x in bt))
    tlo, thi = (None, None) if kind == "flat" else (T(lo), T(hi))
    for fences, levels in PLANS:
        got = tck.word_shard_probe_live_plain(hist, tb, tlo, thi, T(floor0),
                                              fences, levels)
        for g, x, name in zip(got, want, ("too_old", "hist_mask", "hit",
                                          "cand")):
            same(g, x, f"{name} at {fences} fences, {levels} levels")
    for g, x in zip(tck.word_shard_probe_plain(hist, tb, tlo, thi,
                                               T(floor0)), want):
        same(g, x, "word_shard_probe_plain")


# ------------------------------------------------------- the live table


@pytest.mark.parametrize("n", [1, 7, 300])
def test_live_range_max_equals_every_range(n):
    """``live_table_plain`` + ``live_range_max_plain`` give max(v[a:z]) for
    every 0 <= a <= z <= n (NEG_VERSION when empty) at levels 1, 2 and
    the kernel's: single rows, each level and the top's branch."""
    rng = np.random.default_rng(n)
    v = rng.integers(-50, 50, n).astype(np.int32)
    a, z = np.triu_indices(n + 1)
    want = np.array([v[i:j].max() if j > i else NEG for i, j in zip(a, z)],
                    np.int32)
    for levels in (1, 2, K.LIVE_LEVELS):
        rows, top = tck.live_table_plain(T(v), levels)
        same(tck.live_range_max_plain(rows, top, T(a.astype(np.int32)),
                                      T(z.astype(np.int32)), levels), want,
             f"levels {levels}")


def test_live_constants_match_the_header():
    """``kernels.LIVE_LEVELS``, the fence budget and the workspace size
    (``live_table_words``) follow ``csrc/live_probe.cuh``."""
    text = (Path(K.__file__).resolve().parent / "csrc"
            / "live_probe.cuh").read_text()

    def define(name):
        return int(re.search(rf"#define {name} \(?(\d+)", text).group(1))

    assert define("LP_LV") == K.LIVE_LEVELS
    assert K.LIVE_BLOCK == 1 << K.LIVE_LEVELS
    assert define("LP_MAX_FENCES") == K.LIVE_MAX_FENCES
    assert define("LP_FENCE_WORDS") == K.LIVE_FENCE_WORDS
    for s, c in ((1, 1), (4, 1 << 20), (3, 257), (8, 300)):
        nb = -(-c // K.LIVE_BLOCK)
        levels = int(np.floor(np.log2(nb))) + 1
        assert K.live_table_words(s, c) == K.LIVE_LEVELS * s * c \
            + levels * s * nb
    assert K.live_fences(4, 1) == 1024 and K.live_fences(4, 4) == 512
    assert K.live_fences(9000, 1) == 0


def test_live_probe_wrappers_refuse_cpu_tensors():
    """K8's and K16's wrappers take CUDA tensors only (the plain versions
    run on the CPU through ``ck.shard_probe`` / ``ck.word_shard_probe``)."""
    keys = torch.zeros((2, 8, 1), dtype=torch.int32)
    v = torch.zeros((2, 8), dtype=torch.int32)
    n = torch.ones(2, dtype=torch.int32)
    rb = torch.zeros((4, 2), dtype=torch.int32)
    m = torch.ones((4, 2), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.shard_probe(keys, v, n, rb, rb, m, rb[:, 0], m[:, 0], n, n, n[0])
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.word_shard_probe(keys, v, n, rb[..., None], rb[..., None], m,
                           rb[:, 0], m[:, 0], None, None, n[0])
