"""K17's live build and query, plain, against the JAX blocked range max
over all rows, on the CPU.

On the card K17 builds its blocked structure over a history's live rows
[0, n_used) only and clamps each range's end to n_used (kernels/csrc/
rmq_blocked.cu): every row at or past n_used is (+inf, NEG_VERSION)
(``tests/test_torch_live_prefix.py``), so its answers are those over all
C rows. The plain twins of that algorithm (``ops.rmq.block_table_live`` /
``range_max_blocked_live``, ``conflict_kernel.range_max_blocked_live_plain``
and, for the sharded probes, ``shard_probe_live_plain`` /
``word_shard_probe_live_plain`` with ``rmq="blocked"``) are held here
against the JAX ``block_table`` / ``range_max_blocked`` over ALL rows (and
the JAX per-shard probe lines under FDB_TPU_RMQ=blocked), on the states
of every blocked arm after several batches (a few hundred rows; 2 and 4
shards; W = 1 rank histories and W = 4 key rows): ranges starting at or
past n_used, ending at C, empty, whole prefixes, the slot bounds of
searched read rows (+inf rows included), and a full history (n_used =
C). The card versions are in ``tests/test_torch_cuda.py`` (``-k
"blocked_live or blocked_probe_over"``), which skip here: a CUDA kernel
has no CPU mode. Exact tolerance (integers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.ops import lex as jlex
from foundationdb_tpu.ops import rmq as jrmq
from foundationdb_tpu_torch import TorchConflictSet, convert
from foundationdb_tpu_torch.models import conflict_kernel as tck
from foundationdb_tpu_torch.ops.lex import searchsorted_words
from foundationdb_tpu_torch.ops.rmq import (
    block_table_live,
    range_max_blocked_live,
)
from foundationdb_tpu_torch.parallel import sharded_resolver as tsr
from tests.test_conflict_oracle import rand_txn
from tests.test_torch_conflict_kernel import T, same
from tests.test_torch_conflict_set import port_txn
from tests.test_torch_sharded_arms import _jax_rank_shard, _jax_word_shard

torch.set_num_threads(1)

NEG = tck.NEG_VERSION
I32MAX = tck.INT32_MAX
KW = dict(capacity=300, batch_size=24, max_read_ranges=4,
          max_write_ranges=4)

# Every blocked arm of the single engine: (constructor arguments, W).
ARMS = {
    "resident_two_level": (dict(delta_capacity=64), 1),
    "resident_flat": (dict(history="batch", delta_capacity=None), 1),
    "packed_two_level": (dict(resident=False, delta_capacity=64), 4),
    "packed_flat": (dict(resident=False, history="batch"), 4),
    "unpacked_two_level": (dict(packed=False, delta_capacity=64), 4),
    "unpacked_flat": (dict(packed=False, history="batch"), 4),
}


@jax.jit
def _jax_range_max(versions, lo, hi):
    """The JAX blocked range max over all rows of ``versions``."""
    return jrmq.range_max_blocked(jrmq.block_table(versions, NEG), lo, hi,
                                  NEG)


def _drive(cs, rng, batches: int = 8, window: int = 60) -> None:
    """``batches`` batches of 20 random txns; rows older than ``window``
    versions are collected."""
    cv = 100
    for i in range(batches):
        cv += 10
        txns = [port_txn(rand_txn(rng, read_version=int(rng.integers(
            cv - 40, cv)), alphabet=256, max_len=4)) for _ in range(20)]
        cs.resolve(txns, cv, cv - window)


def _levels(state):
    """(name, keys [S, C, W], versions [S, C], n_used [S]) of every
    history level of an engine state (numpy)."""
    leaves = convert.state_leaves(state)
    for p in [k[:-4] for k in leaves if k.endswith("keys")
              and not k.endswith(("dict_keys", "n_keys"))]:
        keys = np.asarray(leaves[p + "keys"])
        keys = keys.reshape(-1, *keys.shape[-2:])
        vers = np.asarray(leaves[p + "versions"]).reshape(keys.shape[:2])
        yield p, keys, vers, np.asarray(leaves[p + "n_used"]).reshape(-1)


def _check_level(rng, keys, vers, n: int, what: str) -> None:
    """One history level: the live twin's range max against JAX's over all
    rows, on adversarial index ranges and on the bounds of searched read
    rows (upper bound of the begin - 1, lower bound of the end)."""
    c, w = keys.shape
    m = 400
    lo = rng.integers(0, c + 1, m)
    hi = np.minimum(lo + rng.integers(-2, c // 2 + 3, m), c)
    lo[:40] = rng.integers(min(n, c), c + 1, 40)  # at or past n_used
    hi[40:80] = c  # ending at C
    hi[80:120] = lo[80:120]  # empty
    lo[120:160] = 0  # whole prefixes
    lo, hi = lo.astype(np.int32), hi.astype(np.int32)
    bt = block_table_live(T(vers), n, NEG)
    same(range_max_blocked_live(bt, T(lo), T(hi), n, NEG),
         np.asarray(_jax_range_max(vers, lo, hi)), f"{what} ranges")
    rows = keys[rng.integers(0, max(n, 1), (m, 2))].copy()
    rows[..., -1] += rng.integers(-1, 2, (m, 2)).astype(np.int32)
    rows[:20, 1] = I32MAX  # ending at +inf
    rows[20:30] = I32MAX  # begin and end at +inf
    qb, qe = rows[:, 0], rows[:, 1]
    a = searchsorted_words(T(keys), T(qb), side="right") - 1
    z = searchsorted_words(T(keys), T(qe), side="left")
    got = tck.range_max_blocked_live_plain(T(vers), n, a.clamp(min=0).int(),
                                           z.int())
    same(got, np.asarray(_jax_word_shard(keys, vers, qb, qe)),
         f"{what} slots")


@pytest.mark.parametrize("arm", list(ARMS))
def test_live_twin_equals_jax_over_all_rows(arm):
    """Every level of every blocked arm's state after 8 batches: the live
    build and query over [0, n_used) give JAX's ``range_max_blocked`` over
    all C rows."""
    rng = np.random.default_rng(len(arm))
    extra, w = ARMS[arm]
    kw = dict(KW, max_key_bytes=8 if w == 1 else 12, **extra)
    cs = TorchConflictSet(device="cpu", rmq="blocked", **kw)
    _drive(cs, rng)
    levels = list(_levels(cs.state))
    assert levels and all(k.shape[-1] == w for _, k, _, _ in levels)
    for name, keys, vers, n_used in levels:
        n = int(n_used[0])
        assert (keys[0, n:] == I32MAX).all() and (vers[0, n:] == NEG).all()
        _check_level(rng, keys[0], vers[0], n, f"{arm} {name}")


@pytest.mark.parametrize("c", [255, 256, 300, 513])
@pytest.mark.parametrize("w", [1, 4])
def test_live_twin_on_a_full_history(c, w):
    """A full history (n_used = C: every row live, a last block cut short
    or whole): the live twin equals JAX over all rows."""
    rng = np.random.default_rng(c + w)
    span = 5000 if w == 1 else 50
    keys = np.unique(rng.integers(-span, span, (4 * c, w)).astype(np.int32),
                     axis=0)
    keys = keys[np.sort(rng.choice(len(keys), c, replace=False))]
    vers = rng.integers(-100, 100, c).astype(np.int32)
    vers[rng.random(c) < 0.2] = NEG
    _check_level(rng, keys, vers, c, f"full C = {c}, W = {w}")


@pytest.mark.parametrize("s", [2, 4])
@pytest.mark.parametrize("resident", [True, False])
def test_sharded_live_twin_equals_jax_per_shard(resident, s):
    """The blocked sharded arms (``ShardedConflictSet(rmq="blocked")``,
    resident at W = 1 and non-resident at W = 4) after 8 batches: each
    shard's level as above, and the sharded probe's live twin
    (``shard_probe_live_plain`` / ``word_shard_probe_live_plain`` with
    ``rmq="blocked"``: fences, searches and the blocked range max over
    each shard's live rows) against the JAX per-shard probe under
    FDB_TPU_RMQ=blocked over all rows, OR-ed; reads clipped to nothing,
    spanning every shard, ending at +inf."""
    rng = np.random.default_rng(s + 10 * resident)
    splits = [bytes([int(x)]) for x in np.linspace(0, 256, s + 1)[1:-1]]
    kw = dict(KW, max_key_bytes=8 if resident else 12)
    if resident:
        kw["dict_capacity"] = 512
    cs = tsr.ShardedConflictSet(n_shards=s, device="cpu", auto_reshard=False,
                                splits=splits, rmq="blocked",
                                resident=resident, **kw)
    _drive(cs, rng)
    st = cs.state
    hist = st.hist if resident else st
    keys, vers, n_used = (x.numpy() for x in (hist.keys, hist.versions,
                                              hist.n_used))
    for d in range(s):
        _check_level(rng, keys[d], vers[d], int(n_used[d]),
                     f"shard {d} of {s}")
    b, r, w = 32, 4, keys.shape[-1]
    mask = rng.random((b, r)) < 0.9
    rv = rng.integers(60, 200, b).astype(np.int32)
    txn = rng.random(b) < 0.95
    floor = T(np.int32(0))
    want = np.zeros((b, r), bool)
    if resident:
        lo, hi = st.shard_lo.numpy(), st.shard_hi.numpy()
        top = int(st.n_keys)
        rb = rng.integers(0, top + 2, (b, r)).astype(np.int32)
        re_ = rb + rng.integers(-1, max(top // 3, 2), (b, r)).astype(np.int32)
        re_[0] = I32MAX
        rb[1], re_[1] = 0, I32MAX  # every shard
        rbk = tck.RankBatch(T(rb), T(re_), T(mask), T(rb), T(re_), T(mask),
                            T(rv), T(txn), T(np.zeros(2 * b * r, np.int32)))
        _, hit, _ = tck.shard_probe_live_plain(hist, rbk, T(lo), T(hi),
                                               floor, rmq="blocked")
        for d in range(s):
            cb = np.minimum(np.maximum(rb, lo[d]), hi[d])
            ce = np.minimum(np.maximum(re_, lo[d]), hi[d])
            newest = np.asarray(_jax_rank_shard(
                keys[d], vers[d], cb.reshape(-1), ce.reshape(-1)))
            want |= (mask & (cb < ce)) & (newest.reshape(b, r)
                                          > rv[:, None])
        same(hit, want.any(1), "resident hist_conflict")
        return
    lo, hi = cs._lo, cs._hi
    rows = keys[rng.integers(0, s, (b, r, 2)),
                rng.integers(0, max(int(n_used.min()), 1), (b, r, 2))]
    rb, re_ = rows[..., 0, :].copy(), rows[..., 1, :].copy()
    re_[0] = I32MAX
    rb[1], re_[1] = lo[0], I32MAX  # every shard
    z3 = np.zeros((b, 1, w), np.int32)
    batch = tck.BatchTensors(T(rb), T(re_), T(mask), T(z3), T(z3),
                             T(np.zeros((b, 1), bool)), T(rv), T(txn))
    _, got, _, _ = tck.word_shard_probe_live_plain(
        hist, batch, T(lo), T(hi), floor, rmq="blocked")
    for d in range(s):
        cb = np.asarray(jlex.lex_max(jnp.asarray(rb), jnp.asarray(lo[d])))
        ce = np.asarray(jlex.lex_min(jnp.asarray(re_), jnp.asarray(hi[d])))
        newest = np.asarray(_jax_word_shard(
            keys[d], vers[d], cb.reshape(-1, w), ce.reshape(-1, w)))
        live = mask & np.asarray(jlex.lex_lt(jnp.asarray(cb),
                                             jnp.asarray(ce)))
        want |= live & (newest.reshape(b, r) > rv[:, None])
    same(got, want, "non-resident hist_mask")
