"""Port conflict kernel (plain torch versions) vs the JAX kernel.

Inputs are captured from a JAX resident engine driving a small
high-conflict stream (capacities tiny enough that folds, full repacks
and capacity pressure all occur), plus synthetic arrays from seeded
numpy draws. Each input goes through the JAX function (CPU, jitted) and
the port's plain version; every output — verdicts, masks, every state
leaf, n_used, oldest, overflow — must be equal byte for byte.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.models import conflict_kernel as jck
from foundationdb_tpu.models.conflict_set import TPUConflictSet
from foundationdb_tpu_torch.convert import STATE_FIELDS, state_leaves
from foundationdb_tpu_torch.models import conflict_kernel as tck
from tests.test_conflict_oracle import rand_txn

NEG = tck.NEG_VERSION
I32MAX = tck.INT32_MAX

# Small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the CPU.
torch.set_num_threads(1)


def T(x):
    return torch.from_numpy(np.array(x, copy=True))


def t_state(js):
    return tck.ConflictState(*(T(getattr(js, f)) for f in STATE_FIELDS))


def t_hist(jh):
    return tck.HistState(t_state(jh.base), T(jh.base_st), t_state(jh.delta))


def t_res(jr):
    return tck.ResState(T(jr.dict_keys), T(jr.n_keys), t_hist(jr.hist),
                        T(jr.shard_lo), T(jr.shard_hi))


def t_ranks(jrb):
    return tck.RankBatch(*(T(x) for x in jrb))


def same(t, j, what=""):
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    b = np.asarray(j)
    if b.dtype == np.uint32:
        a = a.view(np.uint32)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


def same_state(t, j, what=""):
    for f in STATE_FIELDS:
        same(getattr(t, f), getattr(j, f), f"{what}.{f}")


def same_res(t, j):
    tl, jl = state_leaves(t), state_leaves(j)
    assert tl.keys() == jl.keys()
    for k in tl:
        same(tl[k], jl[k], k)


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


@pytest.fixture(scope="module")
def steps():
    """(res_before, ResidentBatch, cv, oldest, jax outputs) for each chunk
    of a JAX resident engine's stream, plus the repack calls it made."""
    rng = np.random.default_rng(42)
    cs = TPUConflictSet(resident=True, capacity=48, batch_size=32,
                        max_read_ranges=2, max_write_ranges=2,
                        max_key_bytes=8, dict_capacity=96,
                        dict_delta_slots=40)
    repacks = []
    orig = cs._repack_fn

    def recording(state, new_dict, new_n, remap):
        repacks.append((_np_tree(state), np.array(new_dict), int(new_n),
                        np.array(remap)))
        return orig(state, new_dict, new_n, remap)

    cs._repack_fn = recording
    out = []
    cv = 1000
    for _ in range(10):
        cv += int(rng.integers(1, 30))
        txns = [rand_txn(rng, read_version=int(rng.integers(cv - 60, cv)),
                         n_ranges=2, alphabet=4, max_len=3)
                for _ in range(int(rng.integers(8, 33)))]
        cs._begin_resolve(cv, cv - 50)
        cvr = np.int32(cs._rel(cv))
        old = np.int32(cs._rel(cs.oldest_version))
        bt = cs._pack(txns)
        rb = _np_tree(cs._dev_batch(bt))
        before = _np_tree(cs.state)
        res = jck._resolve_res_jit(cs.state, rb, cvr, old)
        cs.state = res[-1]
        out.append((before, rb, int(cvr), int(old), _np_tree(res)))
    assert repacks, "the stream must force at least one full repack"
    return out, repacks


_jit_resolve = jax.jit(jck.resolve_batch_res, static_argnames=("report",))


@pytest.mark.parametrize("report", [False, True])
def test_resolve_batch_res(steps, report):
    for i, (res, rb, cv, old, _) in enumerate(steps[0]):
        want = _jit_resolve(res, rb, np.int32(cv), np.int32(old),
                            report=report)
        got = tck.resolve_batch_res(
            t_res(res), tck.ResidentBatch(T(rb.delta_keys), t_ranks(rb.ranks)),
            cv, old, report=report)
        same(got[0], want[0], f"step {i} verdicts")
        if report:
            same(got[1], want[1], f"step {i} losers")
        same_res(got[-1], want[-1])


def test_apply_delta_empty_and_nonempty(steps):
    kinds = set()
    for res, rb, *_ in steps[0]:
        nonempty = bool((rb.delta_keys != I32MAX).any())
        kinds.add(nonempty)
        want = jax.jit(jck.apply_delta)(res, rb.delta_keys)
        same_res(tck.apply_delta(t_res(res), T(rb.delta_keys)), want)
    assert kinds == {True, False}


def test_maybe_merge_taken_and_skipped_and_merge_delta(steps):
    taken = set()
    for res, rb, cv, old, _ in steps[0]:
        hist = jax.jit(jck.apply_delta)(res, rb.delta_keys).hist
        floor = np.int32(max(int(hist.delta.oldest), old))
        r = rb.ranks
        demand = 2 * int((r.write_mask & (r.write_begin < r.write_end)).sum())
        want = jax.jit(jck._maybe_merge)(hist, np.int32(demand), floor)
        got = tck._maybe_merge(t_hist(hist), demand, T(floor))
        taken.add(int(np.asarray(want.base.n_used)) != int(hist.base.n_used)
                  or not np.array_equal(want.base.versions, hist.base.versions))
        same_state(got.base, want.base, "base")
        same(got.base_st, want.base_st, "base_st")
        same_state(got.delta, want.delta, "delta")
        same_state(tck._merge_delta(t_state(hist.base), t_state(hist.delta),
                                    T(floor)),
                   jax.jit(jck._merge_delta)(hist.base, hist.delta, floor),
                   "merge")
    assert taken == {True, False}


@pytest.mark.parametrize("c_out", [8, 64])
def test_dedup_compact_runs_and_overflow(c_out):
    rng = np.random.default_rng(c_out)
    n = 80
    ranks = np.sort(rng.integers(0, 12, size=n - 10)).astype(np.int32)
    ranks[:7] = 0  # a long min-key run
    skeys = np.concatenate([ranks, np.full(10, I32MAX, np.int32)])[:, None]
    newv = rng.integers(0, 3, size=n).astype(np.int32)
    newv[-10:] = NEG
    for prior in (False, True):
        want = jax.jit(jck._dedup_compact, static_argnums=2)(
            skeys, newv, c_out, jnp.bool_(prior))
        got = tck._dedup_compact(T(skeys), T(newv), c_out,
                                 torch.tensor(prior))
        for g, w, name in zip(got, want, ("keys", "versions", "n_used",
                                          "overflow")):
            same(g, w, name)
    assert bool(want[3]) == (c_out == 8) or prior


def test_history_probe(steps):
    for res, rb, cv, old, _ in steps[0]:
        hist = jax.jit(jck.apply_delta)(res, rb.delta_keys).hist
        floor, too_old = jax.jit(jck.too_old_mask_packed)(hist.delta,
                                                          rb.ranks, old)
        mask = jax.jit(jck._history_conflict_ranges_hist_res)(
            hist.base, hist.base_st, hist.delta, rb.ranks)
        cand = rb.ranks.txn_mask & ~np.asarray(too_old) \
            & ~np.asarray(mask).any(1)
        t_floor, _ = tck.too_old_mask_packed(t_state(hist.delta),
                                             t_ranks(rb.ranks), old)
        same(t_floor, floor, "floor")
        got = tck.history_probe(t_hist(hist), t_ranks(rb.ranks), t_floor)
        for g, w, name in zip(got, (too_old, mask, cand),
                              ("too_old", "hist_mask", "cand")):
            same(g, w, name)


@pytest.mark.parametrize("b", [1024, 64, 100])
def test_block_accept_fused(b):
    rng = np.random.default_rng(b)
    r, q, space = 2, 1, 48
    rb = rng.integers(0, space, size=(b, r)).astype(np.int32)
    re_ = rb + rng.integers(1, 4, size=(b, r)).astype(np.int32)
    wb = rng.integers(0, space, size=(b, q)).astype(np.int32)
    we = wb + rng.integers(1, 4, size=(b, q)).astype(np.int32)
    read_live = rng.random((b, r)) < 0.9
    write_live = rng.random((b, q)) < 0.6
    base = rng.random(b) < 0.9
    want = jax.jit(jck._block_accept_fused)(base, rb, re_, read_live, wb, we,
                                            write_live)
    got = tck._block_accept_fused(*(T(x) for x in (base, rb, re_, read_live,
                                                   wb, we, write_live)))
    same(got, want, "accepted")
    too_old = rng.random(b) < 0.05
    txn_mask = base | too_old
    same(tck.accept(T(base), T(too_old), T(txn_mask),
                    tuple(T(x) for x in (rb, re_, read_live, wb, we,
                                         write_live)))[1],
         jck.assemble_verdicts(too_old, txn_mask, want), "verdicts")


def test_paint_loser_mask(steps):
    for res, rb, cv, old, _ in steps[0]:
        hist = jax.jit(jck.apply_delta)(res, rb.delta_keys).hist
        floor = np.int32(max(int(hist.delta.oldest), old))
        ranks = jck.endpoint_ranks_live_packed(rb.ranks)
        base = rb.ranks.txn_mask
        accepted = jax.jit(jck._block_accept_fused)(base, *ranks)
        want = jax.jit(jck._paint_and_compact_res)(hist.delta, rb.ranks,
                                                   accepted, cv, floor)
        got = tck._paint_and_compact_res(t_state(hist.delta),
                                         t_ranks(rb.ranks), T(accepted), cv,
                                         T(floor))
        same_state(got, want, "paint")
        hist_mask = jax.jit(jck._history_conflict_ranges_hist_res)(
            hist.base, hist.base_st, hist.delta, rb.ranks)
        verdicts = jck.assemble_verdicts(np.zeros_like(base), base, accepted)
        wl = jax.jit(lambda *a: jck.pack_loser_mask(jck.loser_range_mask(
            a[0], a[1:7], a[7], a[8])))(hist_mask, *ranks, accepted,
                                        verdicts)
        gl = tck.loser_mask(T(hist_mask), tuple(T(x) for x in ranks),
                            T(accepted), T(verdicts))
        same(gl, wl, "losers")


def test_advance_rebase_remap(steps):
    res, rb, cv, old, _ = steps[0][-1]
    want = jax.jit(jck.advance_hist)(res.hist, np.int32(cv), np.int32(old + 7))
    got = tck.advance_hist(t_hist(res.hist), cv, old + 7)
    same_state(got.base, want.base, "base")
    same(got.base_st, want.base_st, "base_st")
    same_state(got.delta, want.delta, "delta")
    for d in (1, old, 2**31 - 1):
        same_res(tck.rebase_res(t_res(res), d),
                 jax.jit(jck._rebase_res_jit.__wrapped__)(res, np.int32(d)))
    for state, new_dict, new_n, remap in steps[1]:
        want = jax.jit(jck.apply_dict_remap)(state, new_dict, np.int32(new_n),
                                             remap)
        same_res(tck.apply_dict_remap(t_res(state), new_dict, new_n, remap),
                 want)
