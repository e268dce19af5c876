"""Port conflict kernel (plain torch versions) vs the JAX kernel.

Inputs are captured from a JAX resident engine driving a small
high-conflict stream (capacities tiny enough that folds, full repacks
and capacity pressure all occur), plus synthetic arrays from seeded
numpy draws. Each input goes through the JAX function (CPU, jitted) and
the port's plain version; every output — verdicts, masks, every state
leaf, n_used, oldest, overflow — must be equal byte for byte.
"""

import bisect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.models import conflict_kernel as jck
from foundationdb_tpu.models.conflict_set import TPUConflictSet
from foundationdb_tpu_torch.convert import STATE_FIELDS, state_leaves
from foundationdb_tpu_torch.models import conflict_kernel as tck
from foundationdb_tpu.ops import bitset as jbits
from tests.test_conflict_oracle import rand_txn
from tests.test_torch_cuda import accept_graph

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


def _graph(b, kind):
    """An adversarial acceptance graph (``tests/test_torch_cuda``'s), or a
    seeded random one."""
    if kind != "random":
        return accept_graph(b, kind)
    rng = np.random.default_rng(b)
    rb = rng.integers(0, 48, size=(b, 2)).astype(np.int32)
    wb = rng.integers(0, 48, size=(b, 1)).astype(np.int32)
    cand = rng.random(b) < 0.85
    ranks = (rb, rb + rng.integers(1, 4, size=(b, 2)).astype(np.int32),
             rng.random((b, 2)) < 0.9, wb,
             wb + rng.integers(1, 4, size=(b, 1)).astype(np.int32),
             rng.random((b, 1)) < 0.6)
    return cand, ~cand & (rng.random(b) < 0.3), np.ones(b, bool), ranks


@pytest.mark.parametrize("b", [1, 31, 33, 511, 513, 1024])
@pytest.mark.parametrize("kind", ["hot", "chain", "cross", "noncand",
                                  "nocand", "free", "random"])
def test_accept_rows_and_settle_match_jax(b, kind):
    """K3's design through its plain twins: the overlap rows restricted to
    candidate rows and columns equal JAX ``_overlap_rows`` so masked and
    packed; the settle (candidates with no bit at once, rows meeting them
    rejected at once, a walk over the rest in index order) gives JAX
    ``_block_accept_fused``'s accepted set, and within one 32-aligned batch
    ``_wave_accept_packed``'s over the same packed rows."""
    cand, too_old, txn_mask, ranks = _graph(b, kind)
    nw = (b + 31) // 32
    m = np.asarray(jax.jit(jck._overlap_rows)(*ranks))
    m = m & cand[:, None] & cand[None, :] & np.tri(b, k=-1, dtype=bool)
    m = np.pad(m, ((0, 0), (0, nw * 32 - b)))
    want_rows = np.asarray(jax.jit(jbits.pack_bits_u32)(m))
    rows, first, last = tck.accept_rows_plain(
        T(cand), tuple(T(x) for x in ranks))
    same(rows, want_rows, "rows")
    nz = want_rows != 0
    assert (last.numpy() >= 0).tolist() == nz.any(1).tolist()
    for i in np.nonzero(nz.any(1))[0]:
        w = np.nonzero(nz[i])[0]
        assert (first[i], last[i]) == (w[0], w[-1])
    want = jax.jit(jck._block_accept_fused)(cand, *ranks)
    acc, pending = tck.settle_plain(T(cand), rows, first, last)
    same(acc, want, "accepted")
    assert pending.tolist() == sorted(pending.tolist())
    if b % 32 == 0:
        same(acc, jax.jit(jck._wave_accept_packed)(cand, want_rows),
             "accepted (wave)")
    counts = tck.accept_counts(T(cand), T(too_old), T(txn_mask),
                               tuple(T(x) for x in ranks))
    assert counts["pending_rows"] == pending.numel()
    assert counts["edgeful_rows"] == int(nz.any(1).sum())


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


# --- K4's and K1's tile designs (plain twins) against the JAX functions ---

_jit_paint = jax.jit(jck._paint_and_compact_res)
_jit_merge = jax.jit(jck._merge_delta)
_jit_compact = jax.jit(jck._dedup_compact, static_argnums=2)
_jit_maybe_merge = jax.jit(jck._maybe_merge)
_jit_insert = jax.jit(jck._dict_insert)


def _state_np(rng, c, live, lo_v, hi_v, space=None):
    """A width-1 history of ``live`` boundaries (rank 0 first, sorted,
    unique) in capacity ``c``: numpy (keys [c, 1], versions, n_used)."""
    space = space or 4 * c
    keys = np.full(c, I32MAX, np.int32)
    keys[:live] = np.sort(rng.choice(np.arange(1, space), live, replace=False))
    keys[0] = 0
    vers = np.full(c, NEG, np.int32)
    vers[:live] = rng.integers(lo_v, hi_v, live)
    return keys[:, None], vers, np.int32(live)


def _jstate(keys, vers, n_used, oldest=0, overflow=False):
    return jck.ConflictState(jnp.asarray(keys), jnp.asarray(vers),
                             jnp.int32(n_used), jnp.int32(oldest),
                             jnp.bool_(overflow))


def _paint_case(rng, kind, c, b, q):
    """(state, RankBatch fields, accepted, cv, floor) of one adversarial
    paint, numpy."""
    live = {"overflow": c - 2, "full": c}.get(kind, c // 3)
    keys, vers, n_used = _state_np(rng, c, live, 0, 60)
    space = int(keys[n_used - 1, 0]) + 20
    wb = rng.integers(0, space, (b, q)).astype(np.int32)
    we = (wb + rng.integers(1, 6, (b, q))).astype(np.int32)
    mask = rng.random((b, q)) < 0.8
    acc = rng.random(b) < 0.7
    floor = 10
    if kind == "one_rank":  # every endpoint on one rank
        wb[:] = 7
        we[:] = 7
        mask[:] = True
    elif kind == "one_rank_ranges":  # begins on one rank, ends on another
        wb[:] = 5
        we[:] = 9
    elif kind == "none_accepted":
        acc[:] = False
    elif kind == "below_floor":  # every row expires
        floor = 1000
    elif kind == "masked_inf":  # masked slots carry INT32_MAX ranks
        wb[~mask] = I32MAX
        we[~mask] = I32MAX
    elif kind == "empty_ranges":
        we[:] = wb
    ends = np.concatenate([wb.reshape(-1), we.reshape(-1)])
    src = np.argsort(ends, kind="stable").astype(np.int32)
    rv = np.zeros(b, np.int32)
    ranks = (np.zeros((b, 1), np.int32), np.zeros((b, 1), np.int32),
             np.zeros((b, 1), bool), wb, we, mask, rv, np.ones(b, bool), src)
    return (keys, vers, n_used), ranks, acc, 77, floor


_PAINT_KINDS = ["random", "one_rank", "one_rank_ranges", "none_accepted",
                "below_floor", "overflow", "full", "masked_inf",
                "empty_ranges"]


@pytest.mark.parametrize("tile", [1, 3, 8, 64, tck.K4_TILE])
@pytest.mark.parametrize("kind", _PAINT_KINDS)
def test_k4_paint_tiles_equal_jax(kind, tile):
    """The paint's tile algorithm (merge-path split, coverage and survivor
    carries, the run start's version from the inputs) equals JAX
    ``_paint_and_compact_res`` (``_paint_tail`` + ``_dedup_compact``),
    with runs longer than a tile and runs starting at tile edges."""
    rng = np.random.default_rng(len(kind) + tile)
    for c, b, q in ((24, 9, 2), (40, 20, 1)):
        (keys, vers, n_used), ranks, acc, cv, floor = _paint_case(
            rng, kind, c, b, q)
        for prior in (False, True):
            want = _jit_paint(_jstate(keys, vers, n_used, 3, prior),
                              jck.RankBatch(*ranks), acc, np.int32(cv),
                              np.int32(floor))
            st = tck.ConflictState(T(keys), T(vers), T(n_used),
                                   torch.tensor(3, dtype=torch.int32),
                                   torch.tensor(prior))
            got = tck.paint_tiles_plain(st, tck.RankBatch(
                *(T(x) for x in ranks)), T(acc), cv,
                torch.tensor(floor, dtype=torch.int32), tile)
            same_state(got, want, f"{kind} c={c}")
    if kind == "overflow":
        assert bool(want.overflow)


@pytest.mark.parametrize("tile", [1, 2, 5, 64, tck.K4_TILE])
@pytest.mark.parametrize("floor", [0, 30, 1000])
def test_k4_fold_tiles_equal_jax(tile, floor):
    """The fold's tile algorithm equals JAX ``_merge_delta``: the +inf
    tails make runs longer than any small tile; shared keys make runs
    that start at every offset; a small base capacity overflows."""
    rng = np.random.default_rng(tile + floor)
    for c, cd, live_b, live_d in ((40, 16, 20, 10), (12, 16, 10, 12),
                                  (33, 7, 33, 7)):
        bk, bv, bn = _state_np(rng, c, live_b, 0, 60, space=50)
        dk, dv, dn = _state_np(rng, cd, live_d, 0, 80, space=50)
        for prior in (False, True):
            want = _jit_merge(_jstate(bk, bv, bn, 1, prior),
                              _jstate(dk, dv, dn, 2), np.int32(floor))
            got = tck.fold_tiles_plain(
                tck.ConflictState(T(bk), T(bv), T(bn), T(np.int32(1)),
                                  torch.tensor(prior)),
                tck.ConflictState(T(dk), T(dv), T(dn), T(np.int32(2)),
                                  torch.tensor(False)),
                torch.tensor(floor, dtype=torch.int32), tile)
            same_state(got, want, f"fold c={c}")


@pytest.mark.parametrize("tile", [1, 4, 7, tck.K4_TILE])
@pytest.mark.parametrize("kind", ["runs", "all_inf", "one_key", "edge"])
def test_k4_compact_tiles_equal_jax(kind, tile):
    """The compaction's tile algorithm equals JAX ``_dedup_compact``:
    runs of equal keys longer than a tile, all rows +inf (the forced last
    row), one key throughout, and runs starting exactly at tile edges."""
    rng = np.random.default_rng(tile)
    n = 60
    skeys = np.sort(rng.integers(0, 9, n)).astype(np.int32)
    if kind == "all_inf":
        skeys[:] = I32MAX
    elif kind == "one_key":
        skeys[:] = 4
    elif kind == "edge":  # a new key at every multiple of the tile
        skeys = (np.arange(n) // tile).astype(np.int32)
    skeys[-6:] = I32MAX
    if kind == "all_inf":
        skeys[:] = I32MAX
    newv = rng.integers(0, 3, n).astype(np.int32)
    for c_out in (3, 64):
        for prior in (False, True):
            want = _jit_compact(skeys[:, None], newv, c_out, jnp.bool_(prior))
            got = tck.compact_tiles_plain(T(skeys[:, None]), T(newv), c_out,
                                          torch.tensor(prior), tile)
            for g, w, name in zip(got, want, ("keys", "versions", "n_used",
                                              "overflow")):
                same(g, w, f"{kind} c_out={c_out} {name}")


@pytest.mark.parametrize("offset", [-1, 0])
def test_fold_need_at_the_reclaim_threshold(offset):
    """The device decision's twin equals the branch JAX ``_maybe_merge``
    takes with ``reclaimable`` at C // 8 - 1 and at C // 8, and with the
    delta's demand just fitting and just not."""
    rng = np.random.default_rng(5 + offset)
    c, cd = 64, 16
    bk, bv, bn = _state_np(rng, c, 40, 50, 60)
    bv[1:1 + c // 8 + offset] = 20  # expired at floor 30
    dk, dv, dn = _state_np(rng, cd, 6, 40, 60)
    floor = np.int32(30)
    for demand in (cd - 6, cd - 5):
        jh = jck.HistState(_jstate(bk, bv, bn), jnp.asarray(
            jck.sparse_table(jnp.asarray(bv))), _jstate(dk, dv, dn))
        want = _jit_maybe_merge(jh, np.int32(demand), floor)
        taken = not np.array_equal(want.delta.keys, dk)
        th = t_hist(jh)
        need = tck.fold_need_plain(th, demand, T(floor))
        assert bool(need) == taken == (offset == 0 or demand > cd - 6)
        same_state(tck._maybe_merge(th, demand, T(floor)).base, want.base)


def _dict_case(rng, d, w, n_keys, m, kind):
    """(dict [d + 1, w], n_keys, delta [M, w]) with m real delta rows."""
    words = rng.integers(-3, 3, (n_keys + m, w)).astype(np.int32)
    words = np.unique(words, axis=0)
    rng.shuffle(words)
    live = np.unique(words[:n_keys], axis=0)
    dict_keys = np.full((d + 1, w), I32MAX, np.int32)
    dict_keys[:len(live)] = live
    pool = words[n_keys:n_keys + m]
    if kind == "equal":  # delta rows equal to dictionary rows
        pool = live[rng.integers(0, len(live), m)]
    elif kind == "past":  # every delta row past every live row
        pool = np.full((m, w), 5, np.int32) + np.arange(m)[:, None]
    delta = np.unique(pool, axis=0)
    m_cap = max(m, 1) + 3
    delta_keys = np.full((m_cap, w), I32MAX, np.int32)
    delta_keys[:len(delta)] = delta
    return dict_keys, np.int32(len(live)), delta_keys


@pytest.mark.parametrize("tile", [1, 3, 16, tck.K1_TILE])
@pytest.mark.parametrize("w", [1, 3, 4])
@pytest.mark.parametrize("kind", ["random", "equal", "past", "near_full"])
def test_k1_insert_tiles_equal_jax(kind, w, tile):
    """K1's tile algorithm (the delta-side search p, a tile's split over
    j + p[j], marks and their exclusive count) equals JAX ``_dict_insert``,
    shift table included, with delta rows equal to dictionary rows, past
    every live row, and dictionaries so full that rows drop past D + 1."""
    rng = np.random.default_rng(w * 7 + tile)
    d = 40
    for m in (1, 2, 13):
        n_keys = d - 2 if kind == "near_full" else 20
        dict_keys, n, delta_keys = _dict_case(rng, d, w, n_keys, m, kind)
        want = _jit_insert(dict_keys, n, delta_keys)
        out, shift = tck.dict_insert_tiles_plain(T(dict_keys), T(delta_keys),
                                                 tile)
        same(out, want[0], f"{kind} m={m} dict")
        same(shift, want[2], f"{kind} m={m} shift")
        rows = [tuple(r) for r in dict_keys.tolist()]
        same(tck.dict_delta_positions_plain(T(dict_keys), T(delta_keys)),
             np.array([bisect.bisect_right(rows, tuple(r))
                       for r in delta_keys.tolist()], np.int32), "p")


def test_merge_path_split_is_the_merge_order():
    """Every diagonal's split equals the count of A rows whose merged
    position (A before equal B) is below it, ties included."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        a = sorted(rng.integers(0, 6, int(rng.integers(0, 12))).tolist())
        b = sorted(rng.integers(0, 6, int(rng.integers(0, 12))).tolist())
        pos = [i + int(np.searchsorted(b, x, side="left"))
               for i, x in enumerate(a)]
        for diag in range(len(a) + len(b) + 1):
            assert tck.merge_path_split(a, b, diag) == sum(p < diag
                                                          for p in pos)
