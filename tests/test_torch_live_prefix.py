"""The invariant K13's sorted paint relies on, and the tile algorithms of
K13's sorted paint and K14, against ``_paint_tail`` and the JAX package on
the CPU.

K13's sorted paint (``word_compact.cu`` ``wc_paint_sorted``) merges only a
history's live rows [0, n_used) with the batch's sorted new rows, so its
work follows the live rows and not the capacity C. That is ``_paint_tail``
only while every row at or past ``n_used`` holds (+inf, NEG_VERSION):
such rows change nothing in the merge but the forced row when every key is
+inf. Every writer of a word history in the port leaves them so: checked
here after ``init_state``, the plain ``_paint_tail`` (the unpacked paint
of every shard of a non-resident sharded engine and of the flat and
two-level unpacked engines), the plain width-W fold (the two-level
engine's), ``_redistribute_history`` and a reshard, ``rebase`` and
``convert`` from a JAX engine. ``paint_sorted_tiles_plain`` (the kernel's
tile algorithm, live rows only) is held equal to ``_paint_tail`` on random
and adversarial states, and to the JAX ``_paint_tail``;
``word_sort_tiles_plain`` (K14's merge by ranking) to ``lax.sort`` and the
JAX ``_endpoint_ranks``.

K12's search (``word_probe.cu`` ``wp_search``) reads only a history's live
rows when its caller passes n_used: the packed engine's base and delta
(two-level and flat, and the speculation scratch), the unpacked engines'
levels and each shard of the non-resident sharded engine. The invariant is
checked on every one of those states, and ``word_search_tiles_plain`` (the
kernel's block algorithm: the direct, staged and global branches, the
group search and the gallop) is held to the JAX
``searchsorted_words_2sided_fp`` over all C rows. Exact tolerance
throughout (integers).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.models import conflict_kernel as jck
from foundationdb_tpu.models.conflict_set import TPUConflictSet
from foundationdb_tpu.ops import lex as jlex
from foundationdb_tpu.parallel import sharded_resolver as jsr
from foundationdb_tpu_torch import TorchConflictSet, convert
from foundationdb_tpu_torch.models import conflict_kernel as tck
from foundationdb_tpu_torch.ops.lex import (
    searchsorted_words,
    sort_keys_with_payload,
)
from foundationdb_tpu_torch.models.conflict_set import upload
from foundationdb_tpu_torch.parallel import sharded_resolver as tsr
from tests.test_conflict_oracle import rand_txn
from tests.test_torch_conflict_kernel import T, same
from tests.test_torch_conflict_set import port_txn
from tests.test_torch_nr_sharded import KW, jax_snapshot
from tests.test_torch_sharded import jax_snapshot as res_jax_snapshot

torch.set_num_threads(1)

I32MAX = tck.INT32_MAX
NEG = tck.NEG_VERSION


def assert_live_prefix(state, what: str) -> None:
    """Every history level of ``state`` (any engine's: flat, two-level or
    sharded) holds (+inf, NEG_VERSION) at and past its n_used, and 1 <=
    n_used <= C."""
    leaves = convert.state_leaves(state)
    levels = [k[:-4] for k in leaves if k.endswith("keys")
              and not k.endswith(("dict_keys", "n_keys"))]
    assert levels, what
    for p in levels:
        keys = np.asarray(leaves[p + "keys"])
        keys = keys.reshape(-1, *keys.shape[-2:])
        vers = np.asarray(leaves[p + "versions"]).reshape(keys.shape[:2])
        n_used = np.asarray(leaves[p + "n_used"]).reshape(-1)
        for s, n in enumerate(n_used):
            assert 1 <= n <= keys.shape[1], (what, p, s, n)
            assert (keys[s, n:] == I32MAX).all(), (what, p, s)
            assert (vers[s, n:] == NEG).all(), (what, p, s)


def txns(rng, cv, n=20):
    return [port_txn(rand_txn(rng, read_version=int(rng.integers(cv - 12, cv)),
                              alphabet=256, max_len=4)) for _ in range(n)]


@pytest.mark.parametrize("engine", ["sharded", "flat", "two_level",
                                    "overflow", "packed_two_level",
                                    "packed_flat", "packed_overflow",
                                    "resident_sharded", "resident_flat",
                                    "resident_two_level"])
def test_every_writer_leaves_rows_past_n_used_empty(engine):
    """``init_state``, then the plain ``_paint_tail`` of every batch (each
    shard's, the flat history's, the two-level engine's delta, a history
    that overflows its capacity), the plain width-W fold (the two-level
    engine, a small delta), ``_redistribute_history`` through a reshard,
    and ``rebase`` through a version jump; the same for the packed
    non-resident engine (K13's packed paint, two-level with its fold, flat,
    and overflowing). The resident sharded engine's rank histories [S, C,
    1], which K8 reads by their n_used: ``init_res``, K4's plain paint and
    compaction of every shard, K1's rank shift rewrite of every batch that
    inserts keys (the INT32_MAX tail stays INT32_MAX), full repacks (a
    small dictionary), a reshard, the rebase, and ``convert`` from a JAX
    resident sharded engine. The resident engine's rank histories, which
    K17's live build reads by their n_used under ``rmq="blocked"``: the
    flat [C, 1] history (``init_res(delta_capacity=None)``) and the
    two-level one's base and delta, through K4's plain paint and
    compaction, K1's rank rewrite, full repacks, the gated fold and its
    delta reset, and the rebase; and a JAX resident engine's two-level
    state after the same kind of stream."""
    rng = np.random.default_rng(len(engine))
    kw = dict(KW, batch_size=24)
    if engine.endswith("sharded"):
        if engine == "resident_sharded":
            kw.update(resident=True, dict_capacity=256)
        cs = tsr.ShardedConflictSet(n_shards=3, device="cpu",
                                    auto_reshard=False,
                                    splits=[b"\x40", b"\xa0"], **kw)
    elif engine.startswith("resident"):
        kw.update(resident=True, dict_capacity=256)
        flat = engine == "resident_flat"
        cs = TorchConflictSet(device="cpu", history="batch" if flat
                              else "window", delta_capacity=None if flat
                              else 48, **kw)
    else:
        kw.pop("resident")
        if engine.endswith("overflow"):
            kw["capacity"] = 3 if engine.startswith("packed") else 6
        history = "window" if engine.endswith("two_level") else "batch"
        design = ({"resident": False} if engine.startswith("packed")
                  else {"packed": False})
        cs = TorchConflictSet(device="cpu", history=history,
                              delta_capacity=48, **design, **kw)
    assert_live_prefix(cs.state, "init")
    cv = 100
    for i in range(10):
        cv += 10 if i != 7 else (1 << 30) + 7
        cs.resolve(txns(rng, cv), cv, cv - 50)
        assert_live_prefix(cs.state, f"batch {i}")
        if engine.endswith("sharded") and i == 4:
            cs.reshard([b"\x10", b"\xe0"])
            assert_live_prefix(cs.state, "reshard")
    if engine.endswith("overflow"):
        assert cs.overflowed
    if engine.startswith("resident") and engine != "resident_sharded":
        assert cs.dict_stats["full_repacks"] > 0, cs.dict_stats
        if engine == "resident_two_level":
            jkw = {k: v for k, v in kw.items() if k != "resident"}
            jcs = TPUConflictSet(resident=True, delta_capacity=48, **jkw)
            cv = 100
            for i in range(8):
                cv += 10 if i != 5 else (1 << 30) + 7
                jcs.resolve([rand_txn(rng, read_version=cv - 5, alphabet=256,
                                      max_len=4) for _ in range(20)], cv,
                            cv - 50)
                assert_live_prefix(jcs.state, f"jax batch {i}")
            assert jcs.dict_stats["full_repacks"] > 0, jcs.dict_stats
    if engine == "resident_sharded":
        assert cs.dict_stats["full_repacks"] > 0, cs.dict_stats
        jcs = jsr.ShardedConflictSet(n_shards=3, auto_reshard=False,
                                     splits=[b"\x40", b"\xa0"], **kw)
        for i in range(4):
            cv = 100 + 10 * i
            jcs.resolve([rand_txn(rng, read_version=cv - 5, alphabet=256,
                                  max_len=4) for _ in range(14)], cv, cv - 80)
        port = convert.engine_from_snapshot(res_jax_snapshot(jcs),
                                            device="cpu")
        assert_live_prefix(port.state, "convert")
    if engine.endswith("two_level"):
        st = cs.state
        hist = st.hist if hasattr(st, "hist") else st
        floor = torch.tensor(cv - 50, dtype=torch.int32)
        base = tck._merge_delta_plain(hist.base, hist.delta, floor)
        assert_live_prefix(base, "fold")
        assert_live_prefix(tck._reset_delta(hist.delta, floor), "reset")


def test_spec_scratch_leaves_rows_past_n_used_empty():
    """The speculation scratch (``init_state`` and the packed paint at
    INT32_MAX - 1 of a window's rejected writes, ``spec_mark_rejected``),
    which K12's dependency probe searches by its n_used."""
    rng = np.random.default_rng(9)
    kw = dict(KW, batch_size=24)
    kw.pop("resident")
    cs = TorchConflictSet(device="cpu", resident=False, **kw)
    cs.base_version = 900
    pbs = [upload(cs._pack_dict(cs._pack(txns(rng, 1000 + 10 * i))[0]),
                  torch.device("cpu"), packed=True) for i in range(2)]
    window = tck.PackedBatch(
        torch.stack([pb.dict_keys for pb in pbs]),
        tck.RankBatch(*(torch.stack(x) for x in zip(*[pb.ranks
                                                       for pb in pbs]))))
    rejected = T(rng.random((2, pbs[0].ranks.txn_mask.shape[0])) < 0.6)
    for cap in (8, 200):
        scratch = tck.init_state(cap, cs.codec.width, cs.codec.min_key, "cpu")
        assert_live_prefix(scratch, "scratch init")
        scratch = tck.spec_mark_rejected(scratch, window, rejected)
        assert_live_prefix(scratch, f"scratch {cap}")


def test_redistribute_and_rebase_leave_rows_past_n_used_empty():
    """``_redistribute_history`` to new bounds (one shard cut at its
    capacity, overflow set) and ``rebase`` past most versions."""
    rng = np.random.default_rng(5)
    cs = tsr.ShardedConflictSet(n_shards=4, device="cpu", auto_reshard=False,
                                splits=[b"\x40", b"\x80", b"\xc0"],
                                **dict(KW, capacity=64, batch_size=24))
    cv = 100
    for _ in range(6):
        cv += 10
        cs.resolve(txns(rng, cv), cv, cv - 50)
    st = cs.state
    bounds = tsr.pack_splits(cs.codec, [b"\x02", b"\x04", b"\xf0"])
    lo, hi = bounds[:-1], bounds[1:]
    keys, vers, n_used, over = tsr._redistribute_history(
        st.keys.numpy(), st.versions.numpy(), st.n_used.numpy(), lo, hi, 4)
    assert over.any()
    assert_live_prefix(tck.ConflictState(T(keys), T(vers), T(n_used),
                                         st.oldest, T(over)), "redistribute")
    assert_live_prefix(tck.rebase(st, cv - 20), "rebase")


def test_convert_from_a_jax_engine_leaves_rows_past_n_used_empty():
    """A JAX non-resident sharded engine's state converted to the port's."""
    rng = np.random.default_rng(11)
    jcs = jsr.ShardedConflictSet(n_shards=4, **dict(KW, batch_size=16))
    cv = 100
    for _ in range(4):
        cv += 10
        jcs.resolve([rand_txn(rng, read_version=cv - 5, alphabet=256,
                              max_len=4) for _ in range(14)], cv, cv - 80)
    port = convert.engine_from_snapshot(jax_snapshot(jcs), device="cpu")
    assert_live_prefix(port.state, "convert")


# ------------------------------------------- K13's and K14's tile twins


def word_state(rng, c, live, w, vmax=60, overflow=False):
    """A [C, W] history of ``live`` sorted distinct rows (row 0 the minimum
    key), random versions, (+inf, NEG_VERSION) past them; ``live`` 0 gives
    one +inf row (every key +inf)."""
    k = np.full((c, w), I32MAX, np.int32)
    v = np.full(c, NEG, np.int32)
    if live:
        rows = np.unique(rng.integers(-40, 40, (3 * live, w)).astype(
            np.int32), axis=0)
        rows = rows[(rows != -2**31).any(1)][:live - 1]
        rows = rows[np.lexsort(rows.T[::-1])]
        k[0] = -2**31
        k[1:1 + len(rows)] = rows
        v[:1 + len(rows)] = rng.integers(0, vmax, 1 + len(rows))
    n = max(1, 1 + len(rows)) if live else 1
    return tck.ConflictState(T(k), T(v), torch.tensor(n, dtype=torch.int32),
                             torch.tensor(3, dtype=torch.int32),
                             torch.tensor(overflow))


def sorted_new(st, rng, e2, kind):
    """K14's output for a batch's new endpoint rows: (snew, sdelta,
    soldv, scross), a rejected or empty write on +inf with delta 0."""
    w = st.keys.shape[1]
    n = int(st.n_used)
    ends = rng.integers(-4, 4, (2, e2, w)).astype(np.int32)
    if kind == "hist":  # every endpoint a live history key
        ends = st.keys[:n].numpy()[rng.integers(0, n, (2, e2))]
    elif kind == "run":  # every begin on one key: a run past any tile
        ends[0] = ends[0, 0]
    a, z = ends
    swap = tck.lex_lt(T(z), T(a)).numpy()
    a, z = np.where(swap[:, None], z, a), np.where(swap[:, None], a, z)
    valid = tck.lex_lt(T(a), T(z)).numpy() & (rng.random(e2) < 0.8)
    if kind == "parked":
        valid[:] = False
    keys = np.concatenate([a, z])
    keys[np.concatenate([~valid, ~valid])] = I32MAX
    d = valid.astype(np.int32)
    keys, delta = T(keys), T(np.concatenate([d, -d]))
    cross = searchsorted_words(st.keys, keys, "right").to(torch.int32)
    oldv = st.versions[(cross - 1).clamp(min=0).long()]
    return sort_keys_with_payload(keys, delta, oldv, cross)


@pytest.mark.parametrize("case", ["random", "n_used_1", "all_inf", "full",
                                  "parked", "hist", "run", "expire_most"])
def test_live_prefix_paint_equals_paint_tail(case):
    """``paint_sorted_tiles_plain`` (the live rows only, tiles of 1 to
    K13_TILE rows) against ``_paint_tail`` (all C rows): a history of one
    row, of one +inf row, every row live (survivors past C), every new row
    parked on +inf, new rows equal to history keys (runs across tile
    edges), a run longer than a tile, a floor that expires most rows."""
    rng = np.random.default_rng(len(case))
    for trial in range(6):
        w = 1 + trial % 3
        c, e2, fl = int(rng.integers(8, 120)), int(rng.integers(1, 40)), 10
        live = int(rng.integers(2, c + 1))
        if case == "n_used_1":
            live = 1
        elif case == "all_inf":
            live = 0
        elif case == "full":
            live = c
        elif case == "expire_most":
            fl = 55
        st = word_state(rng, c, live, w, overflow=case == "full")
        if case == "full":  # every row live
            n = int(st.n_used)
            st = tck.ConflictState(st.keys[:n].clone(),
                                   st.versions[:n].clone(), *st[2:])
        snew, sd, soldv, sx = sorted_new(st, rng, e2, case)
        cv = 77
        want = tck._paint_tail(st, snew, sd, soldv, sx, cv, fl)
        for tile in (1, 3, 16, tck.K13_TILE):
            got = tck.paint_sorted_tiles_plain(st, snew, sd, sx, cv, fl, tile)
            for f, g, x in zip(want._fields, got, want):
                assert torch.equal(g, x), (case, trial, tile, f)


def test_live_prefix_paint_equals_jax_paint_tail():
    """``paint_sorted_tiles_plain`` against the JAX ``_paint_tail`` on a
    history with a fifth of its rows live."""
    rng = np.random.default_rng(3)
    for w in (1, 4):
        st = word_state(rng, 400, 80, w)
        snew, sd, soldv, sx = sorted_new(st, rng, 64, "random")
        jst = jck.ConflictState(*(jnp.asarray(x.numpy()) for x in st))
        want = jck._paint_tail(jst, *(jnp.asarray(x.numpy()) for x in (
            snew, sd, soldv, sx)), jnp.int32(77), jnp.int32(10))
        got = tck.paint_sorted_tiles_plain(st, snew, sd, sx, 77, 10, 32)
        for g, x in zip(got, want):
            same(g, x, f"w={w}")


@pytest.mark.parametrize("kind", ["random", "all_equal", "all_inf", "runs"])
@pytest.mark.parametrize("tile", [5, 32, 4096])
def test_word_sort_tiles_equal_jax(kind, tile):
    """``word_sort_tiles_plain`` (K14's merge by ranking) against
    ``lax.sort(is_stable=True)`` (the permutation carried as a payload)
    and the JAX ``_endpoint_ranks`` (searchsorted left into the sorted
    rows), N not a multiple of the tile."""
    rng = np.random.default_rng(len(kind) + tile)
    b, r, q, w = 21, 2, 2, 3
    n = 2 * b * (r + q)
    rows = rng.integers(-3, 3, (n, w)).astype(np.int32)
    if kind == "random":
        rows = rng.integers(-2**31, 2**31, (n, w), dtype=np.int64).astype(
            np.int32)
    elif kind == "all_equal":
        rows[:] = rows[0]
    elif kind == "all_inf":
        rows[:] = I32MAX
    perm, ranks = tck.word_sort_tiles_plain(T(rows), tile)
    idx = np.arange(n, dtype=np.int32)
    want = jlex.sort_keys_with_payload(jnp.asarray(rows), jnp.asarray(idx))
    same(perm, want[1], kind)
    secs = rows.reshape(4, -1, w)
    jb = jck.BatchTensors(
        read_begin=secs[0].reshape(b, r, w), read_end=secs[1].reshape(b, r, w),
        read_mask=np.ones((b, r), bool), write_begin=secs[2].reshape(b, q, w),
        write_end=secs[3].reshape(b, q, w), write_mask=np.ones((b, q), bool),
        read_version=np.zeros(b, np.int32), txn_mask=np.ones(b, bool))
    want_ranks = np.concatenate([np.asarray(x).reshape(-1)
                                 for x in jck._endpoint_ranks(jb)])
    same(ranks, want_ranks, kind)


def test_k13_k14_tile_constants_match_the_kernels():
    """``kernels.word_sort_tile`` is word_sort.cu's ``tile_rows`` (its
    defines), and the wrapper sizes K13's look-back words by
    word_compact.cu's tile (``PT``) and K4's workspace head."""
    import re
    from pathlib import Path

    from foundationdb_tpu_torch import kernels

    csrc = Path(kernels.__file__).resolve().parent / "csrc"

    def define(source, name):
        text = (csrc / source).read_text()
        return int(re.search(rf"#define {name} (\d+)", text).group(1))

    t_max, t_min, t_base, tiles, cap = (define("word_sort.cu", k) for k in (
        "TILE_MAX", "TILE_MIN", "TILE_BASE", "TILES", "SMEM_DYN"))
    for w in (1, 4, 9, 11, 12, 24, 54, 100, 225, 226):
        for n in (1, 1024, 16384, 16385, 49152, 1 << 20):
            fit = [t for t in (t_max >> i for i in range(5))
                   if t >= t_min and t * (20 + 4 * (w | 1)) <= cap]
            t = min(fit[0], t_base) if fit else 0
            while fit and t < fit[0] and -(-n // t) > tiles:
                t *= 2
            assert kernels.word_sort_tile(n, w) == t, (n, w)
    assert define("word_compact.cu", "PT") == kernels.K13_TILE
    assert define("word_compact.cu", "WS_WORDS") == kernels._WS_HEAD


# ------------------------------------------------------ K12's block search


SEARCH_C, SEARCH_Q = 320, 300  # one JAX compile per W


@functools.lru_cache(maxsize=None)
def _jax_search2():
    return jax.jit(jlex.searchsorted_words_2sided_fp)


def jax_search2(keys, q):
    """The JAX two-sided search of ``q`` (padded to SEARCH_Q rows with
    +inf, the answers cut back) in ``keys`` [SEARCH_C, W]."""
    pad = np.full((SEARCH_Q - len(q), q.shape[1]), I32MAX, np.int32)
    out = _jax_search2()(jnp.asarray(keys), jnp.asarray(np.concatenate(
        [q, pad])))
    return [np.asarray(x)[: len(q)] for x in out]


def search_case(rng, kind, w):
    """(keys [C, W] with rows past n all INT32_MAX, n, query rows): runs of
    equal rows, all-INT32_MAX queries and live +inf rows, n = 0 and n = C,
    sorted and unsorted queries, query counts around the tiles."""
    c = SEARCH_C
    n = {"n0": 0, "full": c}.get(kind, int(rng.integers(1, c)))
    spread = 3 if kind in ("runs", "top") else 60
    keys = np.full((c, w), I32MAX, np.int32)
    live = rng.integers(-spread, spread, (n, w)).astype(np.int32)
    keys[:n] = live[np.lexsort(live.T[::-1])]
    if kind == "top" and n > 2:
        keys[n - 2:n] = I32MAX  # +inf rows inside the live prefix
    nq = {"tiles": int(rng.choice([3, 4, 5, 8, 9, 15, 16, 17, 127, 128,
                                   129]))}.get(kind, SEARCH_Q)
    q = rng.integers(-spread - 1, spread + 1, (nq, w)).astype(np.int32)
    if n:
        pick = rng.random(nq) < 0.4
        q[pick] = keys[rng.integers(0, n, int(pick.sum()))]
    q[rng.random(nq) < (0.3 if kind == "top" else 0.03)] = I32MAX
    if kind != "unsorted":
        q = q[np.lexsort(q.T[::-1])]
    return keys, n, q


@pytest.mark.parametrize("w", [1, 4, 9, 24])
@pytest.mark.parametrize("kind", ["runs", "top", "n0", "full", "unsorted",
                                  "tiles"])
def test_word_search_tiles_equal_jax(kind, w):
    """``word_search_tiles_plain`` over the live rows only, with the
    kernel's plan and with plans that force each branch (tiles of 16 and
    128 queries with no shared memory, room for 40 rows, room for all),
    and in the two-history form (the second with a shorter live prefix),
    against the JAX two-sided search over all C rows."""
    rng = np.random.default_rng(len(kind) * 31 + w)
    keys, n, q = search_case(rng, kind, w)
    want = jax_search2(keys, q)
    kt, qt, live = T(keys), T(q), torch.tensor(n, dtype=torch.int32)
    seen = torch.zeros(3, dtype=torch.int32)
    for plan in (None, (16, 0), (128, 0), (16, 160 * w), (32, 1 << 20)):
        got = tck.word_search_tiles_plain(kt, qt, live0=live, plan=plan)
        same(got[0], want[0], (kind, w, plan, "left"))
        same(got[1], want[1], (kind, w, plan, "right"))
        seen += got[4]
    assert seen[0] > 0 and seen[1] + seen[2] > 0, seen
    n2 = n // 3
    keys2 = keys.copy()
    keys2[n2:] = I32MAX
    want2 = jax_search2(keys2, q)
    got = tck.word_search_tiles_plain(kt, qt, T(keys2), live,
                                      torch.tensor(n2, dtype=torch.int32))
    for g, x in zip(got[:4], want + want2):
        same(g, x, (kind, w, "two histories"))


def test_word_search_span_just_over_the_shared_budget():
    """Tiles of 16 distinct sorted rows whose spans are the budget's rows
    and one row more: the first is staged, the second searched in global
    memory, with equal answers (and equal to the JAX search)."""
    w, budget = 4, 40
    keys = np.stack([np.arange(SEARCH_C, dtype=np.int32)] * w, 1)
    q = keys[np.concatenate([np.linspace(10, 10 + budget - 1, 16),
                             np.linspace(100, 100 + budget, 16)]).astype(int)]
    # The shared bytes hold the tile's 16 rows, then the budget's rows.
    plan = (16, (16 + budget) * 4 * w)
    got = tck.word_search_tiles_plain(T(keys), T(q), plan=plan)
    want = jax_search2(keys, q)
    same(got[0], want[0])
    same(got[1], want[1])
    assert got[4].tolist() == [0, 1, 1]


def test_word_search_plan_and_constants_match_the_kernel():
    """``kernels.WP_THREADS``, the branch order and K5's ``PRED_ROWS`` are
    the kernels' defines; the plan's direct tiles (4, 8) fill one wave of
    blocks with no shared memory, and past them a tile of 128 has room, at
    the engine's shapes, for an even sorted tile's spans 1.5 times over."""
    import re
    from pathlib import Path

    from foundationdb_tpu_torch import kernels

    csrc = Path(kernels.__file__).resolve().parent / "csrc"
    wp = (csrc / "word_probe.cu").read_text()
    wv = (csrc / "wave.cu").read_text()
    assert int(re.search(r"#define WP_THREADS (\d+)", wp).group(1)) == \
        kernels.WP_THREADS
    enum = re.search(r"enum \{ (WP_\w+), (WP_\w+), (WP_\w+) \}", wp)
    assert [x[3:].lower() for x in enum.groups()] == list(
        kernels.WP_BRANCHES)
    assert int(re.search(r"#define PRED_ROWS (\d+)", wv).group(1)) == \
        kernels.PRED_ROWS
    cd = 16386
    for n1, c, w, tile in ((341, 1 << 20, 9, 4), (16384, 1 << 20, 4, 8),
                           (16897, 1 << 20, 4, 128),
                           (49153, (1 << 20) + cd, 4, 128),
                           (1 << 20, 1 << 20, 1, 128)):
        t, smem = kernels.word_search_plan(n1, c, w)
        assert t == tile, (n1, t)
        assert (smem == 0) == (t <= 8)
        assert smem <= 232448 and smem % 16 == 0
        if n1 == 49153:  # the engine's dictionary: an even tile's spans
            assert smem // (4 * w) >= 3 * t * c // n1 // 2  # fit 1.5 times

