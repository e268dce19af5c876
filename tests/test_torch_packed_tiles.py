"""K13's packed paint and width-W fold and K12's probe over a live table,
by the kernels' algorithms, against the JAX package on the CPU.

The packed paint (``word_compact.cu`` ``wc_paint``) gathers the batch's
new endpoint rows in the host's paint order (``packed_paint_rows_plain``)
and runs the sorted paint's tiles over the level's live rows
(``paint_sorted_tiles_plain``); the width-W fold (``wc_fold``,
``wc_fold_step``) and the compaction (``wc_compact``) are K4's tile
algorithm at width W over the live rows of base and delta
(``word_fold_tiles_plain``, ``word_fold_step_tiles_plain``,
``word_compact_tiles_plain``); K12's probe (``wp_probe``) builds a range-max
table over the per-batch level's live rows and probes it by rank
(``level_probe_live_plain``). Each twin is held bit for bit to the JAX
``_paint_and_compact_packed``, ``_merge_delta`` / ``_maybe_merge`` /
``advance_hist``, ``_dedup_compact``, ``_history_conflict_ranges_hist_packed``
/ ``_history_conflict_ranges_packed`` with ``too_old_mask_packed``: every
array, n_used, overflow and oldest, on rejected writes, keys equal across
the history and the new rows, n_used = 1, a full C, a floor that expires
everything, overflow and an all-+inf history. The searches feeding the
twins are K12's over the live rows (``word_search_tiles_plain`` given each
level's n_used), as on the card; the JAX functions search all C rows.
Every shape is fixed, so each JAX function compiles once.

A rejected write stays a no-op endpoint at its own key in the port (the
new rows stay sorted); JAX parks it on the dictionary's +inf row. The
states agree wherever the level's first row is at or below every
endpoint, as the minimum-key row every engine's history keeps is; the
all-+inf history (no minimum-key row) is therefore painted with accepted,
non-empty writes only.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.models import conflict_kernel as jck
from foundationdb_tpu.ops.rmq import sparse_table as jsparse_table
from foundationdb_tpu_torch import kernels as K
from foundationdb_tpu_torch.models import conflict_kernel as tck
from tests.test_torch_conflict_kernel import T, same, same_state

torch.set_num_threads(1)

I32MAX, NEG = tck.INT32_MAX, tck.NEG_VERSION
C, CD, W, B, R, Q = 64, 32, 3, 16, 2, 2
N1 = 2 * B * (R + Q) + 1  # dictionary rows, the +inf row last
MIN_ROW = np.full(W, -2**31, np.int32)
TILES = (3, 16, K.K13_TILE)


@functools.lru_cache(maxsize=None)
def jitted(name: str, *static):
    return jax.jit(getattr(jck, name), static_argnums=static)


def pool(rng, n):
    """n distinct sorted key rows (first words from a small set, so that
    compares reach the later words), none the minimum row or +inf."""
    rows = np.unique(np.concatenate([
        rng.integers(-3, 3, (4 * n, 1)),
        rng.integers(-6, 6, (4 * n, W - 1))], 1).astype(np.int32), axis=0)
    rows = rows[rng.permutation(len(rows))[:n]]
    return rows[np.lexsort(rows.T[::-1])]


def level(rng, cap, live, from_rows=None, vmax=60, overflow=False,
          all_inf=False):
    """A [cap, W] history: row 0 the minimum key, ``live`` rows (half of
    them from ``from_rows`` when given: keys equal across levels), random
    versions, (+inf, NEG_VERSION) past them; ``all_inf``: one +inf row."""
    k = np.full((cap, W), I32MAX, np.int32)
    v = np.full(cap, NEG, np.int32)
    if all_inf:
        live = 1
    else:
        rows = pool(rng, 2 * live)
        if from_rows is not None and len(from_rows):
            rows = np.concatenate([rows, from_rows[rng.integers(
                0, len(from_rows), live)]])
        rows = np.unique(rows, axis=0)
        rows = rows[rng.permutation(len(rows))[:live - 1]]
        rows = rows[np.lexsort(rows.T[::-1])]
        k[0] = MIN_ROW
        k[1:live] = rows
        v[:live] = rng.integers(0, vmax, live)
    return tck.ConflictState(T(k), T(v), torch.tensor(live, dtype=torch.int32),
                             torch.tensor(3, dtype=torch.int32),
                             torch.tensor(overflow))


def batch(rng, hist_rows=None, reject_all=False, accept_all=False,
          spans=(1, 4)):
    """(dict_keys [N1, W], RankBatch, accepted [B]): the sorted unique
    dictionary (+inf padded, half its rows history keys when
    ``hist_rows`` is given), read and write ranges as rank pairs (empty
    ones among them unless ``accept_all``; an accepted write spans
    ``spans`` ranks), the host's paint order."""
    u = int(rng.integers(N1 // 2, N1 - 8))
    rows = pool(rng, u)
    if hist_rows is not None and len(hist_rows) > 1:
        rows = np.unique(np.concatenate([rows[: u // 2], hist_rows[1:]]),
                         axis=0)[:u]
    u = len(rows)
    dict_keys = np.full((N1, W), I32MAX, np.int32)
    dict_keys[:u] = rows

    def pairs(cols, lo, hi):
        a = rng.integers(0, u, (B, cols))
        z = np.minimum(a + rng.integers(lo, hi, (B, cols)), u)
        return a.astype(np.int32), z.astype(np.int32)

    rb, re_ = pairs(R, 0, 4)
    wb, we = pairs(Q, *spans) if accept_all else pairs(Q, 0, 4)
    wmask = np.ones((B, Q), bool) if accept_all else rng.random((B, Q)) < 0.85
    acc = (np.ones(B, bool) if accept_all
           else np.zeros(B, bool) if reject_all else rng.random(B) < 0.7)
    paint = np.concatenate([wb.reshape(-1), we.reshape(-1)])
    ranks = tck.RankBatch(
        T(rb), T(re_), T(rng.random((B, R)) < 0.9), T(wb), T(we), T(wmask),
        T(rng.integers(0, 70, B).astype(np.int32)), T(rng.random(B) < 0.95),
        T(np.argsort(paint, kind="stable").astype(np.int32)))
    return T(dict_keys), ranks, T(acc)


def j_state(st):
    return jck.ConflictState(*(jnp.asarray(x.numpy()) for x in st))


def j_batch(dict_keys, rbk):
    return jck.PackedBatch(jnp.asarray(dict_keys.numpy()),
                           *(jnp.asarray(x.numpy()) for x in rbk[:-1]))


def live_search(dict_keys, keys_b, n_b, keys_d=None, n_d=None):
    """K12's search as the card runs it: over each level's live rows."""
    got = tck.word_search_tiles_plain(keys_b, dict_keys, keys_d, n_b, n_d)
    ls_b, rs_b = got[0], got[1]
    ls_d, rs_d = (got[2], got[3]) if keys_d is not None else (None, None)
    return tck.DictSearch(ls_b, rs_b, ls_d, rs_d)


def same_hist(got, want, what):
    same_state(got.base, want.base, f"{what}: base")
    same(got.base_st, want.base_st, f"{what}: base_st")
    same_state(got.delta, want.delta, f"{what}: delta")


# ------------------------------------------------------- the packed paint

PAINT_CASES = ["random", "rejected", "hist_keys", "n_used_1", "full",
               "overflowed", "expire_all", "all_inf"]


@pytest.mark.parametrize("case", PAINT_CASES)
def test_packed_paint_tiles_equal_jax(case):
    """``packed_paint_tiles_plain`` (the gather, then the sorted paint's
    tiles over the live rows, at tiles of 3, 16 and K13_TILE rows) equals
    the JAX ``_paint_and_compact_packed`` and the port's plain paint:
    every write rejected, endpoints equal to history keys, a history of
    one row, a full history whose survivors overflow C, one that
    overflowed before (the flag is sticky), a floor past every version,
    an all-+inf history."""
    rng = np.random.default_rng(PAINT_CASES.index(case))
    full = case in ("full", "overflowed")
    live = 1 if case == "n_used_1" else C if full else int(
        rng.integers(8, C - 8))
    st = level(rng, C, live, overflow=case == "overflowed",
               all_inf=case == "all_inf")
    dict_keys, rbk, acc = batch(
        rng, st.keys[:live].numpy() if case == "hist_keys" else None,
        reject_all=case == "rejected",
        accept_all=case in ("all_inf", "full"),
        spans=(1, 2) if case == "full" else (1, 4))
    cv, floor = 77, 100 if case == "expire_all" else 10
    want = jitted("_paint_and_compact_packed")(
        j_state(st), j_batch(dict_keys, rbk), jnp.asarray(acc.numpy()),
        jnp.int32(cv), jnp.int32(floor))
    rs = live_search(dict_keys, st.keys, st.n_used).rs_b
    snew, _, _ = tck.packed_paint_rows_plain(dict_keys, rbk, acc, rs)
    assert tck.lex_le(snew[:-1], snew[1:]).all(), case  # sorted as gathered
    for tile in TILES:
        got = tck.packed_paint_tiles_plain(st, dict_keys, rbk, acc, cv,
                                           floor, rs, tile)
        same_state(got, want, f"{case} tile={tile}")
    same_state(tck._paint_and_compact_packed(st, dict_keys, rbk, acc, cv,
                                             floor, rs, plain=True),
               want, f"{case} plain")
    if full:
        assert bool(want.overflow)
    if case == "expire_all":
        assert int(want.n_used) == 1


# ------------------------------------------------ the width-W fold, compact

FOLD_CASES = ["random", "equal_keys", "n_used_1", "full", "expire_all",
              "overflow", "all_inf", "both_inf"]


def fold_inputs(case):
    rng = np.random.default_rng(10 + FOLD_CASES.index(case))
    nb = {"n_used_1": 1, "full": C}.get(case, int(rng.integers(8, C - 8)))
    nd = {"n_used_1": 1, "full": CD}.get(case, int(rng.integers(4, CD - 4)))
    base = level(rng, C, nb, overflow=case == "overflow",
                 all_inf=case in ("all_inf", "both_inf"))
    delta = level(rng, CD, nd, vmax=90,
                  from_rows=base.keys[:nb].numpy()
                  if case == "equal_keys" else None,
                  all_inf=case == "both_inf")
    floor = {"expire_all": 100, "full": 0}.get(case, 20)
    if case == "full":
        # Pairs of delta rows with no base row between them, the first
        # newer than every base version, the second NEG_VERSION: each pair
        # adds two boundaries to a full base, so the fold overflows C.
        k, v = delta.keys.numpy().copy(), delta.versions.numpy().copy()
        prefix = np.unique(rng.integers(-3, 3, (4 * CD, 2)), axis=0)[
            :(CD - 1) // 2].astype(np.int32)
        m = 2 * len(prefix)
        k[1:1 + m, :2] = np.repeat(prefix, 2, 0)
        k[1:1 + m, 2] = np.tile([100, 101], len(prefix))
        v[1:1 + m] = np.where(np.arange(m) % 2 == 0, 70 + np.arange(m), NEG)
        k[1 + m:], v[1 + m:] = I32MAX, NEG
        delta = tck.ConflictState(T(k), T(v),
                                  torch.tensor(1 + m, dtype=torch.int32),
                                  *delta[3:])
    return base, delta, floor


@pytest.mark.parametrize("case", FOLD_CASES)
def test_word_fold_tiles_equal_jax(case):
    """``word_fold_tiles_plain`` (K4's tile algorithm at width W over the
    live rows of base and delta) equals the JAX ``_merge_delta``; the
    gated step's twin equals the JAX ``_maybe_merge`` with the fold
    needed and not needed; the forced fold's equals ``advance_hist``."""
    base, delta, floor = fold_inputs(case)
    want = jitted("_merge_delta")(j_state(base), j_state(delta),
                                  jnp.int32(floor))
    for tile in TILES:
        same_state(tck.word_fold_tiles_plain(base, delta, floor, tile), want,
                   f"{case} tile={tile}")
    same_state(tck._merge_delta_plain(
        base, delta, torch.tensor(floor, dtype=torch.int32)), want,
        f"{case} plain")
    if case == "full":
        assert bool(want.overflow)
    if case in ("expire_all", "both_inf"):
        assert int(want.n_used) == 1
    base_st = jsparse_table(jnp.asarray(base.versions.numpy()))
    jh = jck.HistState(j_state(base), base_st, j_state(delta))
    th = tck.HistState(base, T(base_st), delta)
    floor_t = torch.tensor(floor, dtype=torch.int32)
    needs = set()
    for demand in (0, CD - int(delta.n_used) + 1):
        need = bool(tck.fold_need_plain(th, demand, floor_t))
        needs.add(need)
        want_h = jitted("_maybe_merge")(jh, jnp.int32(demand),
                                        jnp.int32(floor))
        same_hist(tck.word_fold_step_tiles_plain(th, demand, floor_t), want_h,
                  f"{case} demand={demand} need={need}")
    assert True in needs
    new_oldest = floor + 5
    want_a = jitted("advance_hist")(jh, jnp.int32(90), jnp.int32(new_oldest))
    f = torch.maximum(delta.oldest, torch.tensor(new_oldest,
                                                 dtype=torch.int32))
    same_hist(tck.word_fold_step_tiles_plain(th, None, f), want_a,
              f"{case} advance")


@pytest.mark.parametrize("c_out", [5, 2 * C])
def test_word_compact_tiles_equal_jax(c_out):
    """``word_compact_tiles_plain`` equals the JAX ``_dedup_compact`` on the
    sorted rows of two histories (runs of equal keys, +inf rows, versions
    from a few values), at a capacity that overflows and one that does
    not."""
    rng = np.random.default_rng(c_out)
    base, delta, _ = fold_inputs("equal_keys")
    rows = np.concatenate([base.keys.numpy(), delta.keys.numpy()])
    skeys = rows[np.lexsort(rows.T[::-1])]
    newv = rng.integers(0, 4, len(skeys)).astype(np.int32)
    newv[(skeys == I32MAX).all(1)] = NEG
    for prior in (False, True):
        want = jitted("_dedup_compact", 2)(
            jnp.asarray(skeys), jnp.asarray(newv), c_out, jnp.bool_(prior))
        for tile in TILES:
            got = tck.word_compact_tiles_plain(T(skeys), T(newv), c_out,
                                               torch.tensor(prior), tile)
            for g, x in zip(got, want):
                same(g, x, f"c_out={c_out} prior={prior} tile={tile}")
        assert bool(want[3]) == (prior or c_out == 5)


# --------------------------------------------- K12's probe over a live table

PROBE_CASES = ["random", "hist_keys", "n_used_1", "full", "all_inf",
               "too_old_all"]


@pytest.mark.parametrize("case", PROBE_CASES)
def test_level_probe_live_equals_jax(case):
    """``level_probe_live_plain`` (bounds by rank from K12's live search,
    the end clamped to the level's live count, the level's range max from
    a table over its live rows, the base's from its sparse table) equals
    the JAX ``_history_conflict_ranges_hist_packed`` (two-level) and
    ``_history_conflict_ranges_packed`` (flat), with ``too_old_mask_packed``
    and the candidates, and the port's plain probe."""
    rng = np.random.default_rng(20 + PROBE_CASES.index(case))
    nb = {"n_used_1": 1, "full": C}.get(case, int(rng.integers(8, C - 8)))
    nd = {"n_used_1": 1, "full": CD}.get(case, int(rng.integers(4, CD - 4)))
    base = level(rng, C, nb, all_inf=case == "all_inf")
    delta = level(rng, CD, nd, vmax=90, all_inf=case == "all_inf")
    dict_keys, rbk, _ = batch(
        rng, base.keys[:nb].numpy() if case == "hist_keys" else None)
    new_oldest = 80 if case == "too_old_all" else 5
    jpb = j_batch(dict_keys, rbk)
    jfloor, jto = jitted("too_old_mask_packed")(j_state(delta), jpb,
                                                jnp.int32(new_oldest))
    floor = torch.maximum(delta.oldest, torch.tensor(new_oldest,
                                                     dtype=torch.int32))
    same(floor, jfloor, case)
    # Two levels: the base with its prebuilt table, the delta per batch.
    base_st = jsparse_table(jnp.asarray(base.versions.numpy()))
    rs_b, ls_b = jitted("_dict_history_search")(j_state(base).keys,
                                                jpb.dict_keys)
    rs_d, ls_d = jitted("_dict_history_search")(j_state(delta).keys,
                                                jpb.dict_keys)
    want = jitted("_history_conflict_ranges_hist_packed")(
        j_state(base), base_st, j_state(delta), jpb, rs_b, ls_b, rs_d, ls_d)
    search = live_search(dict_keys, base.keys, base.n_used, delta.keys,
                         delta.n_used)
    got = tck.level_probe_live_plain(rbk, floor, search, T(base_st),
                                     delta.versions, delta.n_used)
    cand = np.asarray(jpb.txn_mask & ~jto & ~want.any(1))
    for g, x in zip(got, (jto, want, cand)):
        same(g, x, f"{case} two-level")
    for g, x in zip(tck.packed_probe(rbk, floor, search, T(base_st),
                                     delta.versions, delta.n_used,
                                     plain=True), got):
        assert torch.equal(g, x), case
    # One flat level (the flat history, the speculation scratch).
    want = jitted("_history_conflict_ranges_packed")(j_state(base), jpb)
    flat = live_search(dict_keys, base.keys, base.n_used)
    got = tck.level_probe_live_plain(rbk, floor, flat, None, base.versions,
                                     base.n_used)
    cand = np.asarray(jpb.txn_mask & ~jto & ~want.any(1))
    for g, x in zip(got, (jto, want, cand)):
        same(g, x, f"{case} flat")
    if case == "too_old_all":
        assert bool(jto.any())


def test_live_table_probe_clamps_every_range():
    """The level's range max over its live table equals the max over all
    C rows for every [a, z) a probe can ask, a and z in [0, C]: the end
    clamped to n_used, empty and inverted ranges NEG_VERSION."""
    rng = np.random.default_rng(7)
    for live in (1, 2, 255, 256, 257, 600, 1024):
        c = 1024
        v = np.full(c, NEG, np.int32)
        v[:live] = rng.integers(-5, 90, live)
        a, z = np.meshgrid(np.arange(0, c + 1, 7), np.arange(0, c + 1, 5))
        a, z = a.reshape(-1), z.reshape(-1)
        table, top = tck.live_table_plain(T(v[:live]))
        got = tck.live_range_max_plain(table, top, T(a.astype(np.int32)),
                                       T(np.minimum(z, live).astype(np.int32)))
        want = np.array([v[x:y].max() if y > x else NEG
                         for x, y in zip(a, z)], np.int32)
        same(got, want, f"live={live}")


# ---------------------------------------------- the bindings and constants


def _entries(source: str) -> dict:
    """Each extern "C" entry of csrc/``source``.cu: its parameters' kinds
    ("i" an int, "p" a pointer or the stream)."""
    text = (Path(K.__file__).resolve().parent / "csrc"
            / f"{source}.cu").read_text()
    out = {}
    for m in re.finditer(r'extern "C" int (\w+)\((.*?)\)\s*\{', text, re.S):
        params = [p.strip() for p in m.group(2).split(",")]
        out[m.group(1)] = ["p" if "*" in p or "cudaStream_t" in p else "i"
                           for p in params]
    return out


@pytest.mark.parametrize("source", ["word_compact", "word_probe",
                                    "rmq_blocked", "step_compact"])
def test_k12_k13_bindings_match_the_entries(source):
    """Every ctypes signature of K12's, K13's, K17's and K4's libraries
    matches its entry's parameters (an int as c_int, a pointer or the
    stream as c_void_p), and every entry is bound: the card's build cannot
    run here, so the binding is checked against the sources."""
    import ctypes

    entries = _entries(source)
    sigs = K._SIGNATURES[source]
    assert set(entries) == set(sigs), (source, set(entries) ^ set(sigs))
    for fn, kinds in entries.items():
        want = [ctypes.c_int if k == "i" else ctypes.c_void_p for k in kinds]
        assert sigs[fn] == want, fn


def test_k13_workspace_words_match_the_kernel():
    """The fold's look-back words sit past its workspace head: the
    delta's live-count word below WS_WORDS, K13's tiles of PT rows."""
    text = (Path(K.__file__).resolve().parent / "csrc"
            / "word_compact.cu").read_text()

    def define(name):
        return int(re.search(rf"#define {name} (\d+)", text).group(1))

    assert define("WS_DLIVE") < define("WS_WORDS") == K._WS_HEAD
    assert len({define(k) for k in ("WS_TICKET", "WS_TOTAL", "WS_LIVE",
                                    "WS_NTILES", "WS_DLIVE")}) == 5
    assert define("PT") == K.K13_TILE
    assert K._k13_tiles(K.K13_TILE + 1) == 2 * K.K4_TILE
