"""The MVCC conflict-resolution kernel, resident + window + accept or wave.

The port of ``foundationdb_tpu/models/conflict_kernel.py`` at its default
design point: a device-resident key dictionary, a two-level (frozen base +
small delta) rank-space history, sparse-table range max and exact
sequential-order acceptance; and its wave-commit arm (``wave=True``),
which schedules a batch into dependency-ordered commit waves instead.
Semantics are the JAX module's; its docstrings explain the algorithms.

Every function that carries device work dispatches on where its tensors
live. On the CPU it runs the plain torch version (``*_plain``), which the
tests hold against the JAX package byte for byte. On a CUDA tensor it
launches the hand-written kernel (kernels/csrc/*.cu) and never falls back:

- K1 ``dict_insert.cu``: dictionary insert, rank-row rewrites, version rebase;
- K7 ``dict_evict.cu``: the tiered dictionary's demotion (evict, shift table);
- K2 ``history_probe.cu``: sparse-table build, history probe, too-old mask;
- K3 ``accept.cu``: overlap rows, sequential acceptance, verdicts, losers;
- K4 ``step_compact.cu``: paint, base+delta fold, dedup and compaction;
- K5, K6 ``wave.cu``: the wave predecessor matrix and the wave leveling;
- K8, K9, K10 ``shard.cu``: the sharded engine's probe with the
  cross-shard OR (over each shard's live rows, ``live_probe.cuh``), its
  per-shard clip, and its wave exchange (the OR of the shards'
  predecessor matrices and their occupied tiles).

The window program ``resolve_many_res`` (the JAX ``lax.scan`` of
``resolve_many_res``) has no kernel source of its own: on the card it is
the launch sequence of K1 once for the window's delta, then K2, K3 (or
K5 and K6) and K4 for each of the k batches, with no host sync inside the
window. The two-phase wave protocol (``wave_edges_res`` /
``wave_apply_res``) is a launch sequence over K1, K2, K5 and K6, K4. The
speculative engine's paint-only re-advance ``paint_many_res`` is K1 once,
then per step the gated K4 fold and a K4 paint with a host-forced accept
mask; its rollback target is ``snapshot_res``, a deep copy of the state.
The sharded engine (section B3: S keyspace shards on one card, each with
a flat history) runs ``sharded_resolve_res_many``: K1 once, then per step
K9, K8 (its live table and probe), K3 (or K5 per shard, K10 and K6) and K4
per shard.

The packed non-resident engine (section B4: ``resident=False``) keeps a
two-level history of full [C, W] word keys and gets, with every batch, a
host-built dictionary of the batch's unique endpoint keys: K12
``word_probe.cu`` searches every dictionary row into the base and the
delta (the W-word two-sided search) and probes the read slots by rank
over K2's tables; K13 ``word_compact.cu`` is K4 at width W (paint with
the keys gathered from the dictionary by rank, fold, compaction). Its
window program ``resolve_many_hist_packed`` is, per step, the gated K13
fold and K2 base table, K12's search, K2's delta table and K12's probe,
K3 (or K5 and K6) and the K13 paint; speculation's dependency probe
paints rejected writes into a flat scratch state (K13) and probes each
younger window's dictionaries against it (K12).

The unpacked flat programs (section B5 flat: a batch of full [B, ., W] key
rows, one flat [C, W] history whose sparse table is rebuilt every batch)
and the non-resident sharded engine that runs them (section B3 with
``resident=False``: S flat histories stacked on a leading axis; K16 reads
only their live rows and builds its own range-max table over them) sort on
the card: K14 ``word_sort.cu`` is a stable sort of W-word rows carrying
payload columns, with a rank tail that gives ``endpoint_ranks_live``;
K15 and K16 ``word_shard.cu`` clip a full-key batch to every shard and
probe the clipped reads of every shard with the cross-shard OR; the paint
is K13's ``wc_paint_keys``, K12's search, K14's sort and K13's
``wc_paint_sorted``. Its window program ``sharded_resolve_many`` is, per
step, K16, K15, K14 and K3 (or per shard K14 and K5, then K10 and K6),
and the paint of each shard.

Under ``rmq="blocked"`` (the JAX FDB_TPU_RMQ knob) each per-batch table is
K17's blocked structure (kernels/csrc/rmq_blocked.cu) in place of K2's
sparse table, built in one launch over the level's live rows [0, n_used)
only, and its probe clamps each range to them (the rows past n_used are
(+inf, NEG_VERSION), so the answers are JAX's over all rows); on a
sharded engine, resident or not, K17's sharded probe (``rb_shard_probe``:
the build over every shard's live rows, then K8's and K16's probe of
live_probe.cuh with the blocked range max, two launches) replaces K8 or
K16.

JAX donates the state argument of every entry point. Here each function
that takes a state CONSUMES it: on the card the history arrays are updated
in place, on the CPU a new state is built; either way callers rebind to
the returned state and never reuse the argument.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from foundationdb_tpu_torch import kernels as K
from foundationdb_tpu_torch.core.keypack import INT32_MAX as _I32MAX
from foundationdb_tpu_torch.core.types import WAVE_LEVEL_CYCLE as LEVEL_CYCLE
from foundationdb_tpu_torch.core.types import WAVE_LEVEL_NONE as LEVEL_NONE
from foundationdb_tpu_torch.ops.bitset import (
    pack_bits_u32,
    to_int32_bits,
    unpack_bits_u32,
)
from foundationdb_tpu_torch.ops.lex import (
    lex_le,
    lex_lt,
    lex_max,
    lex_min,
    searchsorted_words,
    searchsorted_words_2sided_fp,
    searchsorted_words_fp,
    sort_keys_with_payload,
)
from foundationdb_tpu_torch.ops.rmq import (
    block_table,
    block_table_live,
    range_max,
    range_max_blocked,
    range_max_blocked_live,
    sparse_table,
)

INT32_MAX = int(_I32MAX)
NEG_VERSION = -(2**31) + 1

V_COMMITTED = 0
V_CONFLICT = 1
V_TOO_OLD = 2

_ACCEPT_BLOCK = 512

# Window launch sequences issued on the card (resolve_many_res,
# paint_many_res, sharded_resolve_res_many, resolve_many_hist_packed,
# sharded_resolve_many), counted like the kernel launches in
# kernels.LAUNCHES.
LAUNCHES = {"resolve_many": 0, "paint_many": 0, "sharded_many": 0,
            "packed_many": 0, "nr_sharded_many": 0, "unpacked_many": 0}

#: The range-max designs of a per-batch table (the JAX FDB_TPU_RMQ knob): a
#: sparse table (K2) or the two-level blocked structure (K17). A two-level
#: history's base table is sparse under both, as in JAX.
RMQ_DESIGNS = ("sparse", "blocked")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class ConflictState(NamedTuple):
    """Device write history (a step function over rank space)."""

    keys: torch.Tensor  # int32 [C, W] sorted; keys[0] = min key; tail = +inf
    versions: torch.Tensor  # int32 [C]; tail NEG_VERSION
    n_used: torch.Tensor  # int32 0-dim: live boundary count
    oldest: torch.Tensor  # int32 0-dim: oldest resolvable (relative) version
    overflow: torch.Tensor  # bool 0-dim: capacity exceeded (sticky)


class HistState(NamedTuple):
    """Two-level history: frozen base + its sparse table + live delta."""

    base: ConflictState
    base_st: torch.Tensor  # int32 [L, C] sparse table over base.versions
    delta: ConflictState  # capacity Cd; oldest = the live window floor


class RankBatch(NamedTuple):
    """One padded batch in resident rank space (see the JAX RankBatch)."""

    read_begin: torch.Tensor  # int32 [B, R]
    read_end: torch.Tensor  # int32 [B, R]
    read_mask: torch.Tensor  # bool [B, R]
    write_begin: torch.Tensor  # int32 [B, Q]
    write_end: torch.Tensor  # int32 [B, Q]
    write_mask: torch.Tensor  # bool [B, Q]
    read_version: torch.Tensor  # int32 [B] (relative)
    txn_mask: torch.Tensor  # bool [B]
    paint_src: torch.Tensor  # int32 [2·B·Q] argsort of the write endpoints


class ResidentBatch(NamedTuple):
    """A RankBatch plus its dictionary delta (sorted new keys, +inf padded)."""

    delta_keys: torch.Tensor  # int32 [M, W]
    ranks: RankBatch


class ResState(NamedTuple):
    """Device-resident dictionary + rank-space history (+ shard bounds)."""

    dict_keys: torch.Tensor  # int32 [D + 1, W] sorted, +inf padded
    n_keys: torch.Tensor  # int32 0-dim
    hist: HistState
    shard_lo: torch.Tensor  # int32 [S]
    shard_hi: torch.Tensor


def _on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version). Any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _i32(v, device) -> torch.Tensor:
    """0-dim int32 on ``device``. A Python int is written by a fill launch,
    not a blocking host-to-device copy, so it costs no host sync."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int32)
    return torch.full((), int(v), dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# State construction
# ---------------------------------------------------------------------------


def init_state(capacity: int, width: int, min_key, device) -> ConflictState:
    """min_key: boundary 0 (the packed b"", or rank 0 at width 1)."""
    keys = torch.full((capacity, width), INT32_MAX, dtype=torch.int32,
                      device=device)
    keys[0] = torch.as_tensor(min_key, dtype=torch.int32)
    return ConflictState(
        keys=keys,
        versions=torch.full((capacity,), NEG_VERSION, dtype=torch.int32,
                            device=device),
        n_used=_i32(1, device),
        oldest=_i32(0, device),
        overflow=torch.zeros((), dtype=torch.bool, device=device),
    )


def init_hist(capacity: int, width: int, min_key, delta_capacity: int,
              device) -> HistState:
    base = init_state(capacity, width, min_key, device)
    return HistState(base=base, base_st=build_table(base.versions),
                     delta=init_state(delta_capacity, width, min_key, device))


def init_res(dict_rows, dict_capacity: int, capacity: int,
             delta_capacity: int | None, device) -> ResState:
    """dict_rows: host-built initial dictionary [n0, W] (row 0 = packed b"").
    ``delta_capacity`` selects the two-level window history; None gives
    the flat [C, 1] rank history (the JAX ``init_res`` at :1921)."""
    dict_rows = torch.as_tensor(dict_rows, dtype=torch.int32)
    n0, w = dict_rows.shape
    dict_keys = torch.full((dict_capacity + 1, w), INT32_MAX,
                           dtype=torch.int32, device=device)
    dict_keys[:n0] = dict_rows
    return ResState(
        dict_keys=dict_keys,
        n_keys=_i32(n0, device),
        hist=(init_state(capacity, 1, [0], device) if delta_capacity is None
              else init_hist(capacity, 1, [0], delta_capacity, device)),
        shard_lo=torch.zeros(1, dtype=torch.int32, device=device),
        shard_hi=torch.full((1,), INT32_MAX, dtype=torch.int32,
                            device=device),
    )


# ---------------------------------------------------------------------------
# K2: sparse table + history probe (+ too-old mask)
# ---------------------------------------------------------------------------


def build_table(values: torch.Tensor) -> torch.Tensor:
    """Sparse table over ``values`` (a new tensor; values untouched)."""
    if _on_card(values):
        return K.build_table(values)
    return sparse_table(values)


def too_old_mask_packed(state: ConflictState, rbk: RankBatch, new_oldest):
    """(floor, too_old[B]): the floor never regresses; write-only txns are
    never too old."""
    has_reads = (rbk.read_mask & (rbk.read_begin < rbk.read_end)).any(1)
    floor = torch.maximum(state.oldest, _i32(new_oldest, state.oldest.device))
    too_old = rbk.txn_mask & has_reads & (rbk.read_version < floor)
    return floor, too_old


def _rank_probe(keys: torch.Tensor, q: torch.Tensor, side: str):
    return searchsorted_words(keys, q[..., None], side=side)


def range_max_blocked_live_plain(values: torch.Tensor, n_used, lo, hi):
    """K17's live build and query of one history level, plain: the
    blocked structure over ``values[:n_used]`` and max(values[max(lo,
    0):min(hi, n_used)]) per query (what ``rb_probe`` takes from a level
    given its n_used)."""
    n = int(n_used)
    return range_max_blocked_live(block_table_live(values, n, NEG_VERSION),
                                  lo, hi, n, NEG_VERSION)


def range_max_rmq(values: torch.Tensor, lo, hi, rmq: str = "sparse"):
    """max(values[lo:hi]) per query through a table built here, sparse or
    blocked (plain versions; the JAX per-batch table of either design)."""
    if rmq == "blocked":
        return range_max_blocked(block_table(values, NEG_VERSION), lo, hi,
                                 NEG_VERSION)
    return range_max(sparse_table(values), lo, hi, NEG_VERSION)


def _history_conflict_ranges_hist_res(base: ConflictState, base_st,
                                      delta: ConflictState, rbk: RankBatch,
                                      rmq: str = "sparse"):
    """bool [B, R]: read slot overlaps a base or delta write newer than its
    read version (plain version; the delta table is built here, sparse or
    blocked)."""
    b, r = rbk.read_begin.shape
    qb = rbk.read_begin.reshape(-1)
    qe = rbk.read_end.reshape(-1)
    newest_b = range_max(
        base_st,
        (_rank_probe(base.keys, qb, "right") - 1).clamp(min=0),
        _rank_probe(base.keys, qe, "left"),
        NEG_VERSION,
    )
    lo_d = (_rank_probe(delta.keys, qb, "right") - 1).clamp(min=0)
    hi_d = _rank_probe(delta.keys, qe, "left")
    newest_d = range_max_rmq(delta.versions, lo_d, hi_d, rmq)
    newest = torch.maximum(newest_b, newest_d).reshape(b, r)
    live = rbk.read_mask & (rbk.read_begin < rbk.read_end)
    return live & (newest > rbk.read_version[:, None])


def history_probe_plain(hist, rbk: RankBatch, floor, rmq: str = "sparse"):
    """(too_old[B], hist_mask[B, R], cand[B]) with ``floor`` already
    computed: the plain twin of the probe launches, over a two-level
    HistState or a flat [C, 1] ConflictState."""
    has_reads = (rbk.read_mask & (rbk.read_begin < rbk.read_end)).any(1)
    too_old = rbk.txn_mask & has_reads & (rbk.read_version < floor)
    if isinstance(hist, HistState):
        hist_mask = _history_conflict_ranges_hist_res(
            hist.base, hist.base_st, hist.delta, rbk, rmq)
    else:
        hist_mask = _history_conflict_ranges_res(hist, rbk, rmq)
    cand = rbk.txn_mask & ~too_old & ~hist_mask.any(1)
    return too_old, hist_mask, cand


def _rank_bounds(keys0, q, keys1=None):
    """K12's search at W = 1 of the slot ranks ``q`` [B, R] into the rank
    keys ``keys0`` (and ``keys1``): (ls0, rs0, ls1, rs1) per slot."""
    return K.word_search(keys0, q.reshape(-1, 1), keys1)


def history_probe(hist, rbk: RankBatch, floor, rmq: str = "sparse",
                  table=None):
    """The resident history probe, over a two-level HistState or the flat
    [C, 1] history. On the card, sparse: K2's table over the delta (over
    the whole flat history), then one K2 probe launch that writes the slot
    mask, too_old and the acceptance candidates. Blocked: K17's build over
    the live rows of the delta (the flat history), K12's search of the
    slots' begin and end ranks into the base and the delta, and K17's
    probe, which takes the base's range max from its prebuilt sparse table
    and the level's over its live rows (``table``, K17's build of that
    level, when the caller has made it). ``floor`` is the 0-dim int32
    too-old floor."""
    if not _on_card(rbk.read_begin):
        return history_probe_plain(hist, rbk, floor, rmq)
    tail = (rbk.read_mask, rbk.read_version, rbk.txn_mask, floor)
    if isinstance(hist, HistState):
        base, base_st, level = hist.base, hist.base_st, hist.delta
    else:
        base, base_st, level = None, None, hist
    if rmq == "blocked":
        if table is None:
            table = K.blocked_build(level.versions, level.n_used)
        if base is None:
            _, rs, _, _ = _rank_bounds(level.keys, rbk.read_begin)
            ls, _, _, _ = _rank_bounds(level.keys, rbk.read_end)
            return K.blocked_probe(level.versions, table, rs, ls,
                                   rbk.read_begin, rbk.read_end, *tail,
                                   n_used=level.n_used)
        _, rs_b, _, rs_d = _rank_bounds(base.keys, rbk.read_begin, level.keys)
        ls_b, _, ls_d, _ = _rank_bounds(base.keys, rbk.read_end, level.keys)
        return K.blocked_probe(level.versions, table, rs_d, ls_d,
                               rbk.read_begin, rbk.read_end, *tail,
                               base_st=base_st, rs_b=rs_b, ls_b=ls_b,
                               n_used=level.n_used)
    st = K.build_table(level.versions)
    if base is None:
        return K.history_probe(level.keys, st, None, None, rbk.read_begin,
                               rbk.read_end, *tail)
    return K.history_probe(base.keys, base_st, level.keys, st,
                           rbk.read_begin, rbk.read_end, *tail)


# ---------------------------------------------------------------------------
# K3: sequential-order acceptance, verdicts, loser mask
# ---------------------------------------------------------------------------


def _overlap_rows(rows_rb, rows_re, rows_live, wb, we, write_live):
    """bool [N, B]: read ranges of N txns vs write ranges of all B txns."""
    n, r = rows_rb.shape
    b, q = wb.shape
    m = torch.zeros((n, b), dtype=torch.bool, device=wb.device)
    for i in range(r):
        rbi = rows_rb[:, i, None]
        rei = rows_re[:, i, None]
        livei = rows_live[:, i, None]
        for j in range(q):
            t = (rbi < we[None, :, j]) & (wb[None, :, j] < rei)
            m |= t & livei & write_live[None, :, j]
    return m


def _wave_accept(base: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Exact sequential acceptance by relaxation rounds (the JAX
    ``_wave_accept``); the round loop tests ``det.all()`` on the host."""
    b = base.shape[0]
    p = m & torch.ones((b, b), dtype=torch.bool, device=m.device).tril(-1)

    def mv(vec):
        return (p & vec[None, :]).any(1)

    det = ~base
    acc = torch.zeros_like(base)
    i = 0
    while i < b and not bool(det.all()):
        hit_acc = mv(acc)
        pending = mv(~det)
        newly_rej = ~det & hit_acc
        newly_acc = ~det & base & ~hit_acc & ~pending
        det = det | newly_rej | newly_acc | (~det & ~base)
        acc = acc | newly_acc
        i += 1
    return acc


def _block_accept_fused(base, rb, re_, read_live, wb, we, write_live):
    """Block-sequential acceptance, G = 512 txns per block; a batch that
    is not a multiple of G takes the dense whole-batch form, as in JAX."""
    b = base.shape[0]
    g = min(_ACCEPT_BLOCK, b)
    if b % g:
        m = _overlap_rows(rb, re_, read_live, wb, we, write_live)
        return _wave_accept(base, m)
    acc = torch.zeros_like(base)
    for k in range(b // g):
        s = slice(k * g, (k + 1) * g)
        rows = _overlap_rows(rb[s], re_[s], read_live[s], wb, we, write_live)
        prior_hit = (rows & acc[None, :]).any(1)
        acc[s] = _wave_accept(base[s] & ~prior_hit, rows[:, s])
    return acc


def accept_rows_plain(cand, ranks):
    """Plain twin of K3's overlap stage: (rows int32 [B, ceil(B/32)],
    first int32 [B], last int32 [B]). Bit j of row i is set when a live
    read of candidate i overlaps a live write of candidate j < i (a
    non-candidate can never be accepted, so its column is dropped, and
    its row stays zero); ``first``/``last`` are the row's first and last
    nonzero words, -1 both for a row with no bit."""
    b = cand.shape[0]
    nw = (b + 31) // 32
    m = _overlap_rows(*ranks) & cand[:, None] & cand[None, :]
    m &= torch.ones((b, b), dtype=torch.bool, device=cand.device).tril(-1)
    rows = pack_bits_u32(_pad0(m.T, nw * 32).T)
    nz = rows != 0
    idx = torch.arange(nw, device=cand.device)
    first = torch.where(nz, idx, nw).min(1).values
    last = torch.where(nz, idx, -1).max(1).values
    first = torch.where(last >= 0, first, -1)
    return rows, first.to(torch.int32), last.to(torch.int32)


def settle_plain(cand, rows, first, last):
    """Plain twin of K3's settle stage: (accepted bool [B], pending int64
    [P], the rows left after the first pass, in index order). A candidate
    with no bit is accepted at once (``acc0``); a row with bits that meets
    ``acc0`` is rejected at once (those rows are final); the pending rest
    are settled in index order, each accepted when none of its nonzero
    words meets the accepted set so far: the exact sequential result. (The
    card settles part of them by relaxation rounds before its serial walk;
    the answer is the same.)"""
    nw = rows.shape[1]
    acc = cand & (last < 0)
    acc0 = pack_bits_u32(_pad0(acc, nw * 32))
    hit0 = ((rows & acc0[None, :]) != 0).any(1)
    pending = torch.nonzero(cand & (last >= 0) & ~hit0).flatten()
    accw = (acc0.long() & 0xFFFFFFFF).tolist()
    acc = acc.clone()
    for i in pending.tolist():
        f, n = int(first[i]), int(last[i]) + 1
        words = (rows[i, f:n].long() & 0xFFFFFFFF).tolist()
        if not any(w & a for w, a in zip(words, accw[f:n])):
            acc[i] = True
            accw[i >> 5] |= 1 << (i & 31)
    return acc, pending


def accept_counts(cand, too_old, txn_mask, ranks) -> dict:
    """What K3's two designs do on one batch, by the plain twins: the
    candidate rows, the rows with a candidate predecessor (``edgeful``)
    and their bits, the words the one-block scan's demotion reads (each
    candidate row's words before its 512-txn block), the edgeful rows
    rejected at once and the pending rest with their words."""
    rows, first, last = accept_rows_plain(cand, ranks)
    _, pending = settle_plain(cand, rows, first, last)
    edge = last >= 0
    idx = torch.nonzero(cand).flatten()
    span = (last - first + 1)[pending]
    return {
        "candidates": int(cand.sum()), "edgeful_rows": int(edge.sum()),
        "edge_bits": int(unpack_bits_u32(rows, rows.shape[1] * 32).sum()),
        "demotion_words": int(((idx // _ACCEPT_BLOCK)
                               * (_ACCEPT_BLOCK // 32)).sum()),
        "pruned_rows": int(edge.sum()) - pending.numel(),
        "pending_rows": pending.numel(), "pending_words": int(span.sum()),
        "transactions": int(txn_mask.sum()), "too_old": int(too_old.sum())}


def assemble_verdicts(too_old, txn_mask, accepted) -> torch.Tensor:
    return torch.where(
        too_old,
        V_TOO_OLD,
        torch.where(txn_mask & ~accepted, V_CONFLICT, V_COMMITTED),
    ).to(torch.int8)


def endpoint_ranks_live_packed(rbk: RankBatch):
    read_live = rbk.read_mask & (rbk.read_begin < rbk.read_end)
    write_live = rbk.write_mask & (rbk.write_begin < rbk.write_end)
    return (rbk.read_begin, rbk.read_end, read_live,
            rbk.write_begin, rbk.write_end, write_live)


def accept_plain(cand, too_old, txn_mask, ranks):
    accepted = _block_accept_fused(cand, *ranks)
    return accepted, assemble_verdicts(too_old, txn_mask, accepted)


def _written(out, t):
    """``t``, copied into ``out`` when one is given (the plain path)."""
    if out is None:
        return t
    out.copy_(t)
    return out


def accept(cand, too_old, txn_mask, ranks, out=None):
    """K3: (accepted bool [B], verdicts int8 [B]) — overlap rows, the
    in-order block scan and the verdict epilogue. The verdicts go into
    ``out`` (a contiguous int8 [B]) when it is given."""
    if _on_card(cand):
        return K.accept(cand, too_old, txn_mask, *ranks, verdicts=out)
    accepted, verdicts = accept_plain(cand, too_old, txn_mask, ranks)
    return accepted, _written(out, verdicts)


def _read_vs_accepted_writes(rb, re_, read_live, wb, we, write_live,
                             accepted):
    b, q = wb.shape
    aw = (write_live & accepted[:, None]).reshape(b * q)
    wbf = wb.reshape(b * q)
    wef = we.reshape(b * q)
    hit = ((rb[:, :, None] < wef[None, None, :])
           & (wbf[None, None, :] < re_[:, :, None]) & aw[None, None, :])
    return read_live & hit.any(2)


def loser_range_mask(hist_mask, ranks, accepted, verdicts):
    """bool [B, R]: which read slots of each CONFLICT txn lost."""
    rb, re_, read_live, wb, we, write_live = ranks
    intra = _read_vs_accepted_writes(rb, re_, read_live, wb, we, write_live,
                                     accepted)
    return (hist_mask | intra) & (verdicts == V_CONFLICT)[:, None]


def pack_loser_mask(losers: torch.Tensor) -> torch.Tensor:
    """bool [B, R] -> int32 bit patterns [B] (bit c = slot c lost) when
    R <= 32; wider R stays bool, as in JAX."""
    b, r = losers.shape
    if r > 32:
        return losers
    lanes = torch.arange(r, device=losers.device, dtype=torch.int64)
    return to_int32_bits((losers.long() << lanes[None, :]).sum(1))


def loser_mask_plain(hist_mask, ranks, accepted, verdicts):
    return pack_loser_mask(loser_range_mask(hist_mask, ranks, accepted,
                                            verdicts))


def loser_mask(hist_mask, ranks, accepted, verdicts):
    """K3 report launch: the packed loser mask of a report chunk."""
    if _on_card(hist_mask):
        return K.loser_mask(hist_mask, accepted, verdicts, *ranks)
    return loser_mask_plain(hist_mask, ranks, accepted, verdicts)


# ---------------------------------------------------------------------------
# K5 + K6: wave commit (reorder, don't abort)
# ---------------------------------------------------------------------------
#
# A wave engine schedules the candidate txns of a batch into dependency-
# ordered commit waves instead of aborting in batch order: txn i must
# serialize before txn j when a read of i overlaps a write of j. Only the
# members of a true cycle abort, one minimum-index victim per stall.
# Levels ride beside the verdicts: >= 0 committed at that wave,
# LEVEL_NONE any other non-commit, LEVEL_CYCLE a cycle abort. Stats, where
# a caller passes them, are an int64 [5] tensor on the batch's device
# that accumulates (batches, rounds, victims, max rounds, max victims).


def _pad0(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` zero- (False-) padded along dim 0 to ``n`` rows."""
    if x.shape[0] == n:
        return x
    pad = torch.zeros((n - x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, pad])


def _pred_matrix_packed_plain(base, rb, re_, read_live, wb, we, write_live):
    """int32 [BP, BP/32] over inputs already padded to BP: blocks of G rows
    (writers) against every txn's reads, packed as they are built, then
    the diagonal cleared and the columns masked to the candidates."""
    bp = base.shape[0]
    g = min(_ACCEPT_BLOCK, bp)
    rows = [pack_bits_u32(_overlap_rows(wb[s:s + g], we[s:s + g],
                                        write_live[s:s + g], rb, re_,
                                        read_live))
            for s in range(0, bp, g)]
    p = torch.cat(rows)
    idx = torch.arange(bp, device=base.device)
    diag = torch.zeros_like(p)
    diag[idx, idx >> 5] = to_int32_bits(torch.ones_like(idx) << (idx & 31))
    return p & ~diag & pack_bits_u32(base)[None, :]


def wave_pred_matrix_plain(base, ranks):
    """Plain twin of K5 (the JAX ``wave_pred_matrix``)."""
    b = base.shape[0]
    bp = (b + 31) // 32 * 32
    return _pred_matrix_packed_plain(_pad0(base, bp),
                                     *(_pad0(x, bp) for x in ranks))


def wave_pred_tiles_plain(base, ranks, tw: int | None = None):
    """K5 by its tiled ballot layout (wave.cu ``k_pred``), in plain torch:
    blocks of ``kernels.PRED_ROWS`` writer rows by tiles of ``tw`` words
    (default: the kernel's, ``kernels.wave_pred_tile``). A dead slot, a
    reader that is not a candidate and a padding column are staged as the
    empty interval (INT32_MAX, INT32_MIN), which no test can hit; a row
    with no live write and a word with no live reader are zero without a
    test; bit k of word w is lane k's test of reader 32w + k; the diagonal
    is cleared by a mask. The JAX ``wave_pred_matrix``'s result."""
    rb, re_, rlive, wb, we, wlive = ranks
    b, r = rb.shape
    q = wb.shape[1]
    bp = (b + 31) // 32 * 32
    nw = bp // 32
    tw = tw or K.wave_pred_tile(r, q, nw)
    empty_b, empty_e = INT32_MAX, -INT32_MAX - 1
    live_r = _pad0(base[:, None] & rlive, bp)
    rd_b = torch.where(live_r, _pad0(rb, bp), empty_b)
    rd_e = torch.where(live_r, _pad0(re_, bp), empty_e)
    live_w = _pad0(wlive, bp)
    wr_b = torch.where(live_w, _pad0(wb, bp), empty_b)
    wr_e = torch.where(live_w, _pad0(we, bp), empty_e)
    rows = torch.zeros((bp, nw), dtype=torch.int32, device=base.device)
    for w0 in range(0, nw, tw):
        cols = slice(32 * w0, 32 * min(nw, w0 + tw))
        word_live = live_r[cols].any(1).reshape(-1, 32).any(1)
        for j0 in range(0, bp, K.PRED_ROWS):
            jr = slice(j0, min(bp, j0 + K.PRED_ROWS))
            hit = ((wr_b[jr, None, :, None] < rd_e[None, cols, None, :])
                   & (rd_b[None, cols, None, :] < wr_e[jr, None, :, None]))
            hit = (hit.flatten(2).any(2) & live_w[jr].any(1)[:, None]
                   & word_live.repeat_interleave(32)[None, :])
            rows[jr, w0:w0 + word_live.shape[0]] = pack_bits_u32(hit)
    idx = torch.arange(bp, device=base.device)
    diag = torch.zeros_like(rows)
    diag[idx, idx >> 5] = to_int32_bits(torch.ones_like(idx) << (idx & 31))
    return rows & ~diag


def wave_pred_matrix(base, ranks):
    """K5: packed predecessor rows int32 [BP, BP/32], BP = ceil32(B): bit
    i of row j is set when a live read of txn i overlaps a live write of
    txn j, for candidate columns i != j (rows of non-candidates keep their
    bits). Shards partition the keyspace, so the OR of per-shard clipped
    matrices is the global one: the payload of ``resolve_edges``."""
    if _on_card(base):
        return K.wave_pred(base, *ranks)
    return wave_pred_matrix_plain(base, ranks)


def _lowest_bit(word: int) -> int:
    word &= 0xFFFFFFFF
    return (word & -word).bit_length() - 1


def _min_pred(p, undp, j: int) -> int:
    """Lowest-index undetermined predecessor of txn j (called on stalled
    txns only, whose undetermined predecessor set is not empty)."""
    row = p[j] & undp
    w = int(torch.nonzero(row)[0, 0])
    return 32 * w + _lowest_bit(int(row[w]))


def _cycle_victim(p, undet, undp) -> int:
    """The minimum member of the cycle that the min-predecessor walk from
    the lowest undetermined txn enters: walk to the first repeated node
    (on the cycle), then once around it. The JAX walk (BP steps, then BP
    more keeping the minimum) gives the same victim."""
    j = int(torch.nonzero(undet)[0, 0])
    seen = set()
    while j not in seen:
        seen.add(j)
        j = _min_pred(p, undp, j)
    victim, k = j, _min_pred(p, undp, j)
    while k != j:
        victim = min(victim, k)
        k = _min_pred(p, undp, k)
    return victim


def _add_stats(stats, rounds: int, victims: int) -> None:
    if stats is None:
        return
    stats += torch.tensor([1, rounds, victims, 0, 0], dtype=torch.int64,
                          device=stats.device)
    stats[3] = torch.clamp(stats[3], min=rounds)
    stats[4] = torch.clamp(stats[4], min=victims)


def _wave_level_packed_plain(base, p, stats=None) -> torch.Tensor:
    """level int32 [BP] (the JAX ``_wave_level_packed``): each round levels
    every undetermined txn with no undetermined predecessor into the next
    wave, or, when none is ready, aborts one cycle victim. Blocked-ness is
    tested on the undetermined rows only, which changes no result."""
    bp = base.shape[0]
    undet = base.clone()
    level = torch.full((bp,), LEVEL_NONE, dtype=torch.int32,
                       device=base.device)
    wave = rounds = victims = 0
    while rounds < bp + 1 and bool(undet.any()):
        undp = pack_bits_u32(undet)
        idx = torch.nonzero(undet).flatten()
        ready = idx[~((p[idx] & undp[None, :]) != 0).any(1)]
        if ready.numel():
            level[ready] = wave
            undet[ready] = False
            wave += 1
        else:
            v = _cycle_victim(p, undet, undp)
            level[v] = LEVEL_CYCLE
            undet[v] = False
            victims += 1
        rounds += 1
    _add_stats(stats, rounds, victims)
    return level


def wave_level_plain(cand, p, too_old=None, txn_mask=None, stats=None):
    """Plain twin of K6: (accepted [B], level int32 [B], verdicts int8 [B]
    or None without ``too_old``/``txn_mask``)."""
    b = cand.shape[0]
    level = _wave_level_packed_plain(_pad0(cand, p.shape[0]), p, stats)[:b]
    accepted = level >= 0
    verdicts = (None if too_old is None
                else assemble_verdicts(too_old, txn_mask, accepted))
    return accepted, level, verdicts


def wave_level(cand, p, too_old=None, txn_mask=None, stats=None,
               level_out=None, verdicts_out=None):
    """K6: the wave schedule of the candidates ``cand`` [B] over ``p``, and
    with ``too_old``/``txn_mask`` the verdicts as their epilogue. The JAX
    ``wave_level_from_graph`` first re-masks the columns of a global
    matrix to the candidates; here that is implied, since the leveling
    reads only ``p[j] & undetermined`` and the undetermined set never
    leaves the candidates. The levels and verdicts go into
    ``level_out``/``verdicts_out`` when they are given."""
    if _on_card(cand):
        return K.wave_level(cand, p, too_old, txn_mask, stats=stats,
                            level=level_out, verdicts=verdicts_out)
    accepted, level, verdicts = wave_level_plain(cand, p, too_old, txn_mask,
                                                 stats)
    return (accepted, _written(level_out, level),
            None if verdicts is None else _written(verdicts_out, verdicts))


def wave_level_from_graph(cand, p, stats=None):
    """(accepted [B], level [B]) from a global matrix and candidate mask."""
    accepted, level, _ = wave_level(cand, p, stats=stats)
    return accepted, level


# ---------------------------------------------------------------------------
# K4: step-function rewrites (paint, fold, dedup + compaction)
# ---------------------------------------------------------------------------


def _merge_positions(pos_n: torch.Tensor, n: int):
    """Merge-path gather plan: for each output slot, (from_new, k_new,
    cnt_le) given the strictly increasing slots ``pos_n`` of new rows."""
    idx = torch.arange(n, dtype=torch.int32, device=pos_n.device)
    cnt_le = torch.searchsorted(pos_n.contiguous(), idx, right=True).to(
        torch.int32)
    k_new = (cnt_le - 1).clamp(min=0)
    from_new = (cnt_le > 0) & (pos_n[k_new.clamp(max=pos_n.shape[0] - 1).long()]
                               == idx)
    return idx, cnt_le, k_new.long(), from_new


def _dedup_compact_plain(skeys, newv, c_out: int, prior_overflow):
    """Dedup equal keys (keep last), drop boundaries equal to the previous
    dedup survivor's version, force the min key's last row, compact to
    ``c_out`` rows. Returns (keys, versions, n_used, overflow)."""
    n, w = skeys.shape
    dev = skeys.device
    is_inf = (skeys == INT32_MAX).all(-1)
    neq_next = (skeys[:-1] != skeys[1:]).any(-1)
    keep1 = torch.cat([neq_next, torch.ones(1, dtype=torch.bool, device=dev)])
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    kept_idx = torch.where(keep1, idx, -1)
    prev_kept = torch.cat([torch.full((1,), -1, dtype=torch.int64, device=dev),
                           torch.cummax(kept_idx, 0).values[:-1]])
    prev_v = torch.where(prev_kept >= 0, newv[prev_kept.clamp(min=0)],
                         torch.full_like(newv, NEG_VERSION - 1))
    keep = keep1 & (newv != prev_v) & ~is_inf
    first_live = torch.argmax((~is_inf).to(torch.int32))
    is_min = (skeys == skeys[first_live]).all(-1) & ~is_inf
    min_last = n - 1 - torch.argmax(is_min.flip(0).to(torch.int32))
    keep[min_last] = True
    keep_cum = torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32)
    n_used = keep_cum[-1]
    out_j = torch.arange(c_out, dtype=torch.int32, device=dev)
    src = torch.searchsorted(keep_cum, out_j + 1).clamp(0, n - 1)
    live_out = out_j < n_used
    fkeys = torch.where(live_out[:, None], skeys[src],
                        torch.full_like(skeys[src], INT32_MAX))
    fv = torch.where(live_out, newv[src], torch.full_like(newv[src],
                                                           NEG_VERSION))
    overflow = prior_overflow | (n_used > c_out)
    return fkeys, fv, torch.minimum(n_used, _i32(c_out, dev)), overflow


def _dedup_compact(skeys, newv, c_out: int, prior_overflow):
    """The shared compaction tail; on the card the K4 compact launch for
    width-1 (rank-space) rows, K13's for [n, W] word rows."""
    if _on_card(skeys):
        if skeys.shape[1] == 1:
            return K.compact(skeys, newv, c_out, prior_overflow)
        return K.word_compact(skeys, newv, c_out, prior_overflow)
    return _dedup_compact_plain(skeys, newv, c_out, prior_overflow)


def _paint_tail(state: ConflictState, snew, sdelta_new, soldv_new, scross,
                commit_version, new_oldest) -> ConflictState:
    c = state.keys.shape[0]
    n2 = snew.shape[0]
    n = c + n2
    pos_n = torch.arange(n2, dtype=torch.int32, device=snew.device) + scross
    idx, cnt_le, k_new, from_new = _merge_positions(pos_n, n)
    hist_idx = (idx - cnt_le).clamp(0, c - 1).long()
    skeys = torch.where(from_new[:, None], snew[k_new], state.keys[hist_idx])
    sdelta = torch.where(from_new, sdelta_new[k_new], 0)
    soldv = torch.where(from_new, soldv_new[k_new], state.versions[hist_idx])
    covered = torch.cumsum(sdelta, 0) > 0
    is_inf = (skeys == INT32_MAX).all(-1)
    cv = _i32(commit_version, snew.device)
    newv = torch.where(covered, cv, soldv)
    newv = torch.where((newv <= new_oldest) | is_inf, NEG_VERSION, newv).to(
        torch.int32)
    fkeys, fv, n_used, overflow = _dedup_compact_plain(skeys, newv, c,
                                                       state.overflow)
    return ConflictState(keys=fkeys, versions=fv, n_used=n_used,
                         oldest=_i32(new_oldest, snew.device).clone(),
                         overflow=overflow)


def _paint_and_compact_res_plain(state: ConflictState, rbk: RankBatch,
                                 accepted, commit_version, new_oldest):
    b, q = rbk.write_begin.shape
    e2 = b * q
    valid = (accepted[:, None] & rbk.write_mask
             & (rbk.write_begin < rbk.write_end)).reshape(e2).to(torch.int32)
    new_ranks = torch.cat([rbk.write_begin.reshape(e2),
                           rbk.write_end.reshape(e2)])
    new_delta = torch.cat([valid, -valid])
    cross_rank = _rank_probe(state.keys, new_ranks, "right")
    new_oldv = state.versions[(cross_rank - 1).clamp(min=0).long()]
    sidx = rbk.paint_src.long()
    return _paint_tail(state, new_ranks[sidx][:, None], new_delta[sidx],
                       new_oldv[sidx], cross_rank[sidx], commit_version,
                       new_oldest)


def _paint_and_compact_res(state: ConflictState, rbk: RankBatch, accepted,
                           commit_version: int, new_oldest) -> ConflictState:
    """K4 paint: merge the accepted writes' endpoints (in the host's
    ``paint_src`` order) into the delta, paint the commit version where
    coverage is positive, GC to the floor, compact. On the card the delta
    arrays are rewritten in place. ``new_oldest`` is the 0-dim floor."""
    if _on_card(state.keys):
        K.paint(state, rbk.write_begin, rbk.write_end, rbk.write_mask,
                accepted, rbk.paint_src, int(commit_version), new_oldest)
        return state
    return _paint_and_compact_res_plain(state, rbk, accepted, commit_version,
                                        new_oldest)


def _merge_delta_plain(base: ConflictState, delta: ConflictState, floor):
    c = base.keys.shape[0]
    cd = delta.keys.shape[0]
    n = c + cd
    cross_d = searchsorted_words_fp(base.keys, delta.keys, side="right")
    seg_b_for_d = (cross_d - 1).clamp(min=0).long()
    cross_b = searchsorted_words_fp(delta.keys, base.keys, side="right")
    seg_d_for_b = (cross_b - 1).clamp(min=0).long()
    pos_d = torch.arange(cd, dtype=torch.int32, device=base.keys.device) \
        + cross_d
    idx, cnt_le, k_d, from_d = _merge_positions(pos_d, n)
    b_idx = (idx - cnt_le).clamp(0, c - 1).long()
    skeys = torch.where(from_d[:, None], delta.keys[k_d], base.keys[b_idx])
    vb = torch.where(from_d, base.versions[seg_b_for_d[k_d]],
                     base.versions[b_idx])
    vd = torch.where(from_d, delta.versions[k_d],
                     delta.versions[seg_d_for_b[b_idx]])
    v = torch.maximum(vb, vd)
    is_inf = (skeys == INT32_MAX).all(-1)
    v = torch.where((v <= floor) | is_inf, NEG_VERSION, v).to(torch.int32)
    fkeys, fv, n_used, overflow = _dedup_compact_plain(
        skeys, v, c, base.overflow | delta.overflow)
    return ConflictState(keys=fkeys, versions=fv, n_used=n_used,
                         oldest=floor.clone(), overflow=overflow)


def _merge_delta(base: ConflictState, delta: ConflictState, floor):
    """K4 fold: pointwise max of base and delta over their union boundary
    set, GC to ``floor``, compact to base capacity. On the card the base
    arrays are rewritten in place (the delta is only read)."""
    if _on_card(base.keys):
        K.fold(base, delta, floor, None)
        return base
    return _merge_delta_plain(base, delta, floor)


def _reset_delta(delta: ConflictState, floor) -> ConflictState:
    keys = torch.full_like(delta.keys, INT32_MAX)
    keys[0] = delta.keys[0]
    return ConflictState(
        keys=keys,
        versions=torch.full_like(delta.versions, NEG_VERSION),
        n_used=_i32(1, delta.keys.device),
        oldest=floor.clone(),
        overflow=delta.overflow,
    )


def _maybe_merge_plain(hist: HistState, demand: int, floor) -> HistState:
    base, _st, delta = hist
    cd = delta.keys.shape[0]
    c = base.keys.shape[0]
    reclaimable = ((base.versions <= floor)
                   & (base.versions > NEG_VERSION)).sum()
    need = (delta.n_used + demand > cd) | (reclaimable >= max(c // 8, 1))
    if not bool(need):
        return hist
    nb = _merge_delta_plain(base, delta, floor)
    return HistState(nb, sparse_table(nb.versions), _reset_delta(delta, floor))


def _fold_launch(base: ConflictState, delta: ConflictState, floor,
                 demand: int | None):
    """The fold and the delta reset on the card; with ``demand`` gated on
    the device's decision (returned: a 0-dim bool), else forced. K4 for
    the rank-space (width-1) history, K13 for a non-resident engine's
    [C, W] word keys: the decision, the fold's tiles and its finish (which
    resets the delta) from one call, both over the live rows."""
    need = None
    if demand is not None:
        need = torch.empty((), dtype=torch.bool, device=base.keys.device)
    fold = K.fold if base.keys.shape[1] == 1 else K.word_fold
    fold(base, delta, floor, need, reset_delta=True, demand=demand)
    return need


def _maybe_merge(hist: HistState, demand: int, floor) -> HistState:
    """Fold the delta into the base when ``demand`` more boundaries would
    not fit, or when at least C/8 base segments have expired.

    On the card the decision stays on the device: K4's decision kernel
    writes ``need`` (``fold_need_plain``'s value), a 0-dim bool that the
    fold's and the table's launches read, exiting at once when it is
    False. No host sync; five launches a step when nothing folds (the
    decision, K4's or K13's two fold launches, K2's two table launches).
    ``demand`` is the host-known count 2·(live write ranges)."""
    base, base_st, delta = hist
    if not _on_card(base.keys):
        return _maybe_merge_plain(hist, demand, floor)
    need = _fold_launch(base, delta, floor, demand)
    K.build_table(base.versions, out=base_st, need=need)
    return hist


def advance_hist(hist: HistState, commit_version, new_oldest) -> HistState:
    """GC-only step: advance the floor and force a fold, so expired base
    segments compact out (the fail-safe's way to recover headroom)."""
    base, base_st, delta = hist
    floor = torch.maximum(delta.oldest, _i32(new_oldest, delta.oldest.device))
    if not _on_card(base.keys):
        nb = _merge_delta_plain(base, delta, floor)
        return HistState(nb, sparse_table(nb.versions),
                         _reset_delta(delta, floor))
    _fold_launch(base, delta, floor, None)
    K.build_table(base.versions, out=base_st)
    return hist


# ---------------------------------------------------------------------------
# K1: dictionary insert, rank rewrites, version rebase
# ---------------------------------------------------------------------------


def _dict_insert_plain(dict_keys, n_keys, delta_keys):
    d1, w = dict_keys.shape
    m_cap = delta_keys.shape[0]
    shift = searchsorted_words_fp(delta_keys, dict_keys, side="left")
    cross = searchsorted_words_fp(dict_keys, delta_keys, side="right")
    pos_d = torch.arange(m_cap, dtype=torch.int32,
                         device=dict_keys.device) + cross
    idx, cnt_le, k_new, from_new = _merge_positions(pos_d, d1)
    old_idx = (idx - cnt_le).clamp(0, d1 - 1).long()
    out = torch.where(from_new[:, None], delta_keys[k_new], dict_keys[old_idx])
    m = (~(delta_keys == INT32_MAX).all(-1)).sum().to(torch.int32)
    return out, n_keys + m, shift


def _dict_insert(dict_keys, n_keys, delta_keys, n_new: int | None = None):
    """Merge the sorted new keys into the dictionary. Returns (new dict,
    new n_keys, shift) with shift[r] = inserted keys below old rank r.
    ``n_new`` is the host's count of real delta rows (counted on the
    device when omitted)."""
    if not _on_card(dict_keys):
        return _dict_insert_plain(dict_keys, n_keys, delta_keys)
    out, shift = K.dict_insert(dict_keys, delta_keys)
    if n_new is None:
        n_new = (~(delta_keys == INT32_MAX).all(-1)).sum().to(torch.int32)
    return out, n_keys + n_new, shift


def _rewrite_ranks_plain(arrays, table, remap: bool):
    out = []
    for a in arrays:
        c = a.clamp(0, table.shape[0] - 1).long()
        mapped = table[c] if remap else a + table[c]
        out.append(torch.where(a == INT32_MAX, a, mapped))
    return out


def _rewrite_ranks(arrays, table, remap: bool):
    """Rewrite every rank r (INT32_MAX invariant) to ``r + table[r]``
    (insert shift) or ``table[r]`` (repack remap). In place on the card."""
    if _on_card(table):
        K.rewrite_ranks(arrays, table, remap)
        return list(arrays)
    return _rewrite_ranks_plain(arrays, table, remap)


def hist_rank_arrays(hist) -> list:
    """The rank arrays of a history: the base and delta keys of a two-level
    HistState, or the keys of a flat (sharded: [S, C, 1]) ConflictState."""
    if isinstance(hist, HistState):
        return [hist.base.keys, hist.delta.keys]
    return [hist.keys]


def _hist_with_ranks(hist, arrays):
    if isinstance(hist, HistState):
        return HistState(hist.base._replace(keys=arrays[0]), hist.base_st,
                         hist.delta._replace(keys=arrays[1]))
    return hist._replace(keys=arrays[0])


def _rewrite_res_ranks(res: ResState, table, remap: bool, dict_keys, n_keys):
    """Every rank the state holds (history keys, shard bounds) rewritten by
    ``table``: one K1 rewrite launch on the card (at most four arrays)."""
    *hk, lo, hi = _rewrite_ranks(
        [*hist_rank_arrays(res.hist), res.shard_lo, res.shard_hi], table,
        remap)
    return ResState(dict_keys=dict_keys, n_keys=n_keys,
                    hist=_hist_with_ranks(res.hist, hk), shard_lo=lo,
                    shard_hi=hi)


def apply_delta(res: ResState, delta_keys, n_new: int | None = None):
    """Fold a dispatch's key delta into the resident state: insert the new
    keys and shift every history rank and shard bound past them. The JAX
    ``lax.cond`` on an empty delta is decided on the host from ``n_new``
    (the mirror's count); without it, the count is read from the device."""
    if n_new is None:
        n_new = int((~(delta_keys == INT32_MAX).all(-1)).sum())
    if n_new == 0:
        return res
    nd, nn, shift = _dict_insert(res.dict_keys, res.n_keys, delta_keys, n_new)
    return _rewrite_res_ranks(res, shift, False, nd, nn)


# ---------------------------------------------------------------------------
# The tile designs of K4 and K1, in plain Python (the kernels' twins)
# ---------------------------------------------------------------------------

#: Merged rows a K4 tile holds (256 threads x 8), output rows a K1 tile,
#: source rows a K7 tile.
K4_TILE = K.K4_TILE
K1_TILE = K.K1_TILE
K7_TILE = K.K7_TILE


def merge_path_split(a, b, diag: int) -> int:
    """How many rows of ``a`` are among the first ``diag`` rows of the
    stable merge of the sorted rows ``a`` and ``b`` (``a``'s rows before
    equal rows of ``b``): the diagonal search by which a K4 tile finds
    where its slices of the two inputs start. Rows are ints or tuples of
    words (compared lexicographically)."""
    lo, hi = max(0, diag - len(b)), min(diag, len(a))
    while lo < hi:
        mid = (lo + hi) // 2
        if a[mid] <= b[diag - 1 - mid]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _k4_value(mode: str, from_a: bool, i: int, ai: int, bi: int, a_val,
              b_val):
    """(coverage delta, version before the paint / GC) of merged row ``i``
    of A or B, with ``ai`` A rows and ``bi`` B rows before it."""
    if mode == "paint":  # A: the history, B: the new endpoints
        if from_a:
            return 0, a_val[i]
        return b_val[i], a_val[max(ai - 1, 0)]
    if mode == "fold":  # A: the base, B: the delta
        if from_a:
            return 0, max(a_val[i], b_val[max(bi - 1, 0)])
        return 0, max(b_val[i], a_val[max(ai - 1, 0)])
    return 0, a_val[i]  # compact: the values are given


def k4_tiles_plain(a, a_val, b, b_val, mode: str, c_out: int, prior: bool,
                   cv: int = 0, floor: int = 0, tile: int = K4_TILE,
                   inf=INT32_MAX):
    """K4's tile algorithm over the stable merge of the sorted width-1 rows
    ``a`` and ``b`` (Python lists): (keys, versions, n_used, overflow) of
    the dedup + compaction to ``c_out`` rows, as ``_dedup_compact_plain``
    gives them after ``_paint_tail`` (mode "paint": A the history, B the
    new endpoints with coverage deltas ``b_val``), ``_merge_delta_plain``
    ("fold": A the base, B the delta) or alone ("compact": A only).

    Each tile of ``tile`` merged rows finds its slices by
    ``merge_path_split`` and carries two sums across tiles (the kernel's
    look-back): the coverage before it and the survivors before it. The
    dedup needs nothing else from earlier tiles: the version of the row
    before the tile's first run (the previous dedup survivor) is computed
    from the inputs at that run's start, found by two lower-bound
    searches, with the coverage there the tile's coverage minus the
    deltas of the run's rows before the tile. Rows of W words are tuples,
    with ``inf`` the +inf row (K13's fold and compaction at width W, over
    the live rows and at its tile of 256 rows)."""
    from bisect import bisect_left

    na, nb = len(a), len(b)
    n = na + nb
    k0 = min(a[:1] + b[:1])
    gc = mode != "compact"

    def newv(dc, v, key, cov):
        if mode == "paint" and cov > 0:
            v = cv
        return NEG_VERSION if gc and (v <= floor or key == inf) else v

    out_k, out_v = [], []
    cov_before = cnt_before = 0
    for d0 in range(0, n, tile):
        d1 = min(n, d0 + tile)
        a0, a1 = merge_path_split(a, b, d0), merge_path_split(a, b, d1)
        b0, b1 = d0 - a0, d1 - a1
        keys, vals, ai, bi, cov = [], [], a0, b0, cov_before
        while ai < a1 or bi < b1:
            from_a = ai < a1 and (bi >= b1 or a[ai] <= b[bi])
            dc, v = _k4_value(mode, from_a, ai if from_a else bi, ai, bi,
                              a_val, b_val)
            cov += dc
            keys.append(a[ai] if from_a else b[bi])
            vals.append(newv(dc, v, keys[-1], cov))
            ai, bi = ai + from_a, bi + (not from_a)
        nxt = ([a[a1]] if a1 < na else []) + ([b[b1]] if b1 < nb else [])
        # The row before the tile's first run: its start s = la + lb.
        fk = keys[0]
        la, lb = bisect_left(a, fk), bisect_left(b, fk)
        if la + lb == 0:
            prev_first = NEG_VERSION - 1
        else:
            from_b = lb > 0 and (la == 0 or a[la - 1] <= b[lb - 1])
            i = lb - 1 if from_b else la - 1
            dc, v = _k4_value(mode, not from_b, i, la, lb, a_val, b_val)
            run_cov = sum(b_val[lb:b0]) if mode == "paint" else 0
            prev_first = newv(dc, v, (b if from_b else a)[i],
                              cov_before - run_cov)
        local, start = [], -1
        for r, key in enumerate(keys):
            if r > 0 and key != keys[r - 1]:
                start = r
            g = d0 + r
            nk = keys[r + 1] if r + 1 < len(keys) else min(nxt, default=None)
            keep1 = g == n - 1 or key != nk
            prev = prev_first if start < 0 else vals[start - 1]
            forced = (keep1 and key == k0) if k0 != inf else g == n - 1
            if forced or (keep1 and vals[r] != prev and key != inf):
                local.append(r)
        for r in local:
            if cnt_before < c_out:
                out_k.append(keys[r])
                out_v.append(vals[r])
            cnt_before += 1
        cov_before = cov
    total = cnt_before
    pad = c_out - len(out_k)
    return (out_k + [inf] * pad, out_v + [NEG_VERSION] * pad,
            min(total, c_out), bool(prior) or total > c_out)


def _k4_state(out, device, oldest) -> ConflictState:
    """A ConflictState from ``k4_tiles_plain``'s output: rows of ints
    (width 1) or of W-word tuples."""
    keys, vers, n_used, overflow = out
    keys = torch.tensor(keys, dtype=torch.int32, device=device)
    return ConflictState(
        keys=keys[:, None] if keys.dim() == 1 else keys,
        versions=torch.tensor(vers, dtype=torch.int32, device=device),
        n_used=_i32(n_used, device),
        oldest=_i32(oldest, device).clone(),
        overflow=torch.tensor(overflow, device=device))


def paint_tiles_plain(state: ConflictState, rbk: RankBatch, accepted,
                      commit_version: int, new_oldest,
                      tile: int = K4_TILE) -> ConflictState:
    """K4's paint by its tile algorithm: ``_paint_and_compact_res_plain``'s
    result. B is the new endpoints in ``paint_src`` order."""
    b_, q = rbk.write_begin.shape
    e2 = b_ * q
    valid = (accepted[:, None] & rbk.write_mask
             & (rbk.write_begin < rbk.write_end)).reshape(e2).to(torch.int32)
    ranks = torch.cat([rbk.write_begin.reshape(e2),
                       rbk.write_end.reshape(e2)])
    delta = torch.cat([valid, -valid])
    src = rbk.paint_src.long()
    out = k4_tiles_plain(
        state.keys[:, 0].tolist(), state.versions.tolist(),
        ranks[src].tolist(), delta[src].tolist(), "paint",
        state.keys.shape[0], bool(state.overflow), int(commit_version),
        int(new_oldest), tile)
    return _k4_state(out, state.keys.device, _i32(new_oldest, "cpu"))


def fold_tiles_plain(base: ConflictState, delta: ConflictState, floor,
                     tile: int = K4_TILE) -> ConflictState:
    """K4's fold by its tile algorithm: ``_merge_delta_plain``'s result."""
    out = k4_tiles_plain(
        base.keys[:, 0].tolist(), base.versions.tolist(),
        delta.keys[:, 0].tolist(), delta.versions.tolist(), "fold",
        base.keys.shape[0], bool(base.overflow | delta.overflow),
        floor=int(floor), tile=tile)
    return _k4_state(out, base.keys.device, floor)


def compact_tiles_plain(skeys, newv, c_out: int, prior_overflow,
                        tile: int = K4_TILE):
    """K4's compaction by its tile algorithm: ``_dedup_compact_plain``'s
    result for width-1 rows."""
    keys, vers, n_used, overflow = k4_tiles_plain(
        skeys[:, 0].tolist(), newv.tolist(), [], [], "compact", c_out,
        bool(prior_overflow), tile=tile)
    dev = skeys.device
    return (torch.tensor(keys, dtype=torch.int32, device=dev)[:, None],
            torch.tensor(vers, dtype=torch.int32, device=dev),
            _i32(n_used, dev), torch.tensor(overflow, device=dev))


def fold_need_plain(hist: HistState, demand: int, floor) -> torch.Tensor:
    """The gated fold's decision (0-dim bool), which K4's ``sc_need``
    computes on the card: fold when ``demand`` more boundaries would not
    fit in the delta, or when at least max(C // 8, 1) base segments have
    expired (a version in (NEG_VERSION, floor])."""
    base, delta = hist.base, hist.delta
    c, cd = base.keys.shape[0], delta.keys.shape[0]
    reclaimable = ((base.versions <= floor)
                   & (base.versions > NEG_VERSION)).sum()
    return (delta.n_used + demand > cd) | (reclaimable >= max(c // 8, 1))


def dict_delta_positions_plain(dict_keys, delta_keys) -> torch.Tensor:
    """K1's search by the delta: p[j] = the dictionary rows <= delta row
    j. Delta row j lands at j + p[j], and dictionary row i moves by
    shift[i] = #{j : p[j] <= i}."""
    return searchsorted_words_fp(dict_keys, delta_keys, side="right").to(
        torch.int32)


def dict_insert_tiles_plain(dict_keys, delta_keys, tile: int = K1_TILE):
    """K1's insert by its tile algorithm: (merged dictionary, shift) as
    ``_dict_insert_plain`` gives them. Tiles cover the D + 1 + M merged
    positions; a tile finds its delta rows by one search over j + p[j],
    marks where they land, and an exclusive count of the marks gives each
    dictionary row its source index and its shift. Positions past D + 1
    write only their shifts."""
    d1 = dict_keys.shape[0]
    m = delta_keys.shape[0]
    dev = dict_keys.device
    q = (torch.arange(m, dtype=torch.int32, device=dev)
         + dict_delta_positions_plain(dict_keys, delta_keys))
    out = torch.empty_like(dict_keys)
    shift = torch.empty(d1, dtype=torch.int32, device=dev)
    for k0 in range(0, d1 + m, tile):
        k1 = min(k0 + tile, d1 + m)
        j0 = int(torch.searchsorted(q, k0))
        j1 = int(torch.searchsorted(q, k1))
        mark = torch.zeros(k1 - k0, dtype=torch.int32, device=dev)
        mark[(q[j0:j1] - k0).long()] = 1
        before = j0 + torch.cumsum(mark, 0, dtype=torch.int32) - mark
        k = torch.arange(k0, k1, device=dev)
        old = mark == 0
        i = (k - before)[old].long()
        shift[i] = before[old]
        live = k < d1
        rows = torch.where((mark == 1)[:, None],
                           delta_keys[before.clamp(max=m - 1).long()],
                           dict_keys[(k - before).clamp(0, d1 - 1).long()])
        out[k[live]] = rows[live]
    return out, shift


def _dict_evict_plain(dict_keys, n_keys, evict_ranks):
    d1 = dict_keys.shape[0]
    dev = dict_keys.device
    real = evict_ranks != INT32_MAX
    i = torch.arange(evict_ranks.shape[0], dtype=torch.int32, device=dev)
    adj = torch.where(real, evict_ranks - i, INT32_MAX).contiguous()
    j = torch.arange(d1, dtype=torch.int32, device=dev)
    t = torch.searchsorted(adj, j, right=True).to(torch.int32)
    out = dict_keys[(j + t).clamp(0, d1 - 1).long()]
    new_n = n_keys - real.sum().to(torch.int32)
    out = torch.where((j < new_n)[:, None], out, INT32_MAX)
    shift = -torch.searchsorted(evict_ranks.contiguous(), j,
                                right=True).to(torch.int32)
    return out, new_n, shift


def dict_evict_tiles_plain(dict_keys, n_keys, evict_ranks, n_ev: int,
                           n_live: int, tile: int = K7_TILE):
    """K7's demotion by its tile algorithm: (compacted dictionary, new
    n_keys, shift) as ``_dict_evict_plain`` gives them. Tiles cover the
    source rows [0, n_live); a tile finds its slice [s0, s1) of the sorted
    evict vector by two searches, marks the slice's rows, and an exclusive
    count of the marks gives each row the evicted ranks below it
    (``before``): shift[r] = -(before + mark), and a kept row r lands at
    r - before. The tail, rows [n_live - n_ev, D+1) of the output and
    shifts [n_live, D+1), is written without reading anything."""
    d1 = dict_keys.shape[0]
    dev = dict_keys.device
    ev = evict_ranks[:n_ev].contiguous()
    out = torch.empty_like(dict_keys)
    shift = torch.empty(d1, dtype=torch.int32, device=dev)
    for r0 in range(0, n_live, tile):
        r1 = min(r0 + tile, n_live)
        s0, s1 = (int(x) for x in torch.searchsorted(
            ev, torch.tensor([r0, r1], dtype=torch.int32, device=dev)))
        mark = torch.zeros(r1 - r0, dtype=torch.int32, device=dev)
        mark[(ev[s0:s1] - r0).long()] = 1
        before = s0 + torch.cumsum(mark, 0, dtype=torch.int32) - mark
        shift[r0:r1] = -(before + mark)
        r = torch.arange(r0, r1, device=dev)
        kept = mark == 0
        out[(r - before)[kept]] = dict_keys[r0:r1][kept]
    out[n_live - n_ev:] = INT32_MAX
    shift[n_live:] = -n_ev
    return out, n_keys - n_ev, shift


def _dict_evict(dict_keys, n_keys, evict_ranks, n_ev: int, n_live: int):
    """Remove the ``n_ev`` strictly increasing ranks at the head of
    ``evict_ranks`` (INT32_MAX padded, all below ``n_live``, the host's
    count of the dictionary's keys) from the dictionary, the inverse of
    ``_dict_insert``. Returns (new dict, new n_keys, shift) with
    shift[r] = -(evicted ranks <= r): a surviving rank r becomes
    r + shift[r]. On the card, K7 (one launch over the live rows)."""
    if _on_card(dict_keys):
        return K.dict_evict(dict_keys, n_keys, evict_ranks, n_ev, n_live)
    if n_live != int(n_keys):
        raise ValueError(f"the host counts {n_live} keys, the dictionary "
                         f"{int(n_keys)}")
    return _dict_evict_plain(dict_keys, n_keys, evict_ranks)


def apply_evict(res: ResState, evict_ranks, n_ev: int | None = None,
                n_live: int | None = None):
    """Fold a demotion delta into the resident state: evict the ranks from
    the dictionary (K7) and shift every history rank and shard bound down
    past them (K1's rewrite), the mirror image of ``apply_delta``. The
    host guarantees that no evicted rank is still referenced. The JAX
    ``lax.cond`` on an empty delta is decided on the host from ``n_ev``
    (the real count); ``n_live`` is the host's count of the dictionary's
    keys. Without them, each is read from the device. A demotion event
    evicts its whole sorted order in one call: evicting ascending chunks
    one after another, each rebased by the count already gone, leaves
    every surviving rank where one call does."""
    if n_ev is None:
        n_ev = int((evict_ranks != INT32_MAX).sum())
    if n_ev == 0:
        return res
    if n_live is None:
        n_live = int(res.n_keys)
    nd, nn, shift = _dict_evict(res.dict_keys, res.n_keys, evict_ranks, n_ev,
                                n_live)
    return _rewrite_res_ranks(res, shift, False, nd, nn)


def apply_dict_remap(res: ResState, new_dict, new_n, remap) -> ResState:
    """Full-repack tail: swap in the host-rebuilt dictionary and remap
    every device-held rank through ``remap`` (in place on the card)."""
    dev = res.dict_keys.device
    return _rewrite_res_ranks(
        res, torch.as_tensor(remap, dtype=torch.int32).to(dev), True,
        torch.as_tensor(new_dict, dtype=torch.int32).to(dev),
        _i32(int(new_n), dev))


def _rebase_versions_plain(versions, delta: int):
    return torch.where(versions < delta, NEG_VERSION, versions - delta).to(
        torch.int32)


def rebase(state: ConflictState, delta: int) -> ConflictState:
    """Shift versions down by ``delta`` (expired ones to the sentinel)."""
    if _on_card(state.versions):
        K.rebase_versions([state.versions], delta)
        v = state.versions
    else:
        v = _rebase_versions_plain(state.versions, delta)
    return state._replace(versions=v,
                          oldest=(state.oldest - delta).clamp(min=0))


def rebase_hist(h: HistState, delta: int) -> HistState:
    """Version rebase of both history levels plus the base table rebuild."""
    base = rebase(h.base, delta)
    if _on_card(base.versions):
        K.build_table(base.versions, out=h.base_st)
        st = h.base_st
    else:
        st = sparse_table(base.versions)
    return HistState(base, st, rebase(h.delta, delta))


def rebase_res(res, delta: int):
    """Version rebase of a ResState (a flat sharded history has no table),
    of a non-resident engine's bare HistState, or of the non-resident
    sharded engine's bare flat ConflictState."""
    if isinstance(res, HistState):
        return rebase_hist(res, delta)
    if isinstance(res, ConflictState):
        return rebase(res, delta)
    h = res.hist
    if not isinstance(h, HistState):
        return res._replace(hist=rebase(h, delta))
    return res._replace(hist=rebase_hist(h, delta))


# ---------------------------------------------------------------------------
# Resolve entry
# ---------------------------------------------------------------------------


def write_demand(rbk) -> int:
    """2 · live write ranges of a RankBatch (or of a BatchTensors of full
    key rows): the fold trigger's demand (one host sync when the batch
    lives on the card; the engine computes it from host data)."""
    if rbk.write_begin.dim() == 3:
        live = lex_lt(rbk.write_begin, rbk.write_end)
    else:
        live = rbk.write_begin < rbk.write_end
    return 2 * int((rbk.write_mask & live).sum())


class WindowOut(NamedTuple):
    """The verdicts (and a wave engine's levels) of k batches as views of
    ONE byte buffer, so that the host reads them with one copy."""

    raw: torch.Tensor  # uint8
    verdicts: torch.Tensor  # int8 [k, B]
    levels: torch.Tensor | None  # int32 [k, B] (wave engines)


def window_out(k: int, b: int, device, wave: bool) -> WindowOut:
    n = k * b
    off = (n + 3) // 4 * 4
    raw = torch.empty(off + 4 * n if wave else n, dtype=torch.uint8,
                      device=device)
    return WindowOut(raw, raw[:n].view(torch.int8).view(k, b),
                     raw[off:off + 4 * n].view(torch.int32).view(k, b)
                     if wave else None)


def read_out(out: WindowOut):
    """(verdicts int8 [k, B], levels int32 [k, B] or None) as numpy, by one
    device-to-host copy of ``out.raw``."""
    raw = out.raw.cpu().numpy()
    k, b = out.verdicts.shape
    n = k * b
    off = (n + 3) // 4 * 4
    return (raw[:n].view("int8").reshape(k, b),
            None if out.levels is None
            else raw[off:off + 4 * n].view("int32").reshape(k, b))


def _schedule(cand, too_old, txn_mask, ranks, wave: bool, stats=None,
              verdicts_out=None, levels_out=None):
    """(accepted, verdicts, levels or None): sequential-order acceptance
    (K3), or with ``wave`` the wave schedule (K5 then K6)."""
    if not wave:
        accepted, verdicts = accept(cand, too_old, txn_mask, ranks,
                                    out=verdicts_out)
        return accepted, verdicts, None
    p = wave_pred_matrix(cand, ranks)
    accepted, levels, verdicts = wave_level(
        cand, p, too_old, txn_mask, stats=stats, level_out=levels_out,
        verdicts_out=verdicts_out)
    return accepted, verdicts, levels


def _floor(hist, new_oldest):
    """The 0-dim too-old floor: the painted level's oldest, never
    regressing below it."""
    level = _paint_level(hist)
    return torch.maximum(level.oldest, _i32(new_oldest, level.oldest.device))


def _floor_and_fold(hist, rbk: RankBatch, new_oldest, demand, plain: bool):
    """(floor, hist): the too-old floor and, for a two-level history, the
    demand-driven fold (a flat history has no fold: it compacts in its
    paint)."""
    floor = _floor(hist, new_oldest)
    if not isinstance(hist, HistState):
        return floor, hist
    if demand is None:
        demand = write_demand(rbk)
    return floor, (_maybe_merge_plain if plain else _maybe_merge)(
        hist, demand, floor)


def _with_painted(hist, painted: ConflictState):
    """The history after its paint: a two-level history's new delta, or
    the flat history itself."""
    if isinstance(hist, HistState):
        return HistState(hist.base, hist.base_st, painted)
    return painted


def _paint_level(hist) -> ConflictState:
    """The level a resolve paints: the delta, or the flat history."""
    return hist.delta if isinstance(hist, HistState) else hist


def _resolve_core_res(hist, rbk: RankBatch, commit_version: int,
                      new_oldest, report: bool = False,
                      demand: int | None = None, wave: bool = False,
                      stats=None, verdicts_out=None, levels_out=None,
                      rmq: str = "sparse"):
    """The resident resolve over a two-level HistState or the flat [C, 1]
    history (the JAX ``_resolve_core_res`` :2239, both branches). Returns
    (verdicts[, levels][, losers], new_hist)."""
    floor, hist = _floor_and_fold(hist, rbk, new_oldest, demand, False)
    too_old, hist_mask, cand = history_probe(hist, rbk, floor, rmq)
    ranks = endpoint_ranks_live_packed(rbk)
    accepted, verdicts, levels = _schedule(
        cand, too_old, rbk.txn_mask, ranks, wave, stats, verdicts_out,
        levels_out)
    new_hist = _with_painted(hist, _paint_and_compact_res(
        _paint_level(hist), rbk, accepted, commit_version, floor))
    out = (verdicts, levels) if wave else (verdicts,)
    if report:
        return (*out, loser_mask(hist_mask, ranks, accepted, verdicts),
                new_hist)
    return (*out, new_hist)


def resolve_batch_res(res: ResState, rb: ResidentBatch, commit_version: int,
                      new_oldest, report: bool = False,
                      n_new: int | None = None, demand: int | None = None,
                      wave: bool = False, stats=None,
                      out: WindowOut | None = None, rmq: str = "sparse"):
    """Delta insert + rank rebase, then the rank-space resolve core.
    Returns (verdicts int8 [B][, levels int32 [B]][, losers], new
    ResState). ``n_new`` and ``demand`` are host-known counts that spare
    device reads; the verdicts and levels go into row 0 of ``out`` when
    it is given."""
    res = apply_delta(res, rb.delta_keys, n_new)
    got = _resolve_core_res(
        res.hist, rb.ranks, commit_version, new_oldest, report=report,
        demand=demand, wave=wave, stats=stats,
        verdicts_out=None if out is None else out.verdicts[0],
        levels_out=None if out is None or not wave else out.levels[0],
        rmq=rmq)
    return (*got[:-1], res._replace(hist=got[-1]))


# ---------------------------------------------------------------------------
# A14: the window program (one delta merge, then k resolve steps)
# ---------------------------------------------------------------------------


def _step(ranks: RankBatch, i: int) -> RankBatch:
    """Step ``i`` of a [k]-leading RankBatch (views, contiguous)."""
    return RankBatch(*(x[i] for x in ranks))


def _resolve_core_res_plain(hist, rbk: RankBatch, commit_version: int,
                            new_oldest, wave: bool = False, stats=None,
                            rmq: str = "sparse"):
    """``_resolve_core_res`` through the plain versions only, wherever the
    tensors live: the window program's yardstick on the card. Returns
    (verdicts[, levels], new_hist)."""
    floor, hist = _floor_and_fold(hist, rbk, new_oldest, None, True)
    too_old, _, cand = history_probe_plain(hist, rbk, floor, rmq)
    ranks = endpoint_ranks_live_packed(rbk)
    if wave:
        accepted, levels, verdicts = wave_level_plain(
            cand, wave_pred_matrix_plain(cand, ranks), too_old,
            rbk.txn_mask, stats)
    else:
        accepted, verdicts = accept_plain(cand, too_old, rbk.txn_mask, ranks)
    new_hist = _with_painted(hist, _paint_and_compact_res_plain(
        _paint_level(hist), rbk, accepted, commit_version, floor))
    return (verdicts, levels, new_hist) if wave else (verdicts, new_hist)


def _apply_delta_plain(res: ResState, delta_keys) -> ResState:
    """``apply_delta`` through the plain versions only."""
    if not bool((~(delta_keys == INT32_MAX).all(-1)).any()):
        return res
    nd, nn, shift = _dict_insert_plain(res.dict_keys, res.n_keys, delta_keys)
    *hk, lo, hi = _rewrite_ranks_plain(
        [*hist_rank_arrays(res.hist), res.shard_lo, res.shard_hi], shift,
        False)
    return ResState(nd, nn, _hist_with_ranks(res.hist, hk), lo, hi)


def resolve_many_res_plain(res: ResState, rb: ResidentBatch,
                           commit_versions, new_oldests, wave: bool = False,
                           stats=None, rmq: str = "sparse"):
    """Plain version of the window program: one ``apply_delta`` for the
    window's delta, then k resolve steps in order. Returns (stacked
    verdicts int8 [k, B][, levels int32 [k, B]], new ResState)."""
    res = _apply_delta_plain(res, rb.delta_keys)
    hist = res.hist
    rows = []
    for i in range(rb.ranks.read_begin.shape[0]):
        *step, hist = _resolve_core_res_plain(
            hist, _step(rb.ranks, i), int(commit_versions[i]),
            int(new_oldests[i]), wave, stats, rmq)
        rows.append(step)
    return (*(torch.stack(x) for x in zip(*rows)), res._replace(hist=hist))


def resolve_many_res(res: ResState, rb: ResidentBatch, commit_versions,
                     new_oldests, n_new: int | None = None,
                     demands=None, wave: bool = False, stats=None,
                     out: WindowOut | None = None, rmq: str = "sparse"):
    """Window path: ONE delta merge and rank rebase for the whole window
    (the delta has no window axis; every step's endpoints were ranked
    against the post-merge dictionary), then k rank-space resolve steps.
    Returns (verdicts int8 [k, B][, levels int32 [k, B]], new ResState);
    they are also written into ``out`` when it is given.

    On the card: K1 once, then per step K2 probe, the acceptance into
    row i of the window's buffers (K3; a wave engine K5 then K6, whose
    schedule of each batch is its own: batches serialize by commit
    version) and K4 paint, with the device-gated fold and base table of
    K4 and K2. ``n_new`` and ``demands`` (one 2·live-write-ranges count
    per step) are the host's counts; the card path requires ``demands``,
    since counting them there would sync. No host sync happens inside
    the window. A flat history (``history="batch"``) runs per step K2's
    table over all C versions and its probe, K3 and K4's paint of the
    flat history; ``rmq="blocked"`` puts K17's build, K12's rank search
    and K17's probe in place of the per-batch table and probe."""
    if not _on_card(res.dict_keys):
        *got, res = resolve_many_res_plain(res, rb, commit_versions,
                                           new_oldests, wave, stats, rmq)
        if out is not None:
            got = [_written(o, g) for o, g in zip(out[1:], got)]
        return (*got, res)
    k, b = rb.ranks.txn_mask.shape
    if demands is None or len(demands) != k:
        raise ValueError("the card's window program needs one host-known "
                         "write demand per step")
    LAUNCHES["resolve_many"] += 1
    res = apply_delta(res, rb.delta_keys, n_new)
    if out is None:
        out = window_out(k, b, res.dict_keys.device, wave)
    hist = res.hist
    for i in range(k):
        *_, hist = _resolve_core_res(
            hist, _step(rb.ranks, i), int(commit_versions[i]),
            int(new_oldests[i]), demand=int(demands[i]), wave=wave,
            stats=stats, verdicts_out=out.verdicts[i],
            levels_out=out.levels[i] if wave else None, rmq=rmq)
    got = (out.verdicts, out.levels) if wave else (out.verdicts,)
    return (*got, res._replace(hist=hist))


# ---------------------------------------------------------------------------
# B2 (resident): the speculation ring's snapshot and paint-only re-advance
# ---------------------------------------------------------------------------
#
# A speculative engine dispatches window N+1 against the state window N
# advanced before N is confirmed. Rolling N back swaps in a snapshot taken
# before N's dispatch and re-paints N with only the confirmed accepts: the
# same delta merge, fold and paint as the resolve, minus the decision.


def snapshot_res(res):
    """A deep copy of every leaf of a state tree. The card path updates
    the state in place (K1 rewrite, K4 fold and paint, rebase), so a
    rollback target that shared storage with the live state would be
    overwritten by the very windows it is meant to undo."""
    if isinstance(res, torch.Tensor):
        return res.clone()
    return type(res)(*(snapshot_res(x) for x in res))


def _paint_core_res_plain(hist, rbk: RankBatch, accepted,
                          commit_version: int, new_oldest):
    floor, hist = _floor_and_fold(hist, rbk, new_oldest, None, True)
    return _with_painted(hist, _paint_and_compact_res_plain(
        _paint_level(hist), rbk, accepted, commit_version, floor))


def _sharded(hist) -> bool:
    """A sharded engine's stack of S flat histories ([S, C, 1] keys)."""
    return isinstance(hist, ConflictState) and hist.keys.dim() == 3


def paint_many_res_plain(res: ResState, rb: ResidentBatch, accepted,
                         commit_versions, new_oldests) -> ResState:
    """Plain version of the paint-only window: ``_apply_delta_plain`` once,
    then per step the too-old floor, the demand-driven fold and a paint of
    the forced ``accepted`` [k, B] mask."""
    if _sharded(res.hist):
        return _paint_many_sharded(res, rb, accepted, commit_versions,
                                   new_oldests, plain=True)
    res = _apply_delta_plain(res, rb.delta_keys)
    hist = res.hist
    for i in range(rb.ranks.read_begin.shape[0]):
        hist = _paint_core_res_plain(hist, _step(rb.ranks, i), accepted[i],
                                     int(commit_versions[i]),
                                     int(new_oldests[i]))
    return res._replace(hist=hist)


def paint_many_res(res: ResState, rb: ResidentBatch, accepted,
                   commit_versions, new_oldests, n_new: int | None = None,
                   demands=None) -> ResState:
    """Paint-only re-advance of a rolled-back window (the JAX
    ``paint_many_res``): the window's delta re-applies exactly as its
    resolve applied it (a snapshot predates the insert), then each step
    paints the host-forced accept mask ``accepted`` bool [k, B] after the
    same demand-driven fold. On the card: K1 once, then per step the
    gated K4 fold (and K2 table) and a K4 paint; ``n_new`` and
    ``demands`` are the host counts the window's resolve used, so the
    replay inserts and folds exactly as it did. No host sync. A flat
    history takes the JAX flat branch: the too-old floor and a K4 paint,
    no fold; over a sharded engine's shards, with K9's write clip and a K4
    paint per shard."""
    if _sharded(res.hist):
        return _paint_many_sharded(res, rb, accepted, commit_versions,
                                   new_oldests, n_new)
    if not _on_card(res.dict_keys):
        return paint_many_res_plain(res, rb, accepted, commit_versions,
                                    new_oldests)
    k = rb.ranks.txn_mask.shape[0]
    if demands is None or len(demands) != k:
        raise ValueError("the card's paint-only window needs one host-known "
                         "write demand per step")
    LAUNCHES["paint_many"] += 1
    res = apply_delta(res, rb.delta_keys, n_new)
    hist = res.hist
    for i in range(k):
        rbk = _step(rb.ranks, i)
        floor, hist = _floor_and_fold(hist, rbk, int(new_oldests[i]),
                                      int(demands[i]), False)
        hist = _with_painted(hist, _paint_and_compact_res(
            _paint_level(hist), rbk, accepted[i], int(commit_versions[i]),
            floor))
    return res._replace(hist=hist)


# ---------------------------------------------------------------------------
# B1: the two-phase global wave protocol (role-level sharded resolvers)
# ---------------------------------------------------------------------------
#
# A sharded deployment splits one resolve into EDGES (the history gate and
# this shard's clipped predecessor rows; nothing painted) and APPLY (level
# the OR-reduced GLOBAL graph, paint the globally accepted writes). The
# commit proxy reduces between the phases (core/wavemesh.combine_edges);
# every shard levels the same graph, so every shard reports the same
# schedule.


def wave_edges_res(res: ResState, rb: ResidentBatch, new_oldest,
                   n_new: int | None = None, rmq: str = "sparse"):
    """(too_old [B], hist_conflict [B], pred int32 [BP, BP/32], new
    ResState): the dictionary delta merges here, so the apply phase must
    not merge it again; the history is probed (against base and delta
    unmerged: the probe is merge-invariant; or the flat history) and not
    painted."""
    res = apply_delta(res, rb.delta_keys, n_new)
    too_old, hist_mask, cand = history_probe(res.hist, rb.ranks,
                                             _floor(res.hist, new_oldest), rmq)
    p = wave_pred_matrix(cand, endpoint_ranks_live_packed(rb.ranks))
    return too_old, hist_mask.any(1), p, res


def wave_apply_res(res: ResState, rbk: RankBatch, cand, p, commit_version,
                   new_oldest, demand: int | None = None, stats=None):
    """(levels int32 [B], new ResState): level the global graph (K6) and
    paint this shard's globally accepted writes (K4, after the gated fold
    of a two-level history). ``cand`` and ``p`` are the same on every
    shard, so the levels are too."""
    accepted, levels = wave_level_from_graph(cand, p, stats)
    floor, hist = _floor_and_fold(res.hist, rbk, new_oldest, demand, False)
    return levels, res._replace(hist=_with_painted(
        hist, _paint_and_compact_res(_paint_level(hist), rbk, accepted,
                                     commit_version, floor)))


# ---------------------------------------------------------------------------
# B3: the sharded engine (S keyspace shards on one card)
# ---------------------------------------------------------------------------
#
# The JAX ShardedConflictSet runs one SPMD program over a mesh of S devices
# (parallel/sharded_resolver.py). Here the S shards are a leading axis of
# one state on one card. The dictionary is shared (JAX replicates it, and
# every device merges the same delta); shard s keeps a FLAT rank-space
# history (a ConflictState whose leaves are [S, C, 1], [S, C] and [S]) of
# its keyspace slice [shard_lo[s], shard_hi[s]) of ranks. A step clips the
# batch to every shard (K9), probes every shard's history and ORs the
# shards' conflict bits (K8, over each shard's live rows: the JAX
# all_gather or psum across the mesh becomes an OR on the card), accepts
# on the UNCLIPPED batch (K3) or, on a wave engine, builds each shard's
# predecessor rows from its clipped ranges (K5), ORs them and counts their
# occupied tiles (K10) and levels the global graph (K6), then paints each
# shard's clipped accepted writes (K4). The shards share the verdicts:
# JAX's replicated outputs are device 0's, so the too-old floor is shard
# 0's (every shard's floor equals it).


class ShardClip(NamedTuple):
    """A batch clipped to each of S shards (the JAX ``clip_ranks`` of every
    shard, stacked): the writes always, the reads for a wave engine."""

    write_begin: torch.Tensor  # int32 [S, B, Q]
    write_end: torch.Tensor
    write_mask: torch.Tensor  # bool [S, B, Q]: mask & (begin < end)
    read_begin: torch.Tensor | None  # int32 [S, B, R]
    read_end: torch.Tensor | None
    read_mask: torch.Tensor | None


def init_sharded_res(dict_rows, dict_capacity: int, capacity: int,
                     device) -> ResState:
    """The sharded engine's first state (the JAX
    ``ShardedConflictSet._init_engine_resident``): ``dict_rows`` [S, W] are
    the shards' lower bounds (row 0 the packed b""), so shard s starts with
    one boundary at rank s; the last shard's upper bound is INT32_MAX."""
    dict_rows = torch.as_tensor(dict_rows, dtype=torch.int32)
    s, w = dict_rows.shape
    dict_keys = torch.full((dict_capacity + 1, w), INT32_MAX,
                           dtype=torch.int32, device=device)
    dict_keys[:s] = dict_rows
    lo = torch.arange(s, dtype=torch.int32, device=device)
    keys = torch.full((s, capacity, 1), INT32_MAX, dtype=torch.int32,
                      device=device)
    keys[:, 0, 0] = lo
    hist = ConflictState(
        keys=keys,
        versions=torch.full((s, capacity), NEG_VERSION, dtype=torch.int32,
                            device=device),
        n_used=torch.ones(s, dtype=torch.int32, device=device),
        oldest=torch.zeros(s, dtype=torch.int32, device=device),
        overflow=torch.zeros(s, dtype=torch.bool, device=device))
    hi = torch.cat([lo[1:], torch.full((1,), INT32_MAX, dtype=torch.int32,
                                       device=device)])
    return ResState(dict_keys=dict_keys, n_keys=_i32(s, device), hist=hist,
                    shard_lo=lo, shard_hi=hi)


def _shard_hist(hist: ConflictState, s: int) -> ConflictState:
    """Shard s of a flat sharded history (views: the card paints in place)."""
    return ConflictState(*(x[s] for x in hist))


def clip_ranks(rbk: RankBatch, lo, hi) -> RankBatch:
    """The batch restricted to one shard's rank interval [lo, hi) (the JAX
    ``clip_ranks``): the same two-sided clamp on both endpoints, one
    monotone map, so the host's paint order of the UNCLIPPED endpoints
    stays sorted; a range outside the shard drops out of its mask."""
    def clamp(v):
        return torch.minimum(torch.maximum(v, lo), hi)

    rb, re_, wb, we = (clamp(x) for x in (rbk.read_begin, rbk.read_end,
                                          rbk.write_begin, rbk.write_end))
    return rbk._replace(
        read_begin=rb, read_end=re_, read_mask=rbk.read_mask & (rb < re_),
        write_begin=wb, write_end=we, write_mask=rbk.write_mask & (wb < we))


def shard_clip_plain(rbk: RankBatch, lo, hi, reads: bool) -> ShardClip:
    """Plain twin of K9: ``clip_ranks`` of every shard, stacked."""
    lo3, hi3 = lo[:, None, None], hi[:, None, None]

    def clamp(v):
        return torch.minimum(torch.maximum(v[None], lo3), hi3)

    wb, we = clamp(rbk.write_begin), clamp(rbk.write_end)
    wm = rbk.write_mask[None] & (wb < we)
    if not reads:
        return ShardClip(wb, we, wm, None, None, None)
    rb, re_ = clamp(rbk.read_begin), clamp(rbk.read_end)
    return ShardClip(wb, we, wm, rb, re_, rbk.read_mask[None] & (rb < re_))


def shard_clip(rbk: RankBatch, lo, hi, reads: bool) -> ShardClip:
    """K9: the batch clipped to every shard's [lo[s], hi[s]), one
    elementwise launch; the reads too when ``reads`` (a wave engine's
    predecessor rows are built from clipped reads and writes)."""
    if _on_card(lo):
        return ShardClip(*K.shard_clip(
            rbk.read_begin, rbk.read_end, rbk.read_mask, rbk.write_begin,
            rbk.write_end, rbk.write_mask, lo, hi, reads))
    return shard_clip_plain(rbk, lo, hi, reads)


class WindowClip(NamedTuple):
    """K9 for every step of a window: its buffers, allocated once and
    checked once against the window's [k, ...] rank arrays; ``step``
    clips step i into them unchecked (on the card) or through the plain
    version (on the CPU)."""

    out: ShardClip | None
    lo: torch.Tensor
    hi: torch.Tensor
    reads: bool

    @classmethod
    def of(cls, ranks: RankBatch, lo, hi, reads: bool) -> "WindowClip":
        out = None
        if _on_card(lo):
            _, b, r = ranks.read_begin.shape
            q = ranks.write_begin.shape[2]
            out = ShardClip(*K.shard_clip_out(lo.shape[0], b, r, q, reads,
                                              lo.device))
            K.check_shard_clip(*ranks[:6], lo, hi, reads, out)
        return cls(out, lo, hi, reads)

    def step(self, rbk: RankBatch) -> ShardClip:
        if _on_card(self.lo):
            K.shard_clip_into(*rbk[:6], self.lo, self.hi, self.reads,
                              self.out)
            return self.out
        return shard_clip_plain(rbk, self.lo, self.hi, self.reads)


def shard_ranks(rbk: RankBatch, clip: ShardClip, s: int) -> RankBatch:
    """Shard s's view of the batch: its clipped writes, and its clipped
    reads where the clip has them."""
    out = rbk._replace(write_begin=clip.write_begin[s],
                       write_end=clip.write_end[s],
                       write_mask=clip.write_mask[s])
    if clip.read_begin is None:
        return out
    return out._replace(read_begin=clip.read_begin[s],
                        read_end=clip.read_end[s],
                        read_mask=clip.read_mask[s])


def _history_conflict_ranges_res(state: ConflictState, rbk: RankBatch,
                                 rmq: str = "sparse"):
    """bool [B, R]: read slot overlaps a write of the flat history newer
    than its read version (the JAX ``_history_conflict_ranges_res``; its
    table, sparse or blocked, is rebuilt here, as JAX rebuilds it every
    batch)."""
    b, r = rbk.read_begin.shape
    lo = _rank_probe(state.keys, rbk.read_begin.reshape(-1), "right") - 1
    hi = _rank_probe(state.keys, rbk.read_end.reshape(-1), "left")
    newest = range_max_rmq(state.versions, lo.clamp(min=0), hi,
                           rmq).reshape(b, r)
    live = rbk.read_mask & (rbk.read_begin < rbk.read_end)
    return live & (newest > rbk.read_version[:, None])


def shard_probe_plain(hist: ConflictState, rbk: RankBatch, lo, hi, floor,
                      rmq: str = "sparse"):
    """Plain twin of K8 (of K17's sharded probe under ``rmq="blocked"``):
    (too_old [B], hist_conflict [B], cand [B]), the probe half of the JAX
    ``_res_shard_step`` on every shard, each shard's table sparse or
    blocked, with the OR of the shards' conflict bits taken as the mesh
    takes it: the all_gather of the packed bits when B % 32 == 0, the psum
    otherwise. ``floor`` is shard 0's too-old floor (0-dim)."""
    b = rbk.txn_mask.shape[0]
    has_reads = (rbk.read_mask & (rbk.read_begin < rbk.read_end)).any(1)
    too_old = rbk.txn_mask & has_reads & (rbk.read_version < floor)
    hit = torch.stack([
        _history_conflict_ranges_res(_shard_hist(hist, s),
                                     clip_ranks(rbk, lo[s], hi[s]),
                                     rmq).any(1)
        for s in range(lo.shape[0])])
    if b % 32 == 0:
        hist_conflict = unpack_bits_u32(pack_bits_u32(hit), b).any(0)
    else:
        hist_conflict = hit.to(torch.int32).sum(0) > 0
    cand = rbk.txn_mask & ~too_old & ~hist_conflict
    return too_old, hist_conflict, cand


def shard_probe(hist: ConflictState, rbk: RankBatch, lo, hi, floor,
                rmq: str = "sparse"):
    """(too_old, hist_conflict, cand) over every shard. On the card: K8 over
    each shard's live rows [0, n_used[s]) (the rows past it are (+inf,
    NEG_VERSION)): its range-max table over them, then one launch, a
    thread a read slot walking the shards it overlaps, that ORs the
    shards' conflict bits and writes too_old and the candidates. Blocked:
    K17's sharded probe: the blocked structure over the same live rows
    and K8's probe with the blocked range max, two launches."""
    if _on_card(hist.keys) and rmq == "blocked":
        too_old, _, hit, cand = K.blocked_shard_probe(
            hist.keys, hist.versions, hist.n_used,
            rbk.read_begin[..., None], rbk.read_end[..., None],
            rbk.read_mask, rbk.read_version, rbk.txn_mask, lo[:, None],
            hi[:, None], floor)
        return too_old, hit, cand
    if _on_card(hist.keys):
        return K.shard_probe(hist.keys, hist.versions, hist.n_used,
                             rbk.read_begin, rbk.read_end, rbk.read_mask,
                             rbk.read_version, rbk.txn_mask, lo, hi, floor)
    return shard_probe_plain(hist, rbk, lo, hi, floor, rmq)


def _clip_live(clip: ShardClip, s: int) -> tuple:
    """Shard s's clipped endpoint ranks and live masks, in the order of
    ``endpoint_ranks_live_packed``."""
    return (clip.read_begin[s], clip.read_end[s], clip.read_mask[s],
            clip.write_begin[s], clip.write_end[s], clip.write_mask[s])


def wave_occupied_tiles(p: torch.Tensor) -> torch.Tensor:
    """int32 0-dim: the non-zero 32x32-bit tiles (32 rows x 1 word) of a
    packed predecessor matrix (the JAX ``wave_occupied_tiles``)."""
    bp, w = p.shape
    return (p.reshape(bp // 32, 32, w) != 0).any(1).sum().to(torch.int32)


def wave_exchange_plain(ps: torch.Tensor):
    """Plain twin of K10: (the OR of the S matrices [BP, BP/32], int32 [2]
    stats: occupied tiles summed over the shards, and the dense exchange's
    tile count S·(BP/32)·(BP/32)), the JAX ``_wave_exchange_and_level``
    before its leveling."""
    s, bp, w = ps.shape
    p = ps[0].clone()
    for i in range(1, s):
        p |= ps[i]
    occ = torch.stack([wave_occupied_tiles(ps[i]) for i in range(s)]).sum()
    total = torch.full((), s * (bp // 32) * w, dtype=torch.int32,
                       device=ps.device)
    return p, torch.stack([occ.to(torch.int32), total])


def wave_pred_or_plain(cand, ranks, p, stats, shard: int,
                       n_shards: int) -> None:
    """Plain twin of K5's OR mode (``kernels.wave_pred_or``), in place:
    shard ``shard``'s predecessor rows stored into ``p`` (shard 0) or
    OR-ed into it, its occupied tiles (``wave_occupied_tiles`` of its own
    rows) set into (shard 0) or added to ``stats[0]``, and ``stats[1] =
    S·(BP/32)·(BP/32)``. Over shards 0..S-1 in order: the OR and stats of
    ``wave_exchange_plain``."""
    rows = wave_pred_matrix_plain(cand, ranks)
    occ = wave_occupied_tiles(rows)
    if shard == 0:
        p.copy_(rows)
        stats[0] = occ
    else:
        p |= rows
        stats[0] += occ
    bp, w = rows.shape
    stats[1] = n_shards * (bp // 32) * w


def wave_pred_or(cand, ranks, p, stats, shard: int, n_shards: int,
                 plain: bool = False) -> None:
    """K5's OR mode (on the card) or its plain twin: one shard's step of
    the fused exchange, in place into ``p`` and ``stats``."""
    if _card(cand, plain):
        K.wave_pred_or(cand, *ranks, p, stats, shard, n_shards)
    else:
        wave_pred_or_plain(cand, ranks, p, stats, shard, n_shards)


def _exchange_out(cand, stats_out):
    bp = (cand.shape[0] + 31) // 32 * 32
    p = torch.empty((bp, bp // 32), dtype=torch.int32, device=cand.device)
    stats = stats_out if stats_out is not None else torch.empty(
        2, dtype=torch.int32, device=cand.device)
    return p, stats


def shard_pred_exchange(cand, clip: ShardClip, stats_out=None,
                        plain: bool = False):
    """The sharded wave exchange (the port of the JAX
    ``_wave_exchange_and_level`` before its leveling): (the OR of the
    shards' predecessor matrices from their clipped ranges, int32 [BP,
    BP/32]; int32 [2] stats: occupied tiles summed over the shards, and
    S·(BP/32)·(BP/32)), the stats into ``stats_out`` when given. On the
    card K5 in its OR mode once a shard, into one matrix."""
    p, stats = _exchange_out(cand, stats_out)
    n_shards = clip.write_begin.shape[0]
    for s in range(n_shards):
        wave_pred_or(cand, _clip_live(clip, s), p, stats, s, n_shards, plain)
    return p, stats


def _paint_shards(hist: ConflictState, rbk: RankBatch, clip: ShardClip,
                  accepted, commit_version: int, floor,
                  plain: bool = False) -> ConflictState:
    """Each shard's clipped accepted writes painted into its history (K4
    once per shard, in place on the card; ``plain`` forces the plain
    version). ``floor`` [S] holds each shard's too-old floor."""
    n_shards = hist.keys.shape[0]
    if not plain and _on_card(hist.keys):
        for s in range(n_shards):
            K.paint(_shard_hist(hist, s), clip.write_begin[s],
                    clip.write_end[s], clip.write_mask[s], accepted,
                    rbk.paint_src, int(commit_version), floor[s])
        return hist
    outs = [_paint_and_compact_res_plain(_shard_hist(hist, s),
                                         shard_ranks(rbk, clip, s), accepted,
                                         commit_version, floor[s])
            for s in range(n_shards)]
    return ConflictState(*(torch.stack(x) for x in zip(*outs)))


def _sharded_step_plain(hist: ConflictState, lo, hi, rbk: RankBatch,
                        commit_version: int, new_oldest, wave: bool = False,
                        stats=None, rmq: str = "sparse"):
    """One step on every shard through the plain versions only, wherever
    the tensors live (the yardstick on the card). Returns (verdicts, levels
    or None, exchange stats or None, new hist)."""
    floor = torch.maximum(hist.oldest, _i32(new_oldest, hist.oldest.device))
    clip = shard_clip_plain(rbk, lo, hi, wave)
    too_old, _, cand = shard_probe_plain(hist, rbk, lo, hi, floor[0], rmq)
    levels = xstats = None
    if wave:
        p, xstats = shard_pred_exchange(cand, clip, plain=True)
        accepted, levels, verdicts = wave_level_plain(cand, p, too_old,
                                                      rbk.txn_mask, stats)
    else:
        accepted, verdicts = accept_plain(cand, too_old, rbk.txn_mask,
                                          endpoint_ranks_live_packed(rbk))
    return verdicts, levels, xstats, _paint_shards(
        hist, rbk, clip, accepted, commit_version, floor, plain=True)


def _sharded_step(hist: ConflictState, lo, hi, rbk: RankBatch,
                  commit_version: int, new_oldest, wave: bool = False,
                  stats=None, verdicts_out=None, levels_out=None,
                  xstats_out=None, rmq: str = "sparse",
                  wclip: WindowClip | None = None):
    """One step of the JAX ``_res_shard_step`` on every shard. On the card:
    K9 and K8 (blocked: K17's build and sharded probe), then K3
    once on the unclipped batch, or K5 in its OR mode per shard (the
    exchange, K10) and K6 on the clipped ranges, then K4 once per shard.
    The verdicts, levels and exchange stats go into the given buffers.
    Returns (verdicts, levels or None, exchange stats or None, new hist)."""
    if not _on_card(hist.keys):
        v, lv, x, hist = _sharded_step_plain(hist, lo, hi, rbk,
                                             commit_version, new_oldest,
                                             wave, stats, rmq)
        return (_written(verdicts_out, v),
                None if lv is None else _written(levels_out, lv),
                None if x is None else _written(xstats_out, x), hist)
    floor = torch.maximum(hist.oldest, _i32(new_oldest, hist.oldest.device))
    clip = (shard_clip(rbk, lo, hi, wave) if wclip is None
            else wclip.step(rbk))
    too_old, _, cand = shard_probe(hist, rbk, lo, hi, floor[0], rmq)
    levels = xstats = None
    if wave:
        p, xstats = shard_pred_exchange(cand, clip, xstats_out)
        accepted, levels, verdicts = wave_level(
            cand, p, too_old, rbk.txn_mask, stats=stats,
            level_out=levels_out, verdicts_out=verdicts_out)
    else:
        accepted, verdicts = accept(cand, too_old, rbk.txn_mask,
                                    endpoint_ranks_live_packed(rbk),
                                    out=verdicts_out)
    return verdicts, levels, xstats, _paint_shards(
        hist, rbk, clip, accepted, commit_version, floor)


def sharded_resolve_res(res: ResState, rb: ResidentBatch,
                        commit_version: int, new_oldest,
                        n_new: int | None = None, wave: bool = False,
                        stats=None, out: WindowOut | None = None,
                        xstats_out=None, rmq: str = "sparse"):
    """The JAX ``_sharded_resolve_res``: one delta insert and rank rebase of
    every shard's history and bounds (K1, once for all shards), then one
    step on every shard (its probe sparse or blocked, ``rmq``). Returns (verdicts int8 [B], levels int32 [B] or
    None, exchange stats int32 [2] or None, new ResState); the verdicts
    and levels go into row 0 of ``out`` when it is given."""
    res = apply_delta(res, rb.delta_keys, n_new)
    v, lv, x, hist = _sharded_step(
        res.hist, res.shard_lo, res.shard_hi, rb.ranks, commit_version,
        new_oldest, wave, stats,
        None if out is None else out.verdicts[0],
        None if out is None or not wave else out.levels[0], xstats_out, rmq)
    return v, lv, x, res._replace(hist=hist)


def sharded_resolve_res_many(res: ResState, rb: ResidentBatch,
                             commit_versions, new_oldests,
                             n_new: int | None = None, wave: bool = False,
                             stats=None, out: WindowOut | None = None,
                             xstats=None, rmq: str = "sparse"):
    """The sharded window program (the JAX ``_sharded_resolve_res_many``):
    ONE delta insert and rank rebase for the window, then k steps on every
    shard. Returns (verdicts int8 [k, B], levels int32 [k, B] or None,
    exchange stats int32 [k, 2] or None, new ResState); the verdicts and
    levels are written into ``out``, the stats into ``xstats``, when given.
    On the card: K1 once, then per step K9, K8 (blocked: K17's
    build and sharded probe), K3 (or K5's OR mode per shard, K6) and K4
    per shard. No host sync inside the window."""
    k, b = rb.ranks.txn_mask.shape
    dev = res.dict_keys.device
    if _on_card(res.dict_keys):
        LAUNCHES["sharded_many"] += 1
    res = apply_delta(res, rb.delta_keys, n_new)
    if out is None:
        out = window_out(k, b, dev, wave)
    if wave and xstats is None:
        xstats = torch.empty((k, 2), dtype=torch.int32, device=dev)
    hist = res.hist
    wclip = WindowClip.of(rb.ranks, res.shard_lo, res.shard_hi, wave)
    for i in range(k):
        *_, hist = _sharded_step(
            hist, res.shard_lo, res.shard_hi, _step(rb.ranks, i),
            int(commit_versions[i]), int(new_oldests[i]), wave, stats,
            out.verdicts[i], out.levels[i] if wave else None,
            xstats[i] if wave else None, rmq, wclip)
    return out.verdicts, out.levels, xstats if wave else None, \
        res._replace(hist=hist)


def sharded_resolve_res_many_plain(res: ResState, rb: ResidentBatch,
                                   commit_versions, new_oldests,
                                   wave: bool = False, stats=None,
                                   rmq: str = "sparse"):
    """Plain version of the sharded window program (same returns)."""
    res = _apply_delta_plain(res, rb.delta_keys)
    hist = res.hist
    rows = []
    for i in range(rb.ranks.txn_mask.shape[0]):
        *row, hist = _sharded_step_plain(
            hist, res.shard_lo, res.shard_hi, _step(rb.ranks, i),
            int(commit_versions[i]), int(new_oldests[i]), wave, stats, rmq)
        rows.append(row)
    v, lv, x = zip(*rows)
    return (torch.stack(v), torch.stack(lv) if wave else None,
            torch.stack(x) if wave else None, res._replace(hist=hist))


def _paint_many_sharded(res: ResState, rb: ResidentBatch, accepted,
                        commit_versions, new_oldests,
                        n_new: int | None = None,
                        plain: bool = False) -> ResState:
    """The paint-only window over a flat sharded history: the JAX flat
    ``_paint_core_res`` (the floor, then the paint; no fold) on every
    shard's clipped writes. ``plain`` runs the plain versions only."""
    if plain:
        res = _apply_delta_plain(res, rb.delta_keys)
    else:
        if _on_card(res.dict_keys):
            LAUNCHES["paint_many"] += 1
        res = apply_delta(res, rb.delta_keys, n_new)
    hist = res.hist
    wclip = None if plain else WindowClip.of(rb.ranks, res.shard_lo,
                                             res.shard_hi, False)
    for i in range(rb.ranks.txn_mask.shape[0]):
        rbk = _step(rb.ranks, i)
        floor = torch.maximum(hist.oldest,
                              _i32(int(new_oldests[i]), hist.oldest.device))
        clip = (shard_clip_plain(rbk, res.shard_lo, res.shard_hi, False)
                if plain else wclip.step(rbk))
        hist = _paint_shards(hist, rbk, clip, accepted[i],
                             int(commit_versions[i]), floor, plain)
    return res._replace(hist=hist)


# ---------------------------------------------------------------------------
# B4: the packed non-resident engine (resident=False)
# ---------------------------------------------------------------------------
#
# The JAX default design point with resident=False: the history holds full
# [C, W] word keys (base + delta), and every dispatch brings its own sorted
# unique dictionary of the batch's endpoint keys, against which the batch
# is in rank space. The history is searched once per unique key (K12); read
# slots gather their bounds by rank; the paint gathers its boundary keys
# back from the dictionary by rank in the host's paint order (K13). Every
# function takes ``plain`` to run the plain versions wherever the tensors
# live (the yardstick on the card).


class PackedBatch(NamedTuple):
    """One batch (or a [k]-leading window) of the non-resident engine: the
    sorted unique endpoint-key dictionary (+inf padded; the last row is
    always +inf) and the batch as ranks into it (the JAX PackedBatch; the
    RankBatch carries the host's paint order)."""

    dict_keys: torch.Tensor  # int32 [N + 1, W] (a window: [k, N + 1, W])
    ranks: RankBatch


class DictSearch(NamedTuple):
    """Left and right insertion points int32 [N + 1] of every dictionary
    row in the base (``_b``) and the delta (``_d``; None for a flat
    history). ``rs - 1`` is a range begin's segment, ``ls`` the first
    segment at or after a range end, ``rs_d`` the paint's cross rank."""

    ls_b: torch.Tensor
    rs_b: torch.Tensor
    ls_d: torch.Tensor | None
    rs_d: torch.Tensor | None


SPEC_DEP_VERSION = INT32_MAX - 1


def _card(t: torch.Tensor, plain: bool) -> bool:
    return not plain and _on_card(t)


def _step_packed(pb: PackedBatch, i: int) -> PackedBatch:
    return PackedBatch(pb.dict_keys[i], _step(pb.ranks, i))


def dict_history_search(keys_b, dict_keys, keys_d=None,
                        plain: bool = False, live_b=None,
                        live_d=None) -> DictSearch:
    """K12's search (the JAX ``_dict_history_search``, :1445, of the base
    and the delta): one two-sided W-word search per dictionary row. On
    the card ``live_b``/``live_d`` (the levels' n_used) limit it to their
    live rows; the plain version searches every row."""
    if _card(dict_keys, plain):
        return DictSearch(*K.word_search(keys_b, dict_keys, keys_d, live_b,
                                         live_d))
    ls_b, rs_b = searchsorted_words_2sided_fp(keys_b, dict_keys)
    if keys_d is None:
        return DictSearch(ls_b, rs_b, None, None)
    ls_d, rs_d = searchsorted_words_2sided_fp(keys_d, dict_keys)
    return DictSearch(ls_b, rs_b, ls_d, rs_d)


def _history_conflict_ranges_hist_packed(base_st, delta_versions,
                                         rbk: RankBatch, search: DictSearch,
                                         rmq: str = "sparse"):
    """bool [B, R]: a read slot overlaps a write newer than its read
    version (the JAX :1597 with a base table ``base_st`` and the delta's
    versions; the flat :1458 with only one of them: a prebuilt table, or
    the flat history's versions). A per-batch table (the delta's, or a
    flat history's) is built here, sparse or blocked; a flat history's
    bounds are the search's ``_b`` pair."""
    b, r = rbk.read_begin.shape
    rbf = rbk.read_begin.reshape(-1).long()
    ref = rbk.read_end.reshape(-1).long()
    newest = None
    if base_st is not None:
        newest = range_max(base_st, (search.rs_b[rbf] - 1).clamp(min=0),
                           search.ls_b[ref], NEG_VERSION)
    if delta_versions is not None:
        ls, rs = ((search.ls_b, search.rs_b) if base_st is None
                  else (search.ls_d, search.rs_d))
        newest_d = range_max_rmq(delta_versions, (rs[rbf] - 1).clamp(min=0),
                                 ls[ref], rmq)
        newest = newest_d if newest is None else torch.maximum(newest,
                                                               newest_d)
    live = rbk.read_mask & (rbk.read_begin < rbk.read_end)
    return live & (newest.reshape(b, r) > rbk.read_version[:, None])


def packed_probe(rbk: RankBatch, floor, search: DictSearch, base_st,
                 delta_versions, n_used, plain: bool = False,
                 rmq: str = "sparse"):
    """(too_old [B], hist_mask [B, R], cand [B]) with ``floor`` the 0-dim
    too-old floor; the levels as ``_history_conflict_ranges_hist_packed``
    takes them, ``n_used`` the 0-dim live count of the per-batch level
    (None with ``delta_versions``). On the card the per-batch level (the
    delta, or the flat history, given by its versions with ``base_st``
    None) gets a range-max structure over its live rows only, and one
    probe launch gathers the slots' bounds by rank from K12's search,
    takes the base's range max from its prebuilt sparse table and writes
    the three outputs. Sparse: K12's probe (the live table, then
    live_probe.cuh's level probe). Blocked: K17's build and probe."""
    if _card(rbk.read_begin, plain):
        if delta_versions is None:
            raise ValueError("the card's probe needs the per-batch level's "
                             "versions (a flat history: base_st None)")
        tail = (rbk.read_mask, rbk.read_version, rbk.txn_mask, floor)
        flat = base_st is None
        ls, rs = ((search.ls_b, search.rs_b) if flat
                  else (search.ls_d, search.rs_d))
        kw = dict(base_st=base_st, rs_b=None if flat else search.rs_b,
                  ls_b=None if flat else search.ls_b, idx_b=rbk.read_begin,
                  idx_e=rbk.read_end, n_used=n_used)
        if rmq == "blocked":
            return K.blocked_probe(
                delta_versions, K.blocked_build(delta_versions, n_used), rs,
                ls, rbk.read_begin, rbk.read_end, *tail, **kw)
        return K.word_probe(delta_versions, rs, ls, rbk.read_begin,
                            rbk.read_end, *tail, **kw)
    has_reads = (rbk.read_mask & (rbk.read_begin < rbk.read_end)).any(1)
    too_old = rbk.txn_mask & has_reads & (rbk.read_version < floor)
    hist_mask = _history_conflict_ranges_hist_packed(base_st, delta_versions,
                                                     rbk, search, rmq)
    cand = rbk.txn_mask & ~too_old & ~hist_mask.any(1)
    return too_old, hist_mask, cand


def level_probe_live_plain(rbk: RankBatch, floor, search: DictSearch,
                           base_st, values, n_used,
                           levels: int = K.LIVE_LEVELS):
    """Plain twin of K12's probe (``kernels.word_probe``), step for step:
    each live read slot's bounds by rank from the search (the delta's
    pair, or a flat level's ``_b`` pair when ``base_st`` is None), the end
    clamped to the level's live count ``n_used``, the level's range max
    from :func:`live_table_plain`'s table over ``values[:n_used]``, the
    base's from its sparse table ``base_st``. (too_old, hist_mask, cand)
    as :func:`packed_probe` gives them."""
    b, r = rbk.read_begin.shape
    rbf = rbk.read_begin.reshape(-1).long()
    ref = rbk.read_end.reshape(-1).long()
    flat = base_st is None
    ls, rs = ((search.ls_b, search.rs_b) if flat
              else (search.ls_d, search.rs_d))
    n = min(max(int(n_used), 0), values.shape[0])
    table, top = live_table_plain(values[:n], levels)
    newest = live_range_max_plain(table, top, (rs[rbf] - 1).clamp(min=0),
                                  ls[ref].clamp(max=n), levels)
    if not flat:
        newest = torch.maximum(newest, range_max(
            base_st, (search.rs_b[rbf] - 1).clamp(min=0), search.ls_b[ref],
            NEG_VERSION))
    live = rbk.read_mask & (rbk.read_begin < rbk.read_end)
    hist_mask = live & (newest.reshape(b, r) > rbk.read_version[:, None])
    too_old = rbk.txn_mask & live.any(1) & (rbk.read_version < floor)
    return too_old, hist_mask, rbk.txn_mask & ~too_old & ~hist_mask.any(1)


def _paint_and_compact_packed_plain(state: ConflictState, dict_keys,
                                    rbk: RankBatch, accepted,
                                    commit_version: int, new_oldest, rs):
    b, q = rbk.write_begin.shape
    e2 = b * q
    valid = (accepted[:, None] & rbk.write_mask
             & (rbk.write_begin < rbk.write_end)).reshape(e2).to(torch.int32)
    new_ranks = torch.cat([rbk.write_begin.reshape(e2),
                           rbk.write_end.reshape(e2)]).long()
    new_delta = torch.cat([valid, -valid])
    cross = rs[new_ranks]
    new_oldv = state.versions[(cross - 1).clamp(min=0).long()]
    sidx = rbk.paint_src.long()
    return _paint_tail(state, dict_keys[new_ranks[sidx]], new_delta[sidx],
                       new_oldv[sidx], cross[sidx], commit_version,
                       new_oldest)


def _paint_and_compact_packed(state: ConflictState, dict_keys,
                              rbk: RankBatch, accepted, commit_version: int,
                              new_oldest, rs=None,
                              plain: bool = False) -> ConflictState:
    """K13 paint (the JAX :1489): the accepted writes' endpoints, gathered
    from the dictionary by rank in the host's ``paint_src`` order, merge
    into ``state`` at their cross ranks ``rs`` (K12's right search of the
    dictionary into ``state``, searched here when None); the commit
    version is painted where coverage is positive, GC to the floor,
    compaction. A rejected write merges as a no-op endpoint, which leaves
    the state the JAX paint leaves by parking it on the +inf row wherever
    the state's first row is at or below every endpoint (an engine's
    history keeps its minimum-key row). In place on the card: K13's packed
    paint over the state's live rows (three launches)."""
    if rs is None:
        rs = dict_history_search(state.keys, dict_keys, plain=plain,
                                 live_b=state.n_used).rs_b
    if _card(state.keys, plain):
        K.word_paint(state, dict_keys, rs, rbk.write_begin, rbk.write_end,
                     rbk.write_mask, accepted, rbk.paint_src,
                     int(commit_version), _i32(new_oldest, rs.device))
        return state
    return _paint_and_compact_packed_plain(state, dict_keys, rbk, accepted,
                                           commit_version, new_oldest, rs)


def _packed_levels(hist, dict_keys, plain: bool):
    """(search, base table, per-batch level's versions, paint level, paint
    cross ranks) of a packed history: a two-level HistState (K12's search
    of base and delta) or a flat [C, W] ConflictState."""
    if isinstance(hist, HistState):
        search = dict_history_search(hist.base.keys, dict_keys,
                                     hist.delta.keys, plain,
                                     hist.base.n_used, hist.delta.n_used)
        return (search, hist.base_st, hist.delta.versions, hist.delta,
                search.rs_d)
    search = dict_history_search(hist.keys, dict_keys, plain=plain,
                                 live_b=hist.n_used)
    return search, None, hist.versions, hist, search.rs_b


def _resolve_core_packed(hist, pb: PackedBatch, commit_version: int,
                         new_oldest, report: bool = False,
                         demand: int | None = None, wave: bool = False,
                         stats=None, verdicts_out=None, levels_out=None,
                         plain: bool = False, rmq: str = "sparse"):
    """The JAX ``resolve_batch_hist_packed`` (:1634) over a two-level
    history: the gated fold, the probe of base and delta, acceptance (or
    the wave schedule), the paint of the post-fold delta with the probe's
    delta search as its cross rank; over a flat [C, W] history the JAX
    ``resolve_batch_packed`` (:1550): the probe with a table rebuilt over
    all C versions, the paint into the flat history. Returns (verdicts[,
    levels][, losers], new_hist)."""
    rbk = pb.ranks
    floor, hist = _floor_and_fold(hist, rbk, new_oldest, demand, plain)
    search, base_st, versions, level, rs = _packed_levels(hist, pb.dict_keys,
                                                          plain)
    too_old, hist_mask, cand = packed_probe(rbk, floor, search, base_st,
                                            versions, level.n_used, plain,
                                            rmq)
    ranks = endpoint_ranks_live_packed(rbk)
    levels = None
    if not plain:
        accepted, verdicts, levels = _schedule(
            cand, too_old, rbk.txn_mask, ranks, wave, stats, verdicts_out,
            levels_out)
    elif wave:
        accepted, levels, verdicts = wave_level_plain(
            cand, wave_pred_matrix_plain(cand, ranks), too_old, rbk.txn_mask,
            stats)
    else:
        accepted, verdicts = accept_plain(cand, too_old, rbk.txn_mask, ranks)
    new_hist = _with_painted(hist, _paint_and_compact_packed(
        level, pb.dict_keys, rbk, accepted, commit_version, floor, rs, plain))
    out = (verdicts, levels) if wave else (verdicts,)
    if report:
        losers = (loser_mask_plain if plain else loser_mask)(
            hist_mask, ranks, accepted, verdicts)
        return (*out, losers, new_hist)
    return (*out, new_hist)


def resolve_batch_hist_packed(hist, pb: PackedBatch, commit_version: int,
                              new_oldest, report: bool = False,
                              demand: int | None = None, wave: bool = False,
                              stats=None, out: WindowOut | None = None,
                              rmq: str = "sparse"):
    """One packed batch (the object and wire paths) over a two-level or a
    flat history. Returns (verdicts int8 [B][, levels int32 [B]][,
    losers], new history); the verdicts and levels go into row 0 of
    ``out`` when it is given."""
    return _resolve_core_packed(
        hist, pb, commit_version, new_oldest, report=report, demand=demand,
        wave=wave, stats=stats,
        verdicts_out=None if out is None else out.verdicts[0],
        levels_out=None if out is None or not wave else out.levels[0],
        rmq=rmq)


def resolve_many_hist_packed_plain(hist, pb: PackedBatch,
                                   commit_versions, new_oldests,
                                   wave: bool = False, stats=None,
                                   rmq: str = "sparse"):
    """Plain version of the packed window program: k steps in order, each
    with its own dictionary. Returns (verdicts int8 [k, B][, levels], new
    HistState)."""
    rows = []
    for i in range(pb.ranks.txn_mask.shape[0]):
        *step, hist = _resolve_core_packed(
            hist, _step_packed(pb, i), int(commit_versions[i]),
            int(new_oldests[i]), wave=wave, stats=stats, plain=True,
            rmq=rmq)
        rows.append(step)
    return (*(torch.stack(x) for x in zip(*rows)), hist)


def resolve_many_hist_packed(hist, pb: PackedBatch, commit_versions,
                             new_oldests, demands=None, wave: bool = False,
                             stats=None, out: WindowOut | None = None,
                             rmq: str = "sparse"):
    """The packed window program (the JAX ``resolve_many_hist_packed``,
    :1672): k steps, each against its own batch dictionary. Returns
    (verdicts int8 [k, B][, levels int32 [k, B]], new HistState), also
    written into ``out`` when given. On the card, per step: the gated K13
    fold and K2 base table, K12's search, K2's delta table and K12's
    probe, K3 (or K5 and K6) into row i of the window's buffers, the K13
    paint. ``demands`` (the host's 2·live-write-ranges per step) are
    required there: counting them on the card would sync. Over a flat
    history (the JAX ``resolve_many_packed``, :1579) a step is K12's
    search, K2's table over all C versions and K12's probe (or K17's
    build and probe), K3 (or K5 and K6) and the K13 paint, no fold."""
    if not _on_card(_paint_level(hist).keys):
        *got, hist = resolve_many_hist_packed_plain(
            hist, pb, commit_versions, new_oldests, wave, stats, rmq)
        if out is not None:
            got = [_written(o, g) for o, g in zip(out[1:], got)]
        return (*got, hist)
    k, b = pb.ranks.txn_mask.shape
    if demands is None or len(demands) != k:
        raise ValueError("the card's window program needs one host-known "
                         "write demand per step")
    LAUNCHES["packed_many"] += 1
    if out is None:
        out = window_out(k, b, pb.dict_keys.device, wave)
    for i in range(k):
        *_, hist = _resolve_core_packed(
            hist, _step_packed(pb, i), int(commit_versions[i]),
            int(new_oldests[i]), demand=int(demands[i]), wave=wave,
            stats=stats, verdicts_out=out.verdicts[i],
            levels_out=out.levels[i] if wave else None, rmq=rmq)
    got = (out.verdicts, out.levels) if wave else (out.verdicts,)
    return (*got, hist)


def paint_many_hist_packed(hist, pb: PackedBatch, accepted,
                           commit_versions, new_oldests, demands=None,
                           plain: bool = False):
    """Paint-only re-advance of a window (the JAX ``paint_many_hist_packed``,
    :2747): per step the too-old floor, the demand-driven fold and a paint
    of the host-forced ``accepted`` [k, B] mask (its cross ranks searched
    against the post-fold delta). ``demands`` are the host's counts (counted
    here when omitted). Over a flat history (the JAX ``paint_many_packed``,
    :2721) the floor and the paint, no fold."""
    for i in range(pb.ranks.txn_mask.shape[0]):
        step = _step_packed(pb, i)
        floor, hist = _floor_and_fold(
            hist, step.ranks, int(new_oldests[i]),
            None if demands is None else int(demands[i]), plain)
        hist = _with_painted(hist, _paint_and_compact_packed(
            _paint_level(hist), step.dict_keys, step.ranks, accepted[i],
            int(commit_versions[i]), floor, plain=plain))
    return hist


def wave_edges_hist_packed(hist, pb: PackedBatch, new_oldest,
                           rmq: str = "sparse"):
    """Phase 1 of the two-phase wave (the JAX
    ``wave_edges_batch_hist_packed``, :2433; over a flat history
    ``wave_edges_batch_packed``, :2425): (too_old [B], hist_conflict [B],
    pred int32 [BP, BP/32]); the probe runs against base and delta
    unmerged (it is merge-invariant) and nothing is painted."""
    rbk = pb.ranks
    search, base_st, versions, level, _ = _packed_levels(hist, pb.dict_keys,
                                                         False)
    too_old, hist_mask, cand = packed_probe(rbk, _floor(hist, new_oldest),
                                            search, base_st, versions,
                                            level.n_used, rmq=rmq)
    p = wave_pred_matrix(cand, endpoint_ranks_live_packed(rbk))
    return too_old, hist_mask.any(1), p


def wave_apply_hist_packed(hist, pb: PackedBatch, cand, p,
                           commit_version: int, new_oldest,
                           demand: int | None = None, stats=None):
    """Phase 2 (the JAX ``wave_apply_batch_hist_packed``, :2501; over a
    flat history ``wave_apply_batch_packed``, :2489): the demand-driven
    fold of a two-level history, the leveling of the global graph (K6) and
    the paint of this shard's globally accepted writes (K13). Returns
    (levels int32 [B], new history)."""
    floor, hist = _floor_and_fold(hist, pb.ranks, new_oldest, demand, False)
    accepted, levels = wave_level_from_graph(cand, p, stats)
    return levels, _with_painted(hist, _paint_and_compact_packed(
        _paint_level(hist), pb.dict_keys, pb.ranks, accepted, commit_version,
        floor))


def spec_mark_rejected(scratch: ConflictState, pb: PackedBatch, rejected,
                       plain: bool = False) -> ConflictState:
    """The JAX ``_spec_mark_rejected`` (:2854): the reconciling window's
    rejected writes ([k, B] mask) painted into a flat scratch state at
    version INT32_MAX - 1 (K13 per step, in place on the card)."""
    zero = _i32(0, scratch.keys.device)
    for i in range(pb.ranks.txn_mask.shape[0]):
        step = _step_packed(pb, i)
        scratch = _paint_and_compact_packed(
            scratch, step.dict_keys, step.ranks, rejected[i],
            SPEC_DEP_VERSION, zero, plain=plain)
    return scratch


def spec_dep_window(scratch: ConflictState, pb: PackedBatch,
                    plain: bool = False, rmq: str = "sparse") -> torch.Tensor:
    """The JAX ``_spec_dep_window`` (:2867): 0-dim bool, True when a read
    of the younger window ``pb`` overlaps a rejected write in ``scratch``
    (or the scratch overflowed). Per step K12's flat search, then the
    scratch's table and K12's probe (blocked: K17's build and probe), as
    JAX builds the table in every step."""
    dep = scratch.overflow.clone()
    zero = _i32(0, scratch.keys.device)
    for i in range(pb.ranks.txn_mask.shape[0]):
        step = _step_packed(pb, i)
        search = dict_history_search(scratch.keys, step.dict_keys,
                                     plain=plain)
        _, hist_mask, _ = packed_probe(step.ranks, zero, search, None,
                                       scratch.versions, scratch.n_used,
                                       plain, rmq)
        dep = dep | hist_mask.any()
    return dep


# ---------------------------------------------------------------------------
# B5 flat and B3 non-resident: full-key batches over flat [C, W] histories
# ---------------------------------------------------------------------------
#
# The JAX unpacked flat programs (a batch of full [B, ., W] key rows, one
# flat [C, W] step function whose sparse table is rebuilt every batch) and
# the non-resident sharded engine that runs them on S keyspace shards
# (``_sharded_resolve``, sharded_resolver.py:107-166), the shards a
# leading [S] axis of one state on one card and the mesh's OR an OR over
# that axis. On the card: K16 (word_shard.cu) probes the clipped reads of
# every shard over its live rows; K14
# (word_sort.cu) ranks the batch's endpoint rows by sorting them on the
# card, for K3 (or, per shard on the clipped rows, for K5, then K10 and
# K6); K15 (word_shard.cu) clips the writes to every shard; each shard's
# paint is K13's wc_paint_keys, K12's search of the new rows into the
# shard, K14's sort and K13's wc_paint_sorted, in place. At S = 1 with no
# bounds (``resolve_batch``, ``resolve_many``) these are the single flat
# engine's programs. Every function with a kernel route has a ``*_plain``
# twin, or takes ``plain`` to run the plain versions wherever the tensors
# live (the yardstick on the card).


class BatchTensors(NamedTuple):
    """One padded batch of full key rows (the JAX BatchTensors); a window
    has a leading [k] axis on every leaf."""

    read_begin: torch.Tensor  # int32 [B, R, W]
    read_end: torch.Tensor
    read_mask: torch.Tensor  # bool [B, R]
    write_begin: torch.Tensor  # int32 [B, Q, W]
    write_end: torch.Tensor
    write_mask: torch.Tensor  # bool [B, Q]
    read_version: torch.Tensor  # int32 [B] (relative)
    txn_mask: torch.Tensor  # bool [B]


class WordClip(NamedTuple):
    """A full-key batch clipped to each of S shards (the JAX ``clip_batch``
    of every shard, stacked): the writes always, the reads for a wave
    engine."""

    write_begin: torch.Tensor  # int32 [S, B, Q, W]
    write_end: torch.Tensor
    write_mask: torch.Tensor  # bool [S, B, Q]: mask & (begin < end)
    read_begin: torch.Tensor | None  # int32 [S, B, R, W]
    read_end: torch.Tensor | None
    read_mask: torch.Tensor | None


def init_flat_shards(capacity: int, width: int, lo_rows,
                     device) -> ConflictState:
    """S flat [C, W] histories stacked on a leading axis (the JAX
    per-shard ``init_state(capacity, W, lo[d])``): shard s starts with one
    boundary, its lower bound ``lo_rows[s]`` ([S, W])."""
    lo = torch.as_tensor(lo_rows, dtype=torch.int32)
    s, w = lo.shape
    keys = torch.full((s, capacity, w), INT32_MAX, dtype=torch.int32,
                      device=device)
    keys[:, 0] = lo.to(device)
    return ConflictState(
        keys=keys,
        versions=torch.full((s, capacity), NEG_VERSION, dtype=torch.int32,
                            device=device),
        n_used=torch.ones(s, dtype=torch.int32, device=device),
        oldest=torch.zeros(s, dtype=torch.int32, device=device),
        overflow=torch.zeros(s, dtype=torch.bool, device=device))


def _as_shards(state: ConflictState) -> ConflictState:
    """A flat [C, W] state as a one-shard stack (views)."""
    return ConflictState(*(x[None] for x in state))


def _step_batch(batch: BatchTensors, i: int) -> BatchTensors:
    """Step ``i`` of a [k]-leading BatchTensors (views, contiguous)."""
    return BatchTensors(*(x[i] for x in batch))


def too_old_mask(state: ConflictState, batch: BatchTensors, new_oldest):
    """(floor, too_old [B]) (the JAX :1056): the floor never regresses,
    write-only txns are never too old."""
    has_reads = (batch.read_mask
                 & lex_lt(batch.read_begin, batch.read_end)).any(1)
    floor = torch.maximum(state.oldest, _i32(new_oldest, state.oldest.device))
    too_old = batch.txn_mask & has_reads & (batch.read_version < floor)
    return floor, too_old


def _history_conflict_ranges(state: ConflictState, batch: BatchTensors,
                             rmq: str = "sparse"):
    """bool [B, R]: a read slot overlaps a write of the flat history newer
    than its read version (the JAX :219; the table, sparse or blocked, is
    built here, as JAX builds it every batch)."""
    b, r, w = batch.read_begin.shape
    lo = searchsorted_words(state.keys, batch.read_begin.reshape(b * r, w),
                            "right") - 1
    hi = searchsorted_words(state.keys, batch.read_end.reshape(b * r, w),
                            "left")
    newest = range_max_rmq(state.versions, lo.clamp(min=0), hi,
                           rmq).reshape(b, r)
    live = batch.read_mask & lex_lt(batch.read_begin, batch.read_end)
    return live & (newest > batch.read_version[:, None])


def _history_conflict_ranges_hist(base: ConflictState, base_st,
                                  delta: ConflictState, batch: BatchTensors,
                                  rmq: str = "sparse"):
    """bool [B, R] over a two-level history of full key rows (the JAX
    :1316): the base through its prebuilt sparse table, the delta through
    a table built here, sparse or blocked."""
    b, r, w = batch.read_begin.shape
    rb = batch.read_begin.reshape(b * r, w)
    re_ = batch.read_end.reshape(b * r, w)
    lo = searchsorted_words(base.keys, rb, "right") - 1
    hi = searchsorted_words(base.keys, re_, "left")
    newest_b = range_max(base_st, lo.clamp(min=0), hi, NEG_VERSION)
    lo_d = searchsorted_words(delta.keys, rb, "right") - 1
    hi_d = searchsorted_words(delta.keys, re_, "left")
    newest_d = range_max_rmq(delta.versions, lo_d.clamp(min=0), hi_d, rmq)
    newest = torch.maximum(newest_b, newest_d).reshape(b, r)
    live = batch.read_mask & lex_lt(batch.read_begin, batch.read_end)
    return live & (newest > batch.read_version[:, None])


def word_history_probe_plain(hist, batch: BatchTensors, floor,
                             rmq: str = "sparse"):
    """Plain twin of :func:`word_history_probe`: (too_old [B], hist_mask
    [B, R], cand [B])."""
    has_reads = (batch.read_mask
                 & lex_lt(batch.read_begin, batch.read_end)).any(1)
    too_old = batch.txn_mask & has_reads & (batch.read_version < floor)
    if isinstance(hist, HistState):
        hist_mask = _history_conflict_ranges_hist(hist.base, hist.base_st,
                                                  hist.delta, batch, rmq)
    else:
        hist_mask = _history_conflict_ranges(hist, batch, rmq)
    return too_old, hist_mask, batch.txn_mask & ~too_old & ~hist_mask.any(1)


def _word_bounds(level0, rows, level1=None):
    """K12's search of the slots' endpoint rows [B, R, W] into the live
    rows of history level ``level0`` (and ``level1``): (ls0, rs0, ls1,
    rs1) per slot."""
    return K.word_search(level0.keys, rows.reshape(-1, rows.shape[-1]),
                         None if level1 is None else level1.keys,
                         level0.n_used,
                         None if level1 is None else level1.n_used)


def word_history_probe(hist, batch: BatchTensors, floor, rmq: str = "sparse",
                       plain: bool = False):
    """(too_old [B], hist_mask [B, R], cand [B]): the unpacked engine's
    probe of a flat [C, W] history or a two-level one of full key rows.
    On the card, sparse: K16 unclipped over a flat history's live rows
    (with its live table); a two-level one's K16 over the base's live rows
    with its prebuilt K2 table and K16 over the delta's with its live
    table, their masks OR-ed. Blocked: K17's build
    over the per-batch level, K12's search of the slots' begin and end
    rows, and K17's probe (with the base's sparse table when there is
    one)."""
    if not _card(batch.read_begin, plain):
        return word_history_probe_plain(hist, batch, floor, rmq)
    tail = (batch.read_mask, batch.read_version, batch.txn_mask, floor)
    two = isinstance(hist, HistState)
    level = _paint_level(hist)
    if rmq == "blocked":
        table = K.blocked_build(level.versions, level.n_used)
        if not two:
            _, rs, _, _ = _word_bounds(level, batch.read_begin)
            ls, _, _, _ = _word_bounds(level, batch.read_end)
            return K.blocked_probe(level.versions, table, rs, ls,
                                   batch.read_begin, batch.read_end, *tail,
                                   n_used=level.n_used)
        base = hist.base
        _, rs_b, _, rs_d = _word_bounds(base, batch.read_begin, level)
        ls_b, _, ls_d, _ = _word_bounds(base, batch.read_end, level)
        return K.blocked_probe(level.versions, table, rs_d, ls_d,
                               batch.read_begin, batch.read_end, *tail,
                               base_st=hist.base_st, rs_b=rs_b, ls_b=ls_b,
                               n_used=level.n_used)
    rows = (batch.read_begin, batch.read_end)
    probe = K.word_shard_probe(level.keys[None], level.versions[None],
                               level.n_used.reshape(1), *rows, *tail[:3],
                               None, None, floor)
    if not two:
        too_old, hist_mask, _, cand = probe
        return too_old, hist_mask, cand
    base = hist.base
    too_old, mask_b, _, cand = K.word_shard_probe(
        base.keys[None], base.versions[None], base.n_used.reshape(1), *rows,
        *tail[:3], None, None, floor, table=hist.base_st)
    _, mask_d, hist_d, _ = probe
    return too_old, mask_b | mask_d, cand & ~hist_d


def _history_conflicts(state: ConflictState, batch: BatchTensors):
    """bool [B] (the JAX :252)."""
    return _history_conflict_ranges(state, batch).any(1)


def clip_batch(batch: BatchTensors, lo, hi) -> BatchTensors:
    """The batch restricted to the keyspace shard [lo, hi) ([W] rows; the
    JAX :1028): a range outside the shard drops out of its mask;
    read_version and txn_mask are untouched."""
    rb = lex_max(batch.read_begin, lo)
    re_ = lex_min(batch.read_end, hi)
    wb = lex_max(batch.write_begin, lo)
    we = lex_min(batch.write_end, hi)
    return batch._replace(
        read_begin=rb, read_end=re_,
        read_mask=batch.read_mask & lex_lt(rb, re_),
        write_begin=wb, write_end=we,
        write_mask=batch.write_mask & lex_lt(wb, we))


def word_clip_plain(batch: BatchTensors, lo, hi, reads: bool) -> WordClip:
    """Plain twin of K15: ``clip_batch`` of every shard ([S, W] bounds),
    stacked; the reads only when ``reads``."""
    per = [clip_batch(batch, lo[s], hi[s]) for s in range(lo.shape[0])]

    def stack(f):
        return torch.stack([getattr(x, f) for x in per])

    return WordClip(stack("write_begin"), stack("write_end"),
                    stack("write_mask"),
                    *((stack("read_begin"), stack("read_end"),
                       stack("read_mask")) if reads else (None,) * 3))


def word_clip(batch: BatchTensors, lo, hi, reads: bool,
              plain: bool = False) -> WordClip:
    """K15: the batch clipped to every shard's [lo[s], hi[s]), one
    elementwise launch; the reads too when ``reads`` (a wave engine's
    predecessor rows come from clipped reads and writes)."""
    if _card(lo, plain):
        return WordClip(*K.word_clip(
            batch.read_begin, batch.read_end, batch.read_mask,
            batch.write_begin, batch.write_end, batch.write_mask, lo, hi,
            reads))
    return word_clip_plain(batch, lo, hi, reads)


class WordWindowClip(NamedTuple):
    """K15 for every step of a window: its buffers, allocated once and
    checked once against the window's [k, ...] key rows; ``step`` clips
    step i into them unchecked (on the card), or through the plain version
    (on the CPU, or with ``plain``). A step's clip is dead after its
    paint: the next step writes the same buffers in stream order."""

    out: WordClip | None
    lo: torch.Tensor
    hi: torch.Tensor
    reads: bool

    @classmethod
    def of(cls, batches: BatchTensors, lo, hi, reads: bool,
           plain: bool = False) -> "WordWindowClip":
        out = None
        if _card(lo, plain):
            _, b, r, w = batches.read_begin.shape
            q = batches.write_begin.shape[2]
            out = WordClip(*K.word_clip_out(lo.shape[0], b, r, q, w, reads,
                                            lo.device))
            K.check_word_clip(*batches[:6], lo, hi, reads, out)
        return cls(out, lo, hi, reads)

    def step(self, batch: BatchTensors) -> WordClip:
        if self.out is None:
            return word_clip_plain(batch, self.lo, self.hi, self.reads)
        K.word_clip_into(*batch[:6], self.lo, self.hi, self.reads, self.out)
        return self.out


def clip_view(batch: BatchTensors, clip: WordClip, s: int) -> BatchTensors:
    """Shard s's view of the batch: its clipped writes, and its clipped
    reads where the clip has them."""
    out = batch._replace(write_begin=clip.write_begin[s],
                         write_end=clip.write_end[s],
                         write_mask=clip.write_mask[s])
    if clip.read_begin is None:
        return out
    return out._replace(read_begin=clip.read_begin[s],
                        read_end=clip.read_end[s],
                        read_mask=clip.read_mask[s])


def word_shard_probe_plain(hist: ConflictState, batch: BatchTensors, lo, hi,
                           floor, rmq: str = "sparse"):
    """Plain twin of K16 (of K17's sharded probe under ``rmq="blocked"``):
    (too_old [B], hist_mask [B, R], hist_conflict [B], cand [B]) over the
    S flat histories ``hist`` ([S, C, W]): the too-old mask of the
    unclipped batch at ``floor`` (0-dim), each shard's
    ``_history_conflict_ranges`` (its table sparse or blocked) of the
    batch clipped to it (unclipped when ``lo`` is None), OR-ed over the
    shards as the mesh ORs them."""
    has_reads = (batch.read_mask
                 & lex_lt(batch.read_begin, batch.read_end)).any(1)
    too_old = batch.txn_mask & has_reads & (batch.read_version < floor)
    hist_mask = torch.stack([
        _history_conflict_ranges(
            _shard_hist(hist, s),
            batch if lo is None else clip_batch(batch, lo[s], hi[s]), rmq)
        for s in range(hist.keys.shape[0])]).any(0)
    hist_conflict = hist_mask.any(1)
    cand = batch.txn_mask & ~too_old & ~hist_conflict
    return too_old, hist_mask, hist_conflict, cand


def word_shard_probe(hist: ConflictState, batch: BatchTensors, lo, hi,
                     floor, plain: bool = False, rmq: str = "sparse"):
    """(too_old, hist_mask, hist_conflict, cand) over every shard. On the
    card: K16 over each shard's live rows [0, n_used[s]) (the rows past it
    are (+inf, NEG_VERSION)): its range-max table over them, then one
    launch, a thread a read slot walking the shards it overlaps, that ORs
    the shards' conflict bits. Blocked: K17's sharded probe, the blocked
    structure over the same live rows and K16's probe with the blocked
    range max, two launches."""
    if _card(hist.keys, plain) and rmq == "blocked":
        return K.blocked_shard_probe(
            hist.keys, hist.versions, hist.n_used, batch.read_begin,
            batch.read_end, batch.read_mask, batch.read_version,
            batch.txn_mask, lo, hi, floor)
    if _card(hist.keys, plain):
        return K.word_shard_probe(
            hist.keys, hist.versions, hist.n_used, batch.read_begin,
            batch.read_end, batch.read_mask, batch.read_version,
            batch.txn_mask, lo, hi, floor)
    return word_shard_probe_plain(hist, batch, lo, hi, floor, rmq)


# ---------------------------------------------------------------------------
# K8/K16's live-prefix algorithm, step for step (plain)
# ---------------------------------------------------------------------------


def _log2_floor(x: torch.Tensor) -> torch.Tensor:
    """floor(log2 x) of positive int32 values (exact: float64 holds them)."""
    return x.double().log2().floor().to(x.dtype)


def live_table_plain(values: torch.Tensor, levels: int = K.LIVE_LEVELS):
    """K8/K16's range-max table over one shard's live ``values`` [n]
    (live_probe.cuh ``lp_build``): (rows [levels + 1, n], row l the
    windowed max max(v[i : min(i + 2^l, n)]), row 0 the values; top [T,
    nb], the sparse table over the maxima of the nb blocks of 2^levels
    rows, its row 0 those maxima)."""
    n = values.shape[0]
    rows = [values]
    for lvl in range(1, levels + 1):
        prev, d = rows[-1], 1 << (lvl - 1)
        nxt = prev.clone()
        if n > d:
            nxt[:n - d] = torch.maximum(prev[:n - d], prev[d:])
        rows.append(nxt)
    top = [rows[levels][::1 << levels]]
    nb = top[0].shape[0]
    while (1 << len(top)) <= nb:
        prev, d = top[-1], 1 << (len(top) - 1)
        nxt = prev.clone()
        nxt[:nb - d] = torch.maximum(prev[:nb - d], prev[d:])
        top.append(nxt)
    return torch.stack(rows), torch.stack(top)


def live_range_max_plain(rows: torch.Tensor, top: torch.Tensor, a, z,
                         levels: int = K.LIVE_LEVELS) -> torch.Tensor:
    """max(v[a:z]) per query from :func:`live_table_plain`'s table
    (live_probe.cuh ``lp_max``), 0 <= a <= z <= n; NEG_VERSION when empty:
    one row its value, fewer than 2^(levels+1) rows two entries of their
    level, longer ranges their two ends at level ``levels`` and the whole
    blocks between them from the top."""
    length = z - a
    out = torch.full_like(a, NEG_VERSION)
    n = rows.shape[1]
    if n == 0:
        return out
    blk = 1 << levels

    def at(table, lvl, i):
        return table[lvl.long(), i.clamp(0, table.shape[1] - 1).long()]

    lvl = _log2_floor(length.clamp(min=1))
    short = torch.maximum(at(rows, lvl.clamp(max=levels), a),
                          at(rows, lvl.clamp(max=levels), z - (1 << lvl)))
    out = torch.where(length >= 1, short, out)
    long_ = length >= 2 * blk
    if bool(long_.any()):
        ends = torch.maximum(at(rows, torch.full_like(a, levels), a),
                             at(rows, torch.full_like(a, levels), z - blk))
        ja, jz = (a + blk - 1) >> levels, z >> levels
        tl = _log2_floor((jz - ja).clamp(min=1))
        mid = torch.maximum(at(top, tl, ja), at(top, tl, jz - (1 << tl)))
        out = torch.where(long_, torch.maximum(ends, mid), out)
    return out


def _search_steps_plain(rows, q, lo, hi, upper: bool) -> torch.Tensor:
    """The probe's binary search of sorted [n, W] ``rows`` for every query
    row of ``q`` [M, W] within [lo, hi) (live_probe.cuh ``lp_step``): the
    first index whose row is above q (``upper``) or not below it, or hi."""
    lo, hi = lo.clone(), hi.clone()
    while True:
        active = lo < hi
        if not bool(active.any()):
            return lo
        mid = (lo + hi) >> 1
        a = rows[mid.clamp(0, rows.shape[0] - 1).long()]
        before = lex_le(a, q) if upper else lex_lt(a, q)
        lo = torch.where(active & before, mid + 1, lo)
        hi = torch.where(active & ~before, mid, hi)


def live_probe_plain(keys, versions, n_used, read_begin, read_end, read_mask,
                     read_version, txn_mask, lo, hi, floor,
                     fences: int | None = None,
                     levels: int = K.LIVE_LEVELS, rmq: str = "sparse"):
    """Plain twin of K8's and K16's live-prefix probe (live_probe.cuh),
    step for step: (too_old [B], hist_mask [B, R], hist_conflict [B], cand
    [B]) over the S histories ``keys`` [S, C, W] / ``versions`` [S, C],
    each read over its rows [0, n_used[s]) only. A read slot is clipped to
    each shard ([max(begin, lo[s]), min(end, hi[s])), W-word rows; no clip
    when ``lo`` is None); its begin's upper bound and its end's lower bound
    are found by ``fences`` evenly spaced live rows (default: the kernel's,
    ``kernels.live_fences``; 0: none) and a binary search between them;
    the range [upper - 1 clamped at 0, lower) takes its max from
    :func:`live_table_plain`'s table (``levels``: the kernel's
    LIVE_LEVELS), or with ``rmq="blocked"`` (K17's sharded probe) from the
    blocked structure over the shard's live rows (``block_table_live``,
    ``range_max_blocked_live``). The too-old test is on the unclipped
    reads at ``floor`` (0-dim)."""
    s_n, c, w = keys.shape
    b, r = read_mask.shape
    dev = keys.device
    f = K.live_fences(s_n, w) if fences is None else fences
    qb0, qe0 = read_begin.reshape(-1, w), read_end.reshape(-1, w)
    live = read_mask.reshape(-1) & lex_lt(qb0, qe0)
    rv = read_version.repeat_interleave(r)
    hist_mask = torch.zeros(b * r, dtype=torch.bool, device=dev)
    zero = torch.zeros(b * r, dtype=torch.int32, device=dev)
    for s in range(s_n):
        n = min(max(int(n_used[s]), 0), c)
        qb, qe, ok = qb0, qe0, live
        if lo is not None:
            qb, qe = lex_max(qb0, lo[s]), lex_min(qe0, hi[s])
            ok = live & lex_lt(qb, qe)
        rows = keys[s, :n]
        sp = -(-n // f) if f and n else 0
        fence = rows[::sp] if sp else rows[:0]

        def bound(q, upper):
            if fence.shape[0] == 0:
                return _search_steps_plain(rows, q, zero, zero + n, upper)
            k = _search_steps_plain(fence, q, zero, zero + fence.shape[0],
                                    upper)
            lo_ = torch.where(k == 0, zero, (k - 1) * sp + 1)
            hi_ = torch.where(k == 0, zero, torch.clamp(k * sp, max=n))
            return _search_steps_plain(rows, q, lo_, hi_, upper)

        a = (bound(qb, True) - 1).clamp(min=0)
        z = bound(qe, False)
        if rmq == "blocked":
            newest = range_max_blocked_live(
                block_table_live(versions[s], n, NEG_VERSION), a, z, n,
                NEG_VERSION)
        else:
            table, top = live_table_plain(versions[s, :n], levels)
            newest = live_range_max_plain(table, top, a, z, levels)
        hist_mask |= ok & (newest > rv)
    hist_mask = hist_mask.reshape(b, r)
    has_reads = live.reshape(b, r).any(1)
    too_old = txn_mask & has_reads & (read_version < floor)
    hist_conflict = hist_mask.any(1)
    return too_old, hist_mask, hist_conflict, \
        txn_mask & ~too_old & ~hist_conflict


def shard_probe_live_plain(hist: ConflictState, rbk: RankBatch, lo, hi,
                           floor, fences: int | None = None,
                           levels: int = K.LIVE_LEVELS, rmq: str = "sparse"):
    """K8's algorithm, plain (:func:`live_probe_plain` at W = 1 over the
    rank histories [S, C, 1]; ``rmq="blocked"``: K17's sharded probe):
    (too_old, hist_conflict, cand)."""
    too_old, _, hit, cand = live_probe_plain(
        hist.keys, hist.versions, hist.n_used, rbk.read_begin[..., None],
        rbk.read_end[..., None], rbk.read_mask, rbk.read_version,
        rbk.txn_mask, lo[:, None], hi[:, None], floor, fences, levels, rmq)
    return too_old, hit, cand


def word_shard_probe_live_plain(hist: ConflictState, batch: BatchTensors, lo,
                                hi, floor, fences: int | None = None,
                                levels: int = K.LIVE_LEVELS,
                                rmq: str = "sparse"):
    """K16's algorithm, plain (:func:`live_probe_plain` over [S, C, W]
    histories; ``rmq="blocked"``: K17's sharded probe): (too_old,
    hist_mask, hist_conflict, cand)."""
    return live_probe_plain(hist.keys, hist.versions, hist.n_used,
                            batch.read_begin, batch.read_end, batch.read_mask,
                            batch.read_version, batch.txn_mask, lo, hi, floor,
                            fences, levels, rmq)


def _endpoint_ranks(batch: BatchTensors):
    """(rb, re, wb, we): every endpoint row ranked into the sorted
    multiset of the batch's endpoints, searchsorted left (the JAX :291;
    plain)."""
    b, r, w = batch.read_begin.shape
    q = batch.write_begin.shape[1]
    flat = torch.cat([batch.read_begin.reshape(b * r, w),
                      batch.read_end.reshape(b * r, w),
                      batch.write_begin.reshape(b * q, w),
                      batch.write_end.reshape(b * q, w)])
    (sorted_keys,) = sort_keys_with_payload(flat)
    ranks = searchsorted_words(sorted_keys, flat, "left")
    n_r, n_q = b * r, b * q
    return (ranks[:n_r].reshape(b, r), ranks[n_r:2 * n_r].reshape(b, r),
            ranks[2 * n_r:2 * n_r + n_q].reshape(b, q),
            ranks[2 * n_r + n_q:].reshape(b, q))


def endpoint_ranks_live_plain(batch: BatchTensors):
    """Plain twin of K14's rank launch (the JAX ``endpoint_ranks_live``,
    :365): (rb, re, read_live, wb, we, write_live)."""
    rb, re_, wb, we = _endpoint_ranks(batch)
    return (rb, re_, batch.read_mask & (rb < re_), wb, we,
            batch.write_mask & (wb < we))


def endpoint_ranks_live(batch: BatchTensors, plain: bool = False):
    """K14 with its rank tail: the batch's endpoint rows sorted on the
    card, every endpoint's rank and the liveness masks, the shared
    precursor of K3 and K5."""
    if _card(batch.read_begin, plain):
        return K.word_ranks(batch.read_begin, batch.read_end,
                            batch.read_mask, batch.write_begin,
                            batch.write_end, batch.write_mask)
    return endpoint_ranks_live_plain(batch)


def _paint_and_compact_plain(state: ConflictState, batch: BatchTensors,
                             accepted, commit_version: int, new_oldest):
    """Plain twin of the unpacked paint (the JAX :869): the accepted
    writes' endpoints (a rejected one parked on the +inf row), searched
    into the history, sorted with their deltas, pre-paint versions and
    cross ranks, then ``_paint_tail``."""
    c, w = state.keys.shape
    b, q, _ = batch.write_begin.shape
    e2 = b * q
    valid = (accepted[:, None] & batch.write_mask
             & lex_lt(batch.write_begin, batch.write_end))
    inf_row = torch.full((w,), INT32_MAX, dtype=torch.int32,
                         device=state.keys.device)
    wb = torch.where(valid[..., None], batch.write_begin, inf_row)
    we = torch.where(valid[..., None], batch.write_end, inf_row)
    new_keys = torch.cat([wb.reshape(e2, w), we.reshape(e2, w)])
    v = valid.reshape(e2).to(torch.int32)
    new_delta = torch.cat([v, -v])
    cross_rank = searchsorted_words(state.keys, new_keys, "right")
    new_oldv = state.versions[(cross_rank - 1).clamp(min=0).long()]
    snew, sdelta, soldv, scross = sort_keys_with_payload(
        new_keys, new_delta, new_oldv, cross_rank)
    return _paint_tail(state, snew, sdelta, soldv, scross, commit_version,
                       new_oldest)


def _paint_and_compact(state: ConflictState, batch: BatchTensors, accepted,
                       commit_version: int, new_oldest,
                       plain: bool = False) -> ConflictState:
    """The unpacked paint, in place on the card: K13's wc_paint_keys (the
    new endpoint rows, rejected ones on +inf), K12's right search of them
    into the history (their cross ranks), K14's sort carrying deltas and
    cross ranks, and K13's wc_paint_sorted (``_paint_tail``).
    ``new_oldest`` is the 0-dim floor."""
    if _card(state.keys, plain):
        keys, delta = K.word_paint_keys(batch.write_begin, batch.write_end,
                                        batch.write_mask, accepted)
        _, cross, _, _ = K.word_search(state.keys, keys,
                                       live0=state.n_used)
        snew, (sdelta, scross) = K.word_sort(keys, (delta, cross))
        K.word_paint_sorted(state, snew, sdelta, scross, int(commit_version),
                            _i32(new_oldest, keys.device))
        return state
    return _paint_and_compact_plain(state, batch, accepted, commit_version,
                                    new_oldest)


#: Merged rows of K13's sorted-paint tile (one a thread).
K13_TILE = K.K13_TILE


def word_sort_tiles_plain(keys, tile: int | None = None):
    """K14's merge by ranking, in plain torch: (perm, ranks) for the [N, W]
    rows ``keys``. Each tile of ``tile`` rows (default: the kernel's,
    ``kernels.word_sort_tile``) is sorted alone; a row's output slot is
    its slot in its own sorted tile plus, for every other tile, that
    tile's rows before it (<= for an earlier tile, < for a later one, so
    equal rows keep their input order; the kernel counts them by merging
    the two sorted tiles): ``perm[slot]`` is its input index, the stable
    sort's permutation. ``ranks[i]`` is the count of rows strictly less
    than row i, a lower bound in every sorted tile (``_endpoint_ranks``'
    searchsorted left into the sorted rows)."""
    n = keys.shape[0]
    dev = keys.device
    tile = tile or K.word_sort_tile(n, keys.shape[1])
    starts = range(0, n, tile)
    tiles = []
    for t0 in starts:
        local = torch.arange(t0, min(n, t0 + tile), dtype=torch.int32,
                             device=dev)
        tiles.append(sort_keys_with_payload(keys[t0:t0 + tile], local))
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    ranks = torch.zeros(n, dtype=torch.int32, device=dev)
    for t, (sk, idx) in enumerate(tiles):
        slot = torch.arange(sk.shape[0], dtype=torch.int32, device=dev)
        rows = keys[starts[t]:starts[t] + tile]
        for u, (uk, _) in enumerate(tiles):
            ranks[starts[t]:starts[t] + tile] += searchsorted_words(
                uk, rows, "left").to(torch.int32)
            if u != t:
                slot += searchsorted_words(
                    uk, sk, "right" if u < t else "left").to(torch.int32)
        perm[slot.long()] = idx
    return perm, ranks


def _search_pivots(lo, m, g: int, win):
    """[N, g] pivots of word_probe.cu's ``pivot`` (every row when m <= g;
    a gallop window's end at the last; else g + 1 even parts) and which
    lanes test one."""
    k = torch.arange(g, dtype=torch.int64, device=lo.device)
    lo, m, win = lo[:, None], m[:, None], win[:, None]
    spread = torch.where(win, lo + (k + 1) * m // g - 1,
                         lo + (k + 1) * m // (g + 1))
    return torch.where(m <= g, lo + k, spread), k < m.clamp(max=g)


def group_search_plain(keys, lo, hi, q, g: int, upper: bool, gallop: bool,
                       active, span=None):
    """word_probe.cu's ``group_search`` for every query row at once: the
    first row of [lo, hi) of the sorted ``keys`` above ``q`` (``upper``) or
    not below it, or hi, by (g+1)-ary steps of g pivots (with ``gallop``,
    after windows of g, g(g+1), ... rows from lo). ``span`` ([N] lo, [N]
    hi): every compared row must lie in it (the rows a block staged or the
    live prefix), else this raises."""
    lo, hi = lo.long().clone(), hi.long().clone()
    n = lo.shape[0]
    go = active & (lo < hi)
    gal = torch.full_like(go, gallop)
    length = torch.full_like(lo, g)
    ar = torch.arange(n, device=lo.device)
    while bool(go.any()):
        win = gal & go
        end = torch.where(win & (hi - lo > length), lo + length, hi)
        m = end - lo
        p, valid = _search_pivots(lo, m, g, win)
        valid &= go[:, None]
        if span is not None and bool((valid & ((p < span[0][:, None])
                                               | (p >= span[1][:, None])))
                                     .any()):
            raise AssertionError("K12's search read a row outside its span")
        rows = keys[p.clamp(0, max(keys.shape[0] - 1, 0))]
        below = lex_lt(rows, q[:, None, :])
        passed = valid & ((lex_lt(q[:, None, :], rows)) if upper else ~below)
        f = torch.argmax(passed.int(), 1)
        hit = go & passed.any(1)
        whole = go & ~hit & (win | (m <= g))
        part = go & ~hit & ~whole
        prev = torch.where(f > 0, p[ar, (f - 1).clamp(min=0)] + 1, lo)
        lo = torch.where(hit, prev, torch.where(
            whole, end, torch.where(part, p[:, -1] + 1, lo)))
        hi = torch.where(hit, p[ar, f], hi)
        gal &= ~hit
        length = torch.where(whole, torch.where(
            length > 1 << 24, 1 << 30, length * (g + 1)), length)
        go &= lo < hi
    return lo.to(torch.int32)


def word_search_tiles_plain(keys0, dict_keys, keys1=None, live0=None,
                            live1=None, plan=None):
    """K12's search by its block algorithm (word_probe.cu ``k_search``), in
    plain torch: (ls0, rs0, ls1, rs1, branch counts int32 [3], one a block
    and history). The tile and shared bytes come from
    ``kernels.word_search_plan`` unless ``plan`` gives them. Only the live
    prefix [0, n) of each history is read (n its live count, else C): a
    query of all INT32_MAX words gets right bound C. A tile of at most two
    queries a warp searches [0, n) directly; a larger one finds its
    lexicographic minimum and maximum and their bounds in each history
    (the span [L, R], at g = 32), and searches the span, "staged" when its
    rows fit what the tile's own rows (staged first when they fit) and the
    history before it left of the shared bytes (one thread a query: g =
    1), else "global". Each query's group of g = 128 /
    tile lanes finds its left bound, then gallops from it to its right
    bound. Raises if a compare reads a row outside the rows its branch may
    read."""
    n1, w = dict_keys.shape
    dev = dict_keys.device
    hists = [(keys0, live0)] + ([(keys1, live1)] if keys1 is not None
                                else [])
    c_sum = sum(k.shape[0] for k, _ in hists)
    tile, smem = plan or K.word_search_plan(n1, c_sum, w)
    g = 32 * 4 // tile
    stats = torch.zeros(3, dtype=torch.int32)
    if n1 == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=dev)
        return (empty, empty) + ((empty, empty) if keys1 is not None
                                 else (None, None)) + (stats,)
    nt = -(-n1 // tile)
    tile_of = torch.arange(n1, device=dev) // tile
    top = (dict_keys == INT32_MAX).all(1)
    ones = torch.ones(n1, dtype=torch.bool, device=dev)
    if tile > 8:  # each tile's lexicographic minimum and maximum
        first = dict_keys[torch.arange(nt, device=dev) * tile]
        pad = nt * tile - n1
        x = torch.cat([dict_keys, first[-1:].expand(pad, w)])
        mn = mx = x.reshape(nt, tile, w)
        while mn.shape[1] > 1:
            a, b = mn[:, 0::2], mn[:, 1::2]
            mn = torch.where(lex_lt(b, a)[..., None], b, a)
            a, b = mx[:, 0::2], mx[:, 1::2]
            mx = torch.where(lex_lt(a, b)[..., None], b, a)
        t_on = torch.ones(nt, dtype=torch.bool, device=dev)
        q_bytes = tile * w * 4 if smem >= tile * w * 4 else 0  # tile rows
        left_rows = torch.full((nt,), (smem - q_bytes) // (4 * w),
                               dtype=torch.int64,
                               device=dev)  # shared rows not yet staged
    out = []
    for keys, live in hists:
        c = keys.shape[0]
        n = c if live is None else min(max(int(live), 0), c)
        lo = torch.zeros(n1, dtype=torch.int64, device=dev)
        hi = torch.full_like(lo, n)
        alone = torch.zeros(n1, dtype=torch.bool, device=dev)  # staged
        if tile <= 8:
            stats[K.WP_BRANCHES.index("direct")] += nt
        else:
            t_lo = torch.zeros(nt, dtype=torch.int64, device=dev)
            t_hi = torch.full_like(t_lo, n)
            span_l = group_search_plain(keys, t_lo, t_hi, mn[:, 0], 32, False,
                                        False, t_on, (t_lo, t_hi)).long()
            span_r = group_search_plain(keys, t_lo, t_hi, mx[:, 0], 32, True,
                                        False, t_on, (t_lo, t_hi)).long()
            staged = span_r - span_l <= left_rows
            left_rows -= torch.where(staged, span_r - span_l, 0)
            stats[K.WP_BRANCHES.index("staged")] += int(staged.sum())
            stats[K.WP_BRANCHES.index("global")] += int((~staged).sum())
            lo, hi = span_l[tile_of], span_r[tile_of]
            alone = staged[tile_of]
        left = torch.empty(n1, dtype=torch.int32, device=dev)
        right = torch.empty_like(left)
        for gq, sel in ((g, ~alone), (1, alone)):
            if bool(sel.any()):
                a, b, x = lo[sel], hi[sel], dict_keys[sel]
                left[sel] = group_search_plain(keys, a, b, x, gq, False,
                                               False, ones[sel], (a, b))
                right[sel] = group_search_plain(keys, left[sel], b, x, gq,
                                                True, True, ~top[sel], (a, b))
        out += [left, torch.where(top, torch.full_like(right, c), right)]
    if keys1 is None:
        out += [None, None]
    return (*out, stats)


def paint_sorted_tiles_plain(state: ConflictState, snew, sdelta, scross,
                             commit_version: int, new_oldest,
                             tile: int = K13_TILE) -> ConflictState:
    """K13's sorted paint by its tile algorithm, over the history's live
    rows [0, n_used) only: ``_paint_tail``'s result wherever every row past
    ``n_used`` holds (+inf, NEG_VERSION). New row k sits at merged
    position k + min(scross[k], n_used), so a tile finds its new rows by
    one search over those positions and fills the rest from the history
    in order. Two sums cross tiles (the kernel's look-back): the coverage
    before a tile and the survivors before it. The version of the row
    before a tile's first run of equal keys comes from the inputs at that
    run's start (two lower-bound searches when the run began before the
    tile), with the coverage there the tile's less the deltas of the
    run's new rows before the tile. Rows [new n_used, old n_used) become
    (+inf, NEG_VERSION); rows past the old n_used are not touched."""
    from bisect import bisect_left

    c, w = state.keys.shape
    hk = [tuple(r) for r in state.keys.tolist()]
    hv = state.versions.tolist()
    nk = [tuple(r) for r in snew.tolist()]
    nd, nx = sdelta.tolist(), scross.tolist()
    n2 = len(nk)
    nu = min(max(int(state.n_used), 1), c)
    n = nu + n2
    cv, fl = int(commit_version), int(new_oldest)
    inf = (INT32_MAX,) * w
    pos = [k + min(nx[k], nu) for k in range(n2)]

    def row(a, b):  # merged row a + b, given a history and b new rows before
        return nk[b] if b < n2 and pos[b] == a + b else hk[a]

    def row_before(a, b):  # merged row a + b - 1
        return nk[b - 1] if b > 0 and min(nx[b - 1], nu) == a else hk[a - 1]

    def gc(v, key):
        return NEG_VERSION if v <= fl or key == inf else v

    k0 = row(0, 0)
    out_k, out_v = [], []
    cov_before = total = 0
    for d0 in range(0, n, tile):
        d1 = min(n, d0 + tile)
        b0, b1 = bisect_left(pos, d0), bisect_left(pos, d1)
        a0 = d0 - b0
        keys, vals, cov, j = [], [], cov_before, b0
        for r in range(d1 - d0):
            h = a0 + r - (j - b0)  # history rows before merged row d0 + r
            if j < b1 and pos[j] == d0 + r:
                key, pre = nk[j], hv[max(h - 1, 0)]
                cov += nd[j]
                j += 1
            else:
                key, pre = hk[h], hv[h]
            keys.append(key)
            vals.append(gc(cv if cov > 0 else pre, key))
        fa, fb = a0, b0
        if d0 > 0 and row_before(a0, b0) == keys[0]:
            fa = bisect_left(hk, keys[0], 0, nu)
            fb = bisect_left(nk, keys[0])
        prev_first = NEG_VERSION - 1
        if fa + fb > 0:
            run_cov = sum(nd[fb:b0])
            prev_first = gc(cv if cov_before - run_cov > 0
                            else hv[max(fa - 1, 0)], row_before(fa, fb))
        nxt = row(d1 - b1, b1) if d1 < n else None
        start = -1
        for r, key in enumerate(keys):
            if r > 0 and key != keys[r - 1]:
                start = r
            after = keys[r + 1] if r + 1 < len(keys) else nxt
            keep1 = key != after
            prev = prev_first if start < 0 else vals[start - 1]
            forced = (keep1 and key == k0) if k0 != inf else d0 + r == n - 1
            if forced or (keep1 and vals[r] != prev and key != inf):
                if total < c:
                    out_k.append(key)
                    out_v.append(vals[r])
                total += 1
        cov_before = cov
    dev = state.keys.device
    keys_out, vers_out = state.keys.clone(), state.versions.clone()
    m = len(out_k)
    keys_out[:m] = torch.tensor(out_k, dtype=torch.int32, device=dev)
    vers_out[:m] = torch.tensor(out_v, dtype=torch.int32, device=dev)
    keys_out[m:nu] = INT32_MAX
    vers_out[m:nu] = NEG_VERSION
    return ConflictState(keys=keys_out, versions=vers_out, n_used=_i32(m, dev),
                         oldest=_i32(new_oldest, dev).clone(),
                         overflow=state.overflow | (total > c))


def _live_rows_plain(st: ConflictState):
    """(rows as tuples, versions) of a level's live rows [0, n_used), at
    least one: what K13's fold reads."""
    n = min(max(int(st.n_used), 1), st.keys.shape[0])
    return [tuple(r) for r in st.keys[:n].tolist()], st.versions[:n].tolist()


def word_fold_tiles_plain(base: ConflictState, delta: ConflictState, floor,
                          tile: int = K13_TILE) -> ConflictState:
    """K13's fold by its tile algorithm (K4's at width W, ``k4_tiles_plain``
    in its fold mode) over the live rows of base and delta only, tiles of
    ``tile`` merged rows: ``_merge_delta_plain``'s base wherever every row
    past each ``n_used`` holds (+inf, NEG_VERSION)."""
    c, w = base.keys.shape
    a, av = _live_rows_plain(base)
    b, bv = _live_rows_plain(delta)
    out = k4_tiles_plain(a, av, b, bv, "fold", c,
                         bool(base.overflow | delta.overflow),
                         floor=int(floor), tile=tile, inf=(INT32_MAX,) * w)
    return _k4_state(out, base.keys.device, floor)


def word_fold_step_tiles_plain(hist: HistState, demand: int | None, floor,
                               tile: int = K13_TILE) -> HistState:
    """K13's gated fold step by its algorithm (``_maybe_merge_plain``'s
    result; with ``demand`` None the forced fold of ``advance_hist``): K4's
    decision (:func:`fold_need_plain`), then, when it holds, the tiles'
    fold (:func:`word_fold_tiles_plain`), the base's sparse table and the
    delta reset to its min-key row at ``floor``."""
    base, base_st, delta = hist
    if demand is not None and not bool(fold_need_plain(hist, demand, floor)):
        return hist
    nb = word_fold_tiles_plain(base, delta, floor, tile)
    return HistState(nb, sparse_table(nb.versions), _reset_delta(delta, floor))


def word_compact_tiles_plain(skeys, newv, c_out: int, prior_overflow,
                             tile: int = K13_TILE):
    """K13's compaction by its tile algorithm: ``_dedup_compact_plain``'s
    result for [n, W] rows."""
    w = skeys.shape[1]
    out = k4_tiles_plain([tuple(r) for r in skeys.tolist()], newv.tolist(),
                         [], [], "compact", c_out, bool(prior_overflow),
                         tile=tile, inf=(INT32_MAX,) * w)
    st = _k4_state(out, skeys.device, 0)
    return st.keys, st.versions, st.n_used, st.overflow


def packed_paint_rows_plain(dict_keys, rbk: RankBatch, accepted, rs):
    """(snew [2BQ, W], sdelta, scross): the packed paint's new rows in the
    host's ``paint_src`` order, as K13's gather writes them: row k the
    dictionary row of its endpoint's rank, coverage delta +1 / -1 (0 for
    a rejected or empty write, which stays at its own key), cross rank
    ``rs[rank]``. Sorted, since ``paint_src`` sorts the ranks."""
    b, q = rbk.write_begin.shape
    e2 = b * q
    src = rbk.paint_src.long()
    begin = src < e2
    slot = torch.where(begin, src, src - e2)
    wb = rbk.write_begin.reshape(-1)[slot]
    we = rbk.write_end.reshape(-1)[slot]
    valid = accepted[slot // q] & rbk.write_mask.reshape(-1)[slot] & (wb < we)
    rank = torch.where(begin, wb, we).long()
    sign = torch.where(begin, 1, -1)
    delta = torch.where(valid, sign, 0).to(torch.int32)
    return dict_keys[rank], delta, rs[rank]


def packed_paint_tiles_plain(state: ConflictState, dict_keys, rbk: RankBatch,
                             accepted, commit_version: int, new_oldest, rs,
                             tile: int = K13_TILE) -> ConflictState:
    """K13's packed paint by its algorithm: the gather of the new rows
    (:func:`packed_paint_rows_plain`), then the sorted paint's tiles over
    the state's live rows (:func:`paint_sorted_tiles_plain`)."""
    snew, sdelta, scross = packed_paint_rows_plain(dict_keys, rbk, accepted,
                                                   rs)
    return paint_sorted_tiles_plain(state, snew, sdelta, scross,
                                    commit_version, new_oldest, tile)


def _accept_or_schedule(cand, too_old, txn_mask, ranks, wave: bool,
                        stats=None, plain: bool = False, verdicts_out=None,
                        levels_out=None):
    """(accepted, verdicts, levels or None): the JAX ``_accept_or_schedule``
    (:1100) with the verdict epilogue: sequential-order acceptance (K3)
    or the wave schedule (K5 then K6)."""
    if not plain:
        return _schedule(cand, too_old, txn_mask, ranks, wave, stats,
                         verdicts_out, levels_out)
    if wave:
        accepted, levels, verdicts = wave_level_plain(
            cand, wave_pred_matrix_plain(cand, ranks), too_old, txn_mask,
            stats)
        return (accepted, _written(verdicts_out, verdicts),
                _written(levels_out, levels))
    accepted, verdicts = accept_plain(cand, too_old, txn_mask, ranks)
    return accepted, _written(verdicts_out, verdicts), None


def resolve_batch(state, batch: BatchTensors, commit_version: int,
                  new_oldest, report: bool = False,
                  demand: int | None = None, wave: bool = False, stats=None,
                  out: WindowOut | None = None, plain: bool = False,
                  rmq: str = "sparse"):
    """One batch of full key rows over a flat [C, W] history (the JAX
    :1108) or a two-level one (the JAX ``resolve_batch_hist``, :1351). On
    the card: the gated K13 fold of a two-level history, the probe
    (:func:`word_history_probe`), K14's ranks, K3 (or K5 and K6), the
    unpacked paint. Returns (verdicts int8 [B][, levels int32 [B]][,
    losers], new history); the losers in ``pack_loser_mask``'s layout
    (K3's report launch; the JAX unpacked report is the bool [B, R] they
    pack). The verdicts and levels go into row 0 of ``out`` when it is
    given. ``demand`` is the host's 2·live-write-ranges count (counted
    here when omitted)."""
    floor, state = _floor_and_fold(state, batch, new_oldest, demand, plain)
    too_old, hist_mask, cand = word_history_probe(state, batch, floor, rmq,
                                                  plain)
    ranks = endpoint_ranks_live(batch, plain)
    accepted, verdicts, levels = _accept_or_schedule(
        cand, too_old, batch.txn_mask, ranks, wave, stats, plain,
        None if out is None else out.verdicts[0],
        None if out is None or not wave else out.levels[0])
    state = _with_painted(state, _paint_and_compact(
        _paint_level(state), batch, accepted, commit_version, floor, plain))
    got = (verdicts, levels) if wave else (verdicts,)
    if report:
        losers = (loser_mask_plain if plain else loser_mask)(
            hist_mask, ranks, accepted, verdicts)
        return (*got, losers, state)
    return (*got, state)


def resolve_many(state, batches: BatchTensors, commit_versions, new_oldests,
                 demands=None, wave: bool = False, stats=None,
                 out: WindowOut | None = None, plain: bool = False,
                 rmq: str = "sparse"):
    """k batches of full key rows in order, over a flat history (the JAX
    :1156) or a two-level one (``resolve_many_hist``, :1386): the unpacked
    window program. Returns (verdicts int8 [k, B][, levels int32 [k, B]],
    new history), also written into ``out`` when given. No host sync
    inside the window on the card, where a two-level history needs the
    host's ``demands`` (one per step)."""
    k, b = batches.txn_mask.shape
    dev = batches.txn_mask.device
    if _card(batches.txn_mask, plain):
        if isinstance(state, HistState) and (demands is None
                                             or len(demands) != k):
            raise ValueError("the card's window program needs one "
                             "host-known write demand per step")
        LAUNCHES["unpacked_many"] += 1
    if out is None:
        out = window_out(k, b, dev, wave)
    for i in range(k):
        *_, state = resolve_batch(
            state, _step_batch(batches, i), int(commit_versions[i]),
            int(new_oldests[i]),
            demand=None if demands is None else int(demands[i]), wave=wave,
            stats=stats, out=WindowOut(out.raw, out.verdicts[i:i + 1],
                                       None if out.levels is None
                                       else out.levels[i:i + 1]),
            plain=plain, rmq=rmq)
    got = (out.verdicts, out.levels) if wave else (out.verdicts,)
    return (*got, state)


def wave_edges(state, batch: BatchTensors, new_oldest, rmq: str = "sparse"):
    """Phase 1 of the two-phase wave on full key rows (the JAX
    ``wave_edges_batch``, :2400, and ``wave_edges_batch_hist``, :2411):
    (too_old [B], hist_conflict [B], pred int32 [BP, BP/32]); the probe
    runs against base and delta unmerged and nothing is painted."""
    too_old, hist_mask, cand = word_history_probe(
        state, batch, _floor(state, new_oldest), rmq)
    p = wave_pred_matrix(cand, endpoint_ranks_live(batch))
    return too_old, hist_mask.any(1), p


def wave_apply(state, batch: BatchTensors, cand, p, commit_version: int,
               new_oldest, demand: int | None = None, stats=None):
    """Phase 2 on full key rows (the JAX ``wave_apply_batch``, :2459, and
    ``wave_apply_batch_hist``, :2474): the demand-driven fold of a
    two-level history, the leveling of the global graph (K6) and the
    unpacked paint of the globally accepted writes. Returns (levels int32
    [B], new history)."""
    floor, state = _floor_and_fold(state, batch, new_oldest, demand, False)
    accepted, levels = wave_level_from_graph(cand, p, stats)
    return levels, _with_painted(state, _paint_and_compact(
        _paint_level(state), batch, accepted, commit_version, floor))


def word_pred_exchange(cand, batch: BatchTensors, clip: WordClip,
                       stats_out=None, plain: bool = False):
    """The full-key sharded wave exchange: (p int32 [BP, BP/32], stats
    int32 [2]) as ``shard_pred_exchange``, each shard's rows from K14's
    ranks of its clipped key rows, then K5 in its OR mode into one
    matrix."""
    p, stats = _exchange_out(cand, stats_out)
    n_shards = clip.write_begin.shape[0]
    for s in range(n_shards):
        wave_pred_or(cand, endpoint_ranks_live(clip_view(batch, clip, s),
                                               plain),
                     p, stats, s, n_shards, plain)
    return p, stats


def _paint_word_shards(hist: ConflictState, batch: BatchTensors,
                       clip: WordClip, accepted, commit_version: int, floor,
                       plain: bool = False) -> ConflictState:
    """Each shard's clipped accepted writes painted into its history (in
    place on the card). ``floor`` [S] holds each shard's too-old floor."""
    n_shards = hist.keys.shape[0]
    if _card(hist.keys, plain):
        for s in range(n_shards):
            _paint_and_compact(_shard_hist(hist, s), clip_view(batch, clip, s),
                               accepted, commit_version, floor[s])
        return hist
    outs = [_paint_and_compact_plain(_shard_hist(hist, s),
                                     clip_view(batch, clip, s), accepted,
                                     commit_version, floor[s])
            for s in range(n_shards)]
    return ConflictState(*(torch.stack(x) for x in zip(*outs)))


def sharded_resolve(hist: ConflictState, batch: BatchTensors,
                    commit_version: int, new_oldest, lo, hi,
                    wave: bool = False, stats=None, verdicts_out=None,
                    levels_out=None, xstats_out=None, plain: bool = False,
                    rmq: str = "sparse", wclip: WordWindowClip | None = None):
    """One step of the JAX ``_sharded_resolve`` (:107-166) on every shard
    of ``hist`` ([S, C, W]; bounds ``lo``/``hi`` [S, W]). On the card:
    K16 (blocked: K17's build and sharded probe), K15 (checked, or into
    the window's buffers given ``wclip``), then K14's ranks and K3 on the
    unclipped batch, or per shard K14's ranks of the clipped batch and K5
    in its OR mode (the exchange, K10), then K6 (the port of
    ``_wave_exchange_and_level``, :169-185); then the unpacked paint per
    shard. The verdicts, levels and exchange stats go into the given
    buffers. Returns (verdicts, levels or None, exchange stats int32 [2]
    or None, new hist)."""
    dev = hist.keys.device
    floor = torch.maximum(hist.oldest, _i32(new_oldest, dev))
    too_old, _, _, cand = word_shard_probe(hist, batch, lo, hi, floor[0],
                                           plain, rmq)
    clip = (word_clip(batch, lo, hi, wave, plain) if wclip is None
            else wclip.step(batch))
    xstats = None
    if wave:
        p, xstats = word_pred_exchange(cand, batch, clip, xstats_out, plain)
    if wave and plain:
        accepted, levels, verdicts = wave_level_plain(
            cand, p, too_old, batch.txn_mask, stats)
        verdicts = _written(verdicts_out, verdicts)
        levels = _written(levels_out, levels)
    elif wave:
        accepted, levels, verdicts = wave_level(
            cand, p, too_old, batch.txn_mask, stats=stats,
            level_out=levels_out, verdicts_out=verdicts_out)
    else:
        accepted, verdicts, levels = _accept_or_schedule(
            cand, too_old, batch.txn_mask, endpoint_ranks_live(batch, plain),
            False, plain=plain, verdicts_out=verdicts_out)
    hist = _paint_word_shards(hist, batch, clip, accepted, commit_version,
                              floor, plain)
    return verdicts, levels, xstats, hist


def sharded_resolve_many(hist: ConflictState, batches: BatchTensors,
                         commit_versions, new_oldests, lo, hi,
                         wave: bool = False, stats=None,
                         out: WindowOut | None = None, xstats=None,
                         plain: bool = False, rmq: str = "sparse"):
    """The non-resident sharded window program (the JAX scan, :551-558): k
    steps of ``sharded_resolve`` with no host sync inside the window, K15
    checked and its buffers allocated once a window (``WordWindowClip``).
    Returns (verdicts int8 [k, B], levels int32 [k, B] or None, exchange
    stats int32 [k, 2] or None, new hist), written into ``out`` and
    ``xstats`` when given."""
    k, b = batches.txn_mask.shape
    dev = hist.keys.device
    if _card(hist.keys, plain):
        LAUNCHES["nr_sharded_many"] += 1
    if out is None:
        out = window_out(k, b, dev, wave)
    if wave and xstats is None:
        xstats = torch.empty((k, 2), dtype=torch.int32, device=dev)
    wclip = WordWindowClip.of(batches, lo, hi, wave, plain)
    for i in range(k):
        *_, hist = sharded_resolve(
            hist, _step_batch(batches, i), int(commit_versions[i]),
            int(new_oldests[i]), lo, hi, wave, stats, out.verdicts[i],
            out.levels[i] if wave else None, xstats[i] if wave else None,
            plain, rmq, wclip)
    return out.verdicts, out.levels, xstats if wave else None, hist


# ---------------------------------------------------------------------------
# Entry point names by design arm
# ---------------------------------------------------------------------------
#
# The engine composes one name per (history, format) as the JAX engine
# composes its jitted programs: ``{resolve_batch, resolve_many,
# wave_edges, wave_apply, paint_many}`` + ``_hist`` (the two-level window
# history) + ``_res`` | ``_packed`` | nothing (unpacked). Each program
# dispatches on the history it is given (a HistState or a flat
# ConflictState), as the JAX resident programs dispatch on the pytree, so
# the names of one format alias one function and a mis-paired branch has
# nowhere to hide.

resolve_batch_hist_res = resolve_batch_res
resolve_many_hist_res = resolve_many_res
wave_edges_hist_res = wave_edges_res
wave_apply_hist_res = wave_apply_res
paint_many_hist_res = paint_many_res
resolve_batch_packed = resolve_batch_hist_packed
resolve_many_packed = resolve_many_hist_packed
wave_edges_packed = wave_edges_hist_packed
wave_apply_packed = wave_apply_hist_packed
paint_many_packed = paint_many_hist_packed
resolve_batch_hist = resolve_batch
resolve_many_hist = resolve_many
wave_edges_hist = wave_edges
wave_apply_hist = wave_apply
