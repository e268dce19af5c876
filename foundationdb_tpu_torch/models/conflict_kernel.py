"""The MVCC conflict-resolution kernel, resident + window + sequential accept.

The port of ``foundationdb_tpu/models/conflict_kernel.py`` at its default
design point: a device-resident key dictionary, a two-level (frozen base +
small delta) rank-space history, sparse-table range max and exact
sequential-order acceptance. Semantics are the JAX module's; its docstrings
explain the algorithms.

Every function that carries device work dispatches on where its tensors
live. On the CPU it runs the plain torch version (``*_plain``), which the
tests hold against the JAX package byte for byte. On a CUDA tensor it
launches the hand-written kernel (kernels/csrc/*.cu) and never falls back:

- K1 ``dict_insert.cu``: dictionary insert, rank-row rewrites, version rebase;
- K2 ``history_probe.cu``: sparse-table build, history probe, too-old mask;
- K3 ``accept.cu``: overlap rows, sequential acceptance, verdicts, losers;
- K4 ``step_compact.cu``: paint, base+delta fold, dedup and compaction.

The window program ``resolve_many_res`` (the JAX ``lax.scan`` of
``resolve_many_res``) has no kernel source of its own: on the card it is
the launch sequence of K1 once for the window's delta, then K2, K3 and K4
for each of the k batches, with no host sync inside the window.

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
from foundationdb_tpu_torch.ops.bitset import to_int32_bits
from foundationdb_tpu_torch.ops.lex import searchsorted_words, searchsorted_words_fp
from foundationdb_tpu_torch.ops.rmq import range_max, sparse_table

INT32_MAX = int(_I32MAX)
NEG_VERSION = -(2**31) + 1

V_COMMITTED = 0
V_CONFLICT = 1
V_TOO_OLD = 2

_ACCEPT_BLOCK = 512

# Window launch sequences issued on the card (resolve_many_res), counted
# like the kernel launches in kernels.LAUNCHES.
LAUNCHES = {"resolve_many": 0}


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
             delta_capacity: int, device) -> ResState:
    """dict_rows: host-built initial dictionary [n0, W] (row 0 = packed b"")."""
    dict_rows = torch.as_tensor(dict_rows, dtype=torch.int32)
    n0, w = dict_rows.shape
    dict_keys = torch.full((dict_capacity + 1, w), INT32_MAX,
                           dtype=torch.int32, device=device)
    dict_keys[:n0] = dict_rows
    return ResState(
        dict_keys=dict_keys,
        n_keys=_i32(n0, device),
        hist=init_hist(capacity, 1, [0], delta_capacity, device),
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


def _history_conflict_ranges_hist_res(base: ConflictState, base_st,
                                      delta: ConflictState, rbk: RankBatch):
    """bool [B, R]: read slot overlaps a base or delta write newer than its
    read version (plain version; the delta table is built here)."""
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
    newest_d = range_max(sparse_table(delta.versions), lo_d, hi_d,
                         NEG_VERSION)
    newest = torch.maximum(newest_b, newest_d).reshape(b, r)
    live = rbk.read_mask & (rbk.read_begin < rbk.read_end)
    return live & (newest > rbk.read_version[:, None])


def history_probe_plain(hist: HistState, rbk: RankBatch, floor):
    """(too_old[B], hist_mask[B, R], cand[B]) with ``floor`` already
    computed: the plain twin of the K2 probe launch."""
    has_reads = (rbk.read_mask & (rbk.read_begin < rbk.read_end)).any(1)
    too_old = rbk.txn_mask & has_reads & (rbk.read_version < floor)
    hist_mask = _history_conflict_ranges_hist_res(
        hist.base, hist.base_st, hist.delta, rbk)
    cand = rbk.txn_mask & ~too_old & ~hist_mask.any(1)
    return too_old, hist_mask, cand


def history_probe(hist: HistState, rbk: RankBatch, floor):
    """K2: delta table build, then one probe launch that writes the slot
    mask, too_old and the acceptance candidates. ``floor`` is the 0-dim
    int32 tensor from :func:`too_old_mask_packed`."""
    if _on_card(rbk.read_begin):
        delta_st = K.build_table(hist.delta.versions)
        return K.history_probe(
            hist.base.keys, hist.base_st, hist.delta.keys, delta_st,
            rbk.read_begin, rbk.read_end, rbk.read_mask, rbk.read_version,
            rbk.txn_mask, floor)
    return history_probe_plain(hist, rbk, floor)


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


def accept(cand, too_old, txn_mask, ranks, out=None):
    """K3: (accepted bool [B], verdicts int8 [B]) — overlap rows, the
    in-order block scan and the verdict epilogue. On the card the
    verdicts go into ``out`` (a contiguous int8 [B]) when it is given."""
    if _on_card(cand):
        return K.accept(cand, too_old, txn_mask, *ranks, verdicts=out)
    return accept_plain(cand, too_old, txn_mask, ranks)


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
    """The shared compaction tail; on the card the K4 compact launch
    (width-1 keys only, the rank-space history's width)."""
    if _on_card(skeys):
        return K.compact(skeys, newv, c_out, prior_overflow)
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


def _maybe_merge(hist: HistState, demand: int, floor) -> HistState:
    """Fold the delta into the base when ``demand`` more boundaries would
    not fit, or when at least C/8 base segments have expired.

    On the card the decision stays on the device: ``need`` is a 0-dim bool
    that every fold, table and reset launch reads, exiting at once when it
    is False. No host sync. ``demand`` is the host-known count 2·(live
    write ranges)."""
    base, base_st, delta = hist
    if not _on_card(base.keys):
        return _maybe_merge_plain(hist, demand, floor)
    cd = delta.keys.shape[0]
    c = base.keys.shape[0]
    reclaimable = ((base.versions <= floor)
                   & (base.versions > NEG_VERSION)).sum()
    need = (delta.n_used + demand > cd) | (reclaimable >= max(c // 8, 1))
    K.fold(base, delta, floor, need)
    K.build_table(base.versions, out=base_st, need=need)
    delta.keys[1:].masked_fill_(need, INT32_MAX)
    delta.versions.masked_fill_(need, NEG_VERSION)
    delta.n_used.masked_fill_(need, 1)
    delta.oldest.copy_(torch.where(need, floor, delta.oldest))
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
    K.fold(base, delta, floor, None)
    K.build_table(base.versions, out=base_st)
    delta.keys[1:].fill_(INT32_MAX)
    delta.versions.fill_(NEG_VERSION)
    delta.n_used.fill_(1)
    delta.oldest.copy_(floor)
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


def _rewrite_res_ranks(res: ResState, table, remap: bool, dict_keys, n_keys):
    h = res.hist
    bk, dk, lo, hi = _rewrite_ranks(
        [h.base.keys, h.delta.keys, res.shard_lo, res.shard_hi], table, remap)
    return ResState(
        dict_keys=dict_keys, n_keys=n_keys,
        hist=HistState(h.base._replace(keys=bk), h.base_st,
                       h.delta._replace(keys=dk)),
        shard_lo=lo, shard_hi=hi)


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


def rebase_res(res: ResState, delta: int) -> ResState:
    """Version rebase of both history levels plus the base table rebuild."""
    h = res.hist
    base = rebase(h.base, delta)
    if _on_card(base.versions):
        K.build_table(base.versions, out=h.base_st)
        st = h.base_st
    else:
        st = sparse_table(base.versions)
    return res._replace(hist=HistState(base, st, rebase(h.delta, delta)))


# ---------------------------------------------------------------------------
# Resolve entry
# ---------------------------------------------------------------------------


def write_demand(rbk: RankBatch) -> int:
    """2 · live write ranges: the fold trigger's demand (one host sync when
    the batch lives on the card; the engine computes it from host data)."""
    return 2 * int((rbk.write_mask & (rbk.write_begin < rbk.write_end)).sum())


def _resolve_core_res(hist: HistState, rbk: RankBatch, commit_version: int,
                      new_oldest, report: bool = False,
                      demand: int | None = None, verdicts_out=None):
    """Returns (verdicts[, losers], new_hist)."""
    floor, _ = too_old_mask_packed(hist.delta, rbk, new_oldest)
    if demand is None:
        demand = write_demand(rbk)
    hist = _maybe_merge(hist, demand, floor)
    too_old, hist_mask, cand = history_probe(hist, rbk, floor)
    ranks = endpoint_ranks_live_packed(rbk)
    accepted, verdicts = accept(cand, too_old, rbk.txn_mask, ranks,
                                out=verdicts_out)
    delta = _paint_and_compact_res(hist.delta, rbk, accepted, commit_version,
                                   floor)
    new_hist = HistState(hist.base, hist.base_st, delta)
    if report:
        return verdicts, loser_mask(hist_mask, ranks, accepted, verdicts), \
            new_hist
    return verdicts, new_hist


def resolve_batch_res(res: ResState, rb: ResidentBatch, commit_version: int,
                      new_oldest, report: bool = False,
                      n_new: int | None = None, demand: int | None = None):
    """Delta insert + rank rebase, then the rank-space resolve core.
    Returns (verdicts int8 [B][, losers], new ResState). ``n_new`` and
    ``demand`` are host-known counts that spare device reads."""
    res = apply_delta(res, rb.delta_keys, n_new)
    out = _resolve_core_res(res.hist, rb.ranks, commit_version, new_oldest,
                            report=report, demand=demand)
    return (*out[:-1], res._replace(hist=out[-1]))


# ---------------------------------------------------------------------------
# A14: the window program (one delta merge, then k resolve steps)
# ---------------------------------------------------------------------------


def _step(ranks: RankBatch, i: int) -> RankBatch:
    """Step ``i`` of a [k]-leading RankBatch (views, contiguous)."""
    return RankBatch(*(x[i] for x in ranks))


def _resolve_core_res_plain(hist: HistState, rbk: RankBatch,
                            commit_version: int, new_oldest):
    """``_resolve_core_res`` through the plain versions only, wherever the
    tensors live: the window program's yardstick on the card."""
    floor, _ = too_old_mask_packed(hist.delta, rbk, new_oldest)
    hist = _maybe_merge_plain(hist, write_demand(rbk), floor)
    too_old, _, cand = history_probe_plain(hist, rbk, floor)
    accepted, verdicts = accept_plain(cand, too_old, rbk.txn_mask,
                                      endpoint_ranks_live_packed(rbk))
    delta = _paint_and_compact_res_plain(hist.delta, rbk, accepted,
                                         commit_version, floor)
    return verdicts, HistState(hist.base, hist.base_st, delta)


def resolve_many_res_plain(res: ResState, rb: ResidentBatch,
                           commit_versions, new_oldests):
    """Plain version of the window program: one ``apply_delta`` for the
    window's delta, then k resolve steps in order. Returns (stacked
    verdicts int8 [k, B], new ResState)."""
    if bool((~(rb.delta_keys == INT32_MAX).all(-1)).any()):
        nd, nn, shift = _dict_insert_plain(res.dict_keys, res.n_keys,
                                           rb.delta_keys)
        h = res.hist
        bk, dk, lo, hi = _rewrite_ranks_plain(
            [h.base.keys, h.delta.keys, res.shard_lo, res.shard_hi], shift,
            False)
        res = ResState(nd, nn, HistState(h.base._replace(keys=bk), h.base_st,
                                         h.delta._replace(keys=dk)), lo, hi)
    hist = res.hist
    rows = []
    for i in range(rb.ranks.read_begin.shape[0]):
        v, hist = _resolve_core_res_plain(hist, _step(rb.ranks, i),
                                          int(commit_versions[i]),
                                          int(new_oldests[i]))
        rows.append(v)
    return torch.stack(rows), res._replace(hist=hist)


def resolve_many_res(res: ResState, rb: ResidentBatch, commit_versions,
                     new_oldests, n_new: int | None = None,
                     demands=None):
    """Window path: ONE delta merge and rank rebase for the whole window
    (the delta has no window axis; every step's endpoints were ranked
    against the post-merge dictionary), then k rank-space resolve steps.
    Returns (verdicts int8 [k, B], new ResState).

    On the card: K1 once, then per step K2 probe, K3 accept (into row i
    of one [k, B] verdict buffer) and K4 paint, with the device-gated
    fold and base table of K4 and K2. ``n_new`` and ``demands`` (one
    2·live-write-ranges count per step) are the host's counts; the card
    path requires ``demands``, since counting them there would sync. No
    host sync happens inside the window."""
    if not _on_card(res.dict_keys):
        return resolve_many_res_plain(res, rb, commit_versions, new_oldests)
    k, b = rb.ranks.txn_mask.shape
    if demands is None or len(demands) != k:
        raise ValueError("the card's window program needs one host-known "
                         "write demand per step")
    LAUNCHES["resolve_many"] += 1
    res = apply_delta(res, rb.delta_keys, n_new)
    verdicts = torch.empty((k, b), dtype=torch.int8,
                           device=res.dict_keys.device)
    hist = res.hist
    for i in range(k):
        _, hist = _resolve_core_res(hist, _step(rb.ranks, i),
                                    int(commit_versions[i]),
                                    int(new_oldests[i]),
                                    demand=int(demands[i]),
                                    verdicts_out=verdicts[i])
    return verdicts, res._replace(hist=hist)
