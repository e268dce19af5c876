"""Host-side conflict engine over the torch/CUDA kernel: ``TorchConflictSet``.

The port of ``foundationdb_tpu/models/conflict_set.py``'s ``TPUConflictSet``
at its default design point (resident dictionary, window history,
sequential-order acceptance) and its wave-commit arm (``wave_commit=True``:
txns whose reads and writes conflict are scheduled into dependency-ordered
waves, and only true-cycle members abort). It answers the calls the
Resolver role makes (``resolve``, ``resolve_async``, ``advance``,
``headroom``, ``worst_case_growth``, ``overflowed``, ``clear_overflow``,
``dict_stats``) with the same verdicts, the same ``last_conflicting`` and,
for a wave engine, the same ``last_wave`` / ``last_reordered``; the wire
path the bench drives: ``resolve_wire``/``resolve_wire_async`` (one batch
of serialized transactions, packed by one C pass) and the window path
``resolve_wire_window``/``pack_wire_window``/``dispatch_window`` (k
batches at k commit versions in one device launch sequence,
``conflict_kernel.resolve_many_res``); for a wave engine, the two-phase
global wave protocol of sharded resolvers (``resolve_edges`` /
``resolve_apply``, payloads in ``core/wavemesh.py``); the tiered HBM/host
dictionary (``dict_hot_capacity``: demotion by K7 at the hot watermark,
promotion through the ordinary delta); and speculative window and object
resolve (``spec_resolve``: ``spec_dispatch_window``, ``reconcile_window``,
``spec_resolve_async``); an attached admission filter
(``attach_admission_filter``), fed the accepted writes' fingerprints; and
the packed non-resident engine (``resident=False``: no mirror, every
batch packed into its own dictionary by ``_pack_dict``, a [C, W] word-key
history on the card). The device programs sit behind ``_init_engine``,
``_batch_program`` and ``_window_program``, which the sharded engine
(``parallel/sharded_resolver.py``) overrides; every host behaviour is
shared.

The host packs byte ranges into rank space against a mirror of the device
dictionary, ships only never-seen keys, chunks oversized batches (chunks
at one commit version are equivalent to one ordered batch) and keeps the
absolute/relative version mapping. Device reads are explicit
``.cpu()`` calls, each counted in ``host_syncs``: one per chunk at
collect (two for a report chunk), one per window at collect, one per
``headroom()``, ``overflowed`` or ``wave_stats`` call, one per full
repack or demotion event (the device liveness), two per
``resolve_edges`` and one per ``resolve_apply``. A wave engine's levels
share their chunk's or window's one read with the verdicts; a
speculative window's one read is shared by its reconcile and its
collector, and a repair adds one read per re-resolved younger window. Dispatch itself never waits on the device: the fold decision
stays on the device and the insert decision comes from the mirror.

The window path splits into a host half (``pack_wire_window``: numpy and
ctypes only, safe on a packing thread) and a device half
(``dispatch_window``: uploads and launches, on the dispatching thread, in
pack order). A rebase, a full dictionary repack or a tiered demotion
that falls due while packing is deferred into the prepared window and
run by its dispatch; the mirror's gate holds the next pack until it has
run (for a demotion, until the stalled window is re-packed too).
"""

from __future__ import annotations

import struct
import threading
from collections import deque
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from foundationdb_tpu_torch import native
from foundationdb_tpu_torch.admission.filter import u64_cols_fingerprint
from foundationdb_tpu_torch.core import wavemesh
from foundationdb_tpu_torch.core.keypack import INT32_MAX, KeyCodec, row_sort_keys
from foundationdb_tpu_torch.core.types import KeyRange, TxnConflictInfo, Verdict
from foundationdb_tpu_torch.models import conflict_kernel as ck

DEFAULT_WINDOW_VERSIONS = 5_000_000
_REBASE_THRESHOLD = 1 << 30
_DICT_FRAG = 0.75  # opportunistic-repack staleness share


def resolve_device(device) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on a CUDA card and none is available; pass "
            "device='cpu' to run the plain torch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


# ---------------------------------------------------------------------------
# Resident-dictionary host mirror (copied from the JAX package)
# ---------------------------------------------------------------------------


def _rows_to_u64(rows: np.ndarray) -> np.ndarray:
    """[n, W] packed int32 key rows -> [n, ceil(W/2)] uint64 columns whose
    lexicographic order (and equality) equals key order."""
    n, w = rows.shape
    u = np.ascontiguousarray(rows).view(np.uint32) ^ np.uint32(0x80000000)
    if w % 2:
        u = np.concatenate([u, np.zeros((n, 1), np.uint32)], axis=1)
    return (u[:, 0::2].astype(np.uint64) << np.uint64(32)) | u[:, 1::2]


def _u64_lt(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Lexicographic a < b over trailing uint64 columns (vectorized)."""
    out = np.zeros(a.shape[:-1], bool)
    eq = np.ones(a.shape[:-1], bool)
    for j in range(a.shape[-1]):
        out |= eq & (a[..., j] < b[..., j])
        eq &= a[..., j] == b[..., j]
    return out


def _u64_searchsorted(sorted2d: np.ndarray, q: np.ndarray,
                      side: str = "left") -> np.ndarray:
    """Multi-column searchsorted over the uint64 mirror columns: a native
    search on column 0, then a short vectorized search inside each
    equal-column-0 run."""
    d = sorted2d.shape[0]
    n = q.shape[0]
    if d == 0:
        return np.zeros(n, np.int64)
    col0 = sorted2d[:, 0]
    if sorted2d.shape[1] == 1:
        return np.searchsorted(col0, q[:, 0], side=side).astype(np.int64)
    lo = np.searchsorted(col0, q[:, 0], side="left").astype(np.int64)
    hi = np.searchsorted(col0, q[:, 0], side="right").astype(np.int64)
    rest = sorted2d[:, 1:]
    qrest = q[:, 1:]
    max_run = int((hi - lo).max(initial=0))
    for _ in range(int(max_run + 1).bit_length()):
        act = lo < hi
        if not act.any():
            break
        mid = (lo + hi) >> 1
        rows = rest[np.minimum(mid, d - 1)]
        go = (_u64_lt(rows, qrest) if side == "left"
              else ~_u64_lt(qrest, rows))
        lo = np.where(act & go, mid + 1, lo)
        hi = np.where(act & ~go, mid, hi)
    return lo


def _u64_unique_sorted(u: np.ndarray, rows: np.ndarray):
    """Sort+dedup a small u64 key set, carrying the int32 rows along."""
    order = np.lexsort(tuple(u[:, j] for j in reversed(range(u.shape[1]))))
    us = u[order]
    keep = np.ones(len(us), bool)
    if len(us) > 1:
        keep[1:] = (us[1:] != us[:-1]).any(axis=1)
    return us[keep], rows[order][keep]


def pack_rank_dictionary(flat: np.ndarray, pad_rows: int | None = None):
    """Dedup+sort a flat [n, W] packed-key stack into a sorted-unique
    dictionary ([pad_rows, W], +inf padded) plus the int32 rank of each
    input row."""
    n, w = flat.shape
    if pad_rows is None:
        pad_rows = n + 1
    _, first, inverse = np.unique(
        row_sort_keys(flat), return_index=True, return_inverse=True
    )
    if len(first) >= pad_rows:
        raise ValueError(
            f"{len(first)} unique keys need >= {len(first) + 1} dictionary "
            f"rows (one +inf pad), got pad_rows={pad_rows}"
        )
    dict_keys = np.full((pad_rows, w), INT32_MAX, np.int32)
    dict_keys[: len(first)] = flat[first]
    return dict_keys, inverse.astype(np.int32)


class _RepackPlan(NamedTuple):
    """A pack that overflowed the resident dictionary: executed by
    :meth:`TorchConflictSet._repack_and_rank`, inline on the object and
    wire paths, in ``dispatch_window`` on the window path."""

    bt: object  # the raw HostBatch (key space)
    qu: np.ndarray  # [n, U] endpoint u64 keys, flat pack order
    is_pad: np.ndarray  # [n] all-inf rows (masked slots / +inf ends)
    new_u64: np.ndarray  # sorted-unique never-seen keys
    new_rows: np.ndarray  # their int32 rows
    dims: tuple  # (lead, b, r, q, w)
    cv: int


class _DemotePlan(NamedTuple):
    """A pack whose merged key count crossed a tiered engine's hot-tier
    watermark, deferred to the dispatch thread like a _RepackPlan: victim
    selection reads the exact device liveness, which only the dispatch
    thread may do. Executed by :meth:`TorchConflictSet._demote_and_rank`;
    the device traffic is a small evict rank vector per chunk (K7), not
    a dictionary."""

    bt: object  # the raw HostBatch (key space)
    qu: np.ndarray  # [n, U] endpoint u64 keys, flat pack order
    is_pad: np.ndarray  # [n] all-inf rows (masked slots / +inf ends)
    new_u64: np.ndarray  # sorted-unique delta keys (misses + promotions)
    new_rows: np.ndarray  # their int32 rows
    dims: tuple  # (lead, b, r, q, w)
    cv: int


_HASH_C1 = np.uint64(0x9E3779B97F4A7C15)
_HASH_C2 = np.uint64(0xFF51AFD7ED558CCD)


class _ResidentMirror:
    """Host mirror of the device-resident dictionary.

    A sorted view (u64/rows/pinned: the rank space the device shares) and
    a stable ID space probed through a vectorized open-addressing hash
    table (slot -> id, linear probing, load factor <= 1/4). Ids are
    append-only between resets; ``rank_of_id`` is rewritten on every
    insert so id -> current rank stays exact as inserts shift the rank
    space. Field names match the JAX mirror so a snapshot maps 1:1.

    Tiered (``tiered=True``): the ID space is the authoritative host COLD
    store. Demoted keys keep their id, hash entry, u64 row and last-used
    version; only the sorted (hot, rank-space) view shrinks, and
    ``hot_by_id`` says which ids are in it. A probe still finds a cold
    key, and the pack re-enters it through the ordinary delta with the
    same id (a promotion)."""

    def __init__(self, rows: np.ndarray, capacity: int, delta_slots: int,
                 frag_threshold: float, tiered: bool = False):
        self.capacity = int(capacity)
        self.delta_slots = int(delta_slots)
        self.frag_threshold = float(frag_threshold)
        self.tiered = bool(tiered)
        self._n_ids = 0
        rows = np.asarray(rows, np.int32).copy()
        u64 = _rows_to_u64(rows)
        t = 16
        while t < 4 * self.capacity:
            t <<= 1
        self._mask = np.int64(t - 1)
        self.tab = np.full(t, -1, np.int64)
        self.u64_by_id = np.zeros((self.capacity + 1, u64.shape[1]),
                                  np.uint64)
        self.rank_of_id = np.zeros(self.capacity + 1, np.int64)
        self.last_used_by_id = np.zeros(self.capacity + 1, np.int64)
        self.hot_by_id = np.zeros(self.capacity + 1, bool)
        self.reset(u64, rows, np.zeros(len(rows), np.int64),
                   np.ones(len(rows), bool))
        self.lock = threading.RLock()
        # Deferred-repack handshake: cleared when a pack emits a
        # _RepackPlan, set again once the dispatch thread has run it, so
        # the next pack (blocked at entry) ranks against the new mirror.
        self.gate = threading.Event()
        self.gate.set()
        self.stats = {
            "dispatches": 0,
            "endpoints": 0,
            "endpoint_hits": 0,
            "unique_keys": 0,
            "delta_new_keys": 0,
            "evictions": 0,
            "full_repacks": 0,
            "repack_stalls": 0,  # window packs that deferred a repack
            # Tiered-dictionary economics (zero when untiered):
            "demotions": 0,  # keys moved hot -> cold by K7
            "promotions": 0,  # cold keys that re-entered through a delta
            "demotion_stalls": 0,  # window packs that deferred a demotion
            "demotion_bytes": 0,  # evict-vector bytes shipped to the card
            "demotion_events": 0,  # _demote_now calls that evicted > 0
        }

    @property
    def n(self) -> int:
        return len(self.u64)

    @property
    def cold_n(self) -> int:
        """Keys held only in the host cold tier (0 when untiered)."""
        return self._n_ids - self.n

    def _hash(self, u64: np.ndarray) -> np.ndarray:
        h = u64[:, 0] * _HASH_C1
        for j in range(1, u64.shape[1]):
            h = (h ^ u64[:, j]) * _HASH_C2
        return ((h ^ (h >> np.uint64(33))) & np.uint64(self._mask)).astype(
            np.int64
        )

    def reset(self, u64, rows, last_used, pinned) -> None:
        """Rebuild the sorted view from a fresh sorted key set (repack
        path). Untiered, the ID space rebuilds too (ids == sorted
        positions). Tiered, it survives: existing keys keep their ids,
        keys that leave the hot view demote instead of vanishing, and new
        keys allocate fresh ids, so a repack never forgets the cold tier."""
        n = len(u64)
        if self.tiered and self._n_ids:
            ids = self.probe(u64)
            alloc = np.flatnonzero(ids < 0)
            self._ensure_ids(self._n_ids + len(alloc))
            fresh = self._n_ids + np.arange(len(alloc), dtype=np.int64)
            ids[alloc] = fresh
            self.u64_by_id[fresh] = u64[alloc]
            self._n_ids += len(alloc)
            self.u64, self.rows = u64, rows
            self.pinned = pinned
            self.hot_by_id[: self._n_ids] = False
            self.hot_by_id[ids] = True
            self.last_used_by_id[ids] = last_used
            self.id_at = ids
            self.rank_of_id[ids] = np.arange(n)
            self._tab_insert(fresh)
            return
        self.u64, self.rows = u64, rows
        self.pinned = pinned
        self._n_ids = n
        self.u64_by_id[:n] = u64
        self.last_used_by_id[:n] = last_used  # ids == sorted pos at reset
        self.id_at = np.arange(n, dtype=np.int64)  # sorted pos -> id
        self.rank_of_id[:n] = np.arange(n)
        self.hot_by_id[:] = False
        self.hot_by_id[:n] = True
        self.tab[:] = -1
        self._tab_insert(np.arange(n, dtype=np.int64))

    def _ensure_ids(self, need: int) -> None:
        """Grow the ID-space arrays (and rehash the probe table when its
        1/4 load bound would break), so that the cold tier scales with the
        keys ever touched while the hot view stays at its capacity."""
        cur = len(self.u64_by_id)
        if need > cur:
            new = cur
            while new < need:
                new <<= 1
            grow = new - cur
            self.u64_by_id = np.concatenate(
                [self.u64_by_id,
                 np.zeros((grow, self.u64_by_id.shape[1]), np.uint64)])
            self.rank_of_id = np.concatenate(
                [self.rank_of_id, np.zeros(grow, np.int64)])
            self.last_used_by_id = np.concatenate(
                [self.last_used_by_id, np.zeros(grow, np.int64)])
            self.hot_by_id = np.concatenate(
                [self.hot_by_id, np.zeros(grow, bool)])
        if need * 4 > self._mask + 1:
            t = int(self._mask + 1)
            while need * 4 > t:
                t <<= 1
            self._mask = np.int64(t - 1)
            self.tab = np.full(t, -1, np.int64)
            self._tab_insert(np.arange(self._n_ids, dtype=np.int64))

    def demote(self, ranks: np.ndarray) -> np.ndarray:
        """Drop the sorted-view rows at ``ranks`` (the host half of a K7
        evict delta). Their ids stay in the cold store, so a later probe
        finds them and a promotion re-enters them with the same id.
        Returns the demoted ids."""
        ids = self.id_at[ranks]
        self.u64 = np.delete(self.u64, ranks, axis=0)
        self.rows = np.delete(self.rows, ranks, axis=0)
        self.pinned = np.delete(self.pinned, ranks)
        self.id_at = np.delete(self.id_at, ranks)
        self.rank_of_id[self.id_at] = np.arange(len(self.id_at))
        self.hot_by_id[ids] = False
        self.stats["demotions"] += len(ids)
        return ids

    def probe(self, qu: np.ndarray, active: "np.ndarray | None" = None):
        """ids int64 [n] (-1 = absent) for each query key row."""
        n = len(qu)
        ids = np.full(n, -1, np.int64)
        if n == 0 or self._n_ids == 0:
            return ids
        idxs = (np.flatnonzero(active) if active is not None
                else np.arange(n, dtype=np.int64))
        h = self._hash(qu[idxs])
        q = qu[idxs]
        step = np.int64(0)
        while len(idxs):
            slot = (h + step) & self._mask
            cand = self.tab[slot]
            hit = cand >= 0
            match = np.zeros(len(idxs), bool)
            if hit.any():
                rows = self.u64_by_id[cand[hit]]
                qh = q[hit]
                eq = rows[:, 0] == qh[:, 0]
                for j in range(1, rows.shape[1]):
                    eq &= rows[:, j] == qh[:, j]
                match[hit] = eq
            ids[idxs[match]] = cand[match]
            # Empty slot = definitive miss (no deletes outside reset).
            cont = hit & ~match
            idxs, h, q = idxs[cont], h[cont], q[cont]
            step += 1
            if step > self._mask:  # full-table bound (unreachable: load<=1/4)
                break
        return ids

    def touch(self, ids: np.ndarray, cv: int) -> None:
        if ids.size:
            self.last_used_by_id[ids] = cv

    def used_sorted(self) -> np.ndarray:
        """Rank-space view of the last-used versions (repack path)."""
        return self.last_used_by_id[self.id_at]

    def insert_new(self, new_u64, new_rows, cv: int,
                   ids: np.ndarray | None = None) -> np.ndarray:
        """Incremental sorted insert of delta keys; returns their ids.

        ``ids`` (the tiered promotion path): per row its existing cold id,
        or -1 for a key never seen. Cold keys re-enter the sorted view
        with their id; only the -1 rows allocate (untiered: all of them,
        within the ID space a reset sized)."""
        m = len(new_u64)
        ins = _u64_searchsorted(self.u64, new_u64, "left")
        self.u64 = np.insert(self.u64, ins, new_u64, axis=0)
        self.rows = np.insert(self.rows, ins, new_rows, axis=0)
        self.pinned = np.insert(self.pinned, ins, False)
        new_ids = (np.full(m, -1, np.int64) if ids is None
                   else np.asarray(ids, np.int64).copy())
        alloc = np.flatnonzero(new_ids < 0)
        self._ensure_ids(self._n_ids + len(alloc))
        fresh = self._n_ids + np.arange(len(alloc), dtype=np.int64)
        new_ids[alloc] = fresh
        self.u64_by_id[fresh] = new_u64[alloc]
        self.last_used_by_id[new_ids] = cv
        self._n_ids += len(alloc)
        self.id_at = np.insert(self.id_at, ins, new_ids)
        self.rank_of_id[self.id_at] = np.arange(len(self.id_at))
        self.hot_by_id[new_ids] = True
        self.stats["promotions"] += m - len(alloc)
        self._tab_insert(fresh)
        return new_ids

    def _tab_insert(self, ids: np.ndarray) -> None:
        """Vectorized linear-probing insert: same-batch slot races resolve
        by scatter-then-gather-back (losers advance with the occupied)."""
        if not len(ids):
            return
        h = self._hash(self.u64_by_id[ids])
        idxs = np.arange(len(ids), dtype=np.int64)
        step = np.int64(0)
        while len(idxs):
            slot = (h[idxs] + step) & self._mask
            empty = np.flatnonzero(self.tab[slot] < 0)
            if len(empty):
                self.tab[slot[empty]] = ids[idxs[empty]]
                won = self.tab[slot[empty]] == ids[idxs[empty]]
                done = np.zeros(len(idxs), bool)
                done[empty[won]] = True
                idxs = idxs[~done]
            step += 1
            if step > self._mask:
                raise RuntimeError("resident hash table full")

    def frag_due(self, floor_version: int) -> bool:
        """Opportunistic-repack trigger: mostly full AND mostly stale. Off
        when tiered: stale keys leave through demotion there, and a stale
        but device-live key cannot be reclaimed by a repack either."""
        if self.tiered or self.n <= self.capacity // 2:
            return False
        stale = int(
            (self.last_used_by_id[: self._n_ids] < floor_version).sum()
        )
        return stale > self.frag_threshold * self.n


# ---------------------------------------------------------------------------
# Host batches
# ---------------------------------------------------------------------------


class HostBatch(NamedTuple):
    """One padded batch in key space (numpy; the JAX BatchTensors). A
    window's batch has a leading [k] axis on every array."""

    read_begin: np.ndarray  # int32 [B, R, W]
    read_end: np.ndarray
    read_mask: np.ndarray  # bool [B, R]
    write_begin: np.ndarray  # int32 [B, Q, W]
    write_end: np.ndarray
    write_mask: np.ndarray  # bool [B, Q]
    read_version: np.ndarray  # int32 [B] (relative)
    txn_mask: np.ndarray  # bool [B]


class HostRankBatch(NamedTuple):
    """A packed dispatch before upload: numpy ResidentBatch leaves plus
    the two host-known counts the device path uses instead of reads. A
    window's rank leaves have a leading [k] axis; its delta has none. For
    a non-resident engine the key leaf is the batch dictionary instead
    ([N + 1, W], a window's [k, N + 1, W]) and ``n_new`` is 0. For the
    unpacked engine (``packed=False``) the key leaf is None and ``ranks``
    holds the HostBatch's key rows themselves (its txn_mask, too, at
    index 7)."""

    delta_keys: np.ndarray  # int32 [M, W]
    ranks: tuple  # numpy RankBatch fields, in RankBatch order
    n_new: int  # real rows in delta_keys
    demand: int | tuple  # 2 * live write ranges (a window: one per step)


class PreparedWindow(NamedTuple):
    """A host-packed window awaiting ``dispatch_window``: pure host data,
    made by ``pack_wire_window`` (possibly on a packing thread)."""

    batch: object  # HostRankBatch, k-leading; or a _RepackPlan/_DemotePlan
    cvs_rel: np.ndarray  # int32 [k] relative commit versions
    olds_rel: np.ndarray  # int32 [k] relative oldest versions
    count: int  # real txns per batch
    rebase_delta: int  # deferred device rebase; applied before dispatch


@dataclass
class _SpecPending:
    """One speculatively dispatched window awaiting reconcile."""

    seq: int
    snapshot: ck.ResState  # deep copy of the state BEFORE the dispatch
    hb: HostRankBatch  # host leaves: n_new, demands, txn_mask [k, B]
    rb: ck.ResidentBatch  # the uploaded batch, replayed by a repair
    cvs_rel: np.ndarray
    olds_rel: np.ndarray
    count: int
    out: ck.WindowOut  # verdicts (and levels) on the card until read
    read: tuple | None = None  # (verdicts, levels) [k, B] once read


def upload(hb: HostRankBatch, device: torch.device, packed: bool = False):
    """Copy a packed batch or window to ``device``: every int32 leaf in one
    buffer and every bool leaf in another, so a dispatch is two
    host-to-device copies that do not wait for the device. A ResidentBatch,
    or with ``packed`` (a non-resident engine's batch, whose key leaf is
    its dictionary) a PackedBatch."""
    out = _upload_leaves([hb.delta_keys, *hb.ranks], device)
    if packed:
        return ck.PackedBatch(dict_keys=out[0], ranks=ck.RankBatch(*out[1:]))
    return ck.ResidentBatch(delta_keys=out[0], ranks=ck.RankBatch(*out[1:]))


def _live_writes(bt: HostBatch) -> np.ndarray:
    """bool [..., B, Q]: masked write ranges whose begin row is below
    their end row (the lexicographic order of the packed int32 words)."""
    wb, we = np.asarray(bt.write_begin), np.asarray(bt.write_end)
    lt = np.zeros(wb.shape[:-1], bool)
    eq = np.ones(wb.shape[:-1], bool)
    for j in range(wb.shape[-1]):
        lt |= eq & (wb[..., j] < we[..., j])
        eq &= wb[..., j] == we[..., j]
    return np.asarray(bt.write_mask) & lt


def upload_keys(bt: HostBatch, device: torch.device) -> ck.BatchTensors:
    """Copy a batch (or window) of full key rows to ``device`` as
    BatchTensors, in the same two copies as :func:`upload` (the
    non-resident sharded engine's dispatch: its device program takes the
    key rows themselves)."""
    return ck.BatchTensors(*_upload_leaves(list(bt), device))


def _upload_leaves(leaves: list, device: torch.device) -> list:
    """The int32 leaves in one host-to-device copy and the bool leaves in
    another; returns the device views in leaf order."""
    ints = [a for a in leaves if a.dtype == np.int32]
    bools = [a for a in leaves if a.dtype == np.bool_]
    ibuf = np.concatenate([a.reshape(-1) for a in ints])
    bbuf = np.concatenate([a.reshape(-1) for a in bools]).view(np.uint8)
    it = torch.from_numpy(ibuf).to(device, non_blocking=True)
    bt = torch.from_numpy(bbuf).to(device, non_blocking=True).view(torch.bool)
    out, io, bo = [], 0, 0
    for a in leaves:
        if a.dtype == np.int32:
            out.append(it[io:io + a.size].view(a.shape))
            io += a.size
        else:
            out.append(bt[bo:bo + a.size].view(a.shape))
            bo += a.size
    return out


def _coalesce(ranges: list[KeyRange], limit: int) -> list[KeyRange]:
    """At most `limit` ranges covering the input (conservative widening)."""
    live = [x for x in ranges if not x.empty]
    if len(live) <= limit:
        return live
    live.sort(key=lambda x: x.begin)
    out = []
    step = -(-len(live) // limit)
    for i in range(0, len(live), step):
        grp = live[i : i + step]
        out.append(KeyRange(grp[0].begin, max(g.end for g in grp)))
    return out


def _stitch_waves(chunk_levels: list) -> tuple[list[int], int]:
    """(one schedule for a chunked call, reordered count) from per-chunk
    levels. Chunks serialize in submission order (earlier chunks' writes
    are painted before later chunks resolve), so chunk i+1's wave 0 comes
    after all of chunk i's waves: committed levels are offset past the
    previous chunk's maximum. Reordered = committed past its CHUNK's first
    wave (raw level > 0): a later chunk's wave-0 txn committed in arrival
    order and is not counted."""
    waves: list[int] = []
    offset = reordered = 0
    for lv in chunk_levels:
        reordered += int((lv > 0).sum())
        waves.extend(int(x) + offset if x >= 0 else int(x) for x in lv)
        if len(lv) and int(lv.max()) >= 0:
            offset += int(lv.max()) + 1
    return waves, reordered


class TorchConflictSet:
    """Drop-in conflict engine: resolve(txns, commit_version) -> verdicts.

    ``device=None`` runs on ``cuda`` (and raises without a card);
    ``device="cpu"`` runs the plain torch versions. Ported: the default
    design point (the resident rank-space engine), its wave-commit arm
    (``wave_commit=True``: reorder, don't abort), the tiered HBM/host
    dictionary (``dict_hot_capacity > 0``) and speculative window resolve
    (``spec_resolve=True``), in any combination; and the packed
    non-resident engine (``resident=False``: a [C, W] word-key history and
    a per-dispatch batch dictionary, K12 and K13), sequential, wave or
    speculative, on which ``dict_hot_capacity`` is inert (as in JAX) and
    speculation's repair keeps the verdicts of a younger window that read
    no revoked write (a paint-only re-advance).

    The design arms (the JAX package's FDB_TPU_* knobs, read there once
    at import, here per engine): ``history="batch"`` keeps one flat
    history whose table is rebuilt every batch instead of the two-level
    base + delta; ``packed=False`` is the unpacked engine (full W-word key
    rows to the card, no dictionary: K14 ranks the endpoints, K12, K13
    and K16 probe and paint), under which ``resident`` and
    ``spec_resolve`` are forced off, the tier is inert and no admission
    filter attaches, as in JAX; ``rmq="blocked"`` builds each per-batch
    table as the blocked structure (K17) instead of a sparse table (a
    two-level history's base table stays sparse); ``accept="seq"`` is the
    JAX G-step sequential in-block acceptance, whose exact sequential
    result K3 computes for either value. Every arm gives the JAX engine's
    verdicts, levels, reports and state leaves under the same flags.

    Tiered: the device dictionary is the HOT tier of ``dict_hot_capacity``
    keys (``dict_capacity`` becomes that, the delta slots are capped at
    half of it) and the mirror's ID space the host COLD store. When a
    pack would leave less than one delta of headroom (the watermark,
    capacity minus delta slots), unused keys are demoted in rank chunks
    of ``dict_demote_batch`` (default: the delta slots) by K7 instead of
    a full repack.

    Speculative: windows dispatch against the state the unconfirmed
    earlier windows advanced, at most ``spec_depth`` in flight, each with
    a snapshot of the state before it. ``reconcile_window`` confirms the
    oldest or, when ``spec_confirm_hook`` (or the caller) revokes some of
    its accepted txns, rolls back to its snapshot, re-paints it with the
    confirmed accepts only (``paint_many_res``) and re-resolves every
    younger window."""

    def __init__(
        self,
        capacity: int = 1 << 16,
        batch_size: int = 512,
        max_read_ranges: int = 8,
        max_write_ranges: int = 8,
        max_key_bytes: int = 32,
        window_versions: int = DEFAULT_WINDOW_VERSIONS,
        delta_capacity: int | None = None,
        wave_commit: bool = False,
        resident: bool | None = None,
        dict_capacity: int | None = None,
        dict_delta_slots: int | None = None,
        dict_hot_capacity: int | None = None,
        dict_demote_batch: int | None = None,
        spec_resolve: bool | None = None,
        spec_depth: int = 2,
        history: str = "window",
        packed: bool = True,
        rmq: str = "sparse",
        accept: str = "wave",
        device=None,
    ):
        for name, value, allowed in (
                ("history", history, ("window", "batch")),
                ("rmq", rmq, ck.RMQ_DESIGNS),
                ("accept", accept, ("wave", "seq")),
                ("packed", packed, (True, False))):
            if not any(value is a or (type(value) is type(a) and value == a)
                       for a in allowed):
                raise ValueError(f"{name} must be one of {allowed}, not "
                                 f"{value!r}")
        self.history, self.packed, self.rmq, self.accept = (
            history, packed, rmq, accept)
        # resident=False: the packed non-resident engine (a per-dispatch
        # batch dictionary over a [C, W] word-key history, K12 and K13).
        # The unpacked engine has no dictionary: resident is inert there.
        self.resident = resident is not False and packed
        self.device = resolve_device(device)
        self.codec = KeyCodec(max_key_bytes)
        self.dict_capacity = int(
            dict_capacity
            or max(2 * capacity,
                   capacity + 4 * batch_size * (max_read_ranges
                                                + max_write_ranges))
        )
        self.dict_delta_slots = int(
            dict_delta_slots
            or min(max(self.dict_capacity // 2, 1),
                   max(1024, 2 * batch_size * (max_read_ranges
                                               + max_write_ranges)))
        )
        # Tiered: the device dictionary becomes the hot tier.
        self.dict_hot_capacity = int(dict_hot_capacity or 0)
        self.tiered = self.dict_hot_capacity > 0 and self.resident
        if self.tiered:
            self.dict_capacity = self.dict_hot_capacity
            self.dict_delta_slots = min(self.dict_delta_slots,
                                        max(1, self.dict_hot_capacity // 2))
        # The evict chunk (a demotion event ships whole chunks of it, the
        # JAX engine's static evict width; K7 runs once an event) and the
        # key count past which a pack demotes first.
        self.dict_demote_batch = (int(dict_demote_batch
                                      or self.dict_delta_slots)
                                  if self.tiered else 0)
        self._demote_watermark = (
            max(1, self.dict_capacity - self.dict_delta_slots)
            if self.tiered else 0)
        self.spec_resolve = bool(spec_resolve) and packed
        self.spec_depth = max(1, int(spec_depth))
        self._spec_ring: deque[_SpecPending] = deque()
        self._spec_seq = 0
        self._spec_done: dict[int, tuple] = {}
        self._spec_stats = {
            "spec_dispatched": 0,  # windows dispatched speculatively
            "spec_confirmed": 0,  # reconciled with no rollback
            "spec_repaired": 0,  # reconciled through rollback + repair
            "spec_flipped": 0,  # younger-window accepts changed by repair
            "chain_rolls": 0,  # state rolled back to a snapshot
        }
        # Upper-layer confirmation: hook(seq, verdicts int8 [k, count]) ->
        # bool [k, count] (False revokes that txn's speculative outcome)
        # or None to confirm the whole window. None confirms every window.
        self.spec_confirm_hook: Callable | None = None
        self.wave_commit = bool(wave_commit)
        self.capacity = capacity
        self.batch_size = batch_size
        self.max_read_ranges = max_read_ranges
        self.max_write_ranges = max_write_ranges
        self.window_versions = window_versions
        self.delta_capacity = delta_capacity or min(
            capacity, 2 * batch_size * max_write_ranges + 2
        )
        self.base_version: int | None = None
        self.oldest_version: int = 0  # absolute; advances monotonically
        self._last_commit: int = 0
        # Exact conflicting read ranges of the LAST resolve() call, by txn
        # index, for the txns that asked (report_conflicting_keys).
        self.last_conflicting: dict[int, list[KeyRange]] = {}
        # Wave engines only (None otherwise). Levels of the LAST resolve()
        # call by txn index: >= 0 committed at that wave, -2 aborted on a
        # true cycle, -1 any other non-commit; later chunks' waves are
        # offset past earlier ones (chunks serialize in order), so the
        # list is one schedule for the call. ``last_reordered`` counts the
        # txns committed past their chunk's first wave (the offsets
        # excluded). The window path publishes int32 [k, count] levels,
        # one schedule per batch, in ``last_wave_window``.
        self.last_wave: list[int] | None = None
        self.last_reordered: int | None = None
        self.last_wave_window: np.ndarray | None = None
        # The two-phase global wave protocol's stash between
        # resolve_edges and resolve_apply (None between windows).
        self._wave_pending = None
        # K6's device counters (int64 [5]: batches, rounds, victims, max
        # rounds, max victims), read by ``wave_stats``.
        self._wave_stats = (torch.zeros(5, dtype=torch.int64,
                                        device=self.device)
                            if self.wave_commit else None)
        self.host_syncs = 0  # device -> host reads, see the module docstring
        # The attached admission filter (attach_admission_filter), fed the
        # ACCEPTED writes' fingerprints at collect time, and the last
        # object-path pack's write fingerprints awaiting their verdicts.
        self.admission_filter = None
        self._adm_stash = None  # (fps [B, Q], valid [B, Q])
        self._init_engine()

    # -- device programs (the seam a sharded engine overrides) ---------------

    #: True when the engine has a report launch: a chunk holding a txn that
    #: asks for its conflicting keys then fills ``last_conflicting``.
    can_report = True

    def attach_admission_filter(self, f) -> None:
        """Attach a RecentWritesFilter: every object- and wire-path resolve
        feeds it the accepted writes' fingerprints, which are the mirror's
        u64 key columns (so resident engines only, as in JAX)."""
        if not self.resident:
            raise ValueError(
                "admission filter attaches to the resident engine only "
                "(resident=True)")
        self.admission_filter = f

    def _init_engine(self) -> None:
        """The host mirror, the device state and the entry points. The
        state: a resident engine's ResState (a two-level rank history, or
        with ``history="batch"`` a flat [C, 1] one); any other engine's
        bare history of [C, W] word keys, two-level or flat; no mirror.
        The entry points compose one name per (history, format), as the
        JAX ``_init_engine`` composes its jitted programs':
        ``{resolve_batch,resolve_many,wave_edges,wave_apply,paint_many}``
        + ``_hist`` for the window history + ``_res`` (resident),
        ``_packed`` (non-resident) or nothing (unpacked)."""
        window = self.history == "window"
        fmt = ("_res" if self.resident
               else "_packed" if self.packed else "")
        name = ("_hist" if window else "") + fmt
        self._resolve_fn = getattr(ck, "resolve_batch" + name)
        self._many_fn = getattr(ck, "resolve_many" + name)
        self._edges_fn = getattr(ck, "wave_edges" + name)
        self._apply_fn = getattr(ck, "wave_apply" + name)
        self._paint_fn = getattr(ck, "paint_many" + name, None)
        self._empty_hb = None  # advance()'s packed empty batch (flat)
        if not self.resident:
            self._mirror = None
            self.state = (
                ck.init_hist(self.capacity, self.codec.width,
                             self.codec.min_key, self.delta_capacity,
                             self.device) if window
                else ck.init_state(self.capacity, self.codec.width,
                                   self.codec.min_key, self.device))
            return
        self._mirror = _ResidentMirror(
            self.codec.min_key[None, :], self.dict_capacity,
            self.dict_delta_slots, _DICT_FRAG, tiered=self.tiered,
        )
        self.state = ck.init_res(
            self._mirror.rows, self.dict_capacity, self.capacity,
            self.delta_capacity if window else None, self.device,
        )

    def _program_kw(self, hb: HostRankBatch) -> dict:
        """The arguments every program of this engine takes beside its
        state and batch: the acceptance, the range max design and, for a
        resident engine, the host's count of new dictionary rows."""
        kw = {"wave": self.wave_commit, "stats": self._wave_stats,
              "rmq": self.rmq}
        if self.resident:
            kw["n_new"] = hb.n_new
        return kw

    def _batch_program(self, rb, hb: HostRankBatch, cv: int, oldest: int,
                       report: bool, out: ck.WindowOut) -> tuple:
        """One chunk's device program on ``self.state``: (verdicts[,
        levels][, losers], new state), the verdicts (and levels) in row 0
        of ``out``."""
        return self._resolve_fn(self.state, rb, cv, oldest, report=report,
                                demand=hb.demand, out=out,
                                **self._program_kw(hb))

    def _window_program(self, rb, hb: HostRankBatch, cvs_rel, olds_rel,
                        out: ck.WindowOut):
        """One window's device program on ``self.state``; returns the new
        state, the verdicts (and levels) in ``out``."""
        return self._many_fn(self.state, rb, cvs_rel, olds_rel,
                             demands=hb.demand, out=out,
                             **self._program_kw(hb))[-1]

    # -- resident-dictionary packing ----------------------------------------

    def _flat_endpoints(self, bt: HostBatch):
        """All endpoint key rows of a batch, flat in (read_begin, read_end,
        write_begin, write_end) section order."""
        rb = np.asarray(bt.read_begin)
        lead = rb.shape[:-3]
        b, r, w = rb.shape[-3:]
        q = np.asarray(bt.write_begin).shape[-2]
        flat = np.concatenate([
            rb.reshape(-1, w),
            np.asarray(bt.read_end).reshape(-1, w),
            np.asarray(bt.write_begin).reshape(-1, w),
            np.asarray(bt.write_end).reshape(-1, w),
        ])
        return flat, (lead, b, r, q, w)

    def _ranks_to_batch(self, bt: HostBatch, ranks: np.ndarray, dims,
                        delta_rows: np.ndarray) -> HostRankBatch:
        """Reassemble flat endpoint ranks + a key delta into a packed batch
        (delta padded to the engine's static slot count)."""
        lead, b, r, q, w = dims
        nl = int(np.prod(lead)) if lead else 1
        n_r, n_q = nl * b * r, nl * b * q
        delta = np.full((self.dict_delta_slots, w), INT32_MAX, np.int32)
        delta[: len(delta_rows)] = delta_rows
        return self._rank_batch(
            bt, ranks[:n_r].reshape(*lead, b, r),
            ranks[n_r : 2 * n_r].reshape(*lead, b, r),
            ranks[2 * n_r : 2 * n_r + n_q].reshape(*lead, b, q),
            ranks[2 * n_r + n_q :].reshape(*lead, b, q), delta,
            len(delta_rows))

    def _rank_batch(self, bt: HostBatch, rb, re_, wb, we, keys: np.ndarray,
                    n_new: int) -> HostRankBatch:
        """The HostRankBatch of a batch's endpoint ranks (``[..., B, R]``
        and ``[..., B, Q]``) and its key leaf (a delta or a dictionary),
        with the host's paint order and write demands."""
        lead = wb.shape[:-2]
        b, q = wb.shape[-2:]
        nl = int(np.prod(lead)) if lead else 1
        # The paint permutation (acceptance-independent: rejected writes
        # merge as delta-0 no-ops), the same introsort call as the JAX
        # engine so the permutation is the same.
        paint = np.concatenate(
            [wb.reshape(*lead, b * q), we.reshape(*lead, b * q)], axis=-1
        )
        paint_src = np.argsort(paint, axis=-1).astype(np.int32)
        wm = np.asarray(bt.write_mask)
        live = 2 * (wm & (wb < we)).reshape(nl, b * q).sum(-1)
        demand = tuple(int(x) for x in live) if lead else int(live[0])
        return HostRankBatch(
            delta_keys=keys,
            ranks=(
                rb,
                re_,
                np.asarray(bt.read_mask),
                wb,
                we,
                wm,
                np.asarray(bt.read_version),
                np.asarray(bt.txn_mask),
                paint_src,
            ),
            n_new=n_new,
            demand=demand,
        )

    def _pack_dict(self, bt: HostBatch) -> HostRankBatch:
        """The non-resident pack (the JAX ``_pack_dict``): per batch (per
        step of a [k]-leading window) dedup and sort every endpoint key
        into a dictionary of N + 1 rows (N = 2·B·(R + Q), the last always
        +inf) and rank each endpoint into it; plus the paint order and the
        write demands."""
        rb = np.asarray(bt.read_begin)
        lead = rb.shape[:-3]
        b, r, w = rb.shape[-3:]
        q = np.asarray(bt.write_begin).shape[-2]
        nl = int(np.prod(lead)) if lead else 1
        secs = [np.asarray(x).reshape(nl, -1, w) for x in (
            bt.read_begin, bt.read_end, bt.write_begin, bt.write_end)]
        dicts, invs = [], []
        for i in range(nl):
            d, inv = pack_rank_dictionary(np.concatenate([x[i] for x in secs]))
            dicts.append(d)
            invs.append(inv)
        inv = np.stack(invs)
        n_r, n_q = b * r, b * q

        def part(lo, hi, cols):
            return np.ascontiguousarray(inv[:, lo:hi]).reshape(*lead, b, cols)

        return self._rank_batch(
            bt, part(0, n_r, r), part(n_r, 2 * n_r, r),
            part(2 * n_r, 2 * n_r + n_q, q), part(2 * n_r + n_q, None, q),
            np.stack(dicts).reshape(*lead, *dicts[0].shape), 0)

    def _pack_batch(self, bt: HostBatch, defer_repack: bool = False):
        """The engine's pack: the resident rank-space pack (which may
        defer a repack or a demotion), the non-resident ``_pack_dict``, or
        for the unpacked engine the key rows themselves with their write
        demands (the JAX ``_dev_batch`` is the identity there)."""
        if self.resident:
            return self._pack_resident(bt, defer_repack)
        if self.packed:
            return self._pack_dict(bt)
        live = 2 * _live_writes(bt).sum(-1).sum(-1)
        return HostRankBatch(
            delta_keys=None, ranks=tuple(np.asarray(x) for x in bt), n_new=0,
            demand=(tuple(int(x) for x in live) if live.ndim
                    else int(live)))

    def _upload(self, hb: HostRankBatch):
        if not self.packed:
            return upload_keys(HostBatch(*hb.ranks), self.device)
        return upload(hb, self.device, packed=not self.resident)

    def _pack_resident(self, bt: HostBatch, defer_repack: bool = False):
        """Rank-space pack against the mirror: classify every endpoint as
        hit or miss, emit the sorted-unique misses as the dictionary delta
        and rewrite endpoints as ranks into the post-insert dictionary. A
        window ([k]-leading batch) is ranked as a whole against the
        dictionary after its whole delta.

        Overflow or fragmentation forces a full repack, which reads the
        device: inline, or with ``defer_repack`` (the window path's
        packing thread) returned as a _RepackPlan for ``dispatch_window``
        to run, with the mirror's gate cleared so the next pack waits. A
        tiered engine's crossing of the hot watermark demotes first, in
        the same two ways (a _DemotePlan when deferred)."""
        self._mirror.gate.wait()
        return self._pack_ranked(bt, defer_repack)

    def _pack_ranked(self, bt: HostBatch, defer_repack: bool = False):
        """``_pack_resident`` past the gate (a deferred demotion re-packs
        its window here with the gate still closed)."""
        mir = self._mirror
        flat, dims = self._flat_endpoints(bt)
        qu = _rows_to_u64(flat)
        pad = _rows_to_u64(np.full((1, dims[-1]), INT32_MAX, np.int32))[0]
        is_pad = qu[:, 0] == pad[0]
        for j in range(1, qu.shape[1]):
            is_pad &= qu[:, j] == pad[j]
        ids = mir.probe(qu, ~is_pad)
        found = ids >= 0
        if self.tiered:
            # A cold-tier hit re-enters through the same delta as a key
            # never seen (a promotion): only hot hits skip the delta.
            hot_hit = np.zeros(len(ids), bool)
            f = np.flatnonzero(found)
            hot_hit[f] = mir.hot_by_id[ids[f]]
        else:
            hot_hit = found
        miss = ~hot_hit & ~is_pad
        mi = np.flatnonzero(miss)
        if mi.size:
            new_u64, new_rows = _u64_unique_sorted(qu[mi], flat[mi])
        else:
            new_u64 = np.zeros((0, qu.shape[1]), np.uint64)
            new_rows = np.zeros((0, dims[-1]), np.int32)
        m = len(new_u64)
        cv = self._last_commit
        plan = (bt, qu, is_pad, new_u64, new_rows, dims, cv)
        if (m > self.dict_delta_slots
                or (not self.tiered and mir.n + m > mir.capacity)
                or mir.frag_due(self.oldest_version)):
            if defer_repack:
                mir.gate.clear()
                mir.stats["repack_stalls"] += 1
                return _RepackPlan(*plan)
            return self._repack_and_rank(_RepackPlan(*plan))
        if self.tiered and mir.n + m > self._demote_watermark:
            if defer_repack:
                mir.gate.clear()
                mir.stats["demotion_stalls"] += 1
                return _DemotePlan(*plan)
            self._demote_now(m, protect=(qu, is_pad))
            if mir.n + m > mir.capacity:
                # Demotion could not free enough room (every candidate
                # pinned, device-live or recent): the full repack.
                return self._repack_and_rank(_RepackPlan(*plan))
        with mir.lock:
            mir.touch(ids[hot_hit], cv)
            if m:
                # Every miss is in the new set; its index there maps it to
                # its id (a tiered engine: its cold id, or -1 when new).
                pos = _u64_searchsorted(new_u64, qu[mi], "left")
                if self.tiered:
                    row_ids = np.full(m, -1, np.int64)
                    row_ids[pos] = ids[mi]
                    new_ids = mir.insert_new(new_u64, new_rows, cv,
                                             ids=row_ids)
                else:
                    new_ids = mir.insert_new(new_u64, new_rows, cv)
                ids[mi] = new_ids[pos]
            ranks = mir.rank_of_id[np.maximum(ids, 0)].astype(np.int32)
            ranks[is_pad | (ids < 0)] = INT32_MAX
            st = mir.stats
            st["dispatches"] += 1
            st["endpoints"] += int((~is_pad).sum())
            st["endpoint_hits"] += int(hot_hit.sum())
            fid = ids[hot_hit]
            uniq_found = (
                int(np.bincount(fid, minlength=1).astype(bool).sum())
                if fid.size else 0
            )
            st["unique_keys"] += m + uniq_found
            st["delta_new_keys"] += m
        self._note_write_fps(qu, is_pad, dims)
        return self._ranks_to_batch(bt, ranks, dims, new_rows)

    def _note_write_fps(self, qu: np.ndarray, is_pad: np.ndarray,
                        dims) -> None:
        """Stash the pack's write-begin fingerprints for the admission
        feed (``u64_cols_fingerprint`` of the endpoint u64 columns already
        computed, never a key re-hash). A window pack ([k]-leading) clears
        the stash: the window path feeds no engine-attached filter."""
        if self.admission_filter is None:
            return
        lead, b, r, q, _w = dims
        if lead:
            self._adm_stash = None
            return
        sect = slice(2 * b * r, 2 * b * r + b * q)
        fps = u64_cols_fingerprint(qu[sect])
        self._adm_stash = (fps.reshape(b, q), (~is_pad[sect]).reshape(b, q))

    def _take_adm(self, commit_version: int):
        """Claim the last pack's fingerprint stash, bound to its resolve's
        commit version (None when no filter is attached or the pack left
        none). The version rides in the pending tuple, not in the engine,
        so a later dispatch cannot relabel an earlier one's writes."""
        stash, self._adm_stash = self._adm_stash, None
        return None if stash is None else (stash, commit_version)

    def _feed_admission(self, rows: list[tuple], pending: list[tuple]) -> None:
        """Record the accepted write fingerprints of each collected chunk
        at its commit version (a chunk with none ages the banks)."""
        if self.admission_filter is None:
            return
        for (v, _), (*_, adm) in zip(rows, pending):
            if adm is None:
                continue
            (fps, valid), cv = adm
            n = len(v)
            sel = valid[:n] & (v == Verdict.COMMITTED)[:, None]
            if sel.any():
                self.admission_filter.record_u64(fps[:n][sel], cv)
            else:
                self.admission_filter.advance(cv)

    def _device_live_ranks(self) -> np.ndarray:
        """Every rank the device history still references (one sync)."""
        ranks = torch.cat([a.reshape(-1) for a in ck.hist_rank_arrays(
            self.state.hist)]).cpu().numpy()
        self.host_syncs += 1
        live = np.unique(ranks[ranks != INT32_MAX])
        return live[(live >= 0) & (live < self._mirror.n)]

    def _repack_and_rank(self, plan: _RepackPlan) -> HostRankBatch:
        """Full dictionary repack: rebuild the dictionary from {live
        history ranks} ∪ {pinned} ∪ {this dispatch's keys} ∪ the most
        recently used survivors, ship it whole, and remap every
        device-held rank."""
        mir = self._mirror
        with mir.lock:
            try:
                live = self._device_live_ranks()
                keep = np.zeros(mir.n, bool)
                keep[live] = True
                keep |= mir.pinned
                pos = _u64_searchsorted(mir.u64, plan.qu, "left")
                cand = np.minimum(pos, max(mir.n - 1, 0))
                found = (
                    (pos < mir.n)
                    & (mir.u64[cand] == plan.qu).all(axis=1)
                    & ~plan.is_pad
                )
                keep[pos[found]] = True  # this dispatch's keys stay
                mir.touch(mir.id_at[pos[found]], plan.cv)
                m = len(plan.new_u64)
                must = int(keep.sum())
                if must + m + 1 > mir.capacity + 1:
                    raise ValueError(
                        f"resident dictionary cannot fit {must} live/pinned"
                        f" + {m} new keys in capacity {mir.capacity};"
                        " raise dict_capacity"
                    )
                used_sorted = mir.used_sorted()
                target = max(mir.capacity - self.dict_delta_slots - m, must)
                room = target - must
                cand_idx = np.flatnonzero(~keep)
                if room > 0 and cand_idx.size:
                    by_age = cand_idx[
                        np.argsort(used_sorted[cand_idx], kind="stable")
                    ]
                    keep[by_age[max(0, by_age.size - room):]] = True
                evicted = mir.n - int(keep.sum())

                kept_u64 = mir.u64[keep]
                kept_rows = mir.rows[keep]
                kept_used = used_sorted[keep]
                kept_pin = mir.pinned[keep]
                ins = _u64_searchsorted(kept_u64, plan.new_u64, "left")
                fin_u64 = np.insert(kept_u64, ins, plan.new_u64, axis=0)
                fin_rows = np.insert(kept_rows, ins, plan.new_rows, axis=0)
                fin_used = np.insert(kept_used, ins, plan.cv)
                fin_pin = np.insert(kept_pin, ins, False)
                n_new = len(fin_u64)

                # remap: exact new rank for every kept old rank; dropped ranks
                # get their insertion point (never gathered by the device).
                remap = np.zeros(mir.capacity + 1, np.int32)
                remap[: mir.n] = _u64_searchsorted(
                    fin_u64, mir.u64, "left"
                ).astype(np.int32)
                dict_dev = np.full(
                    (mir.capacity + 1, fin_rows.shape[1]), INT32_MAX, np.int32
                )
                dict_dev[:n_new] = fin_rows
                self.state = ck.apply_dict_remap(self.state, dict_dev, n_new,
                                                 remap)
                mir.reset(fin_u64, fin_rows, fin_used, fin_pin)
                st = mir.stats
                st["full_repacks"] += 1
                st["evictions"] += evicted
                st["dispatches"] += 1
                st["endpoints"] += int((~plan.is_pad).sum())
                st["endpoint_hits"] += int(found.sum())
                st["unique_keys"] += m + int(np.unique(pos[found]).size)
                st["delta_new_keys"] += m
                ranks = _u64_searchsorted(fin_u64, plan.qu, "left").astype(
                    np.int32
                )
                ranks[plan.is_pad] = INT32_MAX
            finally:
                mir.gate.set()
        self._note_write_fps(plan.qu, plan.is_pad, plan.dims)
        return self._ranks_to_batch(
            plan.bt, ranks, plan.dims,
            np.zeros((0, plan.dims[-1]), np.int32),
        )

    def _demote_now(self, incoming: int, protect=None) -> int:
        """Demote unused hot-tier keys to the host cold store (dispatch
        thread only: the victim selection reads the device liveness).

        Victims, in exclusion order: pinned keys never move; ranks the
        device history still references stay (evicting one would skew
        every younger rank through the shift table); keys used inside the
        MVCC window (last used >= oldest_version) stay; the current
        dispatch's keys (``protect``: its probed u64 rows) stay; with an
        admission filter attached, keys its banks report maybe written
        since the floor stay. The survivors demote oldest-last-used first,
        enough to get past the watermark plus half an evict chunk. The
        event's whole sorted order ships at once, padded to whole chunks
        of ``dict_demote_batch`` ranks (the JAX engine's static evict
        width, so ``demotion_bytes`` counts 4·e a chunk as it does): one
        K7 launch and one rank rewrite an event, which leave the state
        the JAX engine's ascending chunks leave. Returns the count
        demoted (0: nothing evictable)."""
        mir = self._mirror
        with mir.lock:
            used = mir.used_sorted()
            cand = ~mir.pinned & (used < self.oldest_version)
            cand[self._device_live_ranks()] = False
            if protect is not None:
                qu, is_pad = protect
                pids = mir.probe(qu, ~is_pad)
                pf = pids[pids >= 0]
                cand[mir.rank_of_id[pf[mir.hot_by_id[pf]]]] = False
            if self.admission_filter is not None:
                idx = np.flatnonzero(cand)
                if idx.size:
                    recent = np.asarray(self.admission_filter.probe_u64(
                        u64_cols_fingerprint(mir.u64[idx]),
                        self.oldest_version))
                    cand[idx[recent]] = False
            idx = np.flatnonzero(cand)
            if not idx.size:
                return 0
            # Free past the watermark plus half a chunk of hysteresis, so
            # that the next windows' deltas fit without demoting again.
            over = mir.n + incoming - self._demote_watermark
            want = min(idx.size, max(over, 0)
                       + max(1, self.dict_demote_batch // 2))
            order = np.sort(idx[np.argsort(used[idx], kind="stable")[:want]])
            e = self.dict_demote_batch
            chunks = -(-len(order) // e)
            ev = np.full(chunks * e, INT32_MAX, np.int32)
            ev[:len(order)] = order
            self.state = ck.apply_evict(
                self.state, torch.from_numpy(ev).to(self.device), len(order),
                mir.n)
            mir.stats["demotion_bytes"] += 4 * e * chunks
            mir.demote(order)
            mir.stats["demotion_events"] += 1
            return len(order)

    def _demote_and_rank(self, plan: _DemotePlan) -> HostRankBatch:
        """Run a deferred demotion on the dispatch thread (every earlier
        window has dispatched, so the liveness is exact), then re-pack the
        stalled window against the demoted mirror; that re-pack escalates
        to a full repack itself if demotion could not free enough room.
        The gate opens only after the re-pack, so that the next window's
        pack (on the packing thread) ranks against a mirror that already
        holds this window's keys."""
        try:
            self._demote_now(len(plan.new_u64),
                             protect=(plan.qu, plan.is_pad))
            return self._pack_ranked(plan.bt)
        finally:
            self._mirror.gate.set()

    def _run_plan(self, plan) -> HostRankBatch:
        """A deferred _RepackPlan or _DemotePlan, run on the dispatch
        thread."""
        if isinstance(plan, _RepackPlan):
            return self._repack_and_rank(plan)
        return self._demote_and_rank(plan)

    @property
    def dict_stats(self) -> dict | None:
        """Dictionary-economics counters: unique keys/dispatch, delta hit
        rate, evictions, forced full repacks, and the tier economics
        (zeros when untiered): demotions, promotions, demotion stalls,
        events and bytes, hot occupancy, cold-tier keys, and the bytes one
        full repack would ship. None for a non-resident engine (no
        dictionary), as in JAX."""
        mir = self._mirror
        if mir is None:
            return None
        s = dict(mir.stats)
        d = max(1, s["dispatches"])
        e = max(1, s["endpoints"])
        s.update(
            resident_keys=mir.n,
            dict_capacity=mir.capacity,
            delta_slots=self.dict_delta_slots,
            unique_keys_per_dispatch=round(s["unique_keys"] / d, 1),
            delta_hit_rate=round(s["endpoint_hits"] / e, 4),
            tiered=self.tiered,
            dict_hot_occupancy=round(mir.n / max(1, mir.capacity), 4),
            cold_tier_keys=mir.cold_n,
            demotion_bytes_per_dispatch=round(s["demotion_bytes"] / d, 1),
            full_repack_ship_bytes=(mir.capacity + 1) * 4
            * (mir.rows.shape[1] + 1),
        )
        return s

    # -- public API ---------------------------------------------------------

    def resolve(
        self,
        txns: list[TxnConflictInfo],
        commit_version: int,
        oldest_version: int | None = None,
    ) -> list[Verdict]:
        return self.resolve_async(txns, commit_version, oldest_version)()

    def resolve_async(
        self,
        txns: list[TxnConflictInfo],
        commit_version: int,
        oldest_version: int | None = None,
    ) -> Callable[[], list[Verdict]]:
        """Dispatch every chunk to the device and return a collector; the
        device->host copy of the verdicts waits for the collector. A chunk
        holding a txn that set report_conflicting_keys also returns its
        loser mask, which fills ``last_conflicting``."""
        self._spec_drain_serial()
        self._begin_resolve(commit_version, oldest_version)
        cv = self._rel(commit_version)
        oldest = self._rel(self.oldest_version)
        pending: list[tuple] = []
        for i in range(0, len(txns), self.batch_size):
            chunk = txns[i : i + self.batch_size]
            report = self.can_report and any(t.report_conflicting_keys
                                             for t in chunk)
            batch, reads = self._pack(chunk)
            # Pack BEFORE reading self.state: a repack inside the packer
            # replaces it.
            hb = self._pack_batch(batch)
            out, got = self._resolve_chunk(hb, cv, oldest, report)
            losers = got[-2] if report else None
            flags = [t.report_conflicting_keys for t in chunk]
            pending.append((out, len(chunk), losers, reads, flags,
                            self._take_adm(commit_version)))
        return lambda: self._collect(pending)

    def _resolve_chunk(self, hb: HostRankBatch, cv: int, oldest: int,
                       report: bool = False):
        """Dispatch one packed chunk; returns (its WindowOut, the resolve
        outputs). The verdicts (and levels) land in the WindowOut, which
        the collector reads with one device-to-host copy."""
        out = ck.window_out(1, self.batch_size, self.device, self.wave_commit)
        got = self._batch_program(self._upload(hb), hb, cv, oldest,
                                  report, out)
        self.state = got[-1]
        return out, got

    def resolve_wire(
        self,
        wire,
        commit_version: int,
        oldest_version: int | None = None,
        count: int | None = None,
    ) -> list[Verdict]:
        return self.resolve_wire_async(wire, commit_version, oldest_version,
                                       count)()

    def resolve_wire_async(
        self,
        wire,
        commit_version: int,
        oldest_version: int | None = None,
        count: int | None = None,
        as_array: bool = False,
    ) -> Callable:
        """One batch of serialized transactions (the wire format of
        ``native/keypack.cpp``, made by :func:`encode_resolve_batch`),
        packed by one C pass and dispatched chunk by chunk. The collector
        returns verdicts, or an int8 array with ``as_array``.

        The whole buffer is validated before anything is dispatched: a
        chunk failing mid-stream would leave earlier chunks' writes in the
        device history with no verdicts delivered."""
        buf = native.as_wire(wire)
        counted = native.count_txns(buf)
        if counted < 0 or (count is not None and count > counted):
            raise ValueError("malformed resolver wire batch")
        if count is None:
            count = counted
        self._spec_drain_serial()
        self._begin_resolve(commit_version, oldest_version)
        cv = self._rel(commit_version)
        oldest = self._rel(self.oldest_version)
        pending: list[tuple] = []
        offset, remaining = 0, count
        while remaining > 0:
            n = min(remaining, self.batch_size)
            batch, offset = self._pack_wire(buf, offset, n)
            hb = self._pack_batch(batch)  # may repack: before self.state
            out, _ = self._resolve_chunk(hb, cv, oldest)
            pending.append((out, n, None, None, None,
                            self._take_adm(commit_version)))
            remaining -= n
        if as_array:
            def collect_array() -> np.ndarray:
                rows = self._read_chunks(pending)
                self._feed_admission(rows, pending)
                return np.concatenate([v for v, _ in rows]
                                      or [np.zeros(0, np.int8)])

            return collect_array
        return lambda: self._collect(pending)

    def resolve_wire_window(self, wire, commit_versions,
                            count: int) -> np.ndarray:
        return self.resolve_wire_window_async(wire, commit_versions, count)()

    def resolve_wire_window_async(self, wire, commit_versions,
                                  count: int) -> Callable[[], np.ndarray]:
        """Resolve a window of k consecutive batches in one dispatch:
        ``wire`` holds k·count txns; txns [i·count, (i+1)·count) resolve
        at ``commit_versions[i]`` (strictly increasing). The collector
        returns int8 verdicts [k, count]."""
        return self.dispatch_window(
            self.pack_wire_window(wire, commit_versions, count))

    def pack_wire_window(self, wire, commit_versions,
                         count: int) -> PreparedWindow:
        """Host half of the window path: validate, advance the version
        bookkeeping, C-pack the k batches and rank them against the
        mirror. Host work only (numpy and ctypes), so it may run on a
        packing thread while ``dispatch_window`` of the previous window
        runs; never beside another pack (packs go in commit-version
        order). A rebase or a full repack that falls due is deferred into
        the PreparedWindow. On any raise the bookkeeping is restored."""
        buf = native.as_wire(wire)
        k = len(commit_versions)
        if count > self.batch_size:
            raise ValueError("the window path resolves one batch of at most "
                             "batch_size txns per commit version")
        if native.count_txns(buf) < k * count:
            raise ValueError("malformed resolver wire batch")
        snap = (self.base_version, self.oldest_version, self._last_commit)
        try:
            rebase_delta = 0
            oldest_abs = np.empty(k, np.int64)
            for i, cv in enumerate(commit_versions):
                rebase_delta += self._begin_resolve(int(cv), None,
                                                    defer_rebase=True)
                oldest_abs[i] = self.oldest_version
            # base_version is final now. A rebase inside the window can
            # lift it above floors taken earlier: those clamp to 0, which
            # is exact (everything below base has expired on the device,
            # and the kernel's floor never regresses).
            cvs_rel = np.asarray(
                [self._rel(int(cv)) for cv in commit_versions], np.int32)
            olds_rel = np.asarray(
                [max(0, int(v) - self.base_version) for v in oldest_abs],
                np.int32)
            batches = self._empty_batch(k)
            if self.spec_resolve and not self.resident:
                # The fused C window pack feeds the speculative
                # non-resident engine, as in JAX.
                batch = self._pack_window_native(buf, batches, count)
            else:
                offset = 0
                for i in range(k):
                    offset = native.pack_batch(
                        buf, offset, count, self.codec.n_words,
                        self.base_version, HostBatch(*(a[i] for a in batches)))
                    if offset < 0:
                        raise ValueError("malformed resolver wire batch")
                batch = self._pack_batch(batches, defer_repack=True)
        except BaseException:
            self.base_version, self.oldest_version, self._last_commit = snap
            raise
        return PreparedWindow(batch=batch, cvs_rel=cvs_rel, olds_rel=olds_rel,
                              count=count, rebase_delta=rebase_delta)

    def _pack_window_native(self, buf: np.ndarray, bt: HostBatch,
                            count: int) -> HostRankBatch:
        """One ``kp_pack_window`` call (the wire walk and every batch's
        dictionary in one C pass; a library without the symbol raises):
        the window's padded batch ``bt`` ([k]-leading, prefilled) and its
        dictionaries and ranks, bit for bit ``_pack_dict``'s."""
        k, b, r, w = bt.read_begin.shape
        q = bt.write_begin.shape[2]
        n = 2 * b * (r + q)
        dict_keys = np.full((k, n + 1, w), INT32_MAX, np.int32)
        ranks = [np.empty((k, b, c), np.int32) for c in (r, r, q, q)]
        if native.pack_window(buf, 0, k, count, self.codec.n_words,
                              self.base_version, bt, dict_keys, *ranks) < 0:
            raise ValueError("malformed resolver wire batch")
        return self._rank_batch(bt, *ranks, dict_keys, 0)

    def dispatch_window(self, prepared: PreparedWindow
                        ) -> Callable[[], np.ndarray]:
        """Device half of the window path, on the dispatching thread in
        pack order: the deferred rebase, then the deferred repack or
        demotion (exact here, since every earlier window has dispatched),
        then one upload and the window's launch sequence. The collector
        makes the window's one device-to-host read: int8 verdicts
        [k, count]. A speculative engine routes the window through its
        reconcile ring (``spec_dispatch_window``); its collector
        reconciles in dispatch order before it returns the verdicts."""
        if self.spec_resolve:
            seq = self.spec_dispatch_window(prepared)

            def collect_spec() -> np.ndarray:
                while seq not in self._spec_done:
                    self.reconcile_window()
                verdicts, levels = self._spec_done.pop(seq)
                if self.wave_commit:
                    self.last_wave_window = levels
                return verdicts

            return collect_spec
        if prepared.rebase_delta:
            self.state = ck.rebase_res(
                self.state, min(prepared.rebase_delta, 2**31 - 1))
        hb = prepared.batch
        if isinstance(hb, (_RepackPlan, _DemotePlan)):
            hb = self._run_plan(hb)
        out = self._resolve_window(self._upload(hb), hb,
                                   prepared.cvs_rel, prepared.olds_rel)

        def collect() -> np.ndarray:
            self.host_syncs += 1
            verdicts, levels = ck.read_out(out)
            if levels is not None:
                # One schedule per batch: batches serialize by version.
                self.last_wave_window = levels[:, : prepared.count]
            return verdicts[:, : prepared.count]

        return collect

    def _resolve_window(self, rb: ck.ResidentBatch, hb: HostRankBatch,
                        cvs_rel, olds_rel) -> ck.WindowOut:
        """Launch the window program on ``rb`` (uploaded ``hb``) into a
        fresh WindowOut, advancing ``self.state``."""
        out = ck.window_out(len(cvs_rel), self.batch_size, self.device,
                            self.wave_commit)
        self.state = self._window_program(rb, hb, cvs_rel, olds_rel, out)
        return out

    # -- speculative window resolve (spec_resolve=True) ---------------------
    #
    # The window program paints the writes it accepts, so the state is
    # advanced optimistically before the upper layer has confirmed the
    # verdicts (a log push, a ratekeeper revoke). A speculative engine
    # dispatches the next window at once and keeps a ring of at most
    # spec_depth unconfirmed windows, each with a snapshot of the state
    # before it. Reconcile confirms the oldest (drop the snapshot) or
    # rolls back to it, re-paints it with the confirmed accepts only and
    # re-resolves every younger window against the corrected history. A
    # non-resident engine first runs the dependency probe: the rejected
    # writes painted into a scratch history, each younger window's
    # dictionaries probed against it; a window that read none of them
    # keeps its verdicts and is only re-painted. A resident engine's
    # windows rank against per-window dictionaries the scratch cannot
    # share, so it re-resolves every younger window (as JAX does).

    def spec_dispatch_window(self, prepared: PreparedWindow) -> int:
        """Dispatch a packed window speculatively; returns its reconcile
        sequence number. Dispatching thread, pack order. A rebase, a full
        repack or a demotion drains the ring first: snapshots hold the
        pre-rebase versions and pre-evict ranks, and the liveness read
        must not see unconfirmed paints."""
        if not self.spec_resolve:
            raise ValueError("speculative resolve is off for this engine "
                             "(spec_resolve=True)")
        while len(self._spec_ring) >= self.spec_depth:
            self.reconcile_window()
        if prepared.rebase_delta:
            self.reconcile_all()
            self.state = ck.rebase_res(
                self.state, min(prepared.rebase_delta, 2**31 - 1))
        hb = prepared.batch
        if isinstance(hb, (_RepackPlan, _DemotePlan)):
            self.reconcile_all()
            hb = self._run_plan(hb)
        return self._spec_launch(hb, prepared.cvs_rel, prepared.olds_rel,
                                 prepared.count)

    def _spec_launch(self, hb: HostRankBatch, cvs_rel, olds_rel,
                     count: int) -> int:
        snapshot = ck.snapshot_res(self.state)
        rb = self._upload(hb)
        out = self._resolve_window(rb, hb, cvs_rel, olds_rel)
        seq = self._spec_seq
        self._spec_seq += 1
        self._spec_ring.append(_SpecPending(seq, snapshot, hb, rb, cvs_rel,
                                            olds_rel, count, out))
        self._spec_stats["spec_dispatched"] += 1
        return seq

    def _spec_read(self, p: _SpecPending) -> tuple:
        """(verdicts int8 [k, B], levels int32 [k, B] or None) of a ring
        entry: its one device-to-host read, shared by reconcile and the
        collector."""
        if p.read is None:
            p.read = ck.read_out(p.out)
            self.host_syncs += 1
        return p.read

    def _spec_accept_mask(self, p: _SpecPending) -> np.ndarray:
        """bool [k, B]: the txns the entry's dispatch accepted (painted).
        Wave engines: committed at some wave (padding never is). Others:
        COMMITTED and a real txn (padding gets verdict 0)."""
        verdicts, levels = self._spec_read(p)
        if levels is not None:
            return levels >= 0
        return (verdicts == ck.V_COMMITTED) & p.hb.ranks[7]

    def reconcile_window(self, confirmed: np.ndarray | None = None
                         ) -> np.ndarray:
        """Reconcile the OLDEST in-flight window; returns its verdicts int8
        [k, count] (also kept for its collector).

        ``confirmed`` is a bool [k, count] mask (False: the upper layer
        revoked that txn's outcome); None asks ``spec_confirm_hook``, and
        no hook confirms all. The window's own verdicts are returned
        unchanged (a revocation is an upper-layer abort, not a resolver
        verdict); what reconcile repairs is the history and every younger
        window that speculated on it. A repair re-resolves the younger
        windows, so ``wave_stats`` then counts their batches again."""
        p = self._spec_ring.popleft()
        verdicts, levels = self._spec_read(p)
        spec_acc = self._spec_accept_mask(p)
        k, b = spec_acc.shape
        verdicts_np = verdicts[:, : p.count]
        levels_np = None if levels is None else levels[:, : p.count]
        if confirmed is None and self.spec_confirm_hook is not None:
            confirmed = self.spec_confirm_hook(p.seq, verdicts_np)
        rejected = np.zeros((k, b), bool)
        if confirmed is not None:
            conf = np.zeros((k, b), bool)
            conf[:, : p.count] = np.asarray(confirmed, bool)[:, : p.count]
            rejected = spec_acc & ~conf
        self._spec_done[p.seq] = (verdicts_np, levels_np)
        if not rejected.any():
            self._spec_stats["spec_confirmed"] += 1
            return verdicts_np
        self._spec_stats["spec_repaired"] += 1
        self._spec_stats["chain_rolls"] += 1
        # Roll back to the snapshot and re-advance with the confirmed
        # accepts only: the same delta, folds and paints, no decision.
        self.state = self._paint_window(p, spec_acc & ~rejected, p.snapshot)
        # Repair every younger window against the corrected history, in
        # dispatch order, each under a fresh snapshot: re-resolve a window
        # that depends on a rejected write, re-paint one that does not.
        deps = self._spec_dep_windows(p, rejected)
        for y, dep in zip(self._spec_ring, deps):
            old_acc = self._spec_accept_mask(y)
            y.snapshot = ck.snapshot_res(self.state)
            if not dep:
                self.state = self._paint_window(y, old_acc, self.state)
                continue
            y.out = self._resolve_window(y.rb, y.hb, y.cvs_rel, y.olds_rel)
            y.read = None
            self._spec_stats["spec_flipped"] += int(
                (old_acc != self._spec_accept_mask(y))[:, : y.count].sum())
        return verdicts_np

    def _paint_window(self, p: _SpecPending, accepted: np.ndarray, state):
        """``state`` advanced by a ring entry's window with a host-forced
        accept mask [k, B] (the paint-only re-advance)."""
        acc = torch.from_numpy(accepted).to(self.device)
        kw = {"n_new": p.hb.n_new} if self.resident else {}
        return self._paint_fn(state, p.rb, acc, p.cvs_rel, p.olds_rel,
                              demands=p.hb.demand, **kw)

    def _spec_dep_windows(self, p: _SpecPending,
                          rejected: np.ndarray) -> list[bool]:
        """Per younger window in the ring: does any of its reads overlap a
        write that the reconciling window ``p`` had rejected? (The JAX
        ``_spec_dep_windows``.) The rejected writes are painted into a
        small flat scratch history at version INT32_MAX - 1 (K13), then
        each younger window's dictionaries probe it (K12): one device read
        per younger window. A resident engine answers True for every
        window."""
        if self.resident or not self._spec_ring:
            return [True] * len(self._spec_ring)
        k, b = rejected.shape
        cap = min(self.capacity, 2 * k * b * self.max_write_ranges + 2)
        scratch = ck.init_state(cap, self.codec.width, self.codec.min_key,
                                self.device)
        scratch = ck.spec_mark_rejected(
            scratch, p.rb, torch.from_numpy(rejected).to(self.device))
        deps = []
        for y in self._spec_ring:
            deps.append(bool(ck.spec_dep_window(scratch, y.rb,
                                                rmq=self.rmq)))
            self.host_syncs += 1
        return deps

    def reconcile_all(self) -> None:
        """Drain the in-flight ring (confirmations via spec_confirm_hook)."""
        while self._spec_ring:
            self.reconcile_window()

    def _spec_drain_serial(self) -> None:
        """Serial entry points reconcile every in-flight window before
        they read or advance the state outside the ring."""
        if self._spec_ring:
            self.reconcile_all()

    def spec_metrics(self) -> dict:
        """The speculation counters, and the ring's current depth."""
        return {**self._spec_stats, "spec_depth": len(self._spec_ring)}

    def spec_resolve_async(self, txns: list[TxnConflictInfo],
                           commit_version: int,
                           oldest_version: int | None = None):
        """Object-path speculative dispatch: one chunk lifted to a window
        of 1 through the same ring. Returns a collector of list[Verdict],
        or None when the batch cannot speculate (more than one chunk, or a
        txn asking for its conflicting keys, which needs the report
        launch); the caller then resolves serially, which drains the ring
        first."""
        if (not self.spec_resolve or len(txns) > self.batch_size
                or any(t.report_conflicting_keys for t in txns)):
            return None
        while len(self._spec_ring) >= self.spec_depth:
            self.reconcile_window()
        delta = self._begin_resolve(commit_version, oldest_version,
                                    defer_rebase=True)
        if delta:
            self.reconcile_all()
            self.state = ck.rebase_res(self.state, min(delta, 2**31 - 1))
        cv_rel = np.asarray([self._rel(commit_version)], np.int32)
        old_rel = np.asarray([self._rel(self.oldest_version)], np.int32)
        batch, _ = self._pack(txns)
        # Speculative accepts feed no filter (a revocation could poison
        # it); as in JAX the stash is cleared before this pack.
        self._adm_stash = None
        hb = self._pack_batch(batch, defer_repack=True)
        if isinstance(hb, (_RepackPlan, _DemotePlan)):
            self.reconcile_all()
            hb = self._run_plan(hb)
        # A window of 1: the ranks get the step axis, and so does a
        # non-resident engine's dictionary (a resident delta has none).
        hb = hb._replace(ranks=tuple(a[None] for a in hb.ranks),
                         demand=(hb.demand,),
                         delta_keys=hb.delta_keys if self.resident
                         else hb.delta_keys[None])
        seq = self._spec_launch(hb, cv_rel, old_rel, len(txns))

        def collect() -> list[Verdict]:
            while seq not in self._spec_done:
                self.reconcile_window()
            verdicts, levels = self._spec_done.pop(seq)
            if self.wave_commit:
                self.last_wave = [int(x) for x in levels[0]]
                self.last_reordered = int((levels[0] > 0).sum())
            return [Verdict(int(x)) for x in verdicts[0]]

        return collect

    # -- the role-level global wave protocol (core/wavemesh) ----------------

    @property
    def wave_global_capable(self) -> bool:
        """Does this engine implement resolve_edges / resolve_apply?"""
        return self.wave_commit

    def resolve_edges(self, txns: list[TxnConflictInfo], commit_version: int,
                      oldest_version: int | None = None) -> wavemesh.WaveEdges:
        """Phase 1 of the global wave protocol: gate this shard's CLIPPED
        view of the window (TOO_OLD and history conflicts) and build its
        clipped predecessor rows (K5), painting nothing. The packed batch
        stays stashed until ``resolve_apply`` brings the combined graph.
        Returns the commit proxy's OR-reduce operand; its payload is byte
        for byte the JAX engine's."""
        if not self.wave_global_capable:
            raise ValueError(
                "resolve_edges requires a wave-commit engine with the "
                "two-phase entry points (wave_commit=True)")
        if self._wave_pending is not None:
            raise ValueError(
                "resolve_edges with an apply outstanding: the previous "
                "window's resolve_apply must land first (version chain)")
        if len(txns) > self.batch_size:
            # One exchange carries one schedule domain. Chunks of a larger
            # window would serialize through the history on the single
            # engine (a later chunk's gate sees an earlier chunk's
            # paints); a one-shot exchange gates every chunk against the
            # pre-window history and would commit those pairs.
            raise ValueError(
                f"global wave window of {len(txns)} txns exceeds the "
                f"engine chunk ({self.batch_size}): one exchange carries "
                "one schedule domain")
        self._spec_drain_serial()
        self._begin_resolve(commit_version, oldest_version)
        cv = self._rel(commit_version)
        oldest = self._rel(self.oldest_version)
        n = len(txns)
        if not n:
            self._wave_pending = ([], commit_version)
            return wavemesh.WaveEdges(count=0, too_old=np.zeros(0, bool),
                                      hist_conflict=np.zeros(0, bool),
                                      chunks=[])
        batch, _ = self._pack(txns)
        hb = self._pack_batch(batch)  # may repack: before self.state
        rb = self._upload(hb)
        if self.resident:
            too_old, hist_c, p, self.state = self._edges_fn(
                self.state, rb, oldest, n_new=hb.n_new, rmq=self.rmq)
        else:
            too_old, hist_c, p = self._edges_fn(self.state, rb, oldest,
                                                rmq=self.rmq)
        self._wave_pending = ([(rb, n, cv, oldest, hb.demand,
                                self._take_adm(commit_version))],
                              commit_version)
        flags = torch.stack([too_old, hist_c]).cpu().numpy()
        p = p.cpu().numpy().view(np.uint32)
        self.host_syncs += 2
        return wavemesh.WaveEdges(count=n, too_old=flags[0, :n],
                                  hist_conflict=flags[1, :n],
                                  chunks=[(n, p)])

    def resolve_abandon(self) -> None:
        """Drop a pending resolve_edges without painting (another shard's
        fail-safe rejected the window). Phase 1 painted nothing, so
        dropping the stash is the whole rollback; the version bookkeeping
        stays advanced (the device floor catches up on the next
        dispatch)."""
        self._wave_pending = None

    def resolve_apply(self, graph: wavemesh.WaveGraph) -> list[Verdict]:
        """Phase 2: level the combined GLOBAL graph (K6; the same inputs on
        every shard give the same schedule on every shard), paint this
        shard's accepted writes (K4) and publish ``last_wave`` /
        ``last_reordered`` as a single wave resolve does. The conflicting-
        keys report is not produced on this path (``last_conflicting``
        stays empty)."""
        if self._wave_pending is None:
            raise ValueError("resolve_apply without a pending resolve_edges")
        pend, _ = self._wave_pending
        self._wave_pending = None
        if len(graph.chunks) != len(pend):
            raise ValueError(
                f"global graph has {len(graph.chunks)} chunks; this shard "
                f"packed {len(pend)}")
        gi = 0
        parts: list[np.ndarray] = []
        feed: list[tuple] = []
        for (rb, n, cv, oldest, demand, adm), (nc, pred) in zip(
                pend, graph.chunks):
            if nc != n:
                raise ValueError(
                    f"global graph chunk of {nc} txns vs local pack of {n}")
            cand = np.zeros(self.batch_size, bool)
            cand[:n] = graph.cand[gi : gi + n]
            p = torch.from_numpy(
                np.ascontiguousarray(pred, np.uint32).view(np.int32))
            levels, self.state = self._apply_fn(
                self.state, rb.ranks if self.resident else rb,
                torch.from_numpy(cand).to(self.device), p.to(self.device),
                cv, oldest, demand=demand, stats=self._wave_stats)
            parts.append(levels.cpu().numpy()[:n])
            self.host_syncs += 1
            if adm is not None:
                feed.append((parts[-1], adm))
            gi += n
        self.last_wave, self.last_reordered = _stitch_waves(parts)
        self.last_conflicting = {}
        # The admission feed: accepted writes at this window's commit
        # version, judged on the GLOBAL schedule.
        if self.admission_filter is not None:
            for lv, ((fps, valid), adm_cv) in feed:
                sel = valid[: len(lv)] & (lv >= 0)[:, None]
                if sel.any():
                    self.admission_filter.record_u64(fps[: len(lv)][sel],
                                                     adm_cv)
                else:
                    self.admission_filter.advance(adm_cv)
        return wavemesh.verdicts_from_schedule(graph, self.last_wave)

    @property
    def wave_stats(self) -> dict | None:
        """K6's counters since the engine was made (one device read):
        batches leveled, rounds and cycle victims in all and at most per
        batch. None for a sequential-order engine."""
        if self._wave_stats is None:
            return None
        b, r, v, rmax, vmax = (int(x) for x in self._wave_stats.cpu())
        self.host_syncs += 1
        return {"batches": b, "rounds": r, "victims": v, "max_rounds": rmax,
                "max_victims": vmax}

    def _read_chunks(self, pending: list[tuple]) -> list[tuple]:
        """[(verdicts int8 [n], levels int32 [n] or None)] of the pending
        chunks, one device-to-host read each; publishes ``last_wave`` and
        ``last_reordered`` on a wave engine."""
        rows = []
        for out, n, *_ in pending:
            verdicts, levels = ck.read_out(out)
            self.host_syncs += 1
            rows.append((verdicts[0, :n],
                         None if levels is None else levels[0, :n]))
        if self.wave_commit:
            self.last_wave, self.last_reordered = _stitch_waves(
                [lv for _, lv in rows])
        return rows

    def _collect(self, pending: list[tuple]) -> list[Verdict]:
        out: list[Verdict] = []
        self.last_conflicting = {}
        gi = 0
        rows = self._read_chunks(pending)
        self._feed_admission(rows, pending)
        for (v, _), (_, n, losers, reads, flags, _) in zip(rows, pending):
            if losers is not None:
                m = losers.cpu().numpy()[:n]
                self.host_syncs += 1
                if m.dtype != np.bool_:
                    # int32 bit rows: bit c = coalesced read slot c lost.
                    m = ((m.view(np.uint32)[:, None]
                          >> np.arange(self.max_read_ranges, dtype=np.uint32))
                         & 1).astype(bool)
                for j in range(n):
                    if v[j] == Verdict.CONFLICT and flags[j]:
                        cols = [
                            reads[j][c]
                            for c in np.nonzero(m[j])[0]
                            if c < len(reads[j])
                        ]
                        self.last_conflicting[gi + j] = cols or list(reads[j])
            out.extend(Verdict(int(x)) for x in v)
            gi += n
        return out

    def _begin_resolve(self, commit_version: int,
                       oldest_version: int | None,
                       defer_rebase: bool = False) -> int:
        """Advance host-side version bookkeeping for one dispatch. Returns
        the delta of a rebase that fell due (0 when none): applied to the
        device state here, unless ``defer_rebase`` (the packing thread may
        not touch device state), when the caller applies it before the
        next device launch."""
        if commit_version <= self._last_commit:
            raise ValueError(
                f"commit versions must advance: {commit_version} <= "
                f"{self._last_commit}"
            )
        if self.base_version is None:
            self.base_version = max(0, commit_version - self.window_versions)
        if oldest_version is not None:
            self.oldest_version = max(self.oldest_version, oldest_version)
        self.oldest_version = max(
            self.oldest_version, commit_version - self.window_versions
        )
        delta = self._maybe_rebase(commit_version, defer=defer_rebase)
        self._last_commit = commit_version
        return delta

    @property
    def _hist(self):
        """The history: two-level (a HistState) or flat (a ConflictState);
        a resident engine's ``state.hist``, any other engine's whole
        state."""
        return self.state.hist if self.resident else self.state

    def _levels(self) -> list:
        """The history's levels: base and delta, or the flat one."""
        h = self._hist
        return [h.base, h.delta] if isinstance(h, ck.HistState) else [h]

    @property
    def overflowed(self) -> bool:
        flags = torch.stack([x.overflow for x in self._levels()]).cpu()
        self.host_syncs += 1
        return bool(flags.any())

    def headroom(self) -> int:
        """Free boundary slots (one device sync): room in the merged base
        and a delta that can absorb one whole batch (a flat history: its
        free slots). The Resolver compares it with
        :meth:`worst_case_growth` before every batch."""
        used = torch.stack([x.n_used for x in self._levels()]).cpu()
        self.host_syncs += 1
        if len(used) == 1:
            return self.capacity - int(used[0])
        return min(self.capacity - int(used.sum()), self.delta_capacity)

    def worst_case_growth(self, n_txns: int) -> int:
        """Upper bound on boundary-slot growth from resolving n_txns."""
        return 2 * n_txns * self.max_write_ranges

    def clear_overflow(self) -> None:
        """Reset the sticky device overflow flags (in place)."""
        for x in self._levels():
            x.overflow.fill_(False)

    def advance(self, commit_version: int,
                oldest_version: int | None = None) -> None:
        """GC-only dispatch: move the version chain and floor forward
        without painting writes, forcing a fold so headroom recovers. A
        flat history resolves an all-masked batch instead (its paint
        compacts the expired segments out), packed once and kept, as in
        JAX."""
        self._spec_drain_serial()
        self._begin_resolve(commit_version, oldest_version)
        if self.admission_filter is not None:
            self.admission_filter.advance(commit_version)  # age the banks
        cv = self._rel(commit_version)
        oldest = self._rel(self.oldest_version)
        if isinstance(self._hist, ck.HistState):
            hist = ck.advance_hist(self._hist, cv, oldest)
            self.state = (self.state._replace(hist=hist) if self.resident
                          else hist)
            return
        if self._empty_hb is None:
            self._empty_hb = self._pack_batch(self._empty_batch())
        hb = self._empty_hb
        out = ck.window_out(1, self.batch_size, self.device, self.wave_commit)
        self.state = self._resolve_fn(
            self.state, self._upload(hb), cv, oldest, demand=hb.demand,
            out=out, **{**self._program_kw(hb), "stats": None})[-1]

    # -- internals ----------------------------------------------------------

    def _rel(self, v: int) -> int:
        rel = v - self.base_version
        if rel < 0:
            raise ValueError(f"version {v} below base {self.base_version}")
        return rel

    def _rel_read(self, v: int) -> int:
        """Read versions may predate the base: clamp to -1, strictly below
        every window floor (TOO_OLD for readers)."""
        return max(-1, v - self.base_version)

    def _maybe_rebase(self, commit_version: int, defer: bool = False) -> int:
        if commit_version - self.base_version < _REBASE_THRESHOLD:
            return 0
        delta = self.oldest_version - self.base_version
        if delta <= 0:
            return 0
        if not defer:
            self.state = ck.rebase_res(self.state, min(delta, 2**31 - 1))
        self.base_version += delta
        return delta

    def _empty_batch(self, k: int | None = None) -> HostBatch:
        """An all-masked padded batch (shared by the object and wire
        packers); ``k`` adds a leading window axis."""
        lead = () if k is None else (k,)
        b = self.batch_size
        r, q = self.max_read_ranges, self.max_write_ranges
        w = self.codec.width
        return HostBatch(
            read_begin=np.full((*lead, b, r, w), INT32_MAX, np.int32),
            read_end=np.full((*lead, b, r, w), INT32_MAX, np.int32),
            read_mask=np.zeros((*lead, b, r), bool),
            write_begin=np.full((*lead, b, q, w), INT32_MAX, np.int32),
            write_end=np.full((*lead, b, q, w), INT32_MAX, np.int32),
            write_mask=np.zeros((*lead, b, q), bool),
            read_version=np.zeros((*lead, b), np.int32),
            txn_mask=np.zeros((*lead, b), bool),
        )

    def _pack_wire(self, buf: np.ndarray, offset: int,
                   count: int) -> tuple[HostBatch, int]:
        """One C pass: wire bytes from ``offset`` -> a padded batch."""
        bt = self._empty_batch()
        new_off = native.pack_batch(buf, offset, count, self.codec.n_words,
                                    self.base_version, bt)
        if new_off < 0:
            raise ValueError("malformed resolver wire batch")
        return bt, new_off

    def _pack(self, txns: list[TxnConflictInfo]):
        """(HostBatch, coalesced read ranges per txn)."""
        bt = self._empty_batch()
        r, q = self.max_read_ranges, self.max_write_ranges
        r_rows, r_cols, r_pairs = [], [], []
        w_rows, w_cols, w_pairs = [], [], []
        reads_per_txn: list[list[KeyRange]] = []
        for i, t in enumerate(txns):
            bt.txn_mask[i] = True
            bt.read_version[i] = self._rel_read(t.read_version)
            creads = _coalesce(t.read_ranges, r)
            reads_per_txn.append(creads)
            for c, x in enumerate(creads):
                r_rows.append(i)
                r_cols.append(c)
                r_pairs.append((x.begin, x.end))
            for c, x in enumerate(_coalesce(t.write_ranges, q)):
                w_rows.append(i)
                w_cols.append(c)
                w_pairs.append((x.begin, x.end))
        if r_pairs:
            rb, re_ = self.codec.pack_ranges(r_pairs)
            bt.read_begin[r_rows, r_cols] = rb
            bt.read_end[r_rows, r_cols] = re_
            bt.read_mask[r_rows, r_cols] = True
        if w_pairs:
            wb, we = self.codec.pack_ranges(w_pairs)
            bt.write_begin[w_rows, w_cols] = wb
            bt.write_end[w_rows, w_cols] = we
            bt.write_mask[w_rows, w_cols] = True
        return bt, reads_per_txn


def encode_resolve_batch(txns: list[TxnConflictInfo]) -> bytes:
    """Serialize transactions to the resolver wire format
    (``native/keypack.cpp``): per txn ``<qii`` (read version, reads,
    writes), then per range ``<ii`` (begin and end lengths) and the bytes."""
    out = bytearray()
    for t in txns:
        reads = list(t.read_ranges)
        writes = list(t.write_ranges)
        out += struct.pack("<qii", t.read_version, len(reads), len(writes))
        for rng in reads + writes:
            out += struct.pack("<ii", len(rng.begin), len(rng.end))
            out += rng.begin
            out += rng.end
    return bytes(out)
