"""Host-side conflict engine over the torch/CUDA kernel: ``TorchConflictSet``.

The port of ``foundationdb_tpu/models/conflict_set.py``'s ``TPUConflictSet``
at its default design point (resident dictionary, window history,
sequential-order acceptance). It answers the calls the Resolver role makes
(``resolve``, ``resolve_async``, ``advance``, ``headroom``,
``worst_case_growth``, ``overflowed``, ``clear_overflow``, ``dict_stats``)
with the same verdicts and the same ``last_conflicting``, and the wire
path the bench drives: ``resolve_wire``/``resolve_wire_async`` (one batch
of serialized transactions, packed by one C pass) and the window path
``resolve_wire_window``/``pack_wire_window``/``dispatch_window`` (k
batches at k commit versions in one device launch sequence,
``conflict_kernel.resolve_many_res``).

The host packs byte ranges into rank space against a mirror of the device
dictionary, ships only never-seen keys, chunks oversized batches (chunks
at one commit version are equivalent to one ordered batch) and keeps the
absolute/relative version mapping. Device reads are explicit
``.cpu()`` calls, each counted in ``host_syncs``: one per chunk at
collect (two for a report chunk), one per window at collect, one per
``headroom()`` or ``overflowed`` call, one per full repack. Dispatch
itself never waits on the device: the fold decision stays on the device
and the insert decision comes from the mirror.

The window path splits into a host half (``pack_wire_window``: numpy and
ctypes only, safe on a packing thread) and a device half
(``dispatch_window``: uploads and launches, on the dispatching thread, in
pack order). A rebase or a full dictionary repack that falls due while
packing is deferred into the prepared window and run by its dispatch;
the mirror's gate holds the next pack until that repack has run.
"""

from __future__ import annotations

import struct
import threading
from typing import Callable, NamedTuple

import numpy as np
import torch

from foundationdb_tpu_torch import native
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
            "TorchConflictSet runs on a CUDA card and none is available; "
            "pass device='cpu' to run the plain torch versions")
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


_HASH_C1 = np.uint64(0x9E3779B97F4A7C15)
_HASH_C2 = np.uint64(0xFF51AFD7ED558CCD)


class _ResidentMirror:
    """Host mirror of the device-resident dictionary (untiered).

    A sorted view (u64/rows/pinned: the rank space the device shares) and
    a stable ID space probed through a vectorized open-addressing hash
    table (slot -> id, linear probing, load factor <= 1/4). Ids are
    append-only between resets; ``rank_of_id`` is rewritten on every
    insert so id -> current rank stays exact as inserts shift the rank
    space. Field names match the JAX mirror so a snapshot maps 1:1."""

    def __init__(self, rows: np.ndarray, capacity: int, delta_slots: int,
                 frag_threshold: float):
        self.capacity = int(capacity)
        self.delta_slots = int(delta_slots)
        self.frag_threshold = float(frag_threshold)
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
        }

    @property
    def n(self) -> int:
        return len(self.u64)

    def _hash(self, u64: np.ndarray) -> np.ndarray:
        h = u64[:, 0] * _HASH_C1
        for j in range(1, u64.shape[1]):
            h = (h ^ u64[:, j]) * _HASH_C2
        return ((h ^ (h >> np.uint64(33))) & np.uint64(self._mask)).astype(
            np.int64
        )

    def reset(self, u64, rows, last_used, pinned) -> None:
        """Rebuild every view from a fresh sorted key set (repack path)."""
        n = len(u64)
        self.u64, self.rows = u64, rows
        self.pinned = pinned
        self._n_ids = n
        self.u64_by_id[:n] = u64
        self.last_used_by_id[:n] = last_used  # ids == sorted pos at reset
        self.id_at = np.arange(n, dtype=np.int64)  # sorted pos -> id
        self.rank_of_id[:n] = np.arange(n)
        self.tab[:] = -1
        self._tab_insert(np.arange(n, dtype=np.int64))

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

    def insert_new(self, new_u64, new_rows, cv: int) -> np.ndarray:
        """Incremental sorted insert of delta keys; returns their ids."""
        m = len(new_u64)
        ins = _u64_searchsorted(self.u64, new_u64, "left")
        self.u64 = np.insert(self.u64, ins, new_u64, axis=0)
        self.rows = np.insert(self.rows, ins, new_rows, axis=0)
        self.pinned = np.insert(self.pinned, ins, False)
        new_ids = self._n_ids + np.arange(m, dtype=np.int64)
        self.u64_by_id[new_ids] = new_u64
        self.last_used_by_id[new_ids] = cv
        self._n_ids += m
        self.id_at = np.insert(self.id_at, ins, new_ids)
        self.rank_of_id[self.id_at] = np.arange(len(self.id_at))
        self._tab_insert(new_ids)
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
        """Opportunistic-repack trigger: mostly full AND mostly stale."""
        if self.n <= self.capacity // 2:
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
    window's rank leaves have a leading [k] axis; its delta has none."""

    delta_keys: np.ndarray  # int32 [M, W]
    ranks: tuple  # numpy RankBatch fields, in RankBatch order
    n_new: int  # real rows in delta_keys
    demand: int | tuple  # 2 * live write ranges (a window: one per step)


class PreparedWindow(NamedTuple):
    """A host-packed window awaiting ``dispatch_window``: pure host data,
    made by ``pack_wire_window`` (possibly on a packing thread)."""

    batch: object  # HostRankBatch, k-leading; or a deferred _RepackPlan
    cvs_rel: np.ndarray  # int32 [k] relative commit versions
    olds_rel: np.ndarray  # int32 [k] relative oldest versions
    count: int  # real txns per batch
    rebase_delta: int  # deferred device rebase; applied before dispatch


def upload(hb: HostRankBatch, device: torch.device) -> ck.ResidentBatch:
    """Copy a packed batch or window to ``device``: every int32 leaf in one
    buffer and every bool leaf in another, so a dispatch is two
    host-to-device copies that do not wait for the device."""
    leaves = [hb.delta_keys, *hb.ranks]
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
    return ck.ResidentBatch(delta_keys=out[0], ranks=ck.RankBatch(*out[1:]))


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


class TorchConflictSet:
    """Drop-in conflict engine: resolve(txns, commit_version) -> verdicts.

    ``device=None`` runs on ``cuda`` (and raises without a card);
    ``device="cpu"`` runs the plain torch versions. Only the default
    design point is ported: the arguments that select another design
    raise ``NotImplementedError`` naming the ROADMAP item that ports it."""

    def __init__(
        self,
        capacity: int = 1 << 16,
        batch_size: int = 512,
        max_read_ranges: int = 8,
        max_write_ranges: int = 8,
        max_key_bytes: int = 32,
        window_versions: int = DEFAULT_WINDOW_VERSIONS,
        delta_capacity: int | None = None,
        wave_commit: bool | None = None,
        resident: bool | None = None,
        dict_capacity: int | None = None,
        dict_delta_slots: int | None = None,
        dict_hot_capacity: int | None = None,
        spec_resolve: bool | None = None,
        device=None,
    ):
        for flag, value, item in (
            ("wave_commit=True", wave_commit, "Queue 1 item 6 (wave commit)"),
            ("resident=False", resident is False,
             "Queue 1 item 10 (design-matrix alternates)"),
            ("dict_hot_capacity>0", bool(dict_hot_capacity),
             "Queue 1 item 8 (tiered dictionary)"),
            ("spec_resolve=True", spec_resolve,
             "Queue 1 item 7 (speculative resolve)"),
        ):
            if value:
                raise NotImplementedError(
                    f"TorchConflictSet({flag}) is not ported yet: see "
                    f"ROADMAP.md {item}")
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
        self.host_syncs = 0  # device -> host reads, see the module docstring
        self._mirror = _ResidentMirror(
            self.codec.min_key[None, :], self.dict_capacity,
            self.dict_delta_slots, _DICT_FRAG,
        )
        self.state = ck.init_res(
            self._mirror.rows, self.dict_capacity, self.capacity,
            self.delta_capacity, self.device,
        )

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
        wb = ranks[2 * n_r : 2 * n_r + n_q].reshape(*lead, b, q)
        we = ranks[2 * n_r + n_q :].reshape(*lead, b, q)
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
            delta_keys=delta,
            ranks=(
                ranks[:n_r].reshape(*lead, b, r),
                ranks[n_r : 2 * n_r].reshape(*lead, b, r),
                np.asarray(bt.read_mask),
                wb,
                we,
                wm,
                np.asarray(bt.read_version),
                np.asarray(bt.txn_mask),
                paint_src,
            ),
            n_new=len(delta_rows),
            demand=demand,
        )

    def _pack_resident(self, bt: HostBatch, defer_repack: bool = False):
        """Rank-space pack against the mirror: classify every endpoint as
        hit or miss, emit the sorted-unique misses as the dictionary delta
        and rewrite endpoints as ranks into the post-insert dictionary. A
        window ([k]-leading batch) is ranked as a whole against the
        dictionary after its whole delta.

        Overflow or fragmentation forces a full repack, which reads the
        device: inline, or with ``defer_repack`` (the window path's
        packing thread) returned as a _RepackPlan for ``dispatch_window``
        to run, with the mirror's gate cleared so the next pack waits."""
        mir = self._mirror
        mir.gate.wait()
        flat, dims = self._flat_endpoints(bt)
        qu = _rows_to_u64(flat)
        pad = _rows_to_u64(np.full((1, dims[-1]), INT32_MAX, np.int32))[0]
        is_pad = qu[:, 0] == pad[0]
        for j in range(1, qu.shape[1]):
            is_pad &= qu[:, j] == pad[j]
        ids = mir.probe(qu, ~is_pad)
        found = ids >= 0
        miss = ~found & ~is_pad
        mi = np.flatnonzero(miss)
        if mi.size:
            new_u64, new_rows = _u64_unique_sorted(qu[mi], flat[mi])
        else:
            new_u64 = np.zeros((0, qu.shape[1]), np.uint64)
            new_rows = np.zeros((0, dims[-1]), np.int32)
        m = len(new_u64)
        cv = self._last_commit
        if (m > self.dict_delta_slots or mir.n + m > mir.capacity
                or mir.frag_due(self.oldest_version)):
            plan = _RepackPlan(bt, qu, is_pad, new_u64, new_rows, dims, cv)
            if defer_repack:
                mir.gate.clear()
                mir.stats["repack_stalls"] += 1
                return plan
            return self._repack_and_rank(plan)
        with mir.lock:
            mir.touch(ids[found], cv)
            if m:
                pos = _u64_searchsorted(new_u64, qu[mi], "left")
                new_ids = mir.insert_new(new_u64, new_rows, cv)
                ids[mi] = new_ids[pos]
            ranks = mir.rank_of_id[np.maximum(ids, 0)].astype(np.int32)
            ranks[is_pad | (ids < 0)] = INT32_MAX
            st = mir.stats
            st["dispatches"] += 1
            st["endpoints"] += int((~is_pad).sum())
            st["endpoint_hits"] += int(found.sum())
            fid = ids[found]
            uniq_found = (
                int(np.bincount(fid, minlength=1).astype(bool).sum())
                if fid.size else 0
            )
            st["unique_keys"] += m + uniq_found
            st["delta_new_keys"] += m
        return self._ranks_to_batch(bt, ranks, dims, new_rows)

    def _device_live_ranks(self) -> np.ndarray:
        """Every rank the device history still references (one sync)."""
        hist = self.state.hist
        ranks = torch.cat([hist.base.keys.reshape(-1),
                           hist.delta.keys.reshape(-1)]).cpu().numpy()
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
        return self._ranks_to_batch(
            plan.bt, ranks, plan.dims,
            np.zeros((0, plan.dims[-1]), np.int32),
        )

    @property
    def dict_stats(self) -> dict:
        """Dictionary-economics counters: unique keys/dispatch, delta hit
        rate, evictions, forced full repacks."""
        s = dict(self._mirror.stats)
        d = max(1, s["dispatches"])
        e = max(1, s["endpoints"])
        s.update(
            resident_keys=self._mirror.n,
            dict_capacity=self._mirror.capacity,
            delta_slots=self.dict_delta_slots,
            unique_keys_per_dispatch=round(s["unique_keys"] / d, 1),
            delta_hit_rate=round(s["endpoint_hits"] / e, 4),
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
        self._begin_resolve(commit_version, oldest_version)
        cv = self._rel(commit_version)
        oldest = self._rel(self.oldest_version)
        pending: list[tuple] = []
        for i in range(0, len(txns), self.batch_size):
            chunk = txns[i : i + self.batch_size]
            report = any(t.report_conflicting_keys for t in chunk)
            batch, reads = self._pack(chunk)
            # Pack BEFORE reading self.state: a repack inside the packer
            # replaces it.
            hb = self._pack_resident(batch)
            out = ck.resolve_batch_res(
                self.state, upload(hb, self.device), cv, oldest,
                report=report, n_new=hb.n_new, demand=hb.demand)
            self.state = out[-1]
            losers = out[1] if report else None
            flags = [t.report_conflicting_keys for t in chunk]
            pending.append((out[0], len(chunk), losers, reads, flags))
        return lambda: self._collect(pending)

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
        self._begin_resolve(commit_version, oldest_version)
        cv = self._rel(commit_version)
        oldest = self._rel(self.oldest_version)
        pending: list[tuple] = []
        offset, remaining = 0, count
        while remaining > 0:
            n = min(remaining, self.batch_size)
            batch, offset = self._pack_wire(buf, offset, n)
            hb = self._pack_resident(batch)  # may repack: before self.state
            out = ck.resolve_batch_res(
                self.state, upload(hb, self.device), cv, oldest,
                n_new=hb.n_new, demand=hb.demand)
            self.state = out[-1]
            pending.append((out[0], n, None, None, None))
            remaining -= n
        if as_array:
            def collect_array() -> np.ndarray:
                self.host_syncs += len(pending)
                return np.concatenate(
                    [v.cpu().numpy()[:n] for v, n, *_ in pending]
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
            offset = 0
            for i in range(k):
                offset = native.pack_batch(
                    buf, offset, count, self.codec.n_words, self.base_version,
                    HostBatch(*(a[i] for a in batches)))
                if offset < 0:
                    raise ValueError("malformed resolver wire batch")
            batch = self._pack_resident(batches, defer_repack=True)
        except BaseException:
            self.base_version, self.oldest_version, self._last_commit = snap
            raise
        return PreparedWindow(batch=batch, cvs_rel=cvs_rel, olds_rel=olds_rel,
                              count=count, rebase_delta=rebase_delta)

    def dispatch_window(self, prepared: PreparedWindow
                        ) -> Callable[[], np.ndarray]:
        """Device half of the window path, on the dispatching thread in
        pack order: the deferred rebase, then the deferred repack (exact
        here, since every earlier window has dispatched), then one upload
        and the window's launch sequence. The collector makes the
        window's one device-to-host read: int8 verdicts [k, count]."""
        if prepared.rebase_delta:
            self.state = ck.rebase_res(
                self.state, min(prepared.rebase_delta, 2**31 - 1))
        hb = prepared.batch
        if isinstance(hb, _RepackPlan):
            hb = self._repack_and_rank(hb)
        verdicts, self.state = ck.resolve_many_res(
            self.state, upload(hb, self.device), prepared.cvs_rel,
            prepared.olds_rel, n_new=hb.n_new, demands=hb.demand)

        def collect() -> np.ndarray:
            self.host_syncs += 1
            return verdicts.cpu().numpy()[:, : prepared.count]

        return collect

    def _collect(self, pending: list[tuple]) -> list[Verdict]:
        out: list[Verdict] = []
        self.last_conflicting = {}
        gi = 0
        for verdicts, n, losers, reads, flags in pending:
            v = verdicts.cpu().numpy()[:n]
            self.host_syncs += 1
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
    def overflowed(self) -> bool:
        h = self.state.hist
        flags = torch.stack([h.base.overflow, h.delta.overflow]).cpu()
        self.host_syncs += 1
        return bool(flags.any())

    def headroom(self) -> int:
        """Free boundary slots (one device sync): room in the merged base
        and a delta that can absorb one whole batch. The Resolver compares
        it with :meth:`worst_case_growth` before every batch."""
        h = self.state.hist
        used = torch.stack([h.base.n_used, h.delta.n_used]).cpu()
        self.host_syncs += 1
        return min(self.capacity - int(used.sum()), self.delta_capacity)

    def worst_case_growth(self, n_txns: int) -> int:
        """Upper bound on boundary-slot growth from resolving n_txns."""
        return 2 * n_txns * self.max_write_ranges

    def clear_overflow(self) -> None:
        """Reset the sticky device overflow flags (in place)."""
        h = self.state.hist
        h.base.overflow.fill_(False)
        h.delta.overflow.fill_(False)

    def advance(self, commit_version: int,
                oldest_version: int | None = None) -> None:
        """GC-only dispatch: move the version chain and floor forward
        without painting writes, forcing a fold so headroom recovers."""
        self._begin_resolve(commit_version, oldest_version)
        oldest = self._rel(self.oldest_version)
        self.state = self.state._replace(hist=ck.advance_hist(
            self.state.hist, self._rel(commit_version), oldest))

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
