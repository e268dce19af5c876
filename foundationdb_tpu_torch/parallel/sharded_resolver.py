"""Multi-resolver conflict detection: S keyspace shards on one card.

The port of ``foundationdb_tpu/parallel/sharded_resolver.py``'s
``ShardedConflictSet``, resident and non-resident. The reference scales
resolution by sharding the keyspace across Resolver processes (a txn
commits only if every resolver reports no conflict); the JAX engine runs
that as one SPMD program over a mesh of devices. Here the S shards are a
leading axis of one device state on one card (``models/conflict_kernel.
py``, section B3): one shared dictionary, one flat rank-space history per
shard, the shard bounds kept as ranks in the state so that dictionary
inserts shift them like history ranks. A step clips the batch to every shard (K9), ORs the shards'
history conflicts (K8), accepts on the unclipped batch (K3) or, on a
wave engine, levels the OR of the shards' clipped predecessor matrices
(K5, K10, K6), and paints each shard's clipped writes (K4).

The non-resident engine (``resident=False``, the JAX ``_sharded_resolve``
body) keeps no dictionary: the batch goes to the card as full [B, ., W]
key rows (the host pack is the wire pack alone) and each shard holds a
flat [C, W] word-key history that starts with one boundary at its lower
bound (``models/conflict_kernel.py``, section B5 flat and B3
non-resident). A step probes every shard's clipped reads with the
cross-shard OR (K16, over each shard's live rows), ranks the batch's endpoints by
sorting them on the card (K14) for K3, or on a wave engine ranks each
shard's clipped endpoints for K5 before K10 and K6, clips the writes to
every shard (K15) and paints each shard (K13, K12, K14). The shard bounds
are [S, W] key rows on the card, replaced by ``reshard``, which
redistributes the downloaded histories on the host
(``_redistribute_history``, a copy of the JAX one).

Every host behaviour is ``TorchConflictSet``'s; this module adds the
split helpers (numpy only, copies of the JAX ones), the density-reshard
policy (``auto_reshard``), the scoped ``reshard``, and the wave-exchange
accounting (``exchange_stats``). The conflicting-keys report degrades as
in JAX: a sharded engine has no report launch, so ``last_conflicting``
stays empty.
"""

from __future__ import annotations

import numpy as np
import torch

from foundationdb_tpu_torch.core.keypack import INT32_MAX, KeyCodec, row_sort_keys
from foundationdb_tpu_torch.models import conflict_kernel as ck
from foundationdb_tpu_torch.models.conflict_set import (
    _DICT_FRAG,
    HostBatch,
    TorchConflictSet,
    _ResidentMirror,
    _rows_to_u64,
    _u64_searchsorted,
    _u64_unique_sorted,
    upload_keys,
)

#: auto-reshard defaults: check the occupancy skew every N dispatches and
#: re-split when max/min exceeds the threshold.
AUTO_RESHARD_INTERVAL = 8
AUTO_RESHARD_SKEW = 4.0


def uniform_splits(codec: KeyCodec, n_shards: int) -> np.ndarray:
    """[n_shards+1, W] shard bounds: uniform first-byte split of the
    keyspace (bounds[0] = b"", bounds[-1] = the +inf sentinel)."""
    return pack_splits(codec, interior_uniform(n_shards))


def interior_uniform(n_shards: int) -> list[bytes]:
    return [bytes([(d * 256) // n_shards]) for d in range(1, n_shards)]


def pack_splits(codec: KeyCodec, interior: list[bytes]) -> np.ndarray:
    """[(len(interior)+2), W] bounds array from interior split keys."""
    packed = codec.pack([b""] + list(interior), "begin")
    return np.concatenate([packed, codec.inf_key[None, :]], axis=0)


def density_splits(n_shards: int, sample_keys: list[bytes]) -> list[bytes]:
    """Interior split keys at the quantiles of an observed key sample, so
    each shard sees about the same key population. Falls back to uniform
    prefixes when the sample is too small or too concentrated to yield
    n_shards distinct quantiles."""
    ks = sorted(set(sample_keys))
    if len(ks) < 2 * n_shards:
        return interior_uniform(n_shards)
    interior: list[bytes] = []
    for d in range(1, n_shards):
        q = ks[(d * len(ks)) // n_shards]
        if interior and q <= interior[-1]:
            return interior_uniform(n_shards)  # degenerate sample
        interior.append(q)
    if interior[0] == b"":
        return interior_uniform(n_shards)
    return interior


class ShardedConflictSet(TorchConflictSet):
    """``TorchConflictSet`` resolving over ``n_shards`` keyspace shards of
    one card; ``capacity`` is per shard and ``batch_size`` must be a
    multiple of ``n_shards``. ``splits`` are the n_shards - 1 interior
    split keys (default: uniform first-byte prefixes).

    Density resharding is the default (``auto_reshard=True``): every
    ``reshard_interval`` dispatches the engine reads its per-shard history
    occupancy and, when max/min exceeds ``reshard_skew``, re-splits the
    keyspace at the quantiles of the live history boundaries between
    dispatches. The policy splits at resident keys only, so it shifts no
    rank; it waits for a later interval while a packed window's
    dictionary delta has not reached the card (the JAX engine reshards
    there against a mirror that is ahead of the device). Harnesses that
    compare split policies pass ``auto_reshard=False``.

    ``resident=False`` gives the non-resident engine (flat [C, W]
    histories, full-key batches; see the module docstring); its reshard
    and auto-reshard redistribute the histories on the host and never
    wait for a packed window.

    The design arms, as on ``TorchConflictSet``: ``rmq="blocked"`` takes
    each shard's range max from K17's blocked structure, built over every
    shard's live rows, in place of the live table of K8 and K16 (resident
    and non-resident); ``packed=False`` forces ``resident`` (and
    speculation) off, as JAX does under FDB_TPU_PACKED=0, so it runs the
    non-resident engine, whose cross-shard OR and acceptance (K3: the
    exact sequential result of either acceptance form) need nothing else.
    Each shard's history is flat under either ``history``, as in JAX, and
    ``accept="seq"`` runs K3 as ``"wave"`` does.

    Not ported: ``spec_resolve=True`` (ROADMAP.md Queue 1 item 15), which
    raises ``NotImplementedError``."""

    #: bytes of one 32x32-bit predecessor tile (32 rows x 1 uint32 word).
    EXCHANGE_TILE_BYTES = 128
    #: fold the pending exchange stats into the account past this many
    #: dispatches (bounds the list and the device buffers it holds).
    EXCHANGE_FOLD_AT = 256
    #: no report launch: ``last_conflicting`` stays empty, as in JAX.
    can_report = False

    def __init__(self, n_shards: int, splits: list[bytes] | None = None,
                 auto_reshard: bool = True,
                 reshard_interval: int = AUTO_RESHARD_INTERVAL,
                 reshard_skew: float = AUTO_RESHARD_SKEW, **kw):
        # Under packed=False speculation is forced off (inert), as in JAX.
        if kw.get("spec_resolve") and kw.get("packed", True) is not False:
            raise NotImplementedError(
                "ShardedConflictSet(spec_resolve=True) is not ported yet: "
                "speculation on a sharded engine is ROADMAP.md Queue 1 "
                "item 15")
        n_shards = int(n_shards)
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, not {n_shards}")
        if splits is not None and len(splits) != n_shards - 1:
            raise ValueError(
                f"need {n_shards - 1} interior splits, got {len(splits)}")
        self.n_shards = n_shards
        self._interior_splits = list(splits) if splits is not None else None
        self.auto_reshard = bool(auto_reshard)
        self.reshard_interval = max(1, int(reshard_interval))
        self.reshard_skew = reshard_skew
        self.auto_reshards = 0  # re-splits the default policy performed
        self._dispatches = 0
        # Wave engines: per-dispatch (occupied tiles, dense tiles) device
        # stats, folded lazily by exchange_stats() (one read per fold).
        self._exchange_pending: list[torch.Tensor] = []
        self._exchange_acc = [0, 0, 0]  # occupied, total, batches
        self._empty_rb = None  # advance()'s packed empty batch, made lazily
        super().__init__(**kw)

    # -- device programs ------------------------------------------------------

    def _init_engine(self) -> None:
        """Resident: the mirror seeded with the S shard lower bounds
        (pinned, so no repack evicts one) and the sharded state.
        Non-resident: no mirror, S flat [C, W] histories and the bounds as
        [S, W] key rows on the card."""
        if self.batch_size % self.n_shards:
            raise ValueError("batch_size must be divisible by n_shards")
        bounds = pack_splits(
            self.codec, self._interior_splits
            if self._interior_splits is not None
            else interior_uniform(self.n_shards))
        self._lo = np.ascontiguousarray(bounds[:-1])  # [S, W]
        self._hi = np.ascontiguousarray(bounds[1:])
        self.reshard_moved_shards = 0  # scoped-repack economy counter
        if not self.resident:
            self._mirror = None
            self.state = ck.init_flat_shards(self.capacity, self.codec.width,
                                             self._lo, self.device)
            self._set_bounds(self._lo, self._hi)
            return
        self._mirror = _ResidentMirror(
            self._lo, self.dict_capacity, self.dict_delta_slots, _DICT_FRAG,
            tiered=self.tiered)
        self.state = ck.init_sharded_res(self._lo, self.dict_capacity,
                                         self.capacity, self.device)

    def _set_bounds(self, lo: np.ndarray, hi: np.ndarray) -> None:
        """The non-resident engine's [S, W] bound rows on the card (runtime
        arguments of its programs, so a reshard swaps them)."""
        self._lo_dev = torch.from_numpy(np.array(lo, np.int32)).to(
            self.device)
        self._hi_dev = torch.from_numpy(np.array(hi, np.int32)).to(
            self.device)

    def _pack_batch(self, bt: HostBatch, defer_repack: bool = False):
        """Non-resident: the key rows themselves (the JAX ``_dev_batch`` is
        the identity there); resident: the rank-space pack."""
        if self.resident:
            return super()._pack_batch(bt, defer_repack)
        return bt

    def _upload(self, hb):
        if self.resident:
            return super()._upload(hb)
        return upload_keys(hb, self.device)

    def _batch_program(self, rb, hb, cv, oldest, report, out) -> tuple:
        wave = self.wave_commit
        if self.resident:
            v, lv, x, state = ck.sharded_resolve_res(
                self.state, rb, cv, oldest, n_new=hb.n_new, wave=wave,
                stats=self._wave_stats, out=out, rmq=self.rmq)
        else:
            v, lv, x, state = ck.sharded_resolve(
                self.state, rb, cv, oldest, self._lo_dev, self._hi_dev, wave,
                self._wave_stats, out.verdicts[0],
                out.levels[0] if wave else None, rmq=self.rmq)
        if x is not None:
            self._note_exchange(x)
        return (v, lv, state) if wave else (v, state)

    def _window_program(self, rb, hb, cvs_rel, olds_rel, out):
        if self.resident:
            *_, x, state = ck.sharded_resolve_res_many(
                self.state, rb, cvs_rel, olds_rel, n_new=hb.n_new,
                wave=self.wave_commit, stats=self._wave_stats, out=out,
                rmq=self.rmq)
        else:
            *_, x, state = ck.sharded_resolve_many(
                self.state, rb, cvs_rel, olds_rel, self._lo_dev,
                self._hi_dev, self.wave_commit, self._wave_stats, out,
                rmq=self.rmq)
        if x is not None:
            self._note_exchange(x)
        return state

    # -- wave-exchange accounting ---------------------------------------------

    def _note_exchange(self, stats: torch.Tensor) -> None:
        self._exchange_pending.append(stats)
        if len(self._exchange_pending) >= self.EXCHANGE_FOLD_AT:
            self._fold_exchange()

    def _fold_exchange(self) -> None:
        """One device read for every pending dispatch's stats."""
        if not self._exchange_pending:
            return
        a = torch.cat([s.reshape(-1, 2) for s in self._exchange_pending]
                      ).cpu().numpy().astype(np.int64)
        self.host_syncs += 1
        self._exchange_acc[0] += int(a[:, 0].sum())
        self._exchange_acc[1] += int(a[:, 1].sum())
        self._exchange_acc[2] += int(a.shape[0])
        self._exchange_pending.clear()

    def exchange_stats(self) -> dict:
        """The wave exchange's economics since construction (folds the
        pending stats: one device read): ``tiles_occupied``, the non-zero
        32x32-bit predecessor tiles summed over the shards (what a
        tile-scoped exchange would move), ``tiles_total``, the dense
        exchange's tiles, and both in bytes per batch."""
        self._fold_exchange()
        occ, tot, batches = self._exchange_acc
        per = max(1, batches)
        return {
            "wave_batches": batches,
            "tiles_occupied": occ,
            "tiles_total": tot,
            "tile_bytes": self.EXCHANGE_TILE_BYTES,
            "exchange_bytes_per_batch_scoped": round(
                occ * self.EXCHANGE_TILE_BYTES / per),
            "exchange_bytes_per_batch_dense": round(
                tot * self.EXCHANGE_TILE_BYTES / per),
            "tile_occupancy": round(occ / max(1, tot), 4),
        }

    # -- density resharding as the default policy -----------------------------

    def resolve_async(self, txns, commit_version, oldest_version=None):
        self._maybe_auto_reshard()
        return super().resolve_async(txns, commit_version, oldest_version)

    def resolve_wire_async(self, wire, commit_version, oldest_version=None,
                           count=None, as_array=False):
        self._maybe_auto_reshard()
        return super().resolve_wire_async(wire, commit_version,
                                          oldest_version, count, as_array)

    def dispatch_window(self, prepared):
        # Non-resident: before the dispatch, as in JAX (a reshard touches
        # only device state, which no pack reads). Resident: after the
        # dispatch, so that this window's delta is on the card; a younger
        # window already packed defers the policy (see _reshard_resident).
        if not self.resident:
            self._maybe_auto_reshard()
            return super().dispatch_window(prepared)
        collect = super().dispatch_window(prepared)
        self._maybe_auto_reshard()
        return collect

    def _maybe_auto_reshard(self) -> None:
        """Between dispatches: when the per-shard occupancy skew exceeds
        the threshold, move the bounds to the live-history quantiles. The
        occupancy probe is one device read every ``reshard_interval``
        dispatches."""
        if not self.auto_reshard:
            return
        self._dispatches += 1
        if self._dispatches % self.reshard_interval:
            return
        occ = self.shard_occupancy()
        if max(occ) <= self.reshard_skew * max(1, min(occ)):
            return
        splits = self.density_splits_from_history()
        if splits is None:
            return
        if not self.resident:
            self._reshard_flat(splits)
        elif not self._reshard_resident(splits, auto=True):
            return
        self.auto_reshards += 1

    @property
    def _flat(self) -> ck.ConflictState:
        """The S flat shard histories (the non-resident engine's whole
        state)."""
        return self.state.hist if self.resident else self.state

    def shard_occupancy(self) -> list[int]:
        """Live history boundaries per shard (one device read): the load
        balance the density splits are judged by."""
        used = self._flat.n_used.cpu()
        self.host_syncs += 1
        return [int(x) for x in used]

    def density_splits_from_history(self) -> list[bytes] | None:
        """Interior split keys at the quantiles of the LIVE history
        boundaries (``density_splits`` over the device's boundary ranks,
        mapped to keys through the mirror, so every candidate split key is
        already resident). None when the history is too small or too
        concentrated to yield n_shards - 1 distinct keys. One device read.
        Non-resident: the boundary rows are the keys themselves."""
        h = self._flat
        s = self.n_shards
        a = torch.cat([h.n_used, h.keys.reshape(-1)]).cpu().numpy()
        self.host_syncs += 1
        n_used = a[:s]
        nw = self.codec.n_words
        sample: list[bytes] = []
        if not self.resident:
            keys = a[s:].reshape(s, -1, self.codec.width)
            for d in range(s):
                for row in keys[d, : int(n_used[d])]:
                    if int(row[nw]) < int(INT32_MAX):  # +inf is no split
                        sample.append(self.codec.unpack(row))
        else:
            keys = a[s:].reshape(s, -1)
            mir = self._mirror
            with mir.lock:
                rows = mir.rows
                n_mir = len(rows)
                for d in range(s):
                    for r in keys[d, : int(n_used[d])]:
                        r = int(r)
                        if r >= n_mir or int(rows[r][nw]) >= int(INT32_MAX):
                            continue
                        sample.append(self.codec.unpack(rows[r]))
        if len(sample) < 2 * s:
            return None
        splits = density_splits(s, sample)
        return None if splits == interior_uniform(s) else splits

    def reshard(self, splits: list[bytes]) -> None:
        """Re-split the keyspace between dispatch windows: a scoped repack
        of the moved shards (the histories are rank arrays, so the
        redistribution is int32 slicing at the new bound ranks). Split
        keys not yet resident are inserted into the mirror and the
        dictionary with the rank shift a delta merge applies, so every
        packed window must have been dispatched first; one that has not
        raises ``ValueError``. Verdicts are unchanged; only the per-shard
        load moves. Non-resident: the histories are downloaded, re-clipped
        to the new bounds on the host and uploaded (every shard moves)."""
        if len(splits) != self.n_shards - 1:
            raise ValueError(
                f"need {self.n_shards - 1} interior splits, got {len(splits)}")
        if not self.resident:
            self._reshard_flat(splits)
            return
        self._reshard_resident(splits)

    def _reshard_flat(self, splits: list[bytes]) -> None:
        """The JAX non-resident ``reshard`` (:692-713): one device read of
        the flat histories, ``_redistribute_history`` to the new bounds
        (sticky overflow: a shard that no longer fits its capacity is cut
        there and flagged), one upload."""
        st = self.state
        s, c, w = st.keys.shape
        flat = torch.cat([st.keys.reshape(-1), st.versions.reshape(-1),
                          st.n_used, st.overflow.to(torch.int32)]
                         ).cpu().numpy()
        self.host_syncs += 1
        sc = s * c
        keys = flat[:sc * w].reshape(s, c, w)
        vers = flat[sc * w:sc * (w + 1)].reshape(s, c)
        n_used = flat[sc * (w + 1):sc * (w + 1) + s]
        over = flat[sc * (w + 1) + s:].astype(bool)
        bounds = pack_splits(self.codec, splits)
        lo = np.ascontiguousarray(bounds[:-1])
        hi = np.ascontiguousarray(bounds[1:])
        nk, nv, nu, nover = _redistribute_history(keys, vers, n_used, lo, hi,
                                                  self.capacity)
        dev = self.device

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        self.state = ck.ConflictState(
            keys=t(nk), versions=t(nv), n_used=t(nu.astype(np.int32)),
            oldest=st.oldest, overflow=t(over | nover))
        self._interior_splits = list(splits)
        self._lo, self._hi = lo, hi
        self._set_bounds(lo, hi)

    def _reshard_resident(self, splits: list[bytes],
                          auto: bool = False) -> bool:
        """The JAX ``_reshard_resident`` under the mirror's lock, after one
        device read of the state. A packed window whose delta has not
        reached the card (the device's key count behind the mirror's, or a
        deferred repack or demotion holding the gate) would be ranked
        against other bounds: the auto policy then returns False and tries
        again at a later interval, an explicit reshard raises. The gate is
        held closed while the mirror changes, so a pack that starts
        meanwhile waits."""
        mir = self._mirror
        s = self.n_shards
        with mir.lock:
            st = self.state
            h = st.hist
            c = h.keys.shape[1]
            flat = torch.cat([
                h.keys.reshape(-1), h.versions.reshape(-1), h.n_used,
                h.overflow.to(torch.int32), st.shard_lo, st.shard_hi,
                st.n_keys.reshape(1)]).cpu().numpy()
            self.host_syncs += 1
            if int(flat[-1]) != mir.n or not mir.gate.is_set():
                if auto:
                    return False
                raise ValueError(
                    "reshard with a packed window awaiting dispatch: "
                    "dispatch every packed window first")
            mir.gate.clear()
            try:
                self._redistribute(splits, flat, c, h.oldest, st.dict_keys)
            finally:
                mir.gate.set()
        return True

    def _redistribute(self, splits, flat, c: int, oldest, dict_keys) -> None:
        """The body of the JAX ``_reshard_resident`` on the downloaded
        state ``flat`` (keys, versions, n_used, overflow, shard_lo,
        shard_hi, n_keys); uploads the new state."""
        mir = self._mirror
        s = self.n_shards
        sc = s * c
        keys = flat[:sc].reshape(s, c, 1)
        vers = flat[sc:2 * sc].reshape(s, c)
        o = 2 * sc
        n_used = flat[o:o + s].astype(np.int64)
        over = flat[o + s:o + 2 * s].astype(bool)
        old_lo = flat[o + 2 * s:o + 3 * s].astype(np.int64)
        old_hi = flat[o + 3 * s:o + 4 * s].astype(np.int64)
        bounds = pack_splits(self.codec, splits)
        brows = np.ascontiguousarray(bounds[:-1])  # S lo rows
        bu = _rows_to_u64(brows)
        pos = _u64_searchsorted(mir.u64, bu, "left")
        cand = np.minimum(pos, max(mir.n - 1, 0))
        foundb = (pos < mir.n) & (mir.u64[cand] == bu).all(axis=1)
        dict_dev = None
        if not foundb.all():
            # Insert the missing bound keys; shift every downloaded rank
            # (histories and old bounds) past the insertions.
            new_u, new_rows = _u64_unique_sorted(bu[~foundb], brows[~foundb])
            ins = _u64_searchsorted(mir.u64, new_u, "left")
            if mir.n + len(new_u) > mir.capacity:
                raise ValueError(
                    "resident dictionary full: cannot insert reshard bound "
                    "keys; raise dict_capacity")
            shift = _u64_searchsorted(new_u, mir.u64, "left").astype(np.int32)
            mir.reset(
                np.insert(mir.u64, ins, new_u, axis=0),
                np.insert(mir.rows, ins, new_rows, axis=0),
                np.insert(mir.used_sorted(), ins, self._last_commit),
                np.insert(mir.pinned, ins, True),
            )

            def sh(r):
                r = np.asarray(r, np.int64)
                out = r + shift[np.clip(r, 0, len(shift) - 1)]
                return np.where(r == INT32_MAX, r, out)

            keys = np.where(keys == INT32_MAX, keys, sh(keys).astype(np.int32))
            old_lo, old_hi = sh(old_lo), sh(old_hi)
            dict_dev = np.full((mir.capacity + 1, self.codec.width),
                               INT32_MAX, np.int32)
            dict_dev[: mir.n] = mir.rows
        lo_ranks = _u64_searchsorted(mir.u64, bu, "left").astype(np.int64)
        hi_ranks = np.concatenate([lo_ranks[1:],
                                   np.full(1, INT32_MAX, np.int64)])
        # Only the bounds (and the keyspace minimum) stay pinned.
        pinned = np.zeros(mir.n, bool)
        pinned[np.clip(lo_ranks, 0, mir.n - 1)] = True
        mir.pinned = pinned

        glob_r = np.concatenate(
            [keys[d, : n_used[d], 0] for d in range(s)]).astype(np.int64)
        glob_v = np.concatenate([vers[d, : n_used[d]] for d in range(s)])
        new_keys = np.full_like(keys, INT32_MAX)
        new_vers = np.full_like(vers, ck.NEG_VERSION)
        new_used = np.zeros(s, np.int32)
        new_over = over.copy()
        moved = 0
        for d in range(s):
            if lo_ranks[d] == old_lo[d] and hi_ranks[d] == old_hi[d]:
                # Unmoved shard: its arrays carry over byte for byte.
                new_keys[d] = keys[d]
                new_vers[d] = vers[d]
                new_used[d] = n_used[d]
                continue
            moved += 1
            i0 = int(np.searchsorted(glob_r, lo_ranks[d], side="right")) - 1
            i1 = int(np.searchsorted(glob_r, hi_ranks[d], side="left"))
            seg_r = glob_r[i0:i1].copy()
            seg_v = glob_v[i0:i1].copy()
            seg_r[0] = lo_ranks[d]  # boundary exactly at the shard's lo
            n = len(seg_r)
            if n > self.capacity:
                new_over[d] = True
                seg_r, seg_v, n = (seg_r[: self.capacity],
                                   seg_v[: self.capacity], self.capacity)
            new_keys[d, :n, 0] = seg_r.astype(np.int32)
            new_vers[d, :n] = seg_v
            new_used[d] = n
        self.reshard_moved_shards += moved

        dev = self.device

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        self.state = ck.ResState(
            dict_keys=dict_keys if dict_dev is None else t(dict_dev),
            n_keys=torch.full((), mir.n, dtype=torch.int32, device=dev),
            hist=ck.ConflictState(keys=t(new_keys), versions=t(new_vers),
                                  n_used=t(new_used), oldest=oldest,
                                  overflow=t(new_over)),
            shard_lo=t(lo_ranks.astype(np.int32)),
            shard_hi=t(np.minimum(hi_ranks, INT32_MAX).astype(np.int32)),
        )
        self._interior_splits = list(splits)
        self._lo = brows
        self._hi = np.ascontiguousarray(bounds[1:])

    # -- the flat history's host reads ---------------------------------------

    @property
    def wave_global_capable(self) -> bool:
        """False: the shards exchange on the card; to the role this is one
        resolver (the JAX sharded engine reports the same)."""
        return False

    @property
    def overflowed(self) -> bool:
        flags = self._flat.overflow.cpu()
        self.host_syncs += 1
        return bool(flags.any())

    def headroom(self) -> int:
        """Free boundary slots in the tightest shard (one device read)."""
        used = int(self._flat.n_used.max())
        self.host_syncs += 1
        return self.capacity - used

    def clear_overflow(self) -> None:
        self._flat.overflow.fill_(False)

    def advance(self, commit_version: int,
                oldest_version: int | None = None) -> None:
        """GC-only dispatch: an empty batch resolved at ``commit_version``
        (the JAX flat-history advance), so the floor moves and expired
        segments compact out of every shard."""
        self._begin_resolve(commit_version, oldest_version)
        cv = self._rel(commit_version)
        oldest = self._rel(self.oldest_version)
        if self._empty_rb is None:
            hb = self._pack_batch(self._empty_batch())
            self._empty_rb = (hb, self._upload(hb))
        hb, rb = self._empty_rb
        out = ck.window_out(1, self.batch_size, self.device, self.wave_commit)
        self.state = self._batch_program(rb, hb, cv, oldest, False, out)[-1]


def _redistribute_history(
    keys: np.ndarray, vers: np.ndarray, n_used: np.ndarray,
    lo: np.ndarray, hi: np.ndarray, capacity: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Re-clip a sharded step-function history to new shard bounds (a copy
    of the JAX host function, :851-888).

    keys/vers: [S, C, W]/[S, C] per-shard histories whose live prefixes
    concatenate to the global sorted boundary list. Returns (keys',
    vers', n_used', overflow') for the bounds lo/hi [S, W]: each shard's
    segment starts with its lower bound (the version of the segment that
    contains it carries over) and is cut at ``capacity`` with overflow
    set."""
    d_n, _, _ = keys.shape
    glob_k = np.concatenate([keys[d, : n_used[d]] for d in range(d_n)])
    glob_v = np.concatenate([vers[d, : n_used[d]] for d in range(d_n)])
    gsort = row_sort_keys(glob_k)
    new_keys = np.full_like(keys, ck.INT32_MAX)
    new_vers = np.full_like(vers, ck.NEG_VERSION)
    new_used = np.zeros(d_n, np.int32)
    new_over = np.zeros(d_n, bool)
    for d in range(d_n):
        lo_sk = row_sort_keys(lo[d : d + 1])[0]
        hi_sk = row_sort_keys(hi[d : d + 1])[0]
        i0 = np.searchsorted(gsort, lo_sk, side="right") - 1
        i1 = np.searchsorted(gsort, hi_sk, side="left")
        seg_k = glob_k[i0:i1].copy()
        seg_v = glob_v[i0:i1].copy()
        seg_k[0] = lo[d]
        n = len(seg_k)
        if n > capacity:
            new_over[d] = True
            seg_k, seg_v, n = seg_k[:capacity], seg_v[:capacity], capacity
        new_keys[d, :n] = seg_k
        new_vers[d, :n] = seg_v
        new_used[d] = n
    return new_keys, new_vers, new_used, new_over


__all__ = ["ShardedConflictSet", "uniform_splits", "density_splits",
           "pack_splits", "interior_uniform"]
