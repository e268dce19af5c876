"""Read-your-writes transaction layer.

A copy of ``foundationdb_tpu/client/ryw.py`` for the port, its imports rewritten to
the port's modules; names and behaviour are the JAX module's.

Reference: fdbclient/ReadYourWrites.actor.cpp — the default client surface.
Reads observe the transaction's own uncommitted writes overlaid on the
snapshot: sets and clears resolve locally without touching storage (and
without adding read conflict ranges, like the reference's known-value
fast path); atomic ops on unknown base values read through, then fold the
pending operations on top.

Overlay model: per-key entries updated in program order — an entry is
either ("value", v) when the outcome is locally known, or ("ops", [...])
when atomic ops await the base value — plus the union of cleared ranges
to suppress snapshot rows with no later entry.
"""

from __future__ import annotations

from foundationdb_tpu_torch.client.transaction import Database, KeySelector, Transaction
from foundationdb_tpu_torch.core.errors import FdbError
from foundationdb_tpu_torch.core.mutations import MutationType, apply_atomic
from foundationdb_tpu_torch.core.types import KeyRange


def _unreadable() -> FdbError:
    # Reference: accessed_unreadable (1036) — reading a versionstamped value.
    return FdbError("read of versionstamped value", code=1036)


class RYWTransaction(Transaction):
    def _reset(self) -> None:
        super()._reset()
        self._overlay: dict[bytes, tuple[str, object]] = {}
        self._clears: list[KeyRange] = []

    def set_option(self, name: str, value=None) -> None:
        # Reference option 51: reads see only the snapshot, never this
        # transaction's own writes (apps use it to audit pre-txn state
        # and to skip the overlay bookkeeping). Like the reference, it
        # must be set before the transaction reads or writes.
        if name == "read_your_writes_disable":
            if self._overlay or self.mutations or self._read_version is not None:
                raise FdbError(
                    "read_your_writes_disable must be set before any "
                    "read or write", code=2006)
            self.ryw_disabled = True
            return
        super().set_option(name, value)

    # -- write path: maintain the overlay -------------------------------------

    def set(self, key: bytes, value: bytes) -> None:
        super().set(key, value)
        self._overlay[key] = ("value", value)

    def clear(self, key: bytes) -> None:
        super().clear(key)
        self._overlay[key] = ("value", None)

    def clear_range(self, begin: bytes, end: bytes) -> None:
        super().clear_range(begin, end)
        r = KeyRange(begin, end)
        if r.empty:
            return
        for k in [k for k in self._overlay if r.contains(k)]:
            self._overlay[k] = ("value", None)
        self._clears.append(r)

    def atomic_op(self, op: MutationType, key: bytes, param: bytes) -> None:
        super().atomic_op(op, key, param)
        if op in (MutationType.SET_VERSIONSTAMPED_KEY, MutationType.SET_VERSIONSTAMPED_VALUE):
            # Final key/value unknown until commit; RYW marks it unreadable
            # (the reference raises accessed_unreadable on such reads — we
            # surface the stamped value as unknowable the same way).
            if op == MutationType.SET_VERSIONSTAMPED_VALUE:
                self._overlay[key] = ("unreadable", None)
            return
        kind, cur = self._overlay.get(key, (None, None))
        if kind == "value":
            self._overlay[key] = ("value", apply_atomic(op, cur, param))
        elif kind == "ops":
            cur.append((op, param))
        elif self._covered_by_clear(key):
            self._overlay[key] = ("value", apply_atomic(op, None, param))
        else:
            self._overlay[key] = ("ops", [(op, param)])

    def _covered_by_clear(self, key: bytes) -> bool:
        return any(r.contains(key) for r in self._clears)

    # -- read path: overlay over snapshot --------------------------------------

    async def get(self, key: bytes, snapshot: bool = False) -> bytes | None:
        if getattr(self, "ryw_disabled", False):
            return await super().get(key, snapshot)
        kind, entry = self._overlay.get(key, (None, None))
        if kind == "value":
            return entry  # known locally: no storage read, no conflict range
        if kind == "unreadable":
            raise _unreadable()
        if self._covered_by_clear(key):
            # Locally known None (own clear_range): no read, no conflict.
            return None
        base = await super().get(key, snapshot)
        if kind == "ops":
            for op, param in entry:
                base = apply_atomic(op, base, param)
            if not snapshot:
                # Safe to serve from the fast path later: the serializable
                # read conflict range was just added by super().get. A
                # snapshot fold must NOT be cached — a later serializable
                # get() still owes its conflict range.
                self._overlay[key] = ("value", base)
        return base

    async def get_multi(self, keys, snapshot: bool = False) -> list:
        """Batched get with the same overlay-over-snapshot semantics as
        get(): locally-known keys resolve without a storage read (and
        without a conflict range); only the remainder rides the batched
        fetch."""
        if getattr(self, "ryw_disabled", False):
            return await super().get_multi(keys, snapshot)
        keys = list(keys)
        out: list = [None] * len(keys)
        # Unique key -> every position wanting it: a duplicated key must
        # fetch once and fan the SAME resolved value out to all positions
        # (per-position folding would rewrite an "ops" overlay to "value"
        # on the first occurrence and hand later occurrences the raw
        # storage base — two different values in one result).
        need: dict[bytes, list[int]] = {}
        for j, key in enumerate(keys):
            kind, entry = self._overlay.get(key, (None, None))
            if kind == "value":
                out[j] = entry
            elif kind == "unreadable":
                raise _unreadable()
            elif self._covered_by_clear(key):
                out[j] = None
            else:
                need.setdefault(key, []).append(j)
        if need:
            uniq = list(need)
            bases = await super().get_multi(uniq, snapshot)
            for key, base in zip(uniq, bases):
                kind, entry = self._overlay.get(key, (None, None))
                if kind == "ops":
                    for op, param in entry:
                        base = apply_atomic(op, base, param)
                    if not snapshot:
                        self._overlay[key] = ("value", base)
                for j in need[key]:
                    out[j] = base
        return out

    def _merge(
        self, base: dict[bytes, bytes], lo: bytes, hi: bytes, reverse: bool
    ) -> list[tuple[bytes, bytes]]:
        """Overlay-merge base rows over the fully-scanned span [lo, hi)."""
        merged: dict[bytes, bytes] = {
            k: v for k, v in base.items() if not self._covered_by_clear(k)
        }
        for k, (kind, entry) in self._overlay.items():
            if not (lo <= k < hi):
                continue
            if kind == "unreadable":
                raise _unreadable()
            if kind == "value":
                if entry is None:
                    merged.pop(k, None)
                else:
                    merged[k] = entry
            elif kind == "ops":
                v = merged.get(k)
                for op, param in entry:
                    v = apply_atomic(op, v, param)
                if v is None:
                    merged.pop(k, None)
                else:
                    merged[k] = v
        return sorted(merged.items(), reverse=reverse)

    async def get_range(
        self,
        begin: bytes,
        end: bytes,
        limit: int = 0,
        reverse: bool = False,
        snapshot: bool = False,
    ) -> list[tuple[bytes, bytes]]:
        if getattr(self, "ryw_disabled", False):
            return await super().get_range(begin, end, limit, reverse, snapshot)
        if limit <= 0:
            base = dict(
                await super().get_range(begin, end, 0, reverse, snapshot)
            )
            return self._merge(base, begin, end, reverse)
        # Limited scan: page through the snapshot until the merged view is
        # full. Rows may be eaten by our clears or deleted/inserted by the
        # overlay, so the merge only counts rows inside the span scanned so
        # far — a key past the scan horizon can never precede them.
        page = max(64, 2 * limit)
        base: dict[bytes, bytes] = {}
        cursor_b, cursor_e = begin, end
        while True:
            rows = await super().get_range(
                cursor_b, cursor_e, limit=page, reverse=reverse, snapshot=snapshot
            )
            base.update(rows)
            exhausted = len(rows) < page
            if exhausted:
                lo, hi = begin, end
            elif reverse:
                lo, hi = rows[-1][0], end
                cursor_e = rows[-1][0]
            else:
                lo, hi = begin, rows[-1][0] + b"\x00"
                cursor_b = rows[-1][0] + b"\x00"
            merged = self._merge(base, lo, hi, reverse)
            if exhausted or len(merged) >= limit:
                return merged[:limit]

    async def get_key(self, sel: KeySelector, snapshot: bool = False) -> bytes:
        # Resolve against the merged view: scan a window around the anchor.
        # (The reference resolves selectors inside the RYW view the same way;
        # we reuse the merged get_range since our selector offsets are small.)
        from foundationdb_tpu_torch.runtime.shardmap import MAX_KEY

        # User-keyspace confinement in BOTH directions without system
        # access (see Transaction.get_key): system keys are neither
        # returned nor read. A prefix-scoped authz token further clamps
        # the scan to its covering span (Transaction._token_span) — the
        # keyspace-edge scan would be denied at storage.
        space_end = self._keyspace_end()
        space_begin = b""
        span = self._token_span()
        if span is not None:
            space_begin = max(space_begin, span[0])
            space_end = min(space_end, span[1])
        if sel.offset >= 1:
            begin = min(sel.key + b"\x00" if sel.or_equal else sel.key,
                        space_end)
            begin = max(begin, space_begin)
            rows = await self.get_range(
                begin, space_end, limit=sel.offset, snapshot=snapshot
            )
            return (rows[sel.offset - 1][0]
                    if len(rows) >= sel.offset else MAX_KEY)
        back = 1 - sel.offset
        end = min(sel.key + b"\x00" if sel.or_equal else sel.key, space_end)
        end = max(end, space_begin)
        rows = await self.get_range(space_begin, end, limit=back,
                                    reverse=True, snapshot=snapshot)
        return rows[back - 1][0] if len(rows) >= back else b""


def open_database(cluster) -> Database:
    """Build a client Database for a SimCluster (the `fdb.open()` analogue)."""
    db = Database(
        cluster.loop,
        cluster.grv_proxy_eps,
        cluster.commit_proxy_eps,
        cluster.storage_map.clone(),  # own copy: goes stale, refreshed on
        cluster.storage_eps,          # wrong_shard_server (location cache)
        controller_ep=getattr(cluster, "controller_ep", None),
        coordinator_eps=getattr(cluster, "coordinator_eps", None),
    )
    db.transaction_class = RYWTransaction  # RYW is the default surface
    db.cluster = cluster  # \xff\xff/status/json reads route through it
    return db
