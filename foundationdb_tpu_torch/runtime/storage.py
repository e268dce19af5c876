"""Storage server: versioned reads over the MVCC window, tlog pull, watches.

A copy of ``foundationdb_tpu/runtime/storage.py`` for the port, its imports
rewritten to the port's modules; names and behaviour are the JAX module's.
Its read plane is the port's: ``TorchReadSet`` (JAX ``TPUReadSet``),
``ReadCoalescer`` and ``WatchIndex``, each on the device arm on
``device`` (``cuda`` unless the caller asks for the CPU), where K12's
search answers every dispatch. Every arm answers byte for byte as the
JAX arms do. A ``kvstore`` (``runtime/kvstore.py``) loads its durable
snapshot into the ``VersionedMap`` (and so into the read plane's key
mirror on ``device``) and takes the flushes and purges, as in JAX.

Reference: fdbserver/storageserver.actor.cpp — each storage server owns a
tag, pulls that tag's mutations from the tlogs, applies them in version
order to a versioned map (the reference's PTree; here per-key version
chains over a sorted key index), serves getValue/getKeyValues at a read
version within the ~5s MVCC window, fires watches on value change, and
pops the tlog as it becomes durable.

Reads behave like the reference's: a version newer than what has been
applied raises FutureVersion (the client waits and retries, reference
error 1009); a version below the window floor raises TransactionTooOld
(1007).
"""

from __future__ import annotations

import bisect

from dataclasses import dataclass, field

from foundationdb_tpu_torch.core.errors import (
    ChangeFeedCancelled,
    ChangeFeedPopped,
    FdbError,
    FutureVersion,
    TooManyWatches,
    TransactionTooOld,
    WrongShardServer,
)
from foundationdb_tpu_torch.core.mutations import ATOMIC_OPS, Mutation, MutationType, apply_atomic
from foundationdb_tpu_torch.reads.coalescer import ReadCoalescer
from foundationdb_tpu_torch.reads.read_set import TorchReadSet
from foundationdb_tpu_torch.reads.watches import WatchIndex
from foundationdb_tpu_torch.runtime.flow import BrokenPromise, Loop, Promise, any_of, rpc
from foundationdb_tpu_torch.runtime.sequencer import MVCC_WINDOW_VERSIONS
from foundationdb_tpu_torch.runtime.tlog import TLog
from foundationdb_tpu_torch.runtime.trace import trace


class VersionedMap:
    """Per-key version chains over a sorted key index (the PTree analogue)."""

    def __init__(self) -> None:
        self._keys: list[bytes] = []  # sorted; includes tombstoned keys
        self._chains: dict[bytes, list[tuple[int, bytes | None]]] = {}
        # Bumped whenever the KEY SET changes (insert/purge/rollback/GC
        # removal) — the read plane's resident mirror (reads/read_set.py)
        # rebuilds on a seq mismatch; value updates mutate chains in
        # place and cost the mirror nothing.
        self.struct_seq = 0

    def latest(self, key: bytes) -> bytes | None:
        chain = self._chains.get(key)
        return chain[-1][1] if chain else None

    def at(self, key: bytes, version: int) -> bytes | None:
        chain = self._chains.get(key)
        if not chain:
            return None
        i = bisect.bisect_right(chain, version, key=lambda e: e[0]) - 1
        if i < 0:
            return None
        return chain[i][1]

    def write(self, key: bytes, version: int, value: bytes | None) -> None:
        chain = self._chains.get(key)
        if chain is None:
            self._chains[key] = [(version, value)]
            bisect.insort(self._keys, key)
            self.struct_seq += 1
        elif chain[-1][0] == version:
            chain[-1] = (version, value)
        else:
            assert chain[-1][0] < version, "writes must arrive in version order"
            chain.append((version, value))

    def range_keys(self, begin: bytes, end: bytes) -> list[bytes]:
        lo = bisect.bisect_left(self._keys, begin)
        hi = bisect.bisect_left(self._keys, end)
        return self._keys[lo:hi]

    def purge_range(self, begin: bytes, end: bytes) -> None:
        """Drop all keys (and their history) in [begin, end) — shard moved
        away and aged out, or an aborted fetch left partial state."""
        for k in list(self.range_keys(begin, end)):
            del self._chains[k]
        lo = bisect.bisect_left(self._keys, begin)
        hi = bisect.bisect_left(self._keys, end)
        if hi > lo:
            self.struct_seq += 1
        del self._keys[lo:hi]

    def rollback(self, version: int) -> None:
        """Discard every write above `version` (recovery: storage may have
        pulled entries from a tlog whose durable suffix was lost with it)."""
        dead: list[bytes] = []
        for key, chain in self._chains.items():
            i = bisect.bisect_right(chain, version, key=lambda e: e[0])
            if i < len(chain):
                del chain[i:]
            if not chain:
                dead.append(key)
        if dead:
            self.struct_seq += 1
        for key in dead:
            del self._chains[key]
            i = bisect.bisect_left(self._keys, key)
            del self._keys[i]

    def gc(self, floor: int) -> None:
        """Drop chain entries superseded before `floor`; fully remove keys
        whose only surviving state is an old tombstone."""
        dead: list[bytes] = []
        for key, chain in self._chains.items():
            i = bisect.bisect_right(chain, floor, key=lambda e: e[0]) - 1
            if i > 0:
                del chain[:i]
            if len(chain) == 1 and chain[0][1] is None and chain[0][0] <= floor:
                dead.append(key)
        if dead:
            self.struct_seq += 1
        for key in dead:
            del self._chains[key]
            i = bisect.bisect_left(self._keys, key)
            del self._keys[i]


@dataclass
class ServedRange:
    """A shard this server answers reads for, bounded by the versions at
    which it acquired/lost the shard (reference: the SS's shard-availability
    tracking — newly fetched shards have no history below their fetch
    version; moved-away shards stop at the handoff version)."""

    begin: bytes
    end: bytes
    start_version: int = 0
    end_version: int | None = None  # None = still owned


@dataclass
class FetchState:
    """An in-flight fetchKeys: tagged mutations for the range are buffered
    (not applied) until the snapshot lands, then replayed — atomic ops must
    never apply against a missing base value (reference: fetchKeys'
    fetchWaitingVector buffering).

    After the snapshot lands (`snap_version` set) the state stays
    registered until the pull loop passes snap_version: in-range mutations
    at versions <= snap_version are already reflected in the snapshot and
    must be DROPPED, not re-applied (re-applying would violate per-key
    version order, or double-apply an atomic op at exactly snap_version)."""

    begin: bytes
    end: bytes
    buffer: list[tuple[int, Mutation]] = field(default_factory=list)
    snap_version: int | None = None  # set once the snapshot is injected


@dataclass
class ChangeFeed:
    """One registered change feed (reference: storageserver.actor.cpp change
    feed state — mutations overlapping [begin, end) are retained in version
    order until popped; readers stream from a begin version and can park on
    a waiter until more arrive). Atomic ops are captured post-application as
    SetValue of the computed result, matching the reference's feed contract."""

    feed_id: bytes
    begin: bytes
    end: bytes
    entries: list[tuple[int, Mutation]] = field(default_factory=list)
    pop_version: int = 0
    stopped: bool = False
    waiters: list[Promise] = field(default_factory=list)

    def add(self, version: int, m: Mutation) -> None:
        # Insert in version order: fetch_keys replays buffered mutations at
        # versions older than captures that already landed (reads promise
        # version order, so appending blindly would corrupt the stream).
        if self.entries and self.entries[-1][0] > version:
            i = bisect.bisect_right(self.entries, version, key=lambda e: e[0])
            self.entries.insert(i, (version, m))
        else:
            self.entries.append((version, m))
        waiters, self.waiters = self.waiters, []
        for p in waiters:
            p.send(version)


class StorageServer:
    PULL_INTERVAL = 0.001
    GC_INTERVAL = 0.5
    MAX_WATCHES = 10_000  # reference knob MAX_WATCHES → too_many_watches

    def __init__(self, loop: Loop, tag: int, tlog_ep, init_version: int = 0,
                 tlog_replicas=None, kvstore=None, authz=None, device=None):
        self.loop = loop
        self.tag = tag
        self.tlog = tlog_ep
        # Per-read tenant authorization (runtime/authz.TokenAuthority;
        # reference: storageserver.actor.cpp read authz) — None = authz
        # off, every read trusted. Enforced on the CLIENT read surface
        # (get/get_range/watch); storage↔storage transfer RPCs
        # (fetch_keys/snapshot_range) ride the mutual-TLS process mesh.
        self.authz = authz
        # Live tenant-map view (authz.TenantMapMirror) so tenant-BOUND
        # tokens stop reading when their tenant dies, matching the
        # commit-side liveness check. Attached by the cluster harness /
        # server bootstrap when authz is on.
        self.tenant_mirror = None
        # System-grant token this storage presents to PEER storages
        # (snapshot_range during shard moves) on an authz cluster.
        self.system_token: str | None = None
        # Persistent engine behind the MVCC window (runtime/kvstore.py;
        # reference: KeyValueStoreSQLite). On restart the durable snapshot
        # reloads and the pull loop resumes from its version. The flush
        # version never exceeds known_committed, so recovery rollback can
        # never contradict what the engine already made durable.
        self.kvstore = kvstore
        self._dirty: set[bytes] = set()
        self._pending_purges: list[tuple[bytes, bytes]] = []
        self._durable_version = 0
        if kvstore is not None:
            version, rows = kvstore.load()
            self._durable_version = version
            init_version = max(init_version, version)
        # Replica tlogs also hold our tag; pops must reach every one or the
        # non-primary logs never trim and grow unbounded within an epoch.
        self.tlog_replicas = list(tlog_replicas or [])
        self._tlog_gen = 0  # bumped by recover_to; fences in-flight peeks
        self.map = VersionedMap()
        self._version = init_version  # applied through this version
        self.oldest_version = 0  # MVCC window floor
        self.known_committed = 0  # acked-on-all-tlogs bound, off peek replies
        self._version_waiters: list[tuple[int, Promise]] = []
        # Read plane (reads/): the resident key-universe mirror + deadline
        # coalescer serve get_multi (and, under FDB_TPU_READ_BATCH=1, the
        # scalar get/get_range RPCs too); the packed watch registry
        # replaces the seed's per-key dict + per-write pops. Mirror and
        # watch rows live on ``device`` (K12's search on the card).
        self.read_set = TorchReadSet(self.map, device=device)
        self._reads = ReadCoalescer(loop, self.read_set)
        self.watches = WatchIndex(device=device)
        self._watch_pending: list[tuple[bytes, int, bytes | None]] = []
        self._too_many_watches = 0
        from foundationdb_tpu_torch.core.types import env_choice

        self._batch_scalar_reads = (
            env_choice("FDB_TPU_READ_BATCH", "0", ("0", "1")) == "1"
        )
        self._feeds: dict[bytes, ChangeFeed] = {}
        self._running = False
        # Shard serving state (data distribution). None = serve everything
        # (single-team clusters never register ranges and skip the guard).
        self.served: list[ServedRange] | None = None
        self._fetching: list[FetchState] = []
        if kvstore is not None:
            for k, v in rows:
                self.map.write(k, self._durable_version, v)

    # -- write path (tlog pull) ----------------------------------------------

    TLOG_RETRY = 0.05  # backoff while our tlog is unreachable/locked

    async def run(self) -> None:
        """Main pull loop actor; also drives MVCC GC. Survives tlog death:
        an unreachable or recovery-locked tlog just parks the loop until
        recovery re-points us at the new generation (recover_to)."""
        self._running = True
        last_gc = self.loop.now
        while True:
            if self.loop.buggify("storage.slow_pull"):
                # A lagging puller: reads hit FutureVersion waits, the
                # tlog queue grows, ratekeeper sees durability lag.
                await self.loop.sleep(self.loop.rng.uniform(0, 0.1))
            try:
                gen, tlog = self._tlog_gen, self.tlog
                entries, end_version, known_committed = await tlog.peek(
                    self.tag, self._version + 1
                )
                if gen != self._tlog_gen:
                    continue  # stale reply from a pre-recovery tlog: discard
                self.known_committed = max(self.known_committed, known_committed)
                # Apply ONLY the known-committed prefix. Anything beyond
                # it is an unacked suffix: normally just one in-flight
                # batch (the next peek delivers it once its ack lands),
                # but after a region partition it is a ZOMBIE generation's
                # divergent timeline — pri proxies keep appending to their
                # local tlogs while the locked satellites fence every ack,
                # so kc freezes exactly at the fork point and this cap is
                # what keeps the fork out of storage state
                # (tests/test_deployed_multiregion.py TestRegionPartition).
                applyable, advance_to = TLog.committed_prefix(
                    entries, end_version, self.known_committed)
                before = self._version
                for version, mutations in applyable:
                    self._apply(version, mutations)
                if advance_to > self._version:
                    self._advance(advance_to)  # idle-tag versions
                if self._version > before:
                    # Pop on every advance (not just on mutations) so cold
                    # tags still raise the tlog's trim floor — without this a
                    # salvage-seeded tag that never sees new writes pins the
                    # floor at 0 and the log grows without bound.
                    #
                    # With a persistent engine the pop floor is the DURABLE
                    # version, not the applied one: popping past what sqlite
                    # holds would let the tlog trim (and recovery salvage
                    # drop) acked commits a whole-cluster crash still needs.
                    pop_v = (
                        self._version if self.kvstore is None
                        else self._durable_version
                    )
                    await tlog.pop(self.tag, pop_v)
                    for rep in self.tlog_replicas:
                        if rep is tlog:
                            continue
                        try:
                            await rep.pop(self.tag, pop_v)
                        except BrokenPromise:
                            pass  # dead replica: recovery will retire it
                        except FdbError as e:
                            if e.code != 1500:
                                raise
                            # stood-down replica: retired, nothing to trim
            except BrokenPromise:
                # Only unreachability is survivable; apply-path errors are
                # real bugs and must crash the actor, not spin silently.
                await self.loop.sleep(self.TLOG_RETRY)
                continue
            except FdbError as e:
                if e.code != 1500:
                    raise
                # "no service": the tlog worker stood its retired log down
                # (zombie retirement) before recovery re-pointed us — same
                # park-and-wait as unreachability, per unserve's contract.
                await self.loop.sleep(self.TLOG_RETRY)
                continue
            if self.loop.now - last_gc >= self.GC_INTERVAL:
                self._gc()
                last_gc = self.loop.now
            await self.loop.sleep(self.PULL_INTERVAL)

    def recover_to(self, recovery_version: int, tlog_ep,
                   tlog_replicas=None) -> None:
        """Recovery handoff: discard applied state above the recovery version
        (this server may have pulled writes whose durable suffix died with
        its tlog — the reference's storage rollback), then pull from the new
        generation's tlog. Called directly by the recruiter (the harness owns
        these objects; an RPC could be lost to the very partition recovery is
        healing).

        Watches are NOT re-evaluated: one armed on a rolled-back (unacked)
        write has already fired. That is the reference's documented watch
        contract — watches may fire spuriously and clients must re-read —
        so rollback keeps it, rather than tracking fired-watch provenance."""
        if self._version > recovery_version:
            self.map.rollback(recovery_version)
            self._version = recovery_version
        # In-flight fetch buffers may hold the rolled-back suffix.
        for f in self._fetching:
            f.buffer = [(v, m) for v, m in f.buffer if v <= recovery_version]
        self.tlog = tlog_ep
        self.tlog_replicas = list(tlog_replicas or [])
        self._tlog_gen += 1  # invalidate any in-flight old-generation peek

    def _apply(self, version: int, mutations: list[Mutation]) -> None:
        assert version > self._version
        if self._fetching:
            mutations = self._buffer_fetching(version, mutations)
        for m in mutations:
            self._apply_one(m, version)
        self._advance(version)
        self._sweep_watches()

    def _advance(self, version: int) -> None:
        self._version = version
        # The GC floor must never pass known_committed: versions above it may
        # be an unacked suffix of our one tlog that recovery rolls back, and
        # GC past them would discard the acked values rollback restores.
        self.oldest_version = max(
            self.oldest_version,
            min(version - MVCC_WINDOW_VERSIONS, self.known_committed),
        )
        still = []
        for want, p in self._version_waiters:
            (p.send(None) if want <= version else still.append((want, p)))
        self._version_waiters = still

    def _write(self, key: bytes, version: int, value: bytes | None) -> None:
        self.map.write(key, version, value)
        if self.kvstore is not None:
            self._dirty.add(key)
        if self.watches.count:
            # Deferred to the per-version sweep (_sweep_watches): one
            # packed probe per applied version instead of a dict pop per
            # write. Same task step, no await between — promises resolve
            # indistinguishably from the seed's inline fire.
            self._watch_pending.append((key, version, value))

    def _sweep_watches(self) -> None:
        """Fire watches for every version applied since the last sweep:
        each version's written keys (FINAL value per key) probe the packed
        registry once (reads/watches.py). Runs at APPLY time — before
        durability acks — which is what preserves the reference's
        spurious-fire-on-rollback contract (see recover_to)."""
        if not self._watch_pending:
            return
        pend, self._watch_pending = self._watch_pending, []
        from time import perf_counter

        from foundationdb_tpu_torch.obs.span import span_sink

        sink = span_sink(self.loop)
        t0 = perf_counter() if sink is not None else 0.0
        i = 0
        while i < len(pend):  # group by version (ascending by construction)
            v = pend[i][1]
            group: list[tuple[bytes, bytes | None]] = []
            while i < len(pend) and pend[i][1] == v:
                group.append((pend[i][0], pend[i][2]))
                i += 1
            self.watches.sweep(v, group)
        if sink is not None:
            sink.stage_tick("watch_sweep", perf_counter() - t0, len(pend))

    def _gc(self) -> None:
        self.map.gc(self.oldest_version)
        self._flush_durable()
        # Retire moved-away shards once no in-window reader can still need
        # them: drop the serve entry and purge the bytes (reference: the SS
        # removes a moved range after its readers age out of the window).
        if self.served is not None:
            dead = [
                s for s in self.served
                if s.end_version is not None and s.end_version < self.oldest_version
            ]
            for s in dead:
                self.served.remove(s)
                # Purge exactly the portions neither a remaining entry nor
                # an in-flight fetch covers — a partial overlap must not pin
                # the whole retired range, and a fetch re-acquiring the
                # shard must not have its fresh snapshot swept away.
                covers = [(o.begin, o.end) for o in self.served]
                covers += [(fs.begin, fs.end) for fs in self._fetching]
                parts = [(s.begin, s.end)]
                for cb, ce in covers:
                    nxt: list[tuple[bytes, bytes]] = []
                    for b, e in parts:
                        ob, oe = max(b, cb), min(e, ce)
                        if ob < oe:
                            if b < ob:
                                nxt.append((b, ob))
                            if oe < e:
                                nxt.append((oe, e))
                        else:
                            nxt.append((b, e))
                    parts = nxt
                for b, e in parts:
                    self._purge(b, e)

    def _flush_durable(self) -> None:
        """Make a consistent prefix durable: dirty keys' values AS OF the
        flush version (never above known_committed — the only bound
        recovery rollback respects) in one atomic engine commit."""
        if self.kvstore is None:
            return
        flush_version = min(self._version, self.known_committed)
        if flush_version <= self._durable_version:
            return
        writes: dict[bytes, bytes | None] = {}
        still_dirty: set[bytes] = set()
        for k in self._dirty:
            chain = self.map._chains.get(k)
            if chain is None:
                writes[k] = None  # purged/GC'd away entirely
                continue
            writes[k] = self.map.at(k, flush_version)
            if chain[-1][0] > flush_version:
                still_dirty.add(k)  # has writes above the flush point
        self.kvstore.flush(writes, flush_version, purges=self._pending_purges)
        self._pending_purges = []
        self._dirty = still_dirty
        self._durable_version = flush_version

    def _purge(self, begin: bytes, end: bytes) -> None:
        """Purge a range from the window AND schedule the same delete in the
        persistent engine (mirrored at the next flush, atomically)."""
        self.map.purge_range(begin, end)
        if self.kvstore is not None:
            self._pending_purges.append((begin, end))

    # -- shard serving / data movement (reference: fetchKeys + shard map) ----

    def _buffer_fetching(
        self, version: int, mutations: list[Mutation]
    ) -> list[Mutation]:
        """Divert mutations for fetch ranges: in-flight fetches buffer them,
        completed fetches drop the already-snapshotted prefix (clears are
        clipped); the remainder applies normally."""
        # Retire completed states the pull loop has fully passed.
        self._fetching = [
            f for f in self._fetching
            if f.snap_version is None or version <= f.snap_version
        ]

        def divert(f: FetchState, v: int, m: Mutation) -> bool:
            """True if `m` (already clipped to f's range) was consumed."""
            if f.snap_version is None:
                f.buffer.append((v, m))
                return True
            return v <= f.snap_version  # in snapshot already: drop

        out: list[Mutation] = []
        for m in mutations:
            if m.type == MutationType.CLEAR_RANGE:
                segs = [(m.param1, m.param2)]
                for f in self._fetching:
                    nxt: list[tuple[bytes, bytes]] = []
                    for b, e in segs:
                        ob, oe = max(b, f.begin), min(e, f.end)
                        if ob < oe:
                            if not divert(
                                f, version,
                                Mutation(MutationType.CLEAR_RANGE, ob, oe),
                            ):
                                nxt.append((ob, oe))
                            if b < ob:
                                nxt.append((b, ob))
                            if oe < e:
                                nxt.append((oe, e))
                        else:
                            nxt.append((b, e))
                    segs = nxt
                out.extend(
                    Mutation(MutationType.CLEAR_RANGE, b, e) for b, e in segs
                )
            else:
                f = next(
                    (f for f in self._fetching if f.begin <= m.param1 < f.end),
                    None,
                )
                if f is None or not divert(f, version, m):
                    out.append(m)
        return out

    def _apply_one(self, m: Mutation, version: int) -> None:
        """Apply one mutation and mirror it into overlapping change feeds
        (atomics normalized to the computed SetValue, clears clipped)."""
        if m.type == MutationType.SET_VALUE:
            self._write(m.param1, version, m.param2)
            self._feed_capture(version, m)
        elif m.type == MutationType.CLEAR_RANGE:
            for k in self.map.range_keys(m.param1, m.param2):
                if self.map.latest(k) is not None:
                    self._write(k, version, None)
            self._feed_capture(version, m)
        elif m.type in ATOMIC_OPS:
            value = apply_atomic(m.type, self.map.latest(m.param1), m.param2)
            self._write(m.param1, version, value)
            self._feed_capture(
                version, Mutation(MutationType.SET_VALUE, m.param1, value)
            )
        else:
            raise ValueError(f"storage cannot apply mutation {m.type!r}")

    @rpc
    async def snapshot_range(
        self, begin: bytes, end: bytes, min_version: int | None = None,
        token: str | None = None,
    ) -> tuple[int, list[tuple[bytes, bytes]]]:
        """Source side of fetchKeys: the range at our applied version.

        `min_version` makes the snapshot wait until our pull loop has
        applied at least that version (reference: fetchKeys reads at a
        fetchVersion at/above the move version). Without it, a lagging
        source could snapshot a state OLDER than mutations already
        committed for this range whose tags the destination does not
        carry — e.g. a clear committed before the move began would be
        silently resurrected.

        Authz: this RPC shares the client-facing service, so with authz
        on it is token-gated like every read (review-found bypass: an
        untokened snapshot_range(b'', b'\\xff') dumped every tenant).
        Peer storages doing shard moves carry the cluster's system token
        (StorageServer.system_token)."""
        self._check_read_authz(begin, end, token)
        if min_version is not None:
            await self.wait_for_version(min_version)
        v = self._version
        rows = []
        for k in self.map.range_keys(begin, end):
            val = self.map.at(k, v)
            if val is not None:
                rows.append((k, val))
        return v, rows

    @rpc
    async def fetch_keys(self, begin: bytes, end: bytes, src_ep,
                         min_version: int | None = None,
                         token: str | None = None) -> int:
        """Destination side of a shard move: copy [begin, end) from `src_ep`.

        The caller (DataDistributor) must already have dual-tagged the range
        so our tag stream carries every mutation concurrent with the
        snapshot; those buffer while the copy is in flight and replay on
        top (atomic ops must never fold into a missing base value).
        Returns the snapshot version — the shard has no history below it.

        Authz: token-gated like snapshot_range (it writes fetched rows
        into this replica and could be aimed at any source)."""
        self._check_read_authz(begin, end, token)
        f = FetchState(begin, end)
        self._fetching.append(f)
        # RE-ACQUIRE discipline (campaign-found at DDBalance seed 3033):
        # a retired ServedRange's in-window grace ("serve reads at
        # version <= end_version from the old data") is only sound while
        # the map is COMPLETE through end_version. From this registration
        # on, in-range mutations divert into the fetch buffer instead of
        # the map — so if this server recently LEFT the shard and its
        # lagging pull hadn't yet applied through the handoff version,
        # the grace window would serve committed writes as missing. Cap
        # the OVERLAP at the version the map is actually complete
        # through (entries are split so non-overlapping portions keep
        # their full grace); reads past the cap get wrong_shard_server
        # and re-route to a complete owner.
        self._restrict_grace(begin, end, self._version)
        trace(self.loop).event("FetchKeysBegin", begin=begin, end=end)
        try:
            # The snapshot must be at/above OUR OWN applied version
            # (reference: fetchKeys reads at fetchVersion >= data->version):
            # with the dual-tag window open, this server may have already
            # applied in-window mutations for the range; a snapshot below
            # them would make the reconcile mistake those legitimate
            # entries for aborted-move residue and purge committed writes
            # (found by the buggify campaign under clogged, long-window
            # moves).
            snap_floor = max(min_version or 0, self._version)
            snap_version, rows = await src_ep.snapshot_range(
                begin, end, snap_floor, token=self.system_token
            )
            # Reconcile existing history with the snapshot instead of
            # purging: when a shard is RE-acquired within the read window,
            # the old history still serves in-window readers through the
            # retired ServedRange (the grace the map's versioned reads give
            # the reference). Only aborted-move residue (entries above the
            # snapshot) is dropped, and keys deleted while we were away get
            # a tombstone so post-flip readers do not resurrect them.
            snap_keys = {k for k, _v in rows}
            for k in list(self.map.range_keys(begin, end)):
                chain = self.map._chains[k]
                if chain[-1][0] > snap_version:
                    self._purge(k, k + b"\x00")  # residue
                elif k not in snap_keys and chain[-1][1] is not None:
                    self.map.write(k, snap_version, None)
            for k, v in rows:
                self.map.write(k, snap_version, v)
            # Advertise the shard as of the snapshot immediately: reads
            # cannot reach us before the map flip (or a replica failover),
            # and registering now means _gc can never mistake the fetched
            # rows for retired-range garbage in the window before the
            # distributor flips the map.
            if self.served is not None:
                self.begin_serve(begin, end, snap_version)
            for version, m in f.buffer:  # sync block through snap_version set
                if version > snap_version:
                    self._apply_one(m, version)
            self._sweep_watches()
            # Keep the state registered until the pull loop passes
            # snap_version: it must DROP re-deliveries at versions the
            # snapshot already covers (our pull cursor may still be behind
            # the source's). _buffer_fetching retires it.
            f.snap_version = snap_version
            return snap_version
        except BaseException:
            if f in self._fetching:
                self._fetching.remove(f)
            self._purge(begin, end)  # buffered mutations were lost
            # The purge deleted the range's map history, so any retired
            # grace overlapping it can no longer answer correctly — drop
            # the overlap (cap below start_version), or in-window reads
            # would return committed keys as missing (review finding:
            # the same stale-read class as the registration cap, on the
            # abort path).
            self._restrict_grace(begin, end, -1)
            raise

    def _restrict_grace(self, begin: bytes, end: bytes, cap: int) -> None:
        """Split RETIRED ServedRanges at [begin, end) and cap the
        overlap's grace at `cap` (a cap below start_version drops the
        overlap piece entirely). Live entries are untouched."""
        if self.served is None:
            return
        out: list[ServedRange] = []
        for s in self.served:
            if s.end_version is None or s.end <= begin or end <= s.begin:
                out.append(s)
                continue
            if s.begin < begin:
                out.append(ServedRange(s.begin, begin,
                                       s.start_version, s.end_version))
            if end < s.end:
                out.append(ServedRange(end, s.end,
                                       s.start_version, s.end_version))
            capped = min(s.end_version, cap)
            if capped >= s.start_version:
                out.append(ServedRange(max(s.begin, begin), min(s.end, end),
                                       s.start_version, capped))
        self.served = out

    def abort_fetch(self, begin: bytes, end: bytes) -> None:
        """Abandon a move: drop buffers and partial data for the range."""
        self._fetching = [
            f for f in self._fetching if not (f.begin == begin and f.end == end)
        ]
        self._purge(begin, end)

    def init_served(self, ranges: list[tuple[bytes, bytes]]) -> None:
        self.served = [ServedRange(b, e) for b, e in ranges]

    def begin_serve(self, begin: bytes, end: bytes, start_version: int) -> None:
        assert self.served is not None
        self.served.append(ServedRange(begin, end, start_version))

    def cancel_serve(self, begin: bytes, end: bytes) -> None:
        """Undo begin_serve after an aborted move: drop LIVE entries fully
        inside the range (the move registered exactly this range; purged
        data must not be advertised as served)."""
        if self.served is None:
            return
        self.served = [
            s for s in self.served
            if not (
                s.end_version is None and begin <= s.begin and s.end <= end
            )
        ]

    def end_serve(self, begin: bytes, end: bytes, end_version: int) -> None:
        """Stop owning [begin, end) above `end_version`; in-window readers
        with older versions are still served until GC retires the entry."""
        assert self.served is not None
        out: list[ServedRange] = []
        for s in self.served:
            if s.end <= begin or end <= s.begin or s.end_version is not None:
                out.append(s)
                continue
            if s.begin < begin:
                out.append(ServedRange(s.begin, begin, s.start_version))
            if end < s.end:
                out.append(ServedRange(end, s.end, s.start_version))
            ob, oe = max(s.begin, begin), min(s.end, end)
            out.append(ServedRange(ob, oe, s.start_version, end_version))
        self.served = out
        # Fail in-flight watches for the range: proxies stop tagging us, so
        # the triggering write would never arrive here — the client gets a
        # retryable error and re-arms on the new owner. O(log n + hits)
        # via the sorted watch index (the seed scanned every armed watch).
        for key, _expect, p in self.watches.cancel_range(begin, end):
            p.fail(WrongShardServer(f"shard with {key[:16]!r} moved away"))

    def _check_serving(self, begin: bytes, end: bytes, version: int) -> None:
        """Reads must land on shards we own at `version`. Spatial gaps →
        wrong_shard_server (client refreshes its map and re-routes); owned
        but no history that old (freshly fetched shard) → too_old (client
        restarts at a fresh read version)."""
        if self.served is None:
            return
        pos = begin
        too_old = False
        for s in sorted(self.served, key=lambda s: s.begin):
            if pos >= end:
                break
            if s.end <= pos or s.begin > pos:
                continue
            if s.end_version is not None and version > s.end_version:
                continue  # moved away before this version
            if version < s.start_version:
                too_old = True
            pos = max(pos, s.end)
        if pos < end:
            raise WrongShardServer(
                f"tag {self.tag} does not serve [{begin!r}, {end!r}) at {version}"
            )
        if too_old:
            raise TransactionTooOld(
                f"shard acquired above read version {version}"
            )

    @rpc
    async def shard_stats(self, begin: bytes, end: bytes,
                          version: int | None = None,
                          token: str | None = None) -> dict:
        """DataDistributor inputs: byte size + a median split key
        (reference: StorageMetrics / splitMetrics). `version`: wait for
        the apply loop to reach it first — client-facing size estimates
        must see the caller's own committed writes, which the pull
        loop's known-committed fence holds back for one push interval.
        DD's balance sampling passes None (best-effort latest).

        Token-checked like every other client-facing read when authz is
        armed: the reply includes a median SPLIT KEY — real key bytes —
        so an unchecked call would leak another tenant's key material
        and data-size side channel to any tokened client. DD carries the
        cluster's system token."""
        self._check_read_authz(begin, end, token)
        if version is not None:
            await self._check_version(version)
        total, n = 0, 0
        sizes: list[tuple[bytes, int]] = []
        for k in self.map.range_keys(begin, end):
            v = self.map.latest(k)
            if v is None:
                continue
            sz = len(k) + len(v)
            total += sz
            n += 1
            sizes.append((k, sz))
        split_key = None
        if n >= 2:
            cum, half = 0, total / 2
            for k, sz in sizes:
                cum += sz
                if cum >= half and k > begin:
                    split_key = k
                    break
        return {"bytes": total, "keys": n, "split_key": split_key}

    # -- read path ------------------------------------------------------------

    VERSION_WAIT_TIMEOUT = 1.0  # virtual s to wait for lagging apply loop

    async def _check_version(self, version: int) -> None:
        if version < self.oldest_version:
            raise TransactionTooOld(f"read at {version} < floor {self.oldest_version}")
        if version > self._version:
            # Wait briefly for the pull loop to catch up (the reference's
            # waitForVersion); past the timeout the client sees
            # FutureVersion and retries at a fresh GRV.
            p = Promise()
            entry = (version, p)
            self._version_waiters.append(entry)
            await any_of([p.future, self.loop.sleep(self.VERSION_WAIT_TIMEOUT)])
            if version > self._version:
                if entry in self._version_waiters:  # lost the race: un-park
                    self._version_waiters.remove(entry)
                raise FutureVersion(f"read at {version} > applied {self._version}")

    def _check_read_authz(self, begin: bytes, end: bytes,
                          token: str | None) -> None:
        if self.authz is not None:
            self.authz.check_read(
                begin, end, token, self.loop.wall_now,
                live_tenants=(self.tenant_mirror.view
                              if self.tenant_mirror else None),
            )

    @rpc
    async def get(self, key: bytes, version: int,
                  token: str | None = None) -> bytes | None:
        self._check_read_authz(key, key + b"\x00", token)
        await self._check_version(version)
        self._check_serving(key, key + b"\x00", version)
        if self._batch_scalar_reads:
            val = (await self._reads.submit_points([key], version))[0]
            # Re-validate after the coalescer's deadline wait: a shard
            # handoff landing during the await purges the key, and the
            # dispatch would answer "absent" from the post-move map
            # instead of wrong_shard_server (the seed's scalar path had
            # no await between this check and map.at).
            self._check_serving(key, key + b"\x00", version)
            return val
        return self.map.at(key, version)

    @rpc
    async def get_multi(self, keys: list[bytes], version: int,
                        token: str | None = None) -> list[bytes | None]:
        """Batched point reads: all keys resolve through ONE coalesced
        probe dispatch (reads/) instead of per-key actor hops. Results are
        positional (None = absent), byte-identical to a sequence of get()
        calls at the same version."""
        for k in keys:
            self._check_read_authz(k, k + b"\x00", token)
        await self._check_version(version)
        for k in keys:
            self._check_serving(k, k + b"\x00", version)
        if not keys:
            return []
        vals = await self._reads.submit_points(keys, version)
        # Re-validate post-await: see get() — a handoff during the
        # coalescer wait must fail the read, not serve purged keys as
        # absent.
        for k in keys:
            self._check_serving(k, k + b"\x00", version)
        return vals

    @rpc
    async def system_snapshot(
        self, begin: bytes, end: bytes, token: str | None = None,
    ) -> tuple[int, list[tuple[bytes, bytes]]]:
        """Latest-applied system-keyspace read WITH the version it
        reflects, for version-MONOTONE infrastructure mirrors (the
        tenant map). A mirror failing over between replicas needs the
        version to reject a LAGGING replica's older view — without it, a
        refresh that lands on a behind replica resurrects deleted
        tenants into enforcement (campaign find: aggressive seed 5336,
        dead-tenant write admitted after the view regressed)."""
        self._check_read_authz(begin, end, token)
        if begin < b"\xff":
            raise FdbError(
                "system_snapshot is system-keyspace-only", code=2108)
        version = self._version
        self._check_serving(begin, end, version)
        out: list[tuple[bytes, bytes]] = []
        for k in self.map.range_keys(begin, end):
            v = self.map.at(k, version)
            if v is not None:
                out.append((k, v))
        return version, out

    @rpc
    async def get_range(
        self,
        begin: bytes,
        end: bytes,
        version: int,
        limit: int = 10_000,
        reverse: bool = False,
        token: str | None = None,
    ) -> list[tuple[bytes, bytes]]:
        self._check_read_authz(begin, end, token)
        if version < 0:
            # Latest-applied read (no wait): infrastructure consumers —
            # the tenant-map mirror — want "whatever this replica has
            # NOW", not a snapshot pinned at some caller's version (a
            # pinned read goes stale/empty on idle or freshly recruited
            # callers — review finding). SYSTEM keyspace only: for user
            # data this would be a dirty read of the applied-but-unacked
            # suffix that recovery may roll back (review finding) — the
            # MVCC/GRV contract stands for everything clients own.
            # (System metadata seen early converges: the mirror re-reads
            # every interval and rollback removes the entry again.)
            if begin < b"\xff":
                raise FdbError(
                    "latest-applied reads (version -1) are system-"
                    "keyspace-only", code=2108)  # invalid_option_value
            version = self._version
        else:
            await self._check_version(version)
        self._check_serving(begin, end, version)
        if self._batch_scalar_reads:
            rows = await self._reads.submit_range(
                begin, end, limit, reverse, version)
            # Re-validate post-await: see get().
            self._check_serving(begin, end, version)
            return rows
        keys = self.map.range_keys(begin, end)
        if reverse:
            keys = reversed(keys)
        out: list[tuple[bytes, bytes]] = []
        for k in keys:
            v = self.map.at(k, version)
            if v is not None:
                out.append((k, v))
                if len(out) >= limit:
                    break
        return out

    @rpc
    async def wait_for_version(self, version: int) -> None:
        """Park until the pull loop has applied through `version`."""
        if version <= self._version:
            return
        p = Promise()
        self._version_waiters.append((version, p))
        await p.future

    @rpc
    async def watch(self, key: bytes, value: bytes | None,
                    token: str | None = None) -> int:
        """Resolves (with the triggering version) once the key's value is
        observed ≠ `value` (reference: storage watch at the latest version).

        Serving guard: a watch armed on a replica that lost (or never had)
        the shard would hang forever — after a move, proxies stop tagging
        us, so the triggering write never arrives. Reject instead; the
        client sees a retryable error and re-arms on the new owner."""
        self._check_read_authz(key, key + b"\x00", token)
        self._check_serving(key, key + b"\x00", self._version)
        current = self.map.latest(key)
        if current != value:
            return self._version
        if self.watches.count >= self.MAX_WATCHES:
            self._too_many_watches += 1
            raise TooManyWatches(f"{self.MAX_WATCHES} watches already armed")
        p = Promise()
        self.watches.add(key, value, p)
        return await p.future

    # -- change feeds (reference: storageserver.actor.cpp change feeds) ------

    def _feed_capture(self, version: int, m: Mutation) -> None:
        if not self._feeds:
            return
        for f in self._feeds.values():
            if f.stopped:
                continue
            if m.type == MutationType.CLEAR_RANGE:
                ob, oe = max(m.param1, f.begin), min(m.param2, f.end)
                if ob < oe:
                    f.add(version, Mutation(MutationType.CLEAR_RANGE, ob, oe))
            elif f.begin <= m.param1 < f.end:
                f.add(version, m)

    @rpc
    def register_change_feed(self, feed_id: bytes, begin: bytes, end: bytes) -> None:
        """Start retaining this range's mutations under `feed_id`. Re-registration
        with the same range is idempotent (reference: change feed registration
        is a versioned special-key write; duplicates are no-ops)."""
        existing = self._feeds.get(feed_id)
        if existing is not None:
            if (existing.begin, existing.end) != (begin, end):
                raise ValueError(f"feed {feed_id!r} exists with another range")
            return
        self._feeds[feed_id] = ChangeFeed(feed_id, begin, end)

    @rpc
    def read_change_feed(
        self, feed_id: bytes, begin_version: int, end_version: int | None = None
    ) -> list[tuple[int, Mutation]]:
        """Mutations with begin_version <= version < end_version, in version
        order. Reading below the popped floor raises ChangeFeedPopped (the
        data is gone; the reader must re-snapshot)."""
        f = self._feed(feed_id)
        if begin_version < f.pop_version:
            raise ChangeFeedPopped(
                f"feed {feed_id!r} popped through {f.pop_version}"
            )
        hi = self._version + 1 if end_version is None else end_version
        return [e for e in f.entries if begin_version <= e[0] < hi]

    @rpc
    async def wait_change_feed(self, feed_id: bytes, after_version: int) -> int:
        """Park until the feed holds a mutation above `after_version`;
        returns that mutation's version. Destroying OR stopping the feed
        wakes waiters with ChangeFeedCancelled (a stopped feed can never
        produce the awaited entry)."""
        while True:
            f = self._feed(feed_id)
            newer = [v for v, _m in f.entries if v > after_version]
            if newer:
                return min(newer)
            if f.stopped:
                raise ChangeFeedCancelled(f"feed {feed_id!r} stopped")
            p = Promise()
            f.waiters.append(p)
            await p.future

    @rpc
    def pop_change_feed(self, feed_id: bytes, version: int) -> None:
        """Discard feed data below `version` (the reader has durably
        consumed it — the feed analogue of tlog pop)."""
        f = self._feed(feed_id)
        f.pop_version = max(f.pop_version, version)
        f.entries = [e for e in f.entries if e[0] >= f.pop_version]

    @rpc
    def stop_change_feed(self, feed_id: bytes) -> None:
        """Stop capturing; retained entries stay readable until destroy.
        Parked waiters are failed — no future capture can ever wake them."""
        f = self._feed(feed_id)
        f.stopped = True
        waiters, f.waiters = f.waiters, []
        for p in waiters:
            p.fail(ChangeFeedCancelled(f"feed {feed_id!r} stopped"))

    @rpc
    def destroy_change_feed(self, feed_id: bytes) -> None:
        f = self._feeds.pop(feed_id, None)
        if f is not None:
            for p in f.waiters:
                p.fail(ChangeFeedCancelled(f"feed {feed_id!r} destroyed"))

    def _feed(self, feed_id: bytes) -> ChangeFeed:
        f = self._feeds.get(feed_id)
        if f is None:
            raise ChangeFeedCancelled(f"no change feed {feed_id!r}")
        return f

    @rpc
    async def metrics(self) -> dict:
        """Ratekeeper inputs (reference: StorageQueuingMetricsReply — the
        real ratekeeper smooths version lag, DURABILITY lag (applied but not
        yet fsynced), and storage queue bytes; all three are reported)."""
        tlog_version = await self.tlog.get_version()
        queue_bytes = 0
        if self.kvstore is not None:
            for k in self._dirty:
                v = self.map.latest(k)
                queue_bytes += len(k) + (len(v) if v is not None else 0)
        rc = self._reads
        return {
            "tag": self.tag,
            "durable_version": (
                self._version if self.kvstore is None else self._durable_version
            ),
            "version_lag": max(0, tlog_version - self._version),
            "durability_lag": (
                0 if self.kvstore is None
                else max(0, self._version - self._durable_version)
            ),
            "queue_bytes": queue_bytes,
            "keys": len(self.map._keys),
            # Read plane + watch registry (reads/): zeros while idle so
            # the DOCUMENTED_COUNTERS audit sees them in every scrape.
            "watch_count": self.watches.count,
            "too_many_watches": self._too_many_watches,
            "watch_fires": self.watches.stats["fired"],
            "reads": {
                "dispatches": rc.stats["dispatches"],
                "served": rc.stats["point_reads"] + rc.stats["range_reads"],
                "queue_depth": rc.queue_depth,
                "occupancy": round(rc.occupancy, 4),
                "per_dispatch": round(rc.reads_per_dispatch, 2),
            },
        }
