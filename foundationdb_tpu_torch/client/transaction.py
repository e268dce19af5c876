"""Client library: Database / Transaction — grv, reads, commit, retry loop.

A copy of ``foundationdb_tpu/client/transaction.py`` for the port, its imports rewritten to
the port's modules; names and behaviour are the JAX module's.

Reference: fdbclient/NativeAPI.actor.cpp. A Transaction lazily acquires a
read version from a GRV proxy, routes reads to storage servers by shard,
accumulates mutations and conflict ranges, and commits through a commit
proxy. ``Database.run`` is the canonical retry loop (reference: the
``on_error`` contract every binding implements): retryable errors reset
the transaction and back off; everything else propagates.

Key selectors resolve the way the reference's getKey does: walk |offset|
keys forward/back from the anchor via shard-routed range reads.
"""

from __future__ import annotations

from dataclasses import dataclass

from foundationdb_tpu_torch.core.errors import (
    AdmissionPreAborted,
    CommitUnknownResult,
    FdbError,
    ProcessKilled,
    UsedDuringCommit,
)
from foundationdb_tpu_torch.runtime.flow import BrokenPromise
from foundationdb_tpu_torch.core.mutations import (
    ATOMIC_OPS,
    Mutation,
    MutationType,
    make_versionstamp,
)
from foundationdb_tpu_torch.core.types import (
    KeyRange,
    MAX_KEY_SIZE,
    MAX_TRANSACTION_SIZE,
    MAX_VALUE_SIZE,
    single_key_range,
)

SPECIAL_KEY_PREFIX = b"\xff\xff"
STATUS_JSON_KEY = b"\xff\xff/status/json"
CONFLICTING_KEYS_PREFIX = b"\xff\xff/transaction/conflicting_keys/"
WORKER_INTERFACES_PREFIX = b"\xff\xff/worker_interfaces/"
from foundationdb_tpu_torch.core.errors import (
    FutureVersion,
    KeyOutsideLegalRange,
    KeyTooLarge,
    NotCommitted,
    TransactionTimedOut,
    TransactionTooLarge,
    ValueTooLarge,
    WrongShardServer,
)
from foundationdb_tpu_torch.obs.span import span_sink
from foundationdb_tpu_torch.runtime.commit_proxy import CommitRequest
from foundationdb_tpu_torch.runtime.shardmap import MAX_KEY, KeyShardMap


async def run_transaction_loop(tr, fn, max_retries: int = 50):
    """THE canonical retry loop (reference: the on_error contract every
    binding implements) — one definition shared by Database.run and
    Tenant.run so their semantics can never diverge."""
    for _ in range(max_retries):
        try:
            result = await fn(tr)
            await tr.commit()
            return result
        except FdbError as e:
            await tr.on_error(e)  # raises if not retryable
    raise FdbError("retry limit reached", code=1021)


@dataclass(frozen=True)
class KeySelector:
    """Reference: fdbclient KeySelectorRef. Resolves to the key `offset`
    positions after (before, if negative) the anchor: the last key < `key`
    (or ≤ `key` when or_equal)."""

    key: bytes
    or_equal: bool
    offset: int

    @classmethod
    def last_less_than(cls, key: bytes) -> "KeySelector":
        return cls(key, False, 0)

    @classmethod
    def last_less_or_equal(cls, key: bytes) -> "KeySelector":
        return cls(key, True, 0)

    @classmethod
    def first_greater_than(cls, key: bytes) -> "KeySelector":
        return cls(key, True, 1)

    @classmethod
    def first_greater_or_equal(cls, key: bytes) -> "KeySelector":
        return cls(key, False, 1)

    def __add__(self, n: int) -> "KeySelector":
        return KeySelector(self.key, self.or_equal, self.offset + n)

    def __sub__(self, n: int) -> "KeySelector":
        return KeySelector(self.key, self.or_equal, self.offset - n)


class Database:
    """Handle to the cluster: GRV proxies, commit proxies, storage routing."""

    def __init__(
        self,
        loop,
        grv_proxy_eps: list,
        commit_proxy_eps: list,
        storage_map: KeyShardMap,
        storage_eps: list,
        controller_ep=None,
        coordinator_eps: list | None = None,
    ):
        self.loop = loop
        self.grv_proxies = grv_proxy_eps
        self.commit_proxies = commit_proxy_eps
        self.storage_map = storage_map
        self.storage_eps = storage_eps
        self.controller = controller_ep
        self.coordinator_eps = list(coordinator_eps or [])
        self.cluster = None  # open_database attaches; special-key reads use it
        self.epoch = 1
        # Round-robin start is randomized per client: with a fixed start
        # every fresh client hammers the same proxy first — and on a
        # multi-region cluster eps[1] can be a standby-region proxy that
        # serves nothing, making a non-retrying caller fail
        # deterministically (deployed multi-region test find). Uses the
        # loop's seeded rng: deterministic under simulation.
        self._rr = loop.rng.randrange(1 << 16) if hasattr(loop, "rng") else 0
        self.transaction_class = Transaction  # ryw.open_database swaps in RYW
        # Failure monitoring (reference: the client's FailureMonitor):
        # storage endpoints that just failed are tried LAST for a TTL, so
        # one dead replica costs one detection delay total — not one per
        # read against its team.
        self._ep_failed_at: dict[int, float] = {}
        # Same for proxies, keyed by endpoint address (see _pick).
        self._proxy_failed_at: dict = {}

    async def refresh_client_info(self) -> None:
        """Re-fetch proxy endpoints from the cluster controller — how clients
        ride through recovery (reference: clients monitor ClientDBInfo and
        swap proxy connections when the epoch changes)."""
        if self.controller is None and not self.coordinator_eps:
            return
        try:
            info = await self.controller.get_client_info()
        except Exception:
            # Controller unreachable — maybe killed and re-elected: ask the
            # coordinators who leads now (reference: clients re-resolve the
            # controller through the cluster file's coordinators).
            await self._relocate_controller()
            try:
                info = await self.controller.get_client_info()
            except Exception:
                return  # still down: keep stale info, retry later
        self.epoch = info.epoch
        # Mid-recovery the controller can publish an empty generation;
        # keep the stale endpoints (they fail retryably) rather than
        # adopting a list the client cannot route through at all.
        if info.grv_proxy_eps:
            self.grv_proxies = list(info.grv_proxy_eps)
        if info.commit_proxy_eps:
            self.commit_proxies = list(info.commit_proxy_eps)

    async def _relocate_controller(self) -> None:
        for ep in self.coordinator_eps:
            try:
                val = await ep.get_leader()
            except Exception:
                continue
            if val and val.get("controller_ep") is not None:
                self.controller = val["controller_ep"]
                return

    def refresh_shard_map(self) -> None:
        """Invalidate the location cache after wrong_shard_server (reference:
        NativeAPI's invalidateCache + re-read of \\xff/keyServers)."""
        if self.cluster is not None:
            self.storage_map = self.cluster.storage_map.clone()

    MAX_SHARD_RETRIES = 5
    FAILED_EP_TTL = 4.0  # how long a failed replica is deprioritized
    PROXY_FAILED_TTL = 5.0  # how long a failed proxy endpoint sits out

    def _order_team(self, team):
        """Team members with recently-failed replicas demoted to the end
        (reference: FailureMonitor-aware load balancing)."""
        now = self.loop.now

        def bad(tag):
            return now - self._ep_failed_at.get(tag, -1e9) < self.FAILED_EP_TTL

        return sorted(team, key=bad)

    async def read_key(self, key: bytes, version: int,
                       token: str | None = None):
        """Point read with replica failover + shard-map refresh: try every
        team member (dead replicas skipped), refresh the map and re-route on
        wrong_shard_server (data distribution moved the shard)."""
        for _ in range(self.MAX_SHARD_RETRIES):
            team = self.storage_map.team_for_key(key)
            wrong_shard = False
            last_future = None
            for tag in self._order_team(team):
                try:
                    return await self.storage_eps[tag].get(
                        key, version, token=token)
                except BrokenPromise:
                    self._ep_failed_at[tag] = self.loop.now
                    continue  # dead/partitioned replica: try the next
                except FutureVersion as e:
                    # Replica behind the read version (pull lag, or a
                    # partitioned region's fenced replica that can NEVER
                    # reach a successor-generation version): demote it
                    # and try a caught-up team member before giving up.
                    self._ep_failed_at[tag] = self.loop.now
                    last_future = e
                    continue
                except WrongShardServer:
                    wrong_shard = True
                    break
            if last_future is not None and not wrong_shard:
                raise last_future
            self.refresh_shard_map()
            if not wrong_shard:
                # Whole team unreachable: brief pause, maybe a recovery or
                # move lands; retried reads are idempotent.
                await self.loop.sleep(0.05)
        raise ProcessKilled(f"no reachable storage replica for {key[:16]!r}")

    async def read_keys(self, keys: list[bytes], version: int,
                        token: str | None = None) -> list:
        """Batched point reads: keys group per owning team and each group
        rides ONE get_multi RPC (the storage side answers the whole group
        from one coalesced probe — reads/). Failover discipline matches
        read_key: team members in failure-demoted order, shard-map refresh
        and re-group on wrong_shard_server. Results are positional."""
        keys = list(keys)
        out: list = [None] * len(keys)
        remaining = list(range(len(keys)))
        for _ in range(self.MAX_SHARD_RETRIES):
            groups: dict[tuple, list[int]] = {}
            for i in remaining:
                team = tuple(self.storage_map.team_for_key(keys[i]))
                groups.setdefault(team, []).append(i)
            retry: list[int] = []
            future_idxs: list[int] = []
            last_future = None
            unreachable = False
            for team, idxs in groups.items():
                sub = [keys[i] for i in idxs]
                try:
                    vals = await self.first_of_team(
                        list(team),
                        lambda tag, sub=sub: self.storage_eps[tag].get_multi(
                            sub, version, token=token),
                    )
                    for i, v in zip(idxs, vals):
                        out[i] = v
                except WrongShardServer:
                    retry.extend(idxs)
                except FutureVersion as e:
                    last_future = e
                    future_idxs.extend(idxs)
                except ProcessKilled:
                    unreachable = True
                    retry.extend(idxs)
            if last_future is not None and not retry:
                # No group needs a re-route: whole-team lag is terminal
                # here, exactly as in read_key.
                raise last_future
            # Lagging-team keys ride the retry loop with the re-routed
            # groups (the map refresh may land them on a caught-up team);
            # they must NEVER fall out of `remaining` as a spurious None.
            retry.extend(future_idxs)
            if not retry:
                return out
            remaining = retry
            self.refresh_shard_map()
            if unreachable:
                await self.loop.sleep(0.05)  # whole team down: brief pause
        raise ProcessKilled("no reachable storage replica for batched read")

    async def watch_key(self, key: bytes, value, token: str | None = None):
        """Arm a watch on the key's current owner. wrong_shard_server —
        at arm time (stale map) or later when the armed shard moves away
        (storage cancel_range fails the watch) — propagates to the watch
        future as a retryable error: the CALLER re-arms, re-reading the
        value first, which is the reference contract. A transparent
        re-arm loop here would leave the future silently parked across
        moves and could not distinguish the two cases anyway."""
        tag = self.storage_map.tag_for_key(key)
        try:
            return await self.storage_eps[tag].watch(key, value, token=token)
        except WrongShardServer:
            self.refresh_shard_map()  # next arm lands on the new owner
            raise

    async def read_range(
        self, begin: bytes, end: bytes, version: int,
        limit: int, reverse: bool, token: str | None = None,
    ) -> list[tuple[bytes, bytes]]:
        """Range read across shards with the same failover/refresh loop."""
        out: list[tuple[bytes, bytes]] = []
        cursor_begin, cursor_end = begin, end
        for _ in range(self.MAX_SHARD_RETRIES):
            try:
                parts = self.storage_map.split_range_teams(
                    KeyRange(cursor_begin, cursor_end)
                )
                if reverse:
                    parts = parts[::-1]
                for r, team in parts:
                    if len(out) >= limit:
                        return out
                    got = await self._read_part(
                        r, team, version, limit - len(out), reverse, token)
                    out.extend(got)
                    # Progress cursor so a later wrong-shard retry does not
                    # re-read (and double-count) finished parts.
                    if reverse:
                        cursor_end = r.begin
                    else:
                        cursor_begin = r.end
                return out
            except WrongShardServer:
                self.refresh_shard_map()
        raise ProcessKilled("shard map kept changing under range read")

    async def first_of_team(self, team, make_call):
        """Try `await make_call(tag)` on every team member in
        failure-demoted order — THE team-failover policy (one definition,
        shared by range reads and locality's shard_stats): dead
        (BrokenPromise) and lagging/fenced (FutureVersion) replicas are
        demoted and the next member tried; a member that no longer serves
        the shard (WrongShardServer) is noted but the rest still get
        their shot. Raise preference: wrong-shard (caller refreshes the
        map) > future-version (caller retries) > no-reachable-replica.
        (Point reads keep their own loop: they STOP at the first
        wrong-shard answer — same team, same stale map — instead of
        trying the remaining members.)"""
        last_wrong: Exception | None = None
        last_future: Exception | None = None
        for tag in self._order_team(team):
            try:
                return await make_call(tag)
            except BrokenPromise:
                self._ep_failed_at[tag] = self.loop.now
                continue
            except FutureVersion as e:
                self._ep_failed_at[tag] = self.loop.now
                last_future = e
                continue
            except WrongShardServer as e:
                last_wrong = e
                continue
        if last_wrong is not None:
            raise last_wrong
        if last_future is not None:
            raise last_future
        raise ProcessKilled("no reachable storage replica in team")

    async def _read_part(
        self, r: KeyRange, team, version: int, limit: int, reverse: bool,
        token: str | None = None,
    ) -> list[tuple[bytes, bytes]]:
        return await self.first_of_team(
            team,
            lambda tag: self.storage_eps[tag].get_range(
                r.begin, r.end, version, limit=limit, reverse=reverse,
                token=token,
            ),
        )

    def _pick(self, eps: list):
        """Round-robin over proxy endpoints, skipping recently-failed ones.

        The demotion matters beyond plain failover: a retry loop calls
        _pick twice per attempt (GRV then commit), so with a bare rotation
        over 2 proxies the parity locks — GRV lands on the healthy proxy
        every attempt and commit on the broken one, forever (deployed
        multi-region find: the standby region's proxy is up but serves
        nothing). Failed endpoints sit out PROXY_FAILED_TTL seconds."""
        if not eps:
            # No known endpoints (fresh client against a recovering
            # cluster): retryable — on_error refreshes the client info.
            raise ProcessKilled("no known proxy endpoints")
        self._rr += 1
        now = self.loop.now
        n = len(eps)
        for j in range(n):
            ep = eps[(self._rr + j) % n]
            if (now - self._proxy_failed_at.get(self._ep_addr(ep), -1e9)
                    >= self.PROXY_FAILED_TTL):
                return ep
        return eps[self._rr % n]  # everything demoted: plain rotation

    @staticmethod
    def _ep_addr(ep):
        """Stable identity for a proxy endpoint (its peer address /
        process): grv and commit endpoint objects for the same process
        must share one demotion entry, and refreshed endpoint lists must
        keep it. NOTE: both transports' endpoint classes synthesize RPC
        stubs via __getattr__ for non-underscore names — only their REAL
        attributes (`_addr`; sim `process`) are safe to probe."""
        addr = ep.__dict__.get("_addr")  # deployed RemoteEndpoint
        if addr is not None:
            return addr
        proc = ep.__dict__.get("process")  # sim Endpoint
        if proc is not None:
            return proc
        return id(ep)

    def note_proxy_failed(self, ep) -> None:
        self._proxy_failed_at[self._ep_addr(ep)] = self.loop.now

    def transaction(self) -> "Transaction":
        return self.transaction_class(self)

    async def run(self, fn, max_retries: int = 50):
        """Run `await fn(tr)` + commit with the standard retry loop."""
        return await run_transaction_loop(self.transaction(), fn, max_retries)


class Transaction:
    """Raw (non-RYW) transaction: reads see the snapshot only; your own
    writes become visible after commit. client/ryw.py layers read-your-writes
    on top (and is what Database.run hands out in practice via layers)."""

    MAX_BACKOFF = 1.0
    # Admission pre-abort pacing (the repair engine's score-scaled
    # jittered formula, starting far below the blind ladder): delay =
    # min(cap, base · odds · 2^streak) · jitter(0.5..1.5), where streak
    # counts CONSECUTIVE pre-aborts of this transaction — first retries
    # are near-immediate (the pre-abort cost the cluster almost nothing),
    # but a txn losing over and over escalates toward the cap so hot-key
    # storms cannot starve a client into its retry limit.
    PREABORT_BACKOFF_BASE = 0.0005
    PREABORT_BACKOFF_CAP = 0.1

    def __init__(self, db: Database):
        self.db = db
        self._backoff = 0.01
        # Options survive resets, like reference options on a retry loop.
        self.report_conflicting_keys = False  # fdb option 712
        self.tags: set[str] = set()  # fdb option TAG (ratekeeper throttling)
        self.timeout_ms: int | None = None  # option 500
        self.retry_limit: int | None = None  # option 501
        self.size_limit: int | None = None  # option 503
        self.access_system_keys = False  # option 301
        self.lock_aware = False  # option 306: commit despite database lock
        self.authorization_token: str | None = None  # option 2000
        # Admission lane (reference: PRIORITY_SYSTEM_IMMEDIATE option 200 /
        # PRIORITY_BATCH option 201): shapes both the GRV lane and the
        # commit proxy's batch formation (sched/lanes.py).
        self.priority = "default"
        # Admission-control opt-out (admission subsystem): fail with
        # AdmissionShaped (retryable) instead of riding the serializing
        # shaped lane — for latency-sensitive clients that prefer an
        # immediate error to a queue position.
        self.admission_no_shape = False
        self._retries = 0  # attempts consumed by on_error (for retry_limit)
        self._preabort_streak = 0  # consecutive pre-aborts (pacing)
        # Commit-path tracing (obs subsystem): None = sampling undecided,
        # False = not sampled, TraceContext = sampled. Decided once per
        # transaction LIFETIME (at the first GRV) so a retried txn keeps
        # its trace id; per-attempt stamps live in _obs_grv (reset-able).
        self._obs = None
        self._obs_grv: "tuple[float, float] | None" = None
        self._reset()

    def set_option(self, name: str, value=None) -> None:
        """Transaction options (reference: fdb_transaction_set_option);
        only the ones this client implements."""
        if name == "report_conflicting_keys":
            self.report_conflicting_keys = True
        elif name == "tag":
            if not value:
                raise FdbError("tag option requires a value", code=2006)
            self.tags.add(value)
        elif name == "timeout":
            ms = int(value)
            # Reference option 500: value 0 clears a previously-set timeout.
            self.timeout_ms = ms if ms > 0 else None
            if self.timeout_ms is not None:
                self._deadline = self._start + self.timeout_ms / 1000.0
        elif name == "retry_limit":
            self.retry_limit = int(value)
        elif name == "size_limit":
            limit = int(value)
            if not 32 <= limit <= MAX_TRANSACTION_SIZE:
                # Rejected option must be a no-op.
                raise FdbError(
                    f"size_limit {value} outside [32, "
                    f"{MAX_TRANSACTION_SIZE}]", code=2006)
            self.size_limit = limit
        elif name == "access_system_keys":
            self.access_system_keys = True
        elif name == "lock_aware":
            self.lock_aware = True
        elif name == "priority_system_immediate":
            self.priority = "system"
        elif name == "priority_batch":
            self.priority = "batch"
        elif name == "admission_no_shape":
            self.admission_no_shape = True
        elif name == "authorization_token":
            if not value:
                raise FdbError("authorization_token requires a value",
                               code=2006)
            self.authorization_token = (
                value.decode() if isinstance(value, bytes) else str(value))
        else:
            raise FdbError(f"unknown transaction option {name!r}", code=2006)

    def _check_timeout(self) -> None:
        if self.timeout_ms is not None and self.db.loop.now > self._deadline:
            raise TransactionTimedOut(
                f"transaction exceeded {self.timeout_ms}ms")

    def _reset(self) -> None:
        # Timeout measures from creation/reset, like the reference (the
        # option itself survives resets; the clock restarts per attempt).
        self._start = self.db.loop.now
        if self.timeout_ms is not None:
            self._deadline = self._start + self.timeout_ms / 1000.0
        self._read_version: int | None = None
        self.mutations: list[Mutation] = []
        self.read_ranges: list[KeyRange] = []
        self.write_ranges: list[KeyRange] = []
        self._committed: tuple[int, int] | None = None  # (version, batch_order)
        self._pending_watches: list[tuple[bytes, bytes | None]] = []
        self._watch_futures: list = []
        self._conflicting_ranges: list[tuple[bytes, bytes]] = []
        self._obs_grv = None  # per-attempt GRV stamp (obs subsystem)

    # -- versions -------------------------------------------------------------

    async def get_read_version(self) -> int:
        self._check_timeout()
        if self._read_version is None:
            if self._obs is None:
                # Sampling decision (obs subsystem): once per txn, at the
                # first GRV — counter-based, so it never perturbs the
                # loop's seeded RNG stream. None (no sink / not sampled)
                # collapses to False: decided, unsampled.
                sink = span_sink(self.db.loop)
                self._obs = (sink.sample() if sink is not None
                             else None) or False
            t_grv = self.db.loop.now if self._obs else 0.0
            ep = self.db._pick(self.db.grv_proxies)
            try:
                self._read_version = await ep.get_read_version(
                    # Lane pass-through: system traffic must reach the GRV
                    # proxy AS system — it bypasses ratekeeper admission
                    # there (campaign find: mapping system onto the default
                    # lane let resolver-queue backpressure starve system
                    # txns behind the very storm they outrank).
                    self.priority,
                    sorted(self.tags) if self.tags else None,
                )
            except BrokenPromise as e:
                # Dead/retired GRV proxy: retryable — on_error refreshes the
                # proxy list from the controller before the next attempt.
                self.db.note_proxy_failed(ep)
                raise ProcessKilled(str(e)) from e
            except ProcessKilled as e:
                if "unconfirmed" in str(e) and str(e).startswith("grv epoch"):
                    # The proxy's epoch-liveness confirm failed (its tlog
                    # set is locked/fenced/unreachable): it can mint no
                    # read versions until stand-down — demote it so the
                    # retry rotates to a confirmable proxy immediately.
                    self.db.note_proxy_failed(ep)
                raise
            except FdbError as e:
                if e.code == 1500 and str(e).startswith("no service"):
                    # Proxy process up but serving no recruited role yet
                    # (standby-region proxy, or mid-recruitment): same
                    # recovery path as a dead proxy — demote + retry
                    # rotates to a recruited one.
                    self.db.note_proxy_failed(ep)
                    raise ProcessKilled(str(e)) from e
                raise
            if self._obs:
                # grv_wait stage: request -> grant, queue/deferral incl.
                self._obs_grv = (t_grv, self.db.loop.now - t_grv)
        return self._read_version

    def set_read_version(self, version: int) -> None:
        self._read_version = version

    @property
    def committed_version(self) -> int:
        if self._committed is None:
            raise FdbError("transaction not committed", code=2021)
        return self._committed[0]

    def get_versionstamp(self) -> bytes:
        """The 10-byte stamp this txn's versionstamped ops used (valid after
        commit; reference: Transaction::getVersionstamp)."""
        v, order = self._committed if self._committed else (None, None)
        if v is None:
            raise FdbError("transaction not committed", code=2021)
        return make_versionstamp(v, order)

    # -- reads ----------------------------------------------------------------

    async def get(self, key: bytes, snapshot: bool = False) -> bytes | None:
        self._check_timeout()
        if key.startswith(SPECIAL_KEY_PREFIX):
            return await self._get_special(key)
        _check_key(key)
        version = await self.get_read_version()
        value = await self._fetch_key(key, version)
        if not snapshot:
            self.read_ranges.append(single_key_range(key))
        return value

    async def get_multi(self, keys, snapshot: bool = False) -> list:
        """Batched point reads: one round trip per owning team instead of
        one per key (Database.read_keys → storage get_multi → the
        coalesced probe). Positional results; conflict-range accounting
        identical to the same sequence of get() calls."""
        self._check_timeout()
        keys = list(keys)
        if any(k.startswith(SPECIAL_KEY_PREFIX) for k in keys):
            # Special keys are client-synthesized — no batched path.
            return [await self.get(k, snapshot) for k in keys]
        for key in keys:
            _check_key(key)
        if not keys:
            return []
        version = await self.get_read_version()
        values = await self._fetch_keys(keys, version)
        if not snapshot:
            for key in keys:
                self.read_ranges.append(single_key_range(key))
        return values

    # Storage-fetch seams: the repair engine's transaction subclass
    # (repair/engine.py RepairableTransaction) overrides these to serve
    # replayed reads from its recorded cache — conflict-range accounting
    # above stays identical either way.

    async def _fetch_key(self, key: bytes, version: int) -> bytes | None:
        return await self.db.read_key(key, version,
                                      token=self.authorization_token)

    async def _fetch_keys(self, keys: list[bytes], version: int) -> list:
        # A subclass that re-points the single-key seam (repair's replayed
        # reads) keeps batched reads consistent automatically: route
        # through ITS _fetch_key rather than bypassing the override.
        if type(self)._fetch_key is not Transaction._fetch_key:
            return [await self._fetch_key(k, version) for k in keys]
        return await self.db.read_keys(keys, version,
                                       token=self.authorization_token)

    async def _fetch_range(
        self, begin: bytes, end: bytes, version: int, limit: int,
        reverse: bool,
    ) -> list[tuple[bytes, bytes]]:
        return await self.db.read_range(begin, end, version, limit, reverse,
                                        token=self.authorization_token)

    async def _get_special(self, key: bytes) -> bytes | None:
        """The special key space (reference: SpecialKeySpace — synthetic
        reads served by the client, no conflict ranges). Only the status
        document is populated, like the reference's most-used entry."""
        if key == STATUS_JSON_KEY and self.db.cluster is not None:
            import json

            from foundationdb_tpu_torch.runtime.status import fetch_status

            doc = await fetch_status(self.db.cluster)
            return json.dumps(doc).encode()
        if key.startswith(CONFLICTING_KEYS_PREFIX):
            for k, v in self._conflicting_rows():
                if k == key:
                    return v
            return None
        if key.startswith(WORKER_INTERFACES_PREFIX):
            for k, v in self._worker_interface_rows():
                if k == key:
                    return v
            return None
        return None

    def _worker_interface_rows(self) -> list[tuple[bytes, bytes]]:
        """\xff\xff/worker_interfaces/<process> rows (reference: the
        module fdbcli uses for process discovery/kill): one row per live
        generation process plus persistent storages, valued with a small
        JSON of role info."""
        import json

        cluster = self.db.cluster
        if cluster is None:
            return []
        rows: list[tuple[bytes, bytes]] = []
        dead = cluster.loop.dead_processes
        gen = cluster.controller.generation
        procs: dict[str, str] = {p: "generation" for p in gen.heartbeat_eps}
        for p in cluster.storage_procs():
            # Real process names — region-prefixed on multi-region
            # clusters, where a bare "storage0" would advertise a row
            # that names nothing (kills through it no-op, dead-filter
            # never matches).
            procs.setdefault(p, "storage")
        for p in sorted(procs):
            if p in dead:
                continue
            rows.append((
                WORKER_INTERFACES_PREFIX + p.encode(),
                json.dumps({"process": p, "class": procs[p],
                            "epoch": gen.epoch}).encode(),
            ))
        return rows

    def _conflicting_rows(self) -> list[tuple[bytes, bytes]]:
        """\\xff\\xff/transaction/conflicting_keys/ rows from the last
        failed commit attempt: merged conflicting ranges as boundary
        markers — range begins valued \\x01, range ends \\x00 (the
        reference's exact format)."""
        merged: list[tuple[bytes, bytes]] = []
        for b, e in sorted(self._conflicting_ranges):
            if merged and b <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((b, e))
        rows: list[tuple[bytes, bytes]] = []
        for b, e in merged:
            rows.append((CONFLICTING_KEYS_PREFIX + b, b"\x01"))
            rows.append((CONFLICTING_KEYS_PREFIX + e, b"\x00"))
        return rows

    async def get_range(
        self,
        begin: bytes,
        end: bytes,
        limit: int = 0,
        reverse: bool = False,
        snapshot: bool = False,
    ) -> list[tuple[bytes, bytes]]:
        """Rows in [begin, end); limit 0 = unlimited. The read conflict range
        covers only what the result depends on: up to the last key returned
        when the limit truncates the scan (reference: getRange conflict-range
        trimming in NativeAPI)."""
        self._check_timeout()
        if begin.startswith(SPECIAL_KEY_PREFIX):
            synthetic = self._conflicting_rows() + self._worker_interface_rows()
            rows = sorted(
                (k, v) for k, v in synthetic if begin <= k < end
            )
            if reverse:
                rows.reverse()
            return rows[:limit] if limit > 0 else rows
        version = await self.get_read_version()
        cap = limit if limit > 0 else 1 << 30
        rows = await self._fetch_range(begin, end, version, cap, reverse)
        rows = rows[:cap]
        if not snapshot:
            if limit > 0 and len(rows) == cap and rows:
                if reverse:
                    conflict = KeyRange(rows[-1][0], end)
                else:
                    conflict = KeyRange(begin, rows[-1][0] + b"\x00")
            else:
                conflict = KeyRange(begin, end)
            if not conflict.empty:
                self.read_ranges.append(conflict)
        return rows

    def _keyspace_end(self) -> bytes:
        """Exclusive end of the keyspace this transaction may resolve
        selectors in: the user keyspace unless access_system_keys."""
        return MAX_KEY if self.access_system_keys else b"\xff"

    def _token_span(self) -> tuple[bytes, bytes] | None:
        """Covering span [lo, hi) of the transaction token's prefixes —
        selector scans clamp to it, or a prefix-scoped token could never
        resolve selectors (the scan-to-the-keyspace-edge read is denied
        at storage; review finding). The token payload is readable
        without the key (signatures protect integrity, not secrecy).
        Multi-prefix tokens get their covering span; scans crossing the
        GAPS between prefixes are still denied server-side — use one
        token per tenant (TenantTransaction clamps exactly)."""
        if not self.authorization_token:
            return None
        try:
            import base64 as _b64
            import json as _json

            payload = self.authorization_token.split(".", 1)[0]
            doc = _json.loads(_b64.urlsafe_b64decode(
                payload + "=" * (-len(payload) % 4)))
            prefixes = [bytes.fromhex(p) for p in doc["prefixes"]]
        except Exception:
            return None  # malformed: let the server be the judge
        if not prefixes or b"" in prefixes:
            return None  # whole-user-keyspace grant: no clamp needed
        from foundationdb_tpu_torch.core.types import strinc

        return min(prefixes), max(strinc(p) for p in prefixes)

    async def get_key(self, sel: KeySelector, snapshot: bool = False) -> bytes:
        """Resolve a key selector (reference: Transaction::getKey). Returns
        b"" when the selector runs off the front, MAX_KEY off the back.

        Without access_system_keys, resolution is confined to the user
        keyspace [b"", b"\\xff"): BOTH scan directions stop at b"\\xff", so
        system keys (e.g. the TimeKeeper's \\xff\\x02/ samples) can neither
        be returned nor be included in the recorded read-conflict range —
        otherwise every 10s system commit would spuriously conflict-abort
        transactions whose selectors ran off the end of user data
        (reference: getKey clamps non-system transactions to maxKey).
        With a prefix-scoped authz token, resolution is further confined
        to the token's covering span (scans outside it are denied at
        storage anyway)."""
        self._check_timeout()
        version = await self.get_read_version()
        anchor = sel.key
        space_end = self._keyspace_end()
        space_begin = b""
        span = self._token_span()
        if span is not None:
            space_begin = max(space_begin, span[0])
            space_end = min(space_end, span[1])
        # Position 0 is "last key ≤/< anchor"; walk |offset| from there.
        if sel.offset >= 1:
            # forward: the offset-th key in order from (anchor, or_equal ? > : ≥)
            begin = min(anchor + b"\x00" if sel.or_equal else anchor, space_end)
            begin = max(begin, space_begin)
            rows = await self._scan_keys(begin, space_end, sel.offset, False, version)
            result = rows[sel.offset - 1] if len(rows) >= sel.offset else MAX_KEY
        else:
            back = 1 - sel.offset  # how many keys back from the anchor
            end = min(anchor + b"\x00" if sel.or_equal else anchor, space_end)
            end = max(end, space_begin)
            rows = await self._scan_keys(space_begin, end, back, True, version)
            result = rows[back - 1] if len(rows) >= back else b""
        if not snapshot:
            # Result depends on the span between anchor and resolved key,
            # clipped to the space actually scanned.
            lo, hi = sorted((min(anchor, space_end), min(result, space_end)))
            self.read_ranges.append(KeyRange(lo, hi + b"\x00"))
        return result

    async def _scan_keys(
        self, begin: bytes, end: bytes, limit: int, reverse: bool, version: int
    ) -> list[bytes]:
        rows = await self.db.read_range(begin, end, version, limit, reverse,
                                        token=self.authorization_token)
        return [k for k, _v in rows[:limit]]

    async def watch(self, key: bytes) -> "object":
        """Register a watch armed at commit (reference: watches are part of
        the commit). Returns a Future resolving when the key's value changes
        from what this txn observed."""
        value = await self.get(key, snapshot=True)
        from foundationdb_tpu_torch.runtime.flow import Future

        slot = Future()
        self._pending_watches.append((key, value))
        self._watch_futures.append(slot)
        return slot

    # -- writes ---------------------------------------------------------------

    def set(self, key: bytes, value: bytes) -> None:
        _check_writable_key(key, self.access_system_keys)
        _check_value(value)
        self.mutations.append(Mutation(MutationType.SET_VALUE, key, value))
        self.write_ranges.append(single_key_range(key))

    def clear(self, key: bytes) -> None:
        _check_writable_key(key, self.access_system_keys)
        self.mutations.append(Mutation(MutationType.CLEAR_RANGE, key, key + b"\x00"))
        self.write_ranges.append(single_key_range(key))

    def clear_range(self, begin: bytes, end: bytes) -> None:
        r = KeyRange(begin, end)
        if r.empty:
            return
        _check_writable_key(begin, self.access_system_keys)
        end_cap = b"\xff\xff" if self.access_system_keys else b"\xff"
        if end > end_cap:
            raise KeyOutsideLegalRange(
                f"clear_range end {end[:16]!r} beyond {end_cap!r}")
        self.mutations.append(Mutation(MutationType.CLEAR_RANGE, begin, end))
        self.write_ranges.append(r)

    def atomic_op(self, op: MutationType, key: bytes, param: bytes) -> None:
        if op not in ATOMIC_OPS and op not in (
            MutationType.SET_VERSIONSTAMPED_KEY,
            MutationType.SET_VERSIONSTAMPED_VALUE,
        ):
            raise ValueError(f"not an atomic op: {op!r}")
        _check_writable_key(key, self.access_system_keys)
        self.mutations.append(Mutation(op, key, param))
        if op == MutationType.SET_VERSIONSTAMPED_KEY:
            # The final key is unknown until commit: conflict over every key
            # the stamp substitution could produce (prefix below the offset,
            # then any stamp + suffix).
            import struct

            (off,) = struct.unpack("<I", key[-4:])
            prefix = key[:-4][:off]
            self.write_ranges.append(KeyRange(prefix, prefix + b"\xff" * 11))
        else:
            self.write_ranges.append(single_key_range(key))

    def add_read_conflict_range(self, begin: bytes, end: bytes) -> None:
        self.read_ranges.append(KeyRange(begin, end))

    def add_write_conflict_range(self, begin: bytes, end: bytes) -> None:
        self.write_ranges.append(KeyRange(begin, end))

    # -- commit ---------------------------------------------------------------

    @property
    def is_read_only(self) -> bool:
        return not self.mutations and not self.write_ranges

    def get_approximate_size(self) -> int:
        """Commit-size estimate of the accumulated mutations + conflict
        ranges (reference: Transaction::getApproximateSize; same number
        the size_limit/transaction_too_large check uses)."""
        return sum(
            len(m.param1) + len(m.param2) + 24 for m in self.mutations
        ) + sum(
            len(r.begin) + len(r.end) + 16
            for r in self.read_ranges + self.write_ranges
        )

    async def commit(self) -> int:
        if self._committed is not None:
            raise UsedDuringCommit("commit() called twice")
        self._check_timeout()
        version = await self.get_read_version()
        if self.is_read_only:
            self._committed = (version, 0)
            self._arm_watches()  # read-only txns still arm watches at commit
            return version
        size = self.get_approximate_size()
        cap = min(self.size_limit or MAX_TRANSACTION_SIZE, MAX_TRANSACTION_SIZE)
        if size > cap:
            raise TransactionTooLarge(f"{size} > {cap}")
        req = CommitRequest(
            read_version=version,
            mutations=list(self.mutations),
            read_ranges=list(self.read_ranges),
            write_ranges=list(self.write_ranges),
            report_conflicting_keys=self.report_conflicting_keys,
            lock_aware=self.lock_aware,
            token=self.authorization_token,
            priority=self.priority,
            admission_no_shape=self.admission_no_shape,
            admission_attempts=self._preabort_streak,
            # Sampled txns carry their trace id so the proxy stamps
            # stage spans onto the reply (obs subsystem).
            trace=self._obs.tid if self._obs else None,
        )
        commit_ep = self.db._pick(self.db.commit_proxies)
        t_commit = self.db.loop.now if self._obs else 0.0
        try:
            res = await commit_ep.commit(req)
        except NotCommitted as e:
            # Stash the resolver's conflicting ranges for this attempt:
            # readable via \xff\xff/transaction/conflicting_keys/ until
            # the next reset (reference: SpecialKeySpace module backed by
            # the commit reply's conflictingKRIndices). The failed batch's
            # commit version + hot-range odds stay on the exception —
            # that's what the repair engine consumes (repair/engine.py).
            self._conflicting_ranges = list(e.conflicting_ranges or [])
            raise
        except BrokenPromise as e:
            # Proxy died mid-commit: the batch may or may not have reached
            # the tlogs — exactly commit_unknown_result.
            self.db.note_proxy_failed(commit_ep)
            raise CommitUnknownResult(str(e)) from e
        except FdbError as e:
            if e.code == 1500 and str(e).startswith("no service"):
                # Unrecruited proxy (standby region / mid-recruitment):
                # the commit never entered a batch, so this is a KNOWN
                # non-commit — plain retryable, not unknown-result.
                self.db.note_proxy_failed(commit_ep)
                raise ProcessKilled(str(e)) from e
            raise
        self._committed = (res.version, res.batch_order)
        if self._obs:
            try:
                self._obs_record_commit(getattr(res, "spans", None),
                                        t_commit, self.db.loop.now)
            except Exception:
                # Tracing bookkeeping must never fail a transaction that
                # IS durably committed (a malformed spans tuple from a
                # buggy/older proxy would otherwise raise out of commit()
                # and skip arming the watches below).
                pass
        self._arm_watches()
        return res.version

    def _obs_record_commit(self, proxy_spans, t0: float, t1: float) -> None:
        """Assemble this sampled txn's exact commit-path breakdown from
        the client-measured GRV/commit envelopes plus the proxy's
        piggybacked stage spans, and record it (span tree + per-stage
        histograms + the arithmetic residue as `unattributed`). e2e is
        the COMMIT PATH only — grv_wait + the commit round trip — so the
        identity e2e == sum(stages) + unattributed is exact and app
        think-time between reads never pollutes it.

        A sampled commit answered WITHOUT spans (the proxy process runs
        untraced — e.g. servers started without FDB_TPU_OBS=1, or an
        older peer) still records: grv_wait plus the whole commit round
        trip as `unattributed`, so the report says loudly that the
        server side is dark instead of silently showing nothing."""
        sink = span_sink(self.db.loop)
        if sink is None:
            return
        commit_dur = t1 - t0
        e2e = commit_dur
        stages: list[tuple[str, float, float]] = []
        if self._obs_grv is not None:
            g0, g_dur = self._obs_grv
            stages.append(("grv_wait", g0, g_dur))
            e2e += g_dur
        if proxy_spans:
            proxy_total = 0.0
            for name, start, dur in proxy_spans:
                if name == "proxy_total":
                    proxy_total = dur
                else:
                    stages.append((name, start, dur))
            # The transport residue: commit round trip minus the proxy's
            # envelope (request + reply legs, client/proxy queueing
            # outside the stamped stages). Clamped at 0 against
            # cross-process clock skew; the exact residue still lands in
            # `unattributed`.
            stages.append(("reply", t0, max(0.0, commit_dur - proxy_total)))
        sink.record_txn(self._obs.tid, e2e, stages)

    def _arm_watches(self) -> None:
        for (key, value), slot in zip(self._pending_watches, self._watch_futures):
            # Database.watch_key re-routes on wrong_shard_server (the
            # shard may have moved between read and commit) — the seed
            # armed directly on the possibly-stale location.
            fut = self.db.loop.spawn(
                self.db.watch_key(key, value,
                                  token=self.authorization_token),
                name="watch_arm",
            )
            fut.add_done_callback(
                lambda f, s=slot: s._finish(f._state, f._value)
            )
        self._pending_watches, self._watch_futures = [], []

    async def on_error(self, e: FdbError) -> None:
        """Reset + backoff for retryable errors; re-raise otherwise."""
        # This attempt's un-armed watches can never fire (reference fails
        # them with transaction_cancelled).
        for slot in self._watch_futures:
            slot._finish("error", FdbError("transaction reset", code=1025))
        self._pending_watches, self._watch_futures = [], []
        if not isinstance(e, FdbError) or not e.retryable:
            raise e
        self._retries += 1
        if self.retry_limit is not None and self._retries > self.retry_limit:
            raise e  # option 501: give up after N retries (reference)
        if isinstance(e, AdmissionPreAborted):
            # Admission pre-abort: a PROVEN loss detected before dispatch.
            # The blind exponential ladder is the wrong pacing here — the
            # proxy attached its hot-range odds, so apply the repair
            # subsystem's score-scaled jittered backoff instead and do
            # NOT consume the ladder (the next real conflict still starts
            # from the small backoff). This is what turns the abort storm
            # into a paced queue instead of a sleep pile-up; the streak
            # escalation bounds how long a persistent loser spins.
            self._reset()
            odds = max((s for _b, _e2, s in (e.hot_ranges or [])),
                       default=0.0)
            delay = min(self.PREABORT_BACKOFF_CAP,
                        self.PREABORT_BACKOFF_BASE * max(odds, 1.0)
                        * (1 << min(self._preabort_streak, 16)))
            self._preabort_streak += 1
            await self.db.loop.sleep(
                delay * (0.5 + self.db.loop.rng.random()))
            return
        self._preabort_streak = 0
        backoff = self._backoff
        self._backoff = min(self.MAX_BACKOFF, self._backoff * 2)
        self._reset()
        await self.db.loop.sleep(backoff * (0.5 + self.db.loop.rng.random()))
        # Only errors that can signal a generation change warrant a trip to
        # the controller — plain conflict retries must stay proxy-local.
        if isinstance(e, (CommitUnknownResult, ProcessKilled)):
            await self.db.refresh_client_info()


def _check_key(key: bytes) -> None:
    if len(key) > MAX_KEY_SIZE:
        raise KeyTooLarge(f"{len(key)} > {MAX_KEY_SIZE}")


def _check_writable_key(key: bytes, allow_system: bool = False) -> None:
    """Writes to the system keyspace (keys starting with 0xff) are illegal
    unless the transaction set the access_system_keys option (reference:
    error 2004 key_outside_legal_range on such mutations). The
    double-0xff special-key space is never directly writable."""
    _check_key(key)
    if key.startswith(SPECIAL_KEY_PREFIX):
        raise KeyOutsideLegalRange(f"write to special key {key[:16]!r}")
    if key.startswith(b"\xff") and not allow_system:
        raise KeyOutsideLegalRange(f"write to system key {key[:16]!r}")


def _check_value(value: bytes) -> None:
    if len(value) > MAX_VALUE_SIZE:
        raise ValueTooLarge(f"{len(value)} > {MAX_VALUE_SIZE}")
