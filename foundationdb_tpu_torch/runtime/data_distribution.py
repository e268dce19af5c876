"""Data distribution: shard split/merge on size, movement between teams,
and load rebalancing — with traffic running.

A copy of ``foundationdb_tpu/runtime/data_distribution.py`` for the port,
its imports rewritten to the port's modules; names and behaviour are the
JAX module's.

Reference: fdbserver/DataDistribution.actor.cpp (the monitor/queue) +
MoveKeys.actor.cpp (the movement protocol). The shape kept here:

- **Split/merge are metadata-only**: a boundary is inserted at the shard's
  byte-median key (storage suggests it, splitMetrics-style) or removed when
  both neighbours are small and same-team. No data moves.
- **Movement is a dual-tag window**: the shard's team is widened to
  src ∪ dst (commit proxies immediately tag new mutations for both sides),
  each new member fetchKeys-copies the range from a source replica while
  buffering its concurrent tagged mutations, and once every new member has
  applied past its snapshot version the map flips to dst and the departing
  members stop serving above the flip version. In-window readers with old
  read versions keep hitting the departing replica until GC retires it —
  the same grace the reference gets from reading the keyServers map at the
  transaction's version.
- **Rebalance** moves a shard from the most-loaded storage to a team led
  by the least-loaded (reference: DDQueue's rebalancing moves).

Serve-set bookkeeping (begin_serve/end_serve) is applied directly to the
storage objects: it is control-plane state the reference carries through
private mutations in the system keyspace; the data path (fetch, reads,
mutation flow) goes through endpoints and is fault-injectable.
"""

from __future__ import annotations

from foundationdb_tpu_torch.core.types import KeyRange
from foundationdb_tpu_torch.runtime.flow import Loop, rpc

MAX_MOVE_RETRIES = 3


class DataDistributor:
    POLL_INTERVAL = 0.4
    SPLIT_BYTES = 5_000  # sim-scale thresholds (reference: 500MB/125MB)
    MERGE_BYTES = 500
    REBALANCE_RATIO = 3.0  # max/min primary-bytes ratio that triggers a move

    def __init__(self, loop: Loop, cluster, replication: int = 1):
        self.loop = loop
        self.cluster = cluster
        self.replication = replication
        self.splits = 0
        self.merges = 0
        self.moves = 0
        self.move_failures = 0
        self.repairs = 0
        self._moving = False
        # Maintenance exclusion (reference: fdbcli exclude / the excluded
        # servers list in \xff/conf): excluded storages receive no new
        # shards and their current shards are drained onto other teams;
        # they remain valid COPY SOURCES while draining (they are alive —
        # that is the point of graceful exclusion vs. a kill).
        self.excluded: set[int] = set()

    @rpc
    async def get_metrics(self) -> dict:
        return {
            "splits": self.splits,
            "merges": self.merges,
            "moves": self.moves,
            "move_failures": self.move_failures,
            "repairs": self.repairs,
            "shards": self.cluster.storage_map.n_shards,
            "excluded": sorted(self.excluded),
        }

    # -- maintenance (reference: fdbcli exclude/include) ----------------------

    @rpc
    async def exclude(self, tag: int) -> None:
        self.excluded.add(tag)

    @rpc
    async def include(self, tag: int) -> None:
        self.excluded.discard(tag)

    @rpc
    async def is_drained(self, tag: int) -> bool:
        """True when no shard's team contains `tag` — the safe-to-remove
        signal the reference's `exclude` blocks on."""
        return all(
            tag not in sh.team for sh in self.cluster.storage_map.shards
        )

    def _placeable(self, tags) -> list[int]:
        return [t for t in tags if t not in self.excluded]

    async def run(self) -> None:
        while True:
            await self.loop.sleep(self.POLL_INTERVAL)
            try:
                await self._pass()
            except Exception:
                continue  # transient role failure: next pass retries

    # -- one monitoring pass --------------------------------------------------

    async def _pass(self) -> None:
        """One monitoring pass over ONE stats snapshot: each shard's stats
        are fetched once and reused by the split, merge, and rebalance
        decisions (shard_stats is a full key-walk on the storage server —
        re-fetching per decision would triple control-plane load)."""
        await self._repair_teams()

        m = self.cluster.storage_map
        shards = m.shards
        stats = [await self._shard_stats(s) for s in shards]
        # Publish per-shard bytes for density consumers (resolver split
        # derivation at recovery reads this — see cluster._derive_resolver_map).
        self.cluster.dd_shard_bytes = [
            (s.range.begin, s.range.end, st["bytes"])
            for s, st in zip(shards, stats)
        ]

        split_ranges = []
        for s, st in zip(shards, stats):
            if st["bytes"] > self.SPLIT_BYTES and st["split_key"]:
                if m.split_at(st["split_key"]):
                    self.splits += 1
                    split_ranges.append(s.range)

        # Merge small same-team neighbours, judged on the snapshot (pairs
        # touched by a fresh split are skipped — they are big by definition).
        for i in range(len(shards) - 1):
            a, b = shards[i], shards[i + 1]
            if a.team != b.team or a.range in split_ranges or b.range in split_ranges:
                continue
            if stats[i]["bytes"] + stats[i + 1]["bytes"] < self.MERGE_BYTES:
                if m.merge_at(b.range.begin):
                    self.merges += 1

        await self._maybe_rebalance(list(zip(shards, (st["bytes"] for st in stats))))

    async def _shard_stats(self, shard) -> dict:
        """Stats from any live team member (kills are permanent in the sim:
        a dead primary must not wedge the monitor forever)."""
        err: Exception | None = None
        # Infrastructure actor: carries the system token on authz-armed
        # clusters (shard_stats is token-checked like every read).
        token = getattr(self.cluster, "authz_system_token", None)
        for tag in shard.team:
            try:
                return await self.cluster.storage_eps[tag].shard_stats(
                    shard.range.begin, shard.range.end, token=token
                )
            except Exception as e:
                err = e
        raise err if err else RuntimeError("empty team")

    def _live_tags(self) -> list[int]:
        dead = self.cluster.loop.dead_processes
        return [
            t for t in range(len(self.cluster.storage_eps))
            if f"storage{t}" not in dead
        ]

    async def _repair_teams(self) -> None:
        """Restore the replication factor after permanent replica loss.

        Reference: DDTeamCollection marks teams containing a failed server
        unhealthy and the DDQueue relocates their shards onto healthy
        teams. Here: any shard whose team has a dead member is moved to
        (survivors + least-indexed spare live storages), which re-copies
        the shard via the normal dual-tag fetch_keys window — no operator
        action. Shards with no live replica are unrecoverable and left
        for recovery/restore; with no spare capacity the shard stays
        degraded and is retried next pass."""
        live = set(self._live_tags())
        m = self.cluster.storage_map
        for shard in list(m.shards):
            # Members needing replacement: dead, or excluded (draining).
            unwanted = [
                t for t in shard.team
                if t not in live or t in self.excluded
            ]
            if not unwanted:
                continue
            keep = [t for t in shard.team
                    if t in live and t not in self.excluded]
            if not any(t in live for t in shard.team):
                continue  # all replicas lost: nothing to copy from
            want = max(len(shard.team), self.replication)
            spares = self._placeable(sorted(live - set(shard.team)))
            dst = tuple((keep + spares)[:want])
            # A repair must ADD at least one member beyond the keepers:
            # with no spare capacity the shard stays degraded (dropping
            # the dead/excluded member alone would be churn that cannot
            # restore replication), retried next pass.
            if len(dst) <= len(keep):
                continue
            await self.move_shard(shard.range.begin, shard.range.end, dst)
            self.repairs += 1
            return  # one repair per pass: the move mutates the shard map,
            # so the remaining snapshot is stale; next pass (0.4s) continues

    async def _maybe_rebalance(self, per_shard: list[tuple]) -> None:
        if self._moving:
            return  # one move at a time (reference: bounded in-flight moves)
        live = self._placeable(self._live_tags())  # never rebalance ONTO excluded
        if len(live) < 2:
            return
        load: dict[int, int] = {t: 0 for t in live}
        for s, nbytes in per_shard:
            for t in s.team:
                if t in load:
                    load[t] += nbytes
        hot_tag = max(load, key=lambda t: load[t])
        cold_tag = min(load, key=lambda t: load[t])
        if load[hot_tag] < self.REBALANCE_RATIO * max(1, load[cold_tag]):
            return
        # Biggest shard whose team contains hot but not cold.
        candidates = [
            (s, b) for s, b in per_shard
            if hot_tag in s.team and cold_tag not in s.team and b > 0
        ]
        if not candidates:
            return
        shard, _ = max(candidates, key=lambda x: x[1])
        dst_team = tuple(
            cold_tag if t == hot_tag else t for t in shard.team
        )
        await self.move_shard(shard.range.begin, shard.range.end, dst_team)

    # -- movement (reference: MoveKeys.actor.cpp) -----------------------------

    async def move_shard(
        self, begin: bytes, end: bytes, dst_team: tuple[int, ...]
    ) -> None:
        """Move [begin, end) to `dst_team` (must align with, or split to,
        shard boundaries). Safe under traffic and fault injection: aborts
        restore the source team and purge destination partial state."""
        # moveKeys lock (reference: the moveKeys lock serializes range
        # movement): overlapping moves interleave their map flips and
        # retire/serve transitions — the buggify campaign caught a leaver
        # that was never retired because a concurrent move rewrote the
        # team under it, leaving a stale replica answering reads.
        while self._moving:
            await self.loop.sleep(0.02)
        self._moving = True
        try:
            m = self.cluster.storage_map
            if begin:
                m.split_at(begin)
            if end:
                m.split_at(end)
            for sub, src_team in list(m.split_range_teams(KeyRange(begin, end))):
                await self._move_one(sub.begin, sub.end, src_team,
                                     tuple(dst_team))
        finally:
            self._moving = False

    async def _move_one(
        self,
        begin: bytes,
        end: bytes,
        src_team: tuple[int, ...],
        dst_team: tuple[int, ...],
    ) -> None:
        if src_team == dst_team:
            return
        m = self.cluster.storage_map
        newcomers = [t for t in dst_team if t not in src_team]
        leavers = [t for t in src_team if t not in dst_team]
        # Open the dual-tag window: proxies now tag every mutation in the
        # range for src AND dst members, so newcomers' tag streams carry
        # all traffic concurrent with their snapshots.
        union = tuple(src_team) + tuple(newcomers)
        m.set_team(begin, end, union)
        try:
            # Fetch from a LIVE source replica (repair moves start from
            # teams that just lost a member — src_team[0] may be the body).
            live = set(self._live_tags())
            src_tag = next((t for t in src_team if t in live), src_team[0])
            src_ep = self.cluster.storage_eps[src_tag]
            # FENCE the dual-tag window: a commit batch that assembled its
            # tags with the OLD map may still be in flight (delayed push)
            # with a version ABOVE the tlog's current version — newcomers
            # would receive it neither via their tag stream (not tagged)
            # nor via a snapshot floored below it (the stale-read the
            # buggify campaign caught). Every such batch's version is
            # <= the sequencer's last handed-out version at this instant,
            # and the version chain is gap-free, so once a tlog's version
            # passes the fence all of them are durably pushed.
            fence = await self._retry(
                self.cluster.sequencer_ep.get_last_version
            )
            deadline = self.loop.now + 15.0
            while True:
                floor = await self._retry(self.cluster.tlog_eps[0].get_version)
                if floor >= fence:
                    break
                if self.loop.now > deadline:
                    raise TimeoutError(
                        f"move fence {fence} not reached (tlog at {floor}) — "
                        "chain wedged; recovery will unwind"
                    )
                await self.loop.sleep(0.05)
            snap_versions: dict[int, int] = {}
            token = getattr(self.cluster, "authz_system_token", None)
            for tag in newcomers:
                dst_ep = self.cluster.storage_eps[tag]
                snap_versions[tag] = await self._retry(
                    lambda ep=dst_ep: ep.fetch_keys(begin, end, src_ep,
                                                    floor, token=token)
                )
            # Every newcomer must be applied past its snapshot before it can
            # answer reads issued after the flip (fetch_keys itself already
            # registered the serve entry at the snapshot version).
            for tag, v in snap_versions.items():
                await self._retry(
                    lambda ep=self.cluster.storage_eps[tag], v=v:
                        ep.wait_for_version(v)
                )
            flip_version = await self._retry(
                self.cluster.tlog_eps[0].get_version
            )
            m.set_team(begin, end, dst_team)
            for tag in leavers:
                self.cluster.storages[tag].end_serve(begin, end, flip_version)
            self.moves += 1
        except Exception:
            self.move_failures += 1
            m.set_team(begin, end, tuple(src_team))
            for tag in newcomers:
                s = self.cluster.storages[tag]
                s.cancel_serve(begin, end)  # purged data must not be served
                s.abort_fetch(begin, end)
            raise

    async def _retry(self, make_call):
        backoff = 0.05
        for _ in range(MAX_MOVE_RETRIES - 1):
            try:
                return await make_call()
            except Exception:
                await self.loop.sleep(backoff)
                backoff *= 2
        return await make_call()
