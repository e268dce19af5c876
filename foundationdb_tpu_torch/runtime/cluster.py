"""Cluster controller: role liveness monitoring, recruitment, client info.

A copy of ``foundationdb_tpu/runtime/cluster.py`` for the port, its imports rewritten to
the port's modules; names and behaviour are the JAX module's.

Reference: fdbserver/ClusterController.actor.cpp. The controller owns the
current transaction-subsystem *generation* (sequencer, resolvers, tlogs,
proxies, ratekeeper — everything recovery replaces as a unit), detects
failure of any generation process via heartbeats, and drives recovery
(runtime/recovery.py) to recruit the next generation. Clients fetch the
current proxy endpoints through ``get_client_info`` (reference:
OpenDatabaseRequest → ClientDBInfo) and refresh it when their cached
endpoints break.

Recruitment itself is delegated to a *recruiter* supplied by the harness
(sim/cluster.py): the controller decides WHEN to form a generation, the
recruiter knows HOW to place role objects on processes. Coordinator disk
Paxos (Coordination.actor.cpp) is not modelled: the controller is a
singleton the harness never kills, standing in for the elected CC the
coordinator quorum would produce.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from foundationdb_tpu_torch.runtime.flow import Loop, rpc
from foundationdb_tpu_torch.runtime.trace import Severity, trace


class Heartbeat:
    """Per-process liveness probe. Hosted on every generation process; a
    killed process fails the RPC with BrokenPromise after the network's
    failure-detection delay, which is the failure signal (reference:
    failureDetectionServer / TransportData heartbeats)."""

    @rpc
    async def ping(self) -> str:
        return "pong"


@dataclass
class Generation:
    """One recovery epoch's transaction subsystem (reference: the role set
    recruited by one pass of masterserver recovery)."""

    epoch: int
    recovery_version: int
    sequencer_ep: object
    resolver_eps: list
    tlog_eps: list
    grv_proxy_eps: list
    commit_proxy_eps: list
    ratekeeper_ep: object
    # process name -> heartbeat endpoint; the controller's watch list.
    heartbeat_eps: dict = field(default_factory=dict)


@dataclass(frozen=True)
class ClientDBInfo:
    """What clients need to route requests (reference: ClientDBInfo)."""

    epoch: int
    grv_proxy_eps: tuple
    commit_proxy_eps: tuple


class ClusterController:
    HEARTBEAT_INTERVAL = 0.25  # virtual seconds between liveness sweeps
    RECOVERY_RETRY_DELAY = 0.5

    def __init__(self, loop: Loop, recruiter, identity: str = "cluster_controller",
                 coord=None, reign: int = 0):
        self.loop = loop
        self.recruiter = recruiter
        self.identity = identity
        # CoordinatedState when a coordinator quorum exists (None = legacy
        # singleton controller). Every post-election registry write doubles
        # as the deposition check (runtime/coordination.py).
        self.coord = coord
        self.reign = reign
        self.generation: Generation | None = None
        self.recoveries_completed = 0
        self._recovering = False
        self._deposed = False
        # Last completed recovery's per-stage MTTR breakdown (same
        # vocabulary as the deployed controller's recovery_log entries —
        # server.py): surfaced via get_metrics as the documented
        # recovery_* counters.
        self.last_recovery: dict = {}

    def bootstrap(self, epoch: int = 1, recovery_version: int = 0,
                  seed_entries: list | None = None) -> None:
        """Recruit the first generation of this process lifetime. A fresh
        cluster starts at epoch 1; a restart from disk starts at the
        persisted epoch + 1 with the disk queues' salvaged entries."""
        assert self.generation is None
        self.generation = self.recruiter.recruit_generation(
            epoch=epoch, recovery_version=recovery_version,
            seed_entries=list(seed_entries or []),
        )

    # -- client face ----------------------------------------------------------

    @rpc
    async def get_client_info(self) -> ClientDBInfo:
        g = self.generation
        return ClientDBInfo(g.epoch, tuple(g.grv_proxy_eps), tuple(g.commit_proxy_eps))

    @rpc
    async def request_recovery(self, epoch: int, reason: str) -> None:
        """A role observed the transaction pipeline wedged (e.g. a version-
        chain gap after lost pushes) — something heartbeats cannot see, since
        every process is alive. Forcing a generation change is the universal
        repair (reference: proxies/master force recovery on tlog failure).
        `epoch` guards against stale requests from an already-replaced
        generation."""
        if self._recovering or self.generation is None:
            return
        if epoch != self.generation.epoch:
            return  # stale: that generation is already being replaced
        self.loop.spawn(
            self._recover(reason=f"requested: {reason}"),
            process="cluster_controller",
            name="cc.requested_recovery",
        )

    @rpc
    async def get_status(self) -> dict:
        """Controller section of the status document (runtime/status.py)."""
        g = self.generation
        return {
            "epoch": g.epoch,
            "recovery_version": g.recovery_version,
            "recoveries_completed": self.recoveries_completed,
            "recovering": self._recovering,
            "generation_processes": sorted(g.heartbeat_eps),
            "controller": self.identity,
            "reign": self.reign,
        }

    @rpc
    async def get_metrics(self) -> dict:
        """Registry scrape surface (obs/registry.py `controller.*`): the
        documented recovery_* counters — count plus the last recovery's
        per-stage MTTR breakdown, zeros before the first recovery (the
        deployed controller exports the identical names)."""
        last = self.last_recovery
        return {
            "recovery_count": self.recoveries_completed,
            "recovery_lock_s": last.get("lock_s", 0.0),
            "recovery_salvage_s": last.get("salvage_s", 0.0),
            "recovery_recruit_s": last.get("recruit_s", 0.0),
            "recovery_total_s": last.get("total_s", 0.0),
            "recovering": self._recovering,
            "epoch": self.generation.epoch if self.generation else 0,
        }

    # -- failure detection ----------------------------------------------------

    async def run(self) -> None:
        """Liveness sweep: ping every generation process; any failure (or a
        stale generation found mid-sweep) triggers recovery of the whole
        transaction subsystem, like the reference's betterMasterExists /
        failure-triggered recovery."""
        while not self._deposed:
            await self.loop.sleep(self.HEARTBEAT_INTERVAL)
            if self._recovering or self.generation is None:
                continue
            failed = await self._sweep(self.generation)
            if failed:
                trace(self.loop).event(
                    "WorkerFailureDetected", Severity.WARN, process=failed)
                await self._recover(reason=f"process {failed!r} failed heartbeat")

    async def _sweep(self, gen: Generation) -> str | None:
        """Ping all generation processes in parallel: one sweep costs one
        failure-detection delay even with several dead processes."""
        pings = [
            (process, self.loop.spawn(hb.ping(), name=f"cc.ping.{process}"))
            for process, hb in gen.heartbeat_eps.items()
        ]
        failed = None
        for process, t in pings:
            try:
                await t
            except Exception:
                failed = failed or process
        if self.generation is not gen:
            return None  # generation changed under the sweep
        return failed

    async def _recover(self, reason: str) -> None:
        from foundationdb_tpu_torch.runtime.recovery import RecoveryFailed, recover

        if self._recovering or self._deposed:
            return  # a concurrent trigger (sweep vs request) already won
        self._recovering = True
        trace(self.loop).event("MasterRecoveryTriggered", Severity.WARN,
                               reason=reason)
        try:
            # A deposed controller must not touch the cluster: confirm
            # leadership through the quorum before recruiting (reference:
            # the master's cstate read at recovery start).
            if not await self._confirm_leadership():
                return
            old = self.generation
            t_detect = self.loop.now
            while True:
                try:
                    stages: dict = {}
                    t_attempt = self.loop.now
                    self.generation = await recover(
                        self.loop, old, self.recruiter, epoch=old.epoch + 1,
                        stage_log=stages,
                    )
                    await self._publish_generation()
                    if self._deposed:
                        # Unpublished generation: leave the OLD roles
                        # alive — the rival's recovery still needs them
                        # (retire_previous stays pending for the winner).
                        return
                    # Only a PUBLISHED generation may retire its
                    # predecessor's roles (Chaos-campaign split-brain fix).
                    retire = getattr(self.recruiter, "retire_previous", None)
                    if retire is not None:
                        retire()
                    self.recoveries_completed += 1
                    # The deployed controller's accrual rule (server.py
                    # _recover): failed-attempt/wait time accrues to the
                    # stage being retried (lock — RecoveryFailed means
                    # locking/salvage never held), publish/retire time
                    # to recruit, so lock+salvage+recruit == total and
                    # the identically named counters mean the same
                    # thing in sim and deployed scrapes.
                    stages["lock_s"] = round(
                        stages.get("lock_s", 0.0) + (t_attempt - t_detect),
                        6)
                    stages["recruit_s"] = round(
                        self.loop.now - t_detect - stages["lock_s"]
                        - stages.get("salvage_s", 0.0), 6)
                    stages["total_s"] = round(self.loop.now - t_detect, 6)
                    self.last_recovery = stages
                    return
                except RecoveryFailed:
                    # Not enough of the old generation reachable to determine
                    # the recovery version — wait for processes/partitions to
                    # heal and try again (reference: recovery stalls in
                    # locking_cstate until a tlog quorum rejoins).
                    await self.loop.sleep(self.RECOVERY_RETRY_DELAY)
        finally:
            self._recovering = False

    async def _confirm_leadership(self) -> bool:
        if self.coord is None:
            return True
        try:
            view = await self.coord.read()
        except Exception:
            return False  # quorum unreachable: act later, not on stale belief
        cur = view.value or {}
        if cur.get("leader") != self.identity or cur.get("reign") != self.reign:
            self._deposed = True
            return False
        return True

    async def _publish_generation(self) -> None:
        """Record the new generation in the coordinated registry — the write
        a rival-elected controller's quorum rejects (we learn we're deposed
        before serving a stale generation to anyone)."""
        if self.coord is None or self.generation is None:
            return
        from foundationdb_tpu_torch.runtime.coordination import Deposed

        g = self.generation
        backoff = 0.1
        while True:
            try:
                await self.coord.write_if_leader(
                    self.identity, self.reign,
                    {
                        "epoch": g.epoch,
                        "recovery_version": g.recovery_version,
                        "tlog_eps": list(g.tlog_eps),
                    },
                )
                return
            except Deposed:
                self._deposed = True
                return
            except Exception:
                # Quorum transiently unreachable / write contention: recovery
                # CANNOT complete without the registry write (the reference
                # blocks in WRITING_CSTATE the same way) — and it must not
                # crash the controller's run task either, or rivals would see
                # a live-but-braindead incumbent forever. Keep trying.
                await self.loop.sleep(backoff)
                backoff = min(1.0, backoff * 2)
