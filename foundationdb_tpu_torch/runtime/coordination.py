"""Coordinators: replicated cluster registry + controller election.

A copy of ``foundationdb_tpu/runtime/coordination.py`` for the port, its imports rewritten to
the port's modules; names and behaviour are the JAX module's.

Reference: fdbserver/Coordination.actor.cpp + LeaderElection.actor.cpp.
The coordinators are a small quorum of processes holding the cluster's
coordinated state — which process is the cluster controller, the current
epoch, and the old generation's tlog endpoints (what a brand-new CC needs
to drive recovery). The shape kept here:

- **Ballot-ordered replicated register.** Each coordinator holds
  (promised_ballot, accepted_ballot, accepted_value). A write runs two
  phases over a quorum: precommit (promise) then commit (accept). Ballots
  are (counter, candidate_id) pairs, totally ordered; any two quorums
  intersect, so a committed write at ballot b invalidates every slower
  concurrent write — two candidates cannot both win an election, and a
  deposed controller's registry update fails its quorum.
- **Election by takeover.** Candidates monitor the incumbent's process
  directly; on heartbeat failure they race a register write naming
  themselves (reign + 1). The quorum serializes the race.
- **Deposition check.** Every registry update is conditioned on the
  register still naming the writer (write_if_leader); a controller that
  lost a partition race discovers it at its next write and abdicates —
  the reference's master failing its cstate write.

Clients locate the controller by reading any coordinator (get_leader),
exactly how fdb clients bootstrap from the cluster file's coordinators.
"""

from __future__ import annotations

from dataclasses import dataclass

from foundationdb_tpu_torch.core.errors import FdbError
from foundationdb_tpu_torch.runtime.flow import Loop, all_of, rpc


class Deposed(FdbError):
    """This controller lost leadership (registry names someone else)."""

    code = 1191  # reference: not_committed family; coordinators moved on


Ballot = tuple[int, int]  # (counter, candidate_id) — lexicographic order

ZERO_BALLOT: Ballot = (0, -1)


class Coordinator:
    """One member of the coordinator quorum (a replicated register cell)."""

    def __init__(self) -> None:
        self.promised: Ballot = ZERO_BALLOT
        self.accepted_ballot: Ballot = ZERO_BALLOT
        self.accepted_value: dict | None = None

    @rpc
    async def precommit(self, ballot: Ballot) -> tuple[bool, Ballot, dict | None]:
        ballot = tuple(ballot)
        if ballot > self.promised:
            self.promised = ballot
            return True, self.accepted_ballot, self.accepted_value
        return False, self.accepted_ballot, self.accepted_value

    @rpc
    async def commit(self, ballot: Ballot, value: dict) -> bool:
        ballot = tuple(ballot)
        if ballot >= self.promised and ballot > self.accepted_ballot:
            self.promised = max(self.promised, ballot)
            self.accepted_ballot = ballot
            self.accepted_value = value
            return True
        return False

    @rpc
    async def get_leader(self) -> dict | None:
        """Client bootstrap: this coordinator's view of the registry. Any
        single coordinator may be slightly stale; clients just need an
        endpoint to try — a wrong one fails and they ask another."""
        return self.accepted_value


@dataclass
class RegistryView:
    ballot: Ballot
    value: dict | None


class CoordinatedState:
    """Quorum client for the coordinator register (one per candidate)."""

    def __init__(self, loop: Loop, coordinator_eps: list, candidate_id: int):
        self.loop = loop
        self.eps = coordinator_eps
        self.candidate_id = candidate_id
        self._counter = 0
        self.quorum = len(coordinator_eps) // 2 + 1

    def _next_ballot(self, at_least: Ballot) -> Ballot:
        self._counter = max(self._counter, at_least[0]) + 1
        return (self._counter, self.candidate_id)

    async def _gather(self, coros_named):
        """Run RPCs in parallel; exceptions (dead coordinators) → None."""
        async def safe(c):
            try:
                return await c
            except Exception:
                return None

        tasks = [
            self.loop.spawn(safe(c), name=f"coord.{n}") for n, c in coros_named
        ]
        return await all_of(tasks)

    async def read(self) -> RegistryView:
        """Quorum read: the value with the highest accepted ballot among a
        quorum dominates every committed write (quorum intersection)."""
        replies = await self._gather(
            [("pre", ep.precommit(ZERO_BALLOT)) for ep in self.eps]
        )
        # ZERO_BALLOT precommit never wins a promise; it is a pure read of
        # (accepted_ballot, accepted_value).
        seen = [r for r in replies if r is not None]
        if len(seen) < self.quorum:
            raise FdbError("coordinator quorum unreachable", code=1214)
        best = max(seen, key=lambda r: tuple(r[1]))
        return RegistryView(tuple(best[1]), best[2])

    async def write(self, make_value, max_attempts: int = 8) -> dict:
        """Ballot-ordered register write. `make_value(current) -> dict|None`
        builds the new value from the freshest committed value; returning
        None aborts (precondition failed) and raises Deposed."""
        for _ in range(max_attempts):
            view = await self.read()
            ballot = self._next_ballot(view.ballot)
            pre = await self._gather(
                [("pre", ep.precommit(ballot)) for ep in self.eps]
            )
            grants = [r for r in pre if r is not None and r[0]]
            if len(grants) < self.quorum:
                await self.loop.sleep(0.05)
                continue  # a higher ballot is racing us
            # Adopt the freshest accepted value among the grants (it may be
            # newer than our read); precondition is judged against it.
            newest = max(grants, key=lambda r: tuple(r[1]))
            current = newest[2] if tuple(newest[1]) > ZERO_BALLOT else view.value
            value = make_value(current)
            if value is None:
                raise Deposed(f"precondition failed at {current!r}")
            acks = await self._gather(
                [("commit", ep.commit(ballot, value)) for ep in self.eps]
            )
            if sum(1 for a in acks if a) >= self.quorum:
                return value
            await self.loop.sleep(0.05)
        raise FdbError("coordinator write contention", code=1214)

    # -- leadership -----------------------------------------------------------

    async def elect(self, my_id: str, controller_ep,
                    expect_leader: str | None = None) -> dict:
        """Claim leadership: write (reign+1, me). Raises Deposed if a rival
        wins the race (the register names them at a higher ballot).

        expect_leader: the incumbent this candidate observed DEAD. If the
        register already names someone else by claim time, a rival won
        first — abort instead of superseding them (claiming over a live
        freshly-elected leader mid-recovery orphans their half-recruited
        generation; found by the Chaos campaign as a permanent stall)."""
        def claim(current: dict | None) -> dict | None:
            cur_leader = (current or {}).get("leader")
            if (expect_leader is not None and cur_leader is not None
                    and cur_leader != expect_leader and cur_leader != my_id):
                return None  # a rival already took over: let them lead
            reign = (current or {}).get("reign", 0) + 1
            value = dict(current or {})
            value.update(reign=reign, leader=my_id, controller_ep=controller_ep)
            return value

        return await self.write(claim)

    async def write_if_leader(self, my_id: str, reign: int, fields: dict) -> dict:
        """Registry update conditioned on still being the named leader —
        the deposition check every post-election write must pass."""
        def update(current: dict | None) -> dict | None:
            if not current or current.get("leader") != my_id \
                    or current.get("reign") != reign:
                return None
            value = dict(current)
            value.update(fields)
            return value

        return await self.write(update)


class ControllerCandidate:
    """One controller-capable process: monitors the incumbent, races a
    register write to take over when it dies, and — on winning — runs a
    fresh ClusterController that recovers from the registry's recorded
    generation (reference: LeaderElection candidates + the new master's
    READING_CSTATE)."""

    MONITOR_INTERVAL = 0.3

    def __init__(self, loop: Loop, cluster, idx: int, coordinator_eps: list):
        self.loop = loop
        self.cluster = cluster
        self.idx = idx
        self.my_id = f"cc{idx}"
        self.coord = CoordinatedState(loop, coordinator_eps, idx)

    async def run(self) -> None:
        while True:
            await self.loop.sleep(self.MONITOR_INTERVAL)
            cc = self.cluster.controller
            if cc is not None and cc.identity == self.my_id and not cc._deposed:
                continue  # we lead; ClusterController.run does the work
            try:
                view = await self.coord.read()
            except Exception:
                continue  # quorum unreachable: nothing safe to decide
            cur = view.value or {}
            leader = cur.get("leader")
            if leader and await self._incumbent_alive(leader):
                continue
            try:
                state = await self.coord.elect(self.my_id, None,
                                               expect_leader=leader)
            except FdbError:
                continue  # lost the race or quorum flaked; re-monitor
            if state.get("leader") == self.my_id:
                await self._lead(state)

    async def _incumbent_alive(self, leader: str) -> bool:
        hb = self.cluster.cc_heartbeats.get(leader)
        if hb is None:
            return False
        try:
            await hb.ping()
            return True
        except Exception:
            return False

    async def _lead(self, state: dict) -> None:
        from foundationdb_tpu_torch.runtime.cluster import ClusterController, Generation

        cc = ClusterController(
            self.loop, recruiter=self.cluster, identity=self.my_id,
            coord=self.coord, reign=state["reign"],
        )
        # Adopt the registry's recorded generation BEFORE going public (its
        # tlogs are what we must lock; status/tests read .generation).
        cc.generation = Generation(
            epoch=state.get("epoch", 1),
            recovery_version=state.get("recovery_version", 0),
            sequencer_ep=None,
            resolver_eps=[],
            tlog_eps=list(state.get("tlog_eps", [])),
            grv_proxy_eps=[],
            commit_proxy_eps=[],
            ratekeeper_ep=None,
            heartbeat_eps={},
        )
        ep = self.cluster.install_controller(cc, process=self.my_id)
        try:
            await self.coord.write_if_leader(
                self.my_id, state["reign"], {"controller_ep": ep}
            )
        except FdbError:
            return  # deposed before doing anything
        await cc._recover(reason=f"controller takeover by {self.my_id}")
        if cc._deposed:
            return
        await cc.run()  # until deposed (or our process is killed)
