"""Simulated RPC network with fault injection.

A copy of ``foundationdb_tpu/sim/network.py`` for the port, its imports
rewritten to the port's modules; names and behaviour are the JAX module's,
but for the order in which ``fail_region`` kills a region's processes
(hosting order, not the order of a set of names).

The reference's fdbrpc/FlowTransport + flow/sim2 pair: endpoints route
requests between named processes, every hop takes seeded-random virtual
latency, and the harness can kill processes or partition pairs at any point.
A request whose destination is dead or unreachable fails the caller with
BrokenPromise after the failure-detection delay — the same observable
behavior as the reference's broken_promise on connection failure
(fdbrpc/FlowTransport.actor.cpp), which is what drives client retry loops
and recovery.

All randomness comes from the loop's seeded RNG: identical seeds replay
identical histories, including message interleavings and failures.
"""

from __future__ import annotations

from typing import Any

from foundationdb_tpu_torch.runtime.flow import BrokenPromise, Future, Loop, Promise


class Endpoint:
    """Callable proxy to a role hosted on some process.

    ``await ep.method(args)`` issues an RPC through the simulated network;
    attribute access returns a stub, so role interfaces read like the
    reference's RequestStream fields."""

    def __init__(self, net: "SimNetwork", process: str, name: str):
        self._net = net
        self.process = process
        self.name = name

    def __getattr__(self, method: str):
        if method.startswith("_"):
            raise AttributeError(method)
        return lambda *a, **kw: self._net.call(self, method, a, kw)

    def __repr__(self) -> str:
        return f"<Endpoint {self.name}@{self.process}>"


class SimNetwork:
    FAILURE_DETECTION_DELAY = 1.0  # virtual seconds until a lost RPC breaks

    def __init__(
        self,
        loop: Loop,
        min_latency: float = 0.0002,
        max_latency: float = 0.002,
        process_prefix: str = "",
    ):
        self.loop = loop
        self.min_latency = min_latency
        self.max_latency = max_latency
        # Process-name namespace: kills/partitions act on loop-global
        # process names, so two clusters sharing one Loop (DR pairs) must
        # not both own a "tlog0". The prefix is applied at host()/kill()
        # so per-cluster call sites keep using bare names.
        self.process_prefix = process_prefix
        self._objects: dict[str, Any] = {}  # endpoint name -> role object
        self._partitions: set[frozenset] = set()
        # Dead REGIONS (reference: multi-region FDB models datacenter
        # loss, fdbserver/DataDistribution.actor.cpp region teams). A
        # region here is a process-name prefix ("pri/", "sat/", "rem/");
        # failing one kills every process under it AND isolates the
        # prefix: later-hosted processes there are unreachable too, so a
        # recovery that recruited into a dead region simply stalls and
        # retries elsewhere.
        self._dead_regions: set[str] = set()
        # Partitioned regions: alive but severed at the boundary (the
        # zombie-generation mode — see partition_region()).
        self._partitioned_regions: set[str] = set()
        # Clogs: slow-but-alive links (reference: sim2's clogging — the
        # failure mode BETWEEN healthy and partitioned that shakes out
        # timeout/ordering assumptions). pair -> (latency multiplier,
        # virtual-time expiry).
        self._clogs: dict[frozenset, tuple[float, float]] = {}

    # -- topology -------------------------------------------------------------

    def host(self, process: str, name: str, obj: Any) -> Endpoint:
        """Register a role object as `name` on `process`; returns its endpoint."""
        process = self.process_prefix + process
        self._objects[(process, name)] = obj
        return Endpoint(self, process, name)

    def kill(self, process: str) -> None:
        self.loop.kill_process(self.process_prefix + process)

    def unhost_process(self, process: str) -> None:
        """Drop every role object hosted on `process` (generation retirement
        — without this, each recovery would leak the full old generation,
        including never-trimmed replica tlogs holding an epoch's history)."""
        process = self.process_prefix + process
        self._objects = {k: v for k, v in self._objects.items() if k[0] != process}

    def reboot(self, process: str) -> None:
        """Clears the dead flag; the harness re-hosts/restarts role actors."""
        self.loop.revive_process(self.process_prefix + process)

    def fail_region(self, prefix: str) -> None:
        """Datacenter loss: kill every live process under `prefix` and
        black-hole the prefix for anything hosted there later."""
        p = self.process_prefix + prefix
        self._dead_regions.add(p)
        # In hosting order (the JAX module iterates a set of names, whose
        # order follows the interpreter's string hashing).
        for proc in dict.fromkeys(k[0] for k in self._objects):
            if proc.startswith(p):
                self.loop.kill_process(proc)

    def heal_region(self, prefix: str) -> None:
        self._dead_regions.discard(self.process_prefix + prefix)
        for proc in {k[0] for k in self._objects}:
            if proc.startswith(self.process_prefix + prefix):
                self.loop.revive_process(proc)

    def region_dead(self, prefix: str) -> bool:
        return (self.process_prefix + prefix) in self._dead_regions

    def _in_dead_region(self, process: str) -> bool:
        return any(process.startswith(r) for r in self._dead_regions)

    def partition_region(self, prefix: str) -> None:
        """The HARD region-failure mode (vs fail_region's blackout):
        every process under `prefix` stays ALIVE with its intra-region
        links intact, but nothing crosses the region boundary in either
        direction. The region's chain keeps running as a ZOMBIE
        generation — proxies keep pushing to in-region tlogs while the
        out-of-region satellite fences every ack — which is exactly the
        scenario the known-committed/epoch fences exist for
        (tests/test_deployed_multiregion.py TestRegionPartition; sim
        twin in tests/test_multi_region.py)."""
        self._partitioned_regions.add(self.process_prefix + prefix)

    def heal_region_partition(self, prefix: str) -> None:
        self._partitioned_regions.discard(self.process_prefix + prefix)

    def region_partitioned(self, prefix: str) -> bool:
        return (self.process_prefix + prefix) in self._partitioned_regions

    def _crosses_partitioned_region(self, src: str, dst: str) -> bool:
        for r in self._partitioned_regions:
            if src.startswith(r) != dst.startswith(r):
                return True
        return False

    def partition(self, a: str, b: str) -> None:
        self._partitions.add(frozenset(
            (self.process_prefix + a, self.process_prefix + b)))

    def heal(self, a: str, b: str) -> None:
        self._partitions.discard(frozenset(
            (self.process_prefix + a, self.process_prefix + b)))

    def heal_all(self) -> None:
        """Clear every link-level fault: pair partitions, clogs, AND
        region partitions (campaign-found: the quiesce path called this
        expecting a clean network, but a region partition injected by a
        nemesis survived it and the post-storm checks ran against a
        still-severed region). Dead regions are NOT cleared — their
        processes are dead and need the heal_region reboot path."""
        self._partitions.clear()
        self._clogs.clear()
        self._partitioned_regions.clear()

    def reset_faults(self) -> None:
        """Explicit full network-fault reset (alias of heal_all, the
        campaign runner's quiesce contract)."""
        self.heal_all()

    def clog(self, a: str, b: str, factor: float = 50.0,
             duration: float = 1.0) -> None:
        """Inflate latency on the a↔b link by `factor` for `duration`
        virtual seconds. The link stays ALIVE: RPCs arrive late rather
        than failing, so no failure detector trips — the hard case."""
        self._clogs[frozenset(
            (self.process_prefix + a, self.process_prefix + b)
        )] = (factor, self.loop.now + duration)

    def unclog(self, a: str, b: str) -> None:
        self._clogs.pop(frozenset(
            (self.process_prefix + a, self.process_prefix + b)), None)

    def _unreachable(self, src: str, dst: str) -> bool:
        return (
            dst in self.loop.dead_processes
            or (src != dst and frozenset((src, dst)) in self._partitions)
            or (self._dead_regions
                and (self._in_dead_region(dst) or self._in_dead_region(src)))
            or (self._partitioned_regions
                and self._crosses_partitioned_region(src, dst))
        )

    def _latency(self, src: str | None = None, dst: str | None = None) -> float:
        base = self.loop.rng.uniform(self.min_latency, self.max_latency)
        if src is None or not self._clogs:
            return base
        entry = self._clogs.get(frozenset((src, dst)))
        if entry is None:
            return base
        factor, until = entry
        if self.loop.now >= until:
            del self._clogs[frozenset((src, dst))]
            return base
        return base * factor

    # -- RPC ------------------------------------------------------------------

    def call(self, ep: Endpoint, method: str, args: tuple, kwargs: dict) -> Future:
        loop = self.loop
        src = loop._current.process if loop._current else "<main>"
        reply = Promise()

        def fail_later(_f=None) -> None:
            loop.sleep(self.FAILURE_DETECTION_DELAY).add_done_callback(
                lambda _: reply.fail(
                    BrokenPromise(f"{ep.name}.{method} unreachable from {src}")
                )
            )

        def deliver(_f) -> None:
            if self._unreachable(src, ep.process):
                fail_later()
                return
            obj = self._objects.get((ep.process, ep.name))
            if obj is None:
                fail_later()
                return
            try:
                coro = getattr(obj, method)(*args, **kwargs)
            except Exception as e:  # bad method/signature fails this RPC only
                reply.fail(e)
                return
            task = loop.spawn(coro, process=ep.process, name=f"{ep.name}.{method}")
            task.add_done_callback(send_reply)

        def send_reply(task) -> None:
            err = task.exception()

            def finish(_f) -> None:
                # The requesting side may itself be dead/partitioned by now;
                # a reply into a partition is simply lost.
                if self._unreachable(ep.process, src):
                    fail_later()
                elif err is not None:
                    reply.fail(err)
                else:
                    reply.send(task.result())

            loop.sleep(self._latency(ep.process, src)).add_done_callback(finish)

        loop.sleep(self._latency(src, ep.process)).add_done_callback(deliver)
        return reply.future
