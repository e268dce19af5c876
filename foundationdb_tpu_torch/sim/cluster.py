"""Whole-cluster simulation harness: wire every role on a SimNetwork.

A copy of ``foundationdb_tpu/sim/cluster.py`` for the port, its imports
rewritten to the port's modules; names and behaviour are the JAX module's,
with three differences:

- **The card by default.** ``SimCluster`` takes ``device`` (None means
  ``cuda``) and hands it to every ``StorageServer`` (its read plane and
  watches, where K12 answers every ``get_multi``) and to every engine
  ``new_conflict_set`` recruits. Its ``engine`` default is ``"torch"``
  (``"tpu"`` is an alias), not the JAX package's ``"oracle"``, so a cluster
  runs on the card unless the caller asks for the CPU (``device="cpu"``).
- **Loud refusals.** The optional arms whose modules the port does not
  have raise ``NotImplementedError`` naming the module: ``recorder_path``
  (obs/recorder.py) and admission, by argument or by ``FDB_TPU_ADMISSION``
  (admission/policy.py ``AdmissionPolicy``). ``data_dir`` with
  ``storage_engine`` (runtime/kvstore.py), ``data_distribution``
  (runtime/data_distribution.py) and the ``authz_*`` keys
  (runtime/authz.py) are the JAX module's arms.
- **Retirement in order.** ``retire_previous`` kills the superseded
  generation's processes in recruitment order; the JAX module kills them
  in the order of a set of names, which varies with the interpreter's
  string hashing from one process to the next.

The analogue of the reference's simulated cluster setup
(fdbserver/SimulatedCluster.actor.cpp): one deterministic loop, each role
hosted on its own named process so kills/partitions hit realistic blast
radii. The conflict engine is pluggable via the ``newConflictSet()`` seam:
``"oracle"`` (pure-python model), ``"oracle-replay"`` (the oracle proving
each wave schedule by replay), ``"cpp"`` (the port's C++ skiplist), and
``"torch"`` (the card engine at the sim's size: capacity 2^14, batch 256).

The transaction subsystem (sequencer, resolvers, tlogs, proxies,
ratekeeper) is owned by a ClusterController and recruited per recovery
*generation*: SimCluster is the controller's recruiter — it knows how to
place role objects on `.e{epoch}`-suffixed processes, seed new tlogs with
salvaged entries, re-point the (persistent) storage servers, and retire
the previous generation. Kill any generation process and the controller's
heartbeat sweep drives recovery to a fresh epoch. Each recovery recruits
fresh resolvers, and so fresh engines, on ``device``.
"""

from __future__ import annotations

import json
import os

from foundationdb_tpu_torch.runtime.cluster import ClusterController, Generation, Heartbeat
from foundationdb_tpu_torch.runtime.commit_proxy import CommitProxy
from foundationdb_tpu_torch.runtime.flow import Loop
from foundationdb_tpu_torch.runtime.grv_proxy import GrvProxy
from foundationdb_tpu_torch.runtime.ratekeeper import Ratekeeper
from foundationdb_tpu_torch.runtime.resolver import Resolver
from foundationdb_tpu_torch.runtime.sequencer import EPOCH_VERSION_JUMP, Sequencer
from foundationdb_tpu_torch.runtime.shardmap import KeyShardMap
from foundationdb_tpu_torch.runtime.storage import StorageServer
from foundationdb_tpu_torch.runtime.tlog import TLog
from foundationdb_tpu_torch.core.types import (
    env_choice,
    validate_wave_commit as _validate_wave_commit,
    wave_commit_env_default as _wave_commit_default,
)
from foundationdb_tpu_torch.sim.network import SimNetwork


#: Engines implementing the role-level global wave protocol
#: (resolve_edges/resolve_apply — core/wavemesh): legal under
#: wave_commit at ANY resolver count. The cpp skiplist never
#: materializes the conflict graph and refuses wave commit outright.
WAVE_GLOBAL_CAPABLE_ENGINES = frozenset(
    {"oracle", "oracle-replay", "tpu", "torch"})


def new_conflict_set(engine: str, wave_commit: bool | None = None,
                     device=None):
    """Conflict-engine factory (the ``newConflictSet()`` seam).

    ``wave_commit`` selects the reorder-don't-abort resolve mode
    (conflict-graph wave scheduling; only true cycles abort). None reads
    the FDB_TPU_WAVE_COMMIT env flag so A/B harnesses can flip whole sim
    clusters per-subprocess without code changes. ``device`` None is
    ``cuda``: the card engine raises when there is no card and never falls
    back to the CPU."""
    if wave_commit is None:
        wave_commit = _wave_commit_default()
    if engine == "oracle":
        from foundationdb_tpu_torch.sim.oracle import OracleConflictSet

        return OracleConflictSet(wave_commit=wave_commit)
    if engine == "oracle-replay":
        # Oracle that PROVES each wave schedule by sequential replay inline
        # (raises on any serializability violation); identical to "oracle"
        # when wave_commit is off.
        from foundationdb_tpu_torch.sim.oracle import ReplayCheckedOracle

        return ReplayCheckedOracle(wave_commit=wave_commit)
    if engine == "cpp":
        from foundationdb_tpu_torch.models.cpu_conflict_set import (
            CPUSkipListConflictSet,
        )

        if wave_commit:
            _validate_wave_commit(skiplist_engine="cpp")
        return CPUSkipListConflictSet()
    if engine in ("torch", "tpu"):
        from foundationdb_tpu_torch.models.conflict_set import TorchConflictSet

        return TorchConflictSet(capacity=1 << 14, batch_size=256,
                                wave_commit=wave_commit, device=device)
    raise ValueError(f"unknown conflict engine {engine!r}")


class SimCluster:
    """A running simulated cluster; role endpoints as attributes (always
    reflecting the CURRENT generation — refreshed on recovery)."""

    def __init__(
        self,
        loop: Loop | None = None,
        seed: int = 0,
        n_proxies: int = 1,
        n_resolvers: int = 1,
        n_tlogs: int = 1,
        n_storages: int = 2,
        n_replicas: int = 1,
        engine: str = "torch",
        ratekeeper: bool = True,
        data_distribution: bool = False,
        n_coordinators: int = 0,
        n_cc_candidates: int = 3,
        data_dir: str | None = None,
        timekeeper: bool = True,
        process_prefix: str = "",
        authz_public_key: bytes | None = None,
        authz_system_token: str | None = None,
        authz_private_pem: bytes | None = None,
        multi_region: dict | None = None,
        storage_engine: str = "sqlite",
        resolver_budget_s: float = 0.0,
        resolver_dispatch_cost_s: float = 0.0,
        wave_commit: bool | None = None,
        admission: bool | None = None,
        admission_opts: dict | None = None,
        obs: bool | None = None,
        obs_sample_every: int | None = None,
        recorder_path: str | None = None,
        recorder_interval_s: float | None = None,
        device=None,
    ):
        """``multi_region`` (reference: DatabaseConfiguration regions —
        fdbclient/DatabaseConfiguration.cpp — and DataDistribution region
        teams): a three-region topology
        ``{"satellite_tlogs": k}`` with

        - **pri/**: the active region — the whole transaction subsystem
          (sequencer, resolvers, tlogs, proxies) plus one storage replica
          per shard;
        - **sat/**: satellite TLogs — IN the synchronous commit path
          (every proxy push awaits them, the reference's satellite
          redundancy), holding the full mutation stream but no storage;
        - **rem/**: the standby region — the other storage replica of
          every shard (pulling asynchronously, the reference's remote
          region), plus capacity to host the next transaction subsystem.

        Automatic inter-region failover: when recovery runs while the
        active region is dead (``net.fail_region("pri/")``), recruitment
        flips the active region to the standby and re-forms the chain
        there, salvaging from the surviving satellite tlogs — which hold
        every ACKED commit by construction, so failover loses nothing.

        ``device`` (None means ``cuda``) holds every storage server's read
        plane and every recruited engine; the arms named in the module
        docstring raise ``NotImplementedError``.
        """
        _refuse_unported(recorder_path=recorder_path, admission=admission)
        assert 1 <= n_replicas <= n_storages
        self.device = device
        self.multi_region = multi_region or None
        if self.multi_region:
            assert n_replicas == 1 and not data_distribution, (
                "multi_region replicates across regions (one replica per "
                "region); in-region replication/DD on top is not modeled"
            )
            self.active_region = "pri"
            self.standby_region = "rem"
            self.n_satellite_tlogs = int(self.multi_region.get(
                "satellite_tlogs", 1))
        self.loop = loop or Loop(seed=seed)
        # Real durability (reference: tlog DiskQueue + KeyValueStoreSQLite):
        # tlogs fsync pushes to append-only queues, storages flush a
        # consistent prefix to sqlite. A SimCluster re-created on the same
        # data_dir restarts from disk: epoch advances, the last generation's
        # disk queues seed the new tlogs, storage reloads its snapshot.
        self.data_dir = data_dir
        self._restore = self._read_cluster_meta() if data_dir else None
        # Ring-buffer tracer on every sim cluster: role trace events are
        # queryable in tests/status with zero config (reference: TraceEvent
        # always logs; sim asserts on trace lines).
        from foundationdb_tpu_torch.runtime.trace import Tracer

        if not hasattr(self.loop, "tracer"):
            Tracer(self.loop)
        # Commit-path tracing (obs subsystem; None = the FDB_TPU_OBS env
        # default, off by default): one SpanSink per loop — every role and
        # client on this cluster's loop stamps spans into it, so a sim run
        # yields complete, seed-deterministic span trees.
        from foundationdb_tpu_torch.obs.span import SpanSink, obs_env_default

        self.obs = obs_env_default() if obs is None else bool(obs)
        if self.obs and not hasattr(self.loop, "span_sink"):
            SpanSink(self.loop, sample_every=obs_sample_every)
        # Flight recorder (obs/recorder.py, not ported: recorder_path is
        # refused above).
        self.flight_recorder = None
        # Namespace for loop-global process names: two clusters on one
        # Loop (a DR pair) must not both own a "tlog0" (kills would
        # cross clusters). Applied by SimNetwork at host()/kill() and
        # here at every loop.spawn(process=...).
        self.process_prefix = process_prefix
        self.net = SimNetwork(self.loop, process_prefix=process_prefix)
        self.engine = engine
        self.n_proxies = n_proxies
        self.n_resolvers = n_resolvers
        self.n_tlogs = n_tlogs
        self.n_replicas = n_replicas
        self.with_ratekeeper = ratekeeper
        # Resolve-dispatch scheduler knobs (sched subsystem): coalescing
        # budget + modeled per-batch device-execution cost (virtual time),
        # applied to every generation's resolvers — nonzero cost is what
        # makes resolver queue depth (and the ratekeeper's resolver_queue
        # backpressure loop) observable under simulation.
        self.resolver_budget_s = resolver_budget_s
        self.resolver_dispatch_cost_s = resolver_dispatch_cost_s
        # Wave-commit resolve mode (reorder-don't-abort; None = the
        # FDB_TPU_WAVE_COMMIT env default). Multi-resolver wave commit is
        # a CAPABILITY check, not a blanket refusal: engines implementing
        # the global edge-exchange protocol (resolve_edges/resolve_apply
        # — oracle, oracle-replay, tpu) reorder against the OR-reduced
        # GLOBAL graph at any resolver count; the cpp skiplist never
        # materializes the graph and still refuses.
        self.wave_commit = (_wave_commit_default() if wave_commit is None
                            else bool(wave_commit))
        if self.wave_commit:
            _validate_wave_commit(
                n_resolvers=n_resolvers,
                skiplist_engine="cpp" if engine == "cpp" else None,
                wave_global_capable=engine in WAVE_GLOBAL_CAPABLE_ENGINES,
            )
        # Admission-time early conflict detection needs AdmissionPolicy
        # (admission/policy.py, not ported): refused above when on.
        self.admission = False
        self.admission_opts = dict(admission_opts or {})
        # Operator tag quotas survive recoveries: the dict is SHARED with
        # each generation's Ratekeeper (set_tag_quota mutates it in
        # place), so a newly recruited ratekeeper inherits every quota —
        # campaign-found defect: a kill-triggered recovery silently
        # unthrottled an abusive tag (QuotaAbuseUnderKills seed 3).
        self.tag_quotas: dict[str, float] = {}
        self.resolver_map = KeyShardMap.uniform(n_resolvers)
        # k-way ring teams (shared with the deployed storage_shard_map —
        # runtime/shardmap.ring_teams; reference: DDTeamCollection builds
        # overlapping teams so load spreads without k*n servers).
        # Multi-region: REGION teams — each shard's replicas are
        # (primary storage i, remote storage n+i), the reference's
        # cross-region team pairing.
        from foundationdb_tpu_torch.runtime.shardmap import ring_teams

        if self.multi_region:
            teams = [(i, n_storages + i) for i in range(n_storages)]
        else:
            teams = ring_teams(n_storages, n_replicas) or [
                (i,) for i in range(n_storages)
            ]
        self.storage_map = KeyShardMap.uniform(n_storages, teams=teams)
        self._gen_processes: list[str] = []  # previous generation, for retirement
        self.backup_active = False  # BackupAgent sets; survives recoveries
        self.backup_worker = None  # live BackupWorker (its cursor bounds salvage)
        self.db_locked = False  # DR switchover / operator lock; survives recoveries
        # Tenant authorization (runtime/authz): proxies of every generation
        # verify commit tokens against this public key when set.
        self.authz = None
        if authz_public_key is not None:
            from foundationdb_tpu_torch.runtime.authz import TokenAuthority

            self.authz = TokenAuthority(authz_public_key)
        # Operator-minted system-scope token for in-process system actors
        # (TimeKeeper): with authz on, \xff writes require it.
        self.authz_system_token = authz_system_token
        # HARNESS-side operator private key (cluster processes never hold
        # it — they verify with the public key only): lets spec-driven
        # workloads mint tokens mid-run, playing the operator (the
        # reference's simulation signs tokens the same way).
        self.authz_private_pem = authz_private_pem
        self.retired_tags: set[int] = set()  # stopped-backup tags, per tlog

        # Storage servers persist across generations (they ARE the data);
        # their tlog endpoint is re-pointed by each recruitment. Their read
        # plane and watches live on ``device``.
        def make_kvstore(i: int):
            if data_dir is None:
                return None
            from foundationdb_tpu_torch.runtime.kvstore import make_kvstore as mk

            return mk(os.path.join(data_dir, f"storage{i}.db"),
                      storage_engine)

        n_storage_total = n_storages * (2 if self.multi_region else 1)
        self.storages = [
            StorageServer(self.loop, tag=i, tlog_ep=None,
                          kvstore=make_kvstore(i), authz=self.authz,
                          device=device)
            for i in range(n_storage_total)
        ]
        self.storage_eps = [
            self.net.host(self._region_proc(self._storage_region(i),
                                            f"storage{i}"),
                          f"storage{i}", s)
            for i, s in enumerate(self.storages)
        ]
        # ONE tenant-map mirror per cluster (authz.TenantMapMirror):
        # proxies check tenant-bound tokens at commit, storages at read;
        # all against the same live view refreshed from the owning
        # storage team at its latest applied version.
        self.tenant_mirror = None
        if self.authz is not None:
            from foundationdb_tpu_torch.runtime.authz import TenantMapMirror

            self.tenant_mirror = TenantMapMirror(
                self.loop, self.storage_eps, self.storage_map,
                token=self.authz_system_token,
            )
            self.loop.spawn(
                self.tenant_mirror.run(),
                process=process_prefix + "tenant_mirror",
                name="tenant_mirror.run",
            )
            for s in self.storages:
                s.tenant_mirror = self.tenant_mirror
                # Peer-facing credential for shard-move snapshots (mint
                # the cluster token as [b""] + system: moves copy user
                # keyspace).
                s.system_token = self.authz_system_token
        # Serve-set guards are active whenever shards can move or replicate
        # (single-replica static clusters skip them entirely).
        if data_distribution or n_replicas > 1 or self.multi_region:
            for i, s in enumerate(self.storages):
                s.init_served([
                    (sh.range.begin, sh.range.end)
                    for sh in self.storage_map.shards
                    if i in sh.team
                ])

        if n_coordinators:
            self._bootstrap_coordinated(n_coordinators, n_cc_candidates)
        else:
            # Legacy singleton controller (no election, never killed).
            self.coordinators = []
            self.coordinator_eps = []
            self.cc_heartbeats = {}
            self.controller = ClusterController(self.loop, recruiter=self)
            self.controller_ep = self.net.host(
                "cluster_controller", "cluster_controller", self.controller
            )
            self.controller.bootstrap(**self._bootstrap_args())
            self.loop.spawn(
                self.controller.run(), process=process_prefix + "cluster_controller", name="cc.run"
            )

        for i, s in enumerate(self.storages):
            self.loop.spawn(
                s.run(),
                process=process_prefix + self._region_proc(
                    self._storage_region(i), f"storage{i}"),
                name=f"storage{i}.run")

        self.data_distributor = None
        self.data_distributor_ep = None
        if data_distribution:
            from foundationdb_tpu_torch.runtime.data_distribution import (
                DataDistributor,
            )

            self.data_distributor = DataDistributor(
                self.loop, self, replication=n_replicas
            )
            self.data_distributor_ep = self.net.host(
                "data_distributor", "data_distributor", self.data_distributor
            )
            self.loop.spawn(
                self.data_distributor.run(),
                process=process_prefix + "data_distributor",
                name="dd.run",
            )

        # TimeKeeper (reference: the actor inside ClusterController):
        # version ↔ clock samples through the normal commit path. Spawned
        # once — it survives recoveries via the client retry loop.
        self.timekeeper = None
        if timekeeper:
            from foundationdb_tpu_torch.client.ryw import open_database
            from foundationdb_tpu_torch.runtime.timekeeper import TimeKeeper

            self.timekeeper = TimeKeeper(self.loop, open_database(self),
                                         token=authz_system_token)
            self.loop.spawn(
                self.timekeeper.run(), process=process_prefix + "timekeeper",
                name="timekeeper.run",
            )

    # -- durable restart (reference: tlog DiskQueue + sqlite engine) ----------

    def _meta_path(self) -> str:
        return os.path.join(self.data_dir, "cluster.json")

    def _read_cluster_meta(self) -> dict | None:
        path = self._meta_path()
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def _persist_cluster_meta(self, epoch: int, recovery_version: int,
                              tlog_files: list[str]) -> None:
        tmp = self._meta_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({
                "epoch": epoch,
                "recovery_version": recovery_version,
                "tlog_files": tlog_files,
            }, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._meta_path())  # atomic swap

    def _bootstrap_args(self) -> dict:
        """Fresh cluster → epoch 1; restart → persisted epoch + 1 with the
        last generation's disk queues salvaged as seed entries (the whole-
        cluster-crash analogue of recovery's lock-and-salvage)."""
        if not self._restore:
            return {}
        from foundationdb_tpu_torch.runtime.diskqueue import DiskQueue

        best: list = []
        for path in self._restore["tlog_files"]:
            entries = DiskQueue.recover(path)
            if len(entries) > len(best):
                best = entries  # replicas are identical chains: longest wins
        recovery_version = max(
            [v for v, _t in best] + [self._restore["recovery_version"]]
        )
        return {
            "epoch": self._restore["epoch"] + 1,
            "recovery_version": recovery_version,
            "seed_entries": best,
        }

    # -- coordinated-controller mode ------------------------------------------

    def install_controller(self, cc, process: str):
        """Host an elected controller's RPC surface and make it the cluster's
        current controller (called at bootstrap and by takeover winners)."""
        ep = self.net.host(process, "cluster_controller", cc)
        self.controller = cc
        self.controller_ep = ep
        return ep

    def _bootstrap_coordinated(self, n_coordinators: int, n_cc: int) -> None:
        """Coordinator quorum + controller candidates. Initial election is
        seeded synchronously (candidate 0 wins reign 1) so the first
        generation exists before the loop runs — the same shortcut the
        reference takes by writing the cluster file's initial coordinated
        state at database creation."""
        from foundationdb_tpu_torch.runtime.cluster import Heartbeat
        from foundationdb_tpu_torch.runtime.coordination import (
            ControllerCandidate,
            CoordinatedState,
            Coordinator,
        )

        self.coordinators = [Coordinator() for _ in range(n_coordinators)]
        self.coordinator_eps = [
            self.net.host(f"coord{i}", "coordinator", c)
            for i, c in enumerate(self.coordinators)
        ]
        # Every candidate process carries a liveness probe so rivals can
        # tell a dead incumbent from a live one before racing a takeover.
        self.cc_heartbeats = {
            f"cc{i}": self.net.host(f"cc{i}", "heartbeat", Heartbeat())
            for i in range(n_cc)
        }

        cc0 = ClusterController(
            self.loop, recruiter=self, identity="cc0",
            coord=CoordinatedState(self.loop, self.coordinator_eps, 0),
            reign=1,
        )
        self.install_controller(cc0, "cc0")
        cc0.bootstrap(**self._bootstrap_args())
        g = cc0.generation
        seed = {
            "reign": 1,
            "leader": "cc0",
            "controller_ep": self.controller_ep,
            "epoch": g.epoch,
            "recovery_version": g.recovery_version,
            "tlog_eps": list(self.tlog_eps),
        }
        for c in self.coordinators:
            c.accepted_ballot = (1, 0)
            c.promised = (1, 0)
            c.accepted_value = dict(seed)
        self.loop.spawn(cc0.run(), process=self.process_prefix + "cc0", name="cc0.run")

        self.cc_candidates = [
            ControllerCandidate(self.loop, self, i, self.coordinator_eps)
            for i in range(n_cc)
        ]
        for cand in self.cc_candidates:
            self.loop.spawn(
                cand.run(), process=self.process_prefix + cand.my_id,
                name=f"{cand.my_id}.candidate"
            )

    def retire_previous(self) -> None:
        """Kill + unhost the superseded generation's roles (reference:
        old-epoch roles die on seeing the new epoch). Called by the
        controller once the new generation is PUBLISHED.

        Names still in the CURRENT generation are skipped: a deposed
        rival that recruited at the same epoch used the same process
        names (sfx is epoch-derived), and killing by that shared name
        would take down the winner's live roles — the rival's orphaned
        actors are left to fail harmlessly against the locked old
        tlogs. The processes are killed in recruitment order (the JAX
        module iterates a set of names, whose order follows the
        interpreter's string hashing)."""
        current = set(self._gen_processes)
        for proc in dict.fromkeys(getattr(self, "_pending_retirement", [])):
            if proc in current:
                continue
            self.loop.kill_process(self.process_prefix + proc)
            self.net.unhost_process(proc)
        self._pending_retirement = []

    # -- region placement -----------------------------------------------------

    def _storage_region(self, i: int) -> str | None:
        if not self.multi_region:
            return None
        return "pri" if i < len(self.storage_map.shards) else "rem"

    def _region_proc(self, region: str | None, name: str) -> str:
        """Region-prefixed process name ("pri/storage0"); plain name in
        single-region clusters (zero behavior change there)."""
        return f"{region}/{name}" if region else name

    def storage_procs(self) -> list[str]:
        """Actual storage process names, region-prefixed on multi-region
        clusters — the ONE place the scheme lives. A bare "storage0"
        names nothing there, so any consumer building its own (fault
        injection, worker_interfaces discovery) silently no-ops."""
        return [
            self._region_proc(self._storage_region(i), f"storage{i}")
            for i in range(len(self.storages))
        ]

    def _pick_active_region(self) -> str | None:
        """Recruitment-time region choice (the automatic failover seam):
        if the active region is dead and the standby is not, flip — the
        new transaction subsystem forms in the standby region, salvaging
        from the satellite tlogs. Reference: ClusterController's
        datacenter preference + region failover
        (fdbserver/ClusterController.actor.cpp bestDC logic)."""
        if not self.multi_region:
            return None

        def dark(region: str) -> bool:
            # Dead (blackout) and partitioned-alive both read as dark
            # from the controller's side — the deployed controller makes
            # the same call from failed probes, unable to distinguish.
            return (self.net.region_dead(region + "/")
                    or self.net.region_partitioned(region + "/"))

        if dark(self.active_region) and not dark(self.standby_region):
            from foundationdb_tpu_torch.runtime.trace import Severity, trace

            trace(self.loop).event(
                "RegionFailover", Severity.WARN_ALWAYS,
                failed=self.active_region, to=self.standby_region,
            )
            self.active_region, self.standby_region = (
                self.standby_region, self.active_region)
        return self.active_region

    def heal_region(self, region: str) -> None:
        """Harness-side region heal: clear the network fault and restart
        the region's storage pull loops (sim kills cancel actor tasks;
        the storage OBJECTS survive with their data — a rebooted machine
        reattaching its disk). Chain roles of the dead region are NOT
        restarted: they belong to a retired generation; the region serves
        as standby until a failover recruits into it again. Catch-up is
        guaranteed by the pop-floor machinery: these storages never
        popped their tags from the new generation's tlogs, so the suffix
        they missed is still held for them."""
        self.net.heal_region(region + "/")
        for i, s in enumerate(self.storages):
            if self._storage_region(i) == region:
                self.loop.spawn(
                    s.run(),
                    process=self.process_prefix + self._region_proc(
                        region, f"storage{i}"),
                    name=f"storage{i}.run")

    # -- recruiter interface (called by ClusterController / recovery) ---------

    def _derive_resolver_map(self) -> KeyShardMap:
        """Density-driven resolver splits (reference: CommitProxyServer
        resolver ranges kept balanced from DD metrics): split the
        keyspace at the byte-weighted quantiles of DataDistribution's
        last shard-stats pass, so each resolver owns ~equal observed
        load instead of equal key prefixes. Safe ONLY at recruitment —
        resolver histories reset with the generation, so moving the
        split cannot separate a read from the history of the writes it
        must be checked against."""
        from foundationdb_tpu_torch.runtime.shardmap import MAX_KEY

        n = self.n_resolvers
        stats = getattr(self, "dd_shard_bytes", None)  # [(begin, end, bytes)]
        total = sum(b for _, _, b in stats) if stats else 0
        if n <= 1 or not total:
            return KeyShardMap.uniform(n)
        picks: list[bytes] = []
        acc, d = 0, 1
        for _begin, end, nbytes in stats:  # shards in key order
            acc += nbytes
            while d < n and acc * n >= d * total:
                if end != MAX_KEY and (not picks or end > picks[-1]):
                    picks.append(end)  # split at this shard's end boundary
                d += 1
        if len(picks) != n - 1:
            return KeyShardMap.uniform(n)  # too few distinct boundaries
        return KeyShardMap(picks, tags=list(range(n)))

    def recruit_generation(
        self, epoch: int, recovery_version: int, seed_entries: list
    ) -> Generation:
        sfx = "" if epoch == 1 else f".e{epoch}"
        start_version = 0 if epoch == 1 else recovery_version + EPOCH_VERSION_JUMP
        # Seed only what some puller may still need: salvage can come from a
        # replica whose log was never trimmed (pullers pop one tlog), and
        # re-seeding its full history would compound across recoveries. The
        # floor is the min over every pull cursor: storage applied versions
        # (DURABLE versions when a persistent engine runs — everything above
        # sqlite's snapshot must survive into the new epoch's disk queues or
        # a later whole-cluster crash loses acked commits) AND the backup
        # worker's log cursor when a backup is running.
        def pull_floor(s) -> int:
            return s._version if s.kvstore is None else s._durable_version

        floor = min(
            (min(pull_floor(s), recovery_version) for s in self.storages),
            default=0,
        )
        if self.backup_active and self.backup_worker is not None:
            floor = min(floor, self.backup_worker._version)
        seed_entries = [(v, t) for v, t in seed_entries if v > floor]
        heartbeat_eps: dict = {}
        region = self._pick_active_region()

        def host(process: str, name: str, obj, run: bool = False,
                 region_name: str | None = region):
            process = self._region_proc(region_name, process)
            ep = self.net.host(process, name, obj)
            heartbeat_eps[process] = self.net.host(process, "heartbeat", Heartbeat())
            if run:
                self.loop.spawn(obj.run(),
                                process=self.process_prefix + process,
                                name=f"{name}.run")
            return ep

        if epoch > 1:
            # Re-split resolver ranges from observed density at recovery
            # (fresh resolver histories make the move safe).
            self.resolver_map = self._derive_resolver_map()

        self.sequencer = Sequencer(self.loop, epoch, recovery_version)
        assert self.sequencer.last_handed_out == start_version
        self.sequencer_ep = host("master" + sfx, "sequencer", self.sequencer)

        self.resolvers = [
            Resolver(self.loop,
                     new_conflict_set(self.engine,
                                      wave_commit=self.wave_commit,
                                      device=self.device),
                     init_version=start_version,
                     budget_s=self.resolver_budget_s,
                     dispatch_cost_s=self.resolver_dispatch_cost_s)
            for _ in range(self.n_resolvers)
        ]
        self.resolver_eps = [
            host(f"resolver{i}{sfx}", f"resolver{i}", r)
            for i, r in enumerate(self.resolvers)
        ]

        def tlog_disk(i: int) -> str | None:
            if self.data_dir is None:
                return None
            return os.path.join(self.data_dir, f"tlog{i}.e{epoch}.q")

        self.tlogs = [
            TLog(self.loop, init_version=start_version, seed=list(seed_entries),
                 retired_tags=set(self.retired_tags), disk_path=tlog_disk(i),
                 epoch=epoch)
            for i in range(self.n_tlogs)
        ]
        self.tlog_eps = [
            host(f"tlog{i}{sfx}", f"tlog{i}", t) for i, t in enumerate(self.tlogs)
        ]
        # Region tlog set: chain tlogs serve storage pulls; satellite
        # tlogs (hosted in the satellite region, full replicas of the
        # mutation stream) are in the proxies' synchronous push set AND
        # recovery's lock/salvage set — that is what makes region
        # failover lossless (reference: satellite TLogs,
        # TLogServer.actor.cpp + DatabaseConfiguration satellite policy).
        chain_tlog_eps = list(self.tlog_eps)
        if self.multi_region and self.n_satellite_tlogs:
            self.satellite_tlogs = [
                TLog(self.loop, init_version=start_version,
                     seed=list(seed_entries),
                     retired_tags=set(self.retired_tags), epoch=epoch)
                for _ in range(self.n_satellite_tlogs)
            ]
            sat_eps = [
                host(f"tlog_s{i}{sfx}", f"tlog_s{i}", t, region_name="sat")
                for i, t in enumerate(self.satellite_tlogs)
            ]
            self.tlogs = self.tlogs + self.satellite_tlogs
            self.tlog_eps = chain_tlog_eps + sat_eps
        if self.data_dir is not None:
            self._persist_cluster_meta(
                epoch, recovery_version,
                [tlog_disk(i) for i in range(self.n_tlogs)],
            )

        self.ratekeeper = (
            # resolver_eps: the sched subsystem's backpressure loop —
            # resolver dispatch-queue depth throttles admission.
            # tag_quotas: the cluster's shared dict, so operator quotas
            # survive the generation change (see __init__).
            Ratekeeper(self.loop, self.storage_eps, self.tlog_eps,
                       resolver_eps=self.resolver_eps,
                       tag_quotas=self.tag_quotas)
            if self.with_ratekeeper
            else None
        )
        self.ratekeeper_ep = (
            host("ratekeeper" + sfx, "ratekeeper", self.ratekeeper, run=True)
            if self.ratekeeper
            else None
        )

        self.grv_proxies = [
            # tlog_eps includes the satellites — the full push set is the
            # confirmEpochLive set (see runtime/grv_proxy.py).
            GrvProxy(self.loop, self.sequencer_ep, self.ratekeeper_ep,
                     tlog_eps=self.tlog_eps, epoch=epoch)
            for _ in range(self.n_proxies)
        ]
        self.grv_proxy_eps = [
            host(f"grv_proxy{i}{sfx}", f"grv_proxy{i}", g, run=True)
            for i, g in enumerate(self.grv_proxies)
        ]

        self.commit_proxies = [
            CommitProxy(
                self.loop,
                self.sequencer_ep,
                self.resolver_eps,
                self.resolver_map,
                self.tlog_eps,
                self.storage_map,
                controller_ep=getattr(self, "controller_ep", None),
                epoch=epoch,
                authz=self.authz,
                tenant_mirror=self.tenant_mirror,
                admission=None,
                wave_commit=self.wave_commit,
                # One exchange = one schedule domain: cap wave batches at
                # the recruited engines' OWN chunk (derived, not
                # re-stated — a drifted constant would hit resolve_edges'
                # loud per-window refusal under load); oracle engines are
                # unchunked (None).
                wave_batch_limit=getattr(
                    self.resolvers[0].cs, "batch_size", None
                ),
            )
            for _ in range(self.n_proxies)
        ]
        for c in self.commit_proxies:
            c.backup_enabled = self.backup_active  # backup spans recoveries
            c.locked = self.db_locked  # the lock spans recoveries too
        self.commit_proxy_eps = [
            host(f"commit_proxy{i}{sfx}", f"commit_proxy{i}", c, run=True)
            for i, c in enumerate(self.commit_proxies)
        ]
        if self.ratekeeper is not None:
            # Proxies recruit after the ratekeeper; hand it their endpoints
            # so it can measure committed-txn throughput (calibration).
            self.ratekeeper.proxies = list(self.commit_proxy_eps)

        # Hand storage servers to the new generation: roll back anything
        # applied above the recovery version (their old tlog's lost suffix)
        # and re-point their pull loops at the new CHAIN tlogs (satellite
        # tlogs hold the same stream but serve recovery, not pulls).
        for s in self.storages:
            s.recover_to(recovery_version, chain_tlog_eps[0], chain_tlog_eps)

        # Retirement of the previous generation is DEFERRED: the
        # controller calls retire_previous() only after the registry
        # accepts the new generation. A deposed controller that already
        # recruited must leave the old roles alive — its rival's recovery
        # still needs to lock the old tlogs (killing them here was the
        # Chaos-campaign stall: an unpublished generation orphaned the
        # only locked log copies).
        # ACCUMULATE (not overwrite): after a deposed rival's unpublished
        # recruit, the winner's retire sweeps both the superseded
        # generation AND the rival's orphaned roles.
        self._pending_retirement = (
            getattr(self, "_pending_retirement", []) + list(self._gen_processes)
        )
        self._gen_processes = list(heartbeat_eps)

        return Generation(
            epoch=epoch,
            recovery_version=recovery_version,
            sequencer_ep=self.sequencer_ep,
            resolver_eps=self.resolver_eps,
            tlog_eps=self.tlog_eps,
            grv_proxy_eps=self.grv_proxy_eps,
            commit_proxy_eps=self.commit_proxy_eps,
            ratekeeper_ep=self.ratekeeper_ep,
            heartbeat_eps=heartbeat_eps,
        )

    # -- client-side routing helpers -----------------------------------------

    def storage_ep_for_key(self, key: bytes):
        return self.storage_eps[self.storage_map.tag_for_key(key)]

    def storage_eps_for_range(self, begin: bytes, end: bytes):
        from foundationdb_tpu_torch.core.types import KeyRange

        return [
            (r, self.storage_eps[tag])
            for r, tag in self.storage_map.split_range(KeyRange(begin, end))
        ]


#: The arms whose modules the port does not have, by argument name.
_UNPORTED = {
    "recorder_path": "obs/recorder.py (FlightRecorder)",
    "admission": "admission/policy.py (AdmissionPolicy)",
}


def _refuse_unported(*, recorder_path, admission) -> None:
    """Raise ``NotImplementedError`` naming the module of the first arm
    asked for that the port does not have. Admission ``None`` reads the
    FDB_TPU_ADMISSION env default, as the JAX package does."""
    if admission is None:
        admission = env_choice("FDB_TPU_ADMISSION", "0", ("0", "1")) == "1"
    asked = {"recorder_path": recorder_path is not None,
             "admission": bool(admission)}
    for arm, on in asked.items():
        if on:
            raise NotImplementedError(
                f"SimCluster({arm}=...) needs {_UNPORTED[arm]}, which is not "
                "ported yet")
