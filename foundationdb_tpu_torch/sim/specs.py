"""TOML test specs driving simulation workloads.

A copy of ``foundationdb_tpu/sim/specs.py`` for the port, its imports
rewritten to the port's modules; names and behaviour are the JAX module's,
with three differences:

- **authz.** ``authz = true`` in a cluster table raises
  ``NotImplementedError`` naming runtime/authz.py, before any key is made
  (the JAX module generates a keypair there).
- **The fresh cluster of a ``[test.cluster]`` test.** ``run_spec`` builds
  it on the caller's cluster's ``engine`` and ``device`` (a table's own
  ``engine`` still wins); the JAX module builds it on its defaults, the
  oracle on the host. The port's defaults are the card, so a caller on the
  CPU would otherwise reach ``cuda``. Under the oracle engine the two
  packages build the same cluster, and the seed is drawn from
  ``cluster.loop.rng`` where the JAX module draws it.
- **Refusals.** A workload or a cluster arm whose module the port does not
  have raises ``NotImplementedError`` naming the module (``load_spec``
  builds every workload, so a file holding one raises there);
  ``ValueError`` stays for a ``testName`` the registry does not know.
  ``load_test`` parses one ``[[test]]`` table, so that a runner can report
  such a test and run the others of its file.

Reference: tests/fast/*.toml — each file holds one or more ``[[test]]``
blocks; a test has a title and one or more ``[[test.workload]]`` entries
run CONCURRENTLY against the same cluster, with optional fault-injection
knobs. The reference's fdbserver -r simulation consumes these; here
``run_spec`` does, against a SimCluster.

Example (the shape the reference uses, reference: tests/fast/Cycle.toml):

    [[test]]
    testTitle = 'CycleWithFaults'
    killInterval = 0.4
    maxKills = 2

    [[test.workload]]
    testName = 'Cycle'
    nodeCount = 10
    transactionCount = 40
"""

from __future__ import annotations

try:
    import tomllib
except ModuleNotFoundError:  # python 3.10: API-compatible backport
    import tomli as tomllib

from dataclasses import dataclass, field

from foundationdb_tpu_torch.runtime.flow import all_of
from foundationdb_tpu_torch.sim.workloads import (
    AtomicOpsWorkload,
    AuthzWorkload,
    BackupRestoreWorkload,
    ChangeFeedWorkload,
    ConflictRangeWorkload,
    ConsistencyCheckWorkload,
    CycleWorkload,
    FailoverZipfRepairWorkload,
    FaultInjector,
    IncrementWorkload,
    MakoWorkload,
    RandomReadWriteWorkload,
    SelectorCorrectnessWorkload,
    TPCCNewOrderWorkload,
    DDBalanceWorkload,
    FuzzApiWorkload,
    IndexStressWorkload,
    RegionFailoverWorkload,
    TaskBucketWorkload,
    TenantWorkload,
    VersionStampWorkload,
    YCSBWorkload,
    WatchesWorkload,
    WatchFanOutWorkload,
    WorkloadMetrics,
    WriteDuringReadWorkload,
    ZipfRepairWorkload,
)

# testName -> (workload class, TOML key -> constructor kwarg). Unknown TOML
# keys are ignored, like the reference tolerates unconsumed knobs.
WORKLOAD_REGISTRY: dict[str, tuple[type, dict[str, str]]] = {
    "Cycle": (CycleWorkload, {
        "nodeCount": "n_nodes",
        "transactionCount": "n_txns",
        "clientCount": "n_clients",
    }),
    "AtomicOps": (AtomicOpsWorkload, {
        "transactionCount": "n_txns",
    }),
    "RandomReadWrite": (RandomReadWriteWorkload, {
        "keyCount": "n_keys",
        "transactionCount": "n_txns",
        "clientCount": "n_clients",
        "writeFraction": "write_fraction",
    }),
    "Mako": (MakoWorkload, {
        "rows": "rows",
        "transactionCount": "n_txns",
        "clientCount": "n_clients",
        "readsPerTransaction": "reads_per_txn",
        "writesPerTransaction": "writes_per_txn",
    }),
    "TpccNewOrder": (TPCCNewOrderWorkload, {
        "warehouses": "warehouses",
        "districts": "districts",
        "items": "items",
        "transactionCount": "n_txns",
        "clientCount": "n_clients",
    }),
    "ConflictRange": (ConflictRangeWorkload, {
        "transactionCount": "n_txns",
        "clientCount": "n_clients",
    }),
    "Watches": (WatchesWorkload, {
        "keyCount": "n_keys",
        "rounds": "n_rounds",
    }),
    "WatchFanOut": (WatchFanOutWorkload, {
        "keyCount": "n_keys",
        "watchersPerKey": "watchers_per_key",
    }),
    "YCSB": (YCSBWorkload, {
        "variant": "variant",
        "keyCount": "n_keys",
        "transactionCount": "n_txns",
        "clientCount": "n_clients",
        "batchSize": "batch",
        "scanFraction": "scan_fraction",
    }),
    "VersionStamp": (VersionStampWorkload, {
        "transactionCount": "n_txns",
        "clientCount": "n_clients",
    }),
    "ChangeFeed": (ChangeFeedWorkload, {
        "keyCount": "n_keys",
        "transactionCount": "n_txns",
        "clientCount": "n_clients",
    }),
    "Increment": (IncrementWorkload, {
        "counterCount": "n_counters",
        "transactionCount": "n_txns",
        "clientCount": "n_clients",
    }),
    "SelectorCorrectness": (SelectorCorrectnessWorkload, {
        "keyCount": "n_keys",
        "queryCount": "n_queries",
        "clientCount": "n_clients",
    }),
    "BackupRestore": (BackupRestoreWorkload, {
        "keyCount": "n_keys",
        "transactionCount": "n_txns",
        "clientCount": "n_clients",
    }),
    "FailoverZipfRepair": (FailoverZipfRepairWorkload, {
        "keyCount": "n_keys",
        "transactionCount": "n_txns",
        "clientCount": "n_clients",
        "theta": "theta",
        "readsPerTransaction": "reads_per_txn",
    }),
    "TaskBucket": (TaskBucketWorkload, {
        "taskCount": "n_tasks",
        "executorCount": "n_executors",
        "lease": "lease",
    }),
    "ZipfRepair": (ZipfRepairWorkload, {
        "keyCount": "n_keys",
        "transactionCount": "n_txns",
        "clientCount": "n_clients",
        "theta": "theta",
        "readsPerTransaction": "reads_per_txn",
        "repair": "repair",
        # hottest = mutual hot-key RMW (cycle-heavy); coldest =
        # read-hot-write-cold chains (the wave-reorderable shape).
        "targetPick": "target_pick",
    }),
    "WriteDuringRead": (WriteDuringReadWorkload, {
        "keyCount": "n_keys",
        "transactionCount": "n_txns",
        "opsPerTransaction": "ops_per_txn",
    }),
    "FuzzApiCorrectness": (FuzzApiWorkload, {
        "keyCount": "n_keys",
        "transactionCount": "n_txns",
        "opsPerTransaction": "ops_per_txn",
    }),
    "IndexStress": (IndexStressWorkload, {
        "itemCount": "n_items",
        "transactionCount": "n_txns",
        "clientCount": "n_clients",
    }),
    "Tenants": (TenantWorkload, {
        "tenantCount": "n_tenants",
        "transactionCount": "n_txns",
        "clientCount": "n_clients",
    }),
    "DDBalance": (DDBalanceWorkload, {
        "keyCount": "n_keys",
        "transactionCount": "n_txns",
        "moveCount": "n_moves",
    }),
    "Authz": (AuthzWorkload, {
        "transactionCount": "n_txns",
        "clientCount": "n_clients",
    }),
    "ConsistencyCheck": (ConsistencyCheckWorkload, {
        "keyCount": "n_keys",
        "transactionCount": "n_txns",
        "clientCount": "n_clients",
    }),
    "RegionFailover": (RegionFailoverWorkload, {
        "transactionCount": "n_txns",
        "clientCount": "n_clients",
        "failAfter": "fail_after",
        "heal": "heal",
        "mode": "mode",
    }),
}


# Base topology every spec runner starts from; [test.cluster] entries
# override it. One definition so the pytest path and the campaign runner
# exercise identical clusters for the same spec.
BASE_CLUSTER = {"n_tlogs": 2, "n_storages": 2}


def cluster_kwargs(spec: "TestSpec") -> dict:
    return {**BASE_CLUSTER, **spec.cluster_opts}


# [test.cluster] / [campaign.cluster] key -> SimCluster kwarg.
CLUSTER_KEY_MAP = {
    "storages": "n_storages",
    "tlogs": "n_tlogs",
    "replicas": "n_replicas",
    "proxies": "n_proxies",
    "resolvers": "n_resolvers",
    "coordinators": "n_coordinators",
    "dataDistribution": "data_distribution",
    "storageEngine": "storage_engine",
    # Resolve-dispatch scheduler (sched subsystem): a coalescing budget
    # and a modeled per-batch device-execution cost — nonzero cost makes
    # dispatch take virtual time, so queue depth (and the ratekeeper's
    # resolver_queue backpressure) is exercisable in simulation.
    "resolverBudget": "resolver_budget_s",
    "resolverDispatchCost": "resolver_dispatch_cost_s",
    # Admission-time early conflict detection (admission subsystem):
    # `admission = true` arms the recent-writes filter + policy on every
    # generation's proxies/resolvers.
    "admission": "admission",
    # Commit-path tracing (obs subsystem): `obs = true` attaches a span
    # sink to the cluster loop; `obsSampleEvery = N` samples 1-in-N
    # (campaigns gate span-tree completeness under faults with it).
    "obs": "obs",
    "obsSampleEvery": "obs_sample_every",
    # Wave commit (reorder-don't-abort resolve; with resolvers > 1 the
    # role-level global edge-exchange protocol) and the engine behind it
    # — campaigns gating wave counters pin engine = 'oracle-replay' so
    # every schedule is sequentially replay-verified inline.
    "waveCommit": "wave_commit",
    "engine": "engine",
}


def cluster_kwargs_from_table(tbl: dict) -> dict:
    """Translate a TOML cluster table into SimCluster kwargs — shared by
    [[test]] specs and [[campaign]] specs so both drive identical
    clusters for the same table."""
    opts = {CLUSTER_KEY_MAP[k]: v for k, v in tbl.items()
            if k in CLUSTER_KEY_MAP}
    # Admission knobs (admission subsystem): threshold/feature overrides
    # collected into SimCluster's admission_opts.
    adm_opts = {}
    if "admissionShapeRisk" in tbl:
        adm_opts["shape_risk"] = float(tbl["admissionShapeRisk"])
    if "admissionPreabort" in tbl:
        adm_opts["preabort"] = bool(tbl["admissionPreabort"])
    if adm_opts:
        opts["admission_opts"] = adm_opts
    # Region config (reference: DatabaseConfiguration regions):
    # `satelliteTlogs = k` turns on the pri/sat/rem multi-region topology.
    if "satelliteTlogs" in tbl:
        opts["multi_region"] = {"satellite_tlogs": tbl["satelliteTlogs"]}
    # `authz = true`: generate an operator keypair for this test cluster —
    # processes verify with the public key; the private key stays
    # harness-side (cluster.authz_private_pem) so workloads can mint
    # tokens, playing the operator.
    if tbl.get("authz"):
        raise NotImplementedError(
            "a cluster table with authz = true needs runtime/authz.py "
            "(generate_keypair, mint_token), which is not ported yet")
    return opts


@dataclass
class TestSpec:
    title: str
    workloads: list  # instantiated Workload objects
    kill_interval: float | None = None
    partition_interval: float | None = None
    max_kills: int = 0
    include_controller: bool = False
    clog_interval: float | None = None  # slow-but-alive link injection
    buggify: bool = False  # enable in-role BUGGIFY sites for this test
    buggify_aggressive: bool = False  # every site active, fire >= 50%
    # [test.cluster] table: tests needing a non-default cluster (e.g. the
    # DataDistributor for DDBalance) declare it; the runner builds a fresh
    # SimCluster with these kwargs for that test only.
    cluster_opts: dict = field(default_factory=dict)


@dataclass
class SpecResult:
    title: str
    metrics: dict[str, WorkloadMetrics] = field(default_factory=dict)
    kills: list[str] = field(default_factory=list)


def load_spec(source: str | bytes) -> list[TestSpec]:
    """Parse TOML text (or a path ending in .toml) into TestSpecs."""
    doc = load_doc(source)
    return [load_test(test) for test in doc.get("test", [])]


def load_doc(source: str | bytes) -> dict:
    """The parsed TOML document of ``source`` (text, or a path ending in
    .toml)."""
    if isinstance(source, str) and source.endswith(".toml"):
        with open(source, "rb") as f:
            return tomllib.load(f)
    text = source.decode() if isinstance(source, bytes) else source
    return tomllib.loads(text)


def load_test(test: dict) -> TestSpec:
    """One parsed ``[[test]]`` table into a TestSpec: its workloads in
    file order, then its cluster table."""
    workloads = []
    for i, w in enumerate(test.get("workload", [])):
        name = w["testName"]
        if name not in WORKLOAD_REGISTRY:
            raise ValueError(f"unknown workload testName {name!r}")
        cls, mapping = WORKLOAD_REGISTRY[name]
        kwargs = {
            mapping[k]: v for k, v in w.items() if k in mapping
        }
        kwargs["seed"] = w.get("seed", test.get("seed", i))
        workloads.append(cls(**kwargs))
    cluster_opts = cluster_kwargs_from_table(test.get("cluster", {}))
    return TestSpec(
        title=test.get("testTitle", "untitled"),
        workloads=workloads,
        kill_interval=test.get("killInterval"),
        partition_interval=test.get("partitionInterval"),
        max_kills=test.get("maxKills", 0),
        include_controller=test.get("killController", False),
        clog_interval=test.get("clogInterval"),
        buggify=test.get("buggify", False),
        buggify_aggressive=test.get("buggifyAggressive", False),
        cluster_opts=cluster_opts,
    )


async def run_spec_test(spec: TestSpec, cluster, db) -> SpecResult:
    """setup all → run all CONCURRENTLY (± faults) → quiesce → check all —
    the reference's multi-workload test execution order."""
    result = SpecResult(spec.title)
    if spec.buggify or spec.buggify_aggressive:
        cluster.loop.buggify_enabled = True
        cluster.loop.buggify_aggressive = spec.buggify_aggressive
    for w in spec.workloads:
        await w.setup(db)
    faults = None
    if spec.max_kills > 0 or spec.partition_interval or spec.clog_interval:
        faults = FaultInjector(
            cluster,
            kill_interval=spec.kill_interval or 2.0,
            partition_interval=spec.partition_interval or 1.3,
            max_kills=spec.max_kills,
            include_controller=spec.include_controller,
            clog_interval=spec.clog_interval or 0.0,
        )
        fault_task = cluster.loop.spawn(faults.run(), name="spec.faults")
    await all_of([
        cluster.loop.spawn(w.run(db, cluster), name=f"spec.{w.name}")
        for w in spec.workloads
    ])
    if faults:
        faults.stop()
        await fault_task
        cluster.net.heal_all()
        while cluster.controller._recovering:
            await cluster.loop.sleep(0.25)
        result.kills = list(faults.kills)
    for w in spec.workloads:
        await w.check(db)
        result.metrics[w.name] = w.metrics
    return result


def run_spec(source: str | bytes, cluster, db) -> list[SpecResult]:
    """Run every [[test]] in the spec against the given cluster (tests
    with [test.cluster] requirements get their own fresh cluster, on the
    given cluster's engine and device)."""
    out = []
    for spec in load_spec(source):
        c, d = cluster, db
        if spec.cluster_opts:
            from foundationdb_tpu_torch.client.ryw import open_database
            from foundationdb_tpu_torch.sim.cluster import SimCluster

            c = SimCluster(seed=cluster.loop.rng.randint(0, 1 << 30),
                           **{"engine": cluster.engine,
                              "device": cluster.device,
                              **cluster_kwargs(spec)})
            d = open_database(c)
        out.append(c.loop.run(run_spec_test(spec, c, d), timeout=3000))
    return out
