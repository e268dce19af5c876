"""Simulation workloads: randomized transactional load with correctness
oracles, run against a SimCluster under seeded fault injection.

A copy of ``foundationdb_tpu/sim/workloads.py`` for the port, its imports
rewritten to the port's modules (those inside functions too); names and
behaviour are the JAX module's: every workload draws from
``cluster.loop.rng`` in the same order, so one seed gives the same events.
The workloads whose modules the port does not have keep their names, and
constructing one raises ``NotImplementedError`` naming the module:
``BackupRestoreWorkload`` (runtime/backup.py), ``DDBalanceWorkload``
(runtime/data_distribution.py), ``TenantWorkload`` (client/tenant.py),
``AuthzWorkload`` (runtime/authz.py), ``ZipfRepairWorkload`` and
``FailoverZipfRepairWorkload`` (repair/engine.py),
``ConsistencyCheckWorkload`` (consistency/checker.py) and
``TaskBucketWorkload`` (layers/taskbucket.py). ``RegionFailoverWorkload``
mints authz tokens only on an authz cluster, which the port's
``SimCluster`` refuses.

Reference: fdbserver/workloads/ (~200 actors driven by TOML specs in
tests/). The ones re-built here are the load-bearing correctness suite:

- CycleWorkload        — Cycle.actor.cpp: the canonical serializability
  check. Keys form a permutation ring; txns swap successor pointers; any
  lost/torn/reordered update breaks the single-cycle invariant.
- AtomicOpsWorkload    — AtomicOps.actor.cpp: concurrent atomic ADD/MAX/
  MIN/XOR streams vs an exactly-computable expected state.
- RandomReadWriteWorkload — mako/YCSB-style mixed load (Zipf hot keys);
  throughput/liveness under contention, with read-your-committed checks.
- ConflictRangeWorkload — ConflictRange.actor.cpp: randomized range
  read/write sets through the real commit path; verdict parity is covered
  kernel-side (tests/test_conflict_oracle.py), here we assert observable
  serializability of the committed history.
- FaultInjector        — the machine-kill/clogging half of the reference's
  simulation: a seeded actor that kills generation processes, injects
  partitions, and heals them, on a schedule drawn from the loop's RNG.

Every workload exposes  setup(db) / run(db) / check(db)  like the
reference's TestWorkload interface; `run_workload` wires one (plus
optional faults) onto a cluster and returns its metrics.
"""

from __future__ import annotations

import bisect
import struct
from dataclasses import dataclass, field

from foundationdb_tpu_torch.core.errors import FdbError
from foundationdb_tpu_torch.core.mutations import MutationType
from foundationdb_tpu_torch.runtime.flow import Promise, all_of


class WorkloadFailed(FdbError):
    """An invariant check failed — the simulation found a bug."""

    code = 1500


@dataclass
class WorkloadMetrics:
    txns_committed: int = 0
    txns_retried: int = 0
    txns_failed: int = 0
    ops: int = 0
    extra: dict = field(default_factory=dict)


class Workload:
    """Reference: TestWorkload — setup once, run concurrent clients, then
    check invariants on the quiesced database."""

    name = "workload"

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.metrics = WorkloadMetrics()

    async def setup(self, db) -> None:  # pragma: no cover - interface
        pass

    async def run(self, db, cluster) -> None:  # pragma: no cover - interface
        pass

    async def check(self, db) -> None:  # pragma: no cover - interface
        pass

    # -- helpers -------------------------------------------------------------

    async def _run_txn(self, db, fn, max_retries: int = 100):
        """Delegates to the ONE canonical retry loop (Database.run), adding
        only attempt accounting; tolerates cluster recoveries."""
        attempts = [0]

        async def counted(tr):
            attempts[0] += 1
            return await fn(tr)

        try:
            result = await db.run(counted, max_retries=max_retries)
        except FdbError:
            self.metrics.txns_failed += 1
            raise
        self.metrics.txns_committed += 1
        self.metrics.txns_retried += attempts[0] - 1
        return result

    @staticmethod
    def _split(n_txns: int, n_clients: int) -> list[int]:
        """Per-client txn counts summing exactly to n_txns (no silent
        remainder drop when n_txns % n_clients != 0)."""
        base, rem = divmod(n_txns, n_clients)
        return [base + (1 if i < rem else 0) for i in range(n_clients)]


class _Unported(Workload):
    """A workload whose module the port does not have yet: it keeps its
    name, and constructing it raises ``NotImplementedError`` naming the
    module it ``needs``."""

    needs = ""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} needs {self.needs}, which is not "
            "ported yet")


class CycleWorkload(Workload):
    """Keys 0..N-1 hold a permutation forming one cycle; each transaction
    picks a random node A and rotates A's successor: A→B→C becomes A→C→B...
    preserving the permutation-single-cycle invariant IF AND ONLY IF every
    transaction is atomic and serializable (reference: Cycle.actor.cpp)."""

    name = "cycle"

    def __init__(self, seed: int = 0, n_nodes: int = 16, n_txns: int = 60,
                 n_clients: int = 4):
        super().__init__(seed)
        self.n_nodes = n_nodes
        self.n_txns = n_txns
        self.n_clients = n_clients

    def _key(self, i: int) -> bytes:
        return b"cycle/%06d" % i

    async def setup(self, db) -> None:
        async def body(tr):
            for i in range(self.n_nodes):
                tr.set(self._key(i), struct.pack("<q", (i + 1) % self.n_nodes))

        await self._run_txn(db, body)

    async def run(self, db, cluster) -> None:
        rng = cluster.loop.rng

        counts = self._split(self.n_txns, self.n_clients)

        async def client(cid: int):
            for _ in range(counts[cid]):
                a = rng.randrange(self.n_nodes)

                async def body(tr, a=a):
                    b = struct.unpack("<q", await tr.get(self._key(a)))[0]
                    c = struct.unpack("<q", await tr.get(self._key(b)))[0]
                    d = struct.unpack("<q", await tr.get(self._key(c)))[0]
                    # Rotate: a -> c -> b -> d
                    tr.set(self._key(a), struct.pack("<q", c))
                    tr.set(self._key(c), struct.pack("<q", b))
                    tr.set(self._key(b), struct.pack("<q", d))

                await self._run_txn(db, body)
                self.metrics.ops += 3

        await all_of(
            [
                cluster.loop.spawn(client(i), name=f"cycle.client{i}")
                for i in range(self.n_clients)
            ]
        )

    async def check(self, db) -> None:
        async def body(tr):
            succ = []
            for i in range(self.n_nodes):
                v = await tr.get(self._key(i))
                if v is None:
                    raise WorkloadFailed(f"cycle: node {i} missing")
                succ.append(struct.unpack("<q", v)[0])
            return succ

        succ = await self._run_txn(db, body)
        seen, node = set(), 0
        for _ in range(self.n_nodes):
            if node in seen:
                raise WorkloadFailed(f"cycle: not a single cycle (revisit {node})")
            seen.add(node)
            node = succ[node]
        if node != 0 or len(seen) != self.n_nodes:
            raise WorkloadFailed("cycle: broken ring — lost or torn update")


class AtomicOpsWorkload(Workload):
    """Concurrent atomic-op streams whose final state is exactly computable:
    ADD totals, MAX/MIN extremes, XOR parity (reference: AtomicOps.actor.cpp
    compares a log-derived expectation against the db)."""

    name = "atomic_ops"

    def __init__(self, seed: int = 0, n_keys: int = 4, n_txns: int = 48,
                 n_clients: int = 4):
        super().__init__(seed)
        self.n_keys = n_keys
        self.n_txns = n_txns
        self.n_clients = n_clients
        self._expected_add = [0] * n_keys
        self._expected_max = [0] * n_keys
        self._expected_xor = [0] * n_keys

    async def run(self, db, cluster) -> None:
        rng = cluster.loop.rng
        # Pre-draw the op log so the expectation is independent of commit
        # interleaving (atomic ops commute — that is the point of the test).
        plan = []
        for count in self._split(self.n_txns, self.n_clients):
            ops = []
            for _ in range(count):
                k = rng.randrange(self.n_keys)
                val = rng.randrange(1, 1000)
                ops.append((k, val))
                self._expected_add[k] += val
                self._expected_max[k] = max(self._expected_max[k], val)
                self._expected_xor[k] ^= val
            plan.append(ops)

        async def client(cid, ops):
            for n, (k, val) in enumerate(ops):
                # Idempotency marker: a CommitUnknownResult retry of a txn
                # that DID commit must not re-apply its ADD/XOR (the
                # expectation counts each op exactly once).
                marker = b"aop/done/%d/%d" % (cid, n)

                async def body(tr, k=k, val=val, marker=marker):
                    if await tr.get(marker) is not None:
                        return  # earlier attempt committed
                    tr.set(marker, b"")
                    p = struct.pack("<q", val)
                    tr.atomic_op(MutationType.ADD, b"aop/add/%d" % k, p)
                    tr.atomic_op(MutationType.MAX, b"aop/max/%d" % k, p)
                    tr.atomic_op(MutationType.XOR, b"aop/xor/%d" % k, p)

                await self._run_txn(db, body)
                self.metrics.ops += 3

        await all_of(
            [
                cluster.loop.spawn(client(i, ops), name=f"aop.client{i}")
                for i, ops in enumerate(plan)
            ]
        )

    async def check(self, db) -> None:
        async def body(tr):
            for k in range(self.n_keys):
                for kind, expected in (
                    ("add", self._expected_add[k]),
                    ("max", self._expected_max[k]),
                    ("xor", self._expected_xor[k]),
                ):
                    raw = await tr.get(b"aop/%s/%d" % (kind.encode(), k))
                    got = struct.unpack("<q", raw)[0] if raw else 0
                    if got != expected:
                        raise WorkloadFailed(
                            f"atomic {kind}[{k}]: got {got}, want {expected}"
                        )

        await self._run_txn(db, body)


class RandomReadWriteWorkload(Workload):
    """mako/YCSB-style mixed point load on a hot-key distribution; checks
    that every acked write is durably readable (read-your-committed)."""

    name = "random_rw"

    def __init__(self, seed: int = 0, n_keys: int = 32, n_txns: int = 80,
                 n_clients: int = 4, write_fraction: float = 0.5):
        super().__init__(seed)
        self.n_keys = n_keys
        self.n_txns = n_txns
        self.n_clients = n_clients
        self.write_fraction = write_fraction
        self._acked: dict[bytes, bytes] = {}  # key -> last acked write

    def _key(self, i: int) -> bytes:
        return b"rw/%06d" % i

    async def run(self, db, cluster) -> None:
        rng = cluster.loop.rng
        counter = [0]
        counts = self._split(self.n_txns, self.n_clients)

        async def client(cid: int):
            for _ in range(counts[cid]):
                k = self._key(min(int(rng.paretovariate(1.5)) - 1, self.n_keys - 1))
                if rng.random() < self.write_fraction:
                    counter[0] += 1
                    val = b"v%08d" % counter[0]

                    async def body(tr, k=k, val=val):
                        await tr.get(k)
                        tr.set(k, val)

                    await self._run_txn(db, body)
                    # Acked: later sequential writes may overwrite, so track
                    # program order per client stream (last committed wins
                    # within this client; cross-client order is by commit).
                    self._acked[k] = val
                else:
                    async def body(tr, k=k):
                        return await tr.get(k)

                    await self._run_txn(db, body)
                self.metrics.ops += 1

        await all_of(
            [
                cluster.loop.spawn(client(i), name=f"rw.client{i}")
                for i in range(self.n_clients)
            ]
        )

    async def check(self, db) -> None:
        async def body(tr):
            for k in self._acked:
                if await tr.get(k) is None:
                    raise WorkloadFailed(f"rw: acked write to {k!r} lost")

        await self._run_txn(db, body)


class MakoWorkload(Workload):
    """mako-style fixed op mix (reference: bindings/c/test/mako): each
    transaction runs `reads_per_txn` GETs and `writes_per_txn` UPDATEs on a
    preloaded row set (the classic 90/10 mix is 9 reads + 1 write). The
    check is read-your-committed from the database itself: every surviving
    value must be one some client actually committed (values are tagged
    with client id + sequence, so torn/partial writes are detectable)."""

    name = "mako"

    def __init__(self, seed: int = 0, rows: int = 64, n_txns: int = 60,
                 n_clients: int = 4, reads_per_txn: int = 9,
                 writes_per_txn: int = 1):
        super().__init__(seed)
        self.rows = rows
        self.n_txns = n_txns
        self.n_clients = n_clients
        self.reads_per_txn = reads_per_txn
        self.writes_per_txn = writes_per_txn
        self._committed: dict[bytes, set[bytes]] = {}

    def _key(self, i: int) -> bytes:
        return b"mako%08d" % i

    async def setup(self, db) -> None:
        async def body(tr):
            for i in range(self.rows):
                k = self._key(i)
                tr.set(k, b"init")
                self._committed.setdefault(k, set()).add(b"init")

        await self._run_txn(db, body)

    async def run(self, db, cluster) -> None:
        rng = cluster.loop.rng
        counts = self._split(self.n_txns, self.n_clients)

        async def client(cid: int):
            for seq in range(counts[cid]):
                picks_r = [rng.randrange(self.rows)
                           for _ in range(self.reads_per_txn)]
                picks_w = [rng.randrange(self.rows)
                           for _ in range(self.writes_per_txn)]
                vals = {self._key(i): b"c%d.%d.%d" % (cid, seq, i)
                        for i in picks_w}

                async def body(tr, picks_r=picks_r, vals=vals):
                    for i in picks_r:
                        await tr.get(self._key(i))
                    for k, v in vals.items():
                        tr.set(k, v)

                await self._run_txn(db, body)
                for k, v in vals.items():
                    self._committed.setdefault(k, set()).add(v)
                self.metrics.ops += self.reads_per_txn + self.writes_per_txn

        await all_of([
            cluster.loop.spawn(client(i), name=f"mako.client{i}")
            for i in range(self.n_clients)
        ])

    async def check(self, db) -> None:
        async def body(tr):
            rows = await tr.get_range(self._key(0), self._key(self.rows))
            if len(rows) != self.rows:
                raise WorkloadFailed(
                    f"mako: {len(rows)} rows survive, expected {self.rows}"
                )
            for k, v in rows:
                if v not in self._committed.get(k, ()):
                    raise WorkloadFailed(
                        f"mako: {k!r} holds {v!r}, never committed"
                    )

        await self._run_txn(db, body)


class TPCCNewOrderWorkload(Workload):
    """Simplified TPC-C new-order mix (reference: mako's tpcc-flavored
    configs; the §5 baseline's 'TPC-C new-order, 1M txns/s sustained').

    Schema (tuple-layer keys): per (warehouse, district) a next_order_id
    counter; per item a stock level; orders + order lines inserted by each
    new-order transaction. Invariants checked from the database alone:

    - order ids are dense: next_order_id - 1 == #orders for the district
      (a lost or double-committed order breaks it);
    - stock conservation: initial_stock == stock + sum(order-line qty)
      - 100 * restocks (restocks ride an atomic ADD counter).
    """

    name = "tpcc_new_order"

    def __init__(self, seed: int = 0, warehouses: int = 2, districts: int = 2,
                 items: int = 20, n_txns: int = 40, n_clients: int = 4,
                 initial_stock: int = 100):
        super().__init__(seed)
        self.warehouses = warehouses
        self.districts = districts
        self.items = items
        self.n_txns = n_txns
        self.n_clients = n_clients
        self.initial_stock = initial_stock

    # -- keys (tuple layer) ---------------------------------------------------

    @staticmethod
    def _pack(*parts) -> bytes:
        from foundationdb_tpu_torch.layers.tuple_layer import pack

        return pack(parts)

    def k_district(self, w, d) -> bytes:
        return self._pack("tpcc", "district", w, d)

    def k_stock(self, i) -> bytes:
        return self._pack("tpcc", "stock", i)

    def k_order(self, w, d, oid) -> bytes:
        return self._pack("tpcc", "order", w, d, oid)

    def k_restocks(self) -> bytes:
        return self._pack("tpcc", "restocks")

    async def setup(self, db) -> None:
        async def body(tr):
            for w in range(self.warehouses):
                for d in range(self.districts):
                    tr.set(self.k_district(w, d), struct.pack("<q", 1))
            for i in range(self.items):
                tr.set(self.k_stock(i), struct.pack("<q", self.initial_stock))
            tr.set(self.k_restocks(), struct.pack("<q", 0))

        await self._run_txn(db, body)

    async def run(self, db, cluster) -> None:
        rng = cluster.loop.rng
        counts = self._split(self.n_txns, self.n_clients)

        async def new_order(cid: int):
            for _ in range(counts[cid]):
                w = rng.randrange(self.warehouses)
                d = rng.randrange(self.districts)
                n_lines = rng.randrange(3, 8)
                lines = [(rng.randrange(self.items), rng.randrange(1, 5))
                         for _ in range(n_lines)]

                async def body(tr, w=w, d=d, lines=lines):
                    (oid,) = struct.unpack("<q", await tr.get(self.k_district(w, d)))
                    tr.set(self.k_district(w, d), struct.pack("<q", oid + 1))
                    tr.set(
                        self.k_order(w, d, oid),
                        self._pack(*[x for ln in lines for x in ln]),
                    )
                    for item, qty in lines:
                        (stock,) = struct.unpack(
                            "<q", await tr.get(self.k_stock(item))
                        )
                        stock -= qty
                        if stock < 10:  # TPC-C's restock rule
                            stock += 100
                            tr.atomic_op(
                                MutationType.ADD, self.k_restocks(),
                                struct.pack("<q", 1),
                            )
                        tr.set(self.k_stock(item), struct.pack("<q", stock))

                await self._run_txn(db, body)
                self.metrics.ops += 1 + len(lines)

        await all_of([
            cluster.loop.spawn(new_order(i), name=f"tpcc.client{i}")
            for i in range(self.n_clients)
        ])

    async def check(self, db) -> None:
        from foundationdb_tpu_torch.layers.tuple_layer import unpack

        async def body(tr):
            total_lines_qty = 0
            n_orders = 0
            for w in range(self.warehouses):
                for d in range(self.districts):
                    (next_oid,) = struct.unpack(
                        "<q", await tr.get(self.k_district(w, d))
                    )
                    lo = self.k_order(w, d, 0)
                    hi = self.k_order(w, d, 1 << 60)
                    orders = await tr.get_range(lo, hi)
                    if len(orders) != next_oid - 1:
                        raise WorkloadFailed(
                            f"tpcc: district ({w},{d}) has {len(orders)} "
                            f"orders but next_oid={next_oid}"
                        )
                    n_orders += len(orders)
                    for _k, v in orders:
                        flat = unpack(v)
                        total_lines_qty += sum(flat[1::2])
            total_stock = 0
            for i in range(self.items):
                (s,) = struct.unpack("<q", await tr.get(self.k_stock(i)))
                total_stock += s
            (restocks,) = struct.unpack("<q", await tr.get(self.k_restocks()))
            expect = self.items * self.initial_stock
            got = total_stock + total_lines_qty - 100 * restocks
            if got != expect:
                raise WorkloadFailed(
                    f"tpcc: stock not conserved: {got} != {expect} "
                    f"(stock={total_stock} lines={total_lines_qty} "
                    f"restocks={restocks}, orders={n_orders})"
                )

        await self._run_txn(db, body)


class ConflictRangeWorkload(Workload):
    """Randomized range reads + writes through the real commit path; the
    observable check is bank-style conservation: txns move value between
    accounts under range-read guards, so the total is invariant IF conflict
    detection is sound (reference: ConflictRange.actor.cpp randomized sets;
    kernel-level verdict parity lives in tests/test_conflict_oracle.py)."""

    name = "conflict_range"

    TOTAL = 1000

    def __init__(self, seed: int = 0, n_accounts: int = 8, n_txns: int = 40,
                 n_clients: int = 4):
        super().__init__(seed)
        self.n_accounts = n_accounts
        self.n_txns = n_txns
        self.n_clients = n_clients

    def _key(self, i: int) -> bytes:
        return b"bank/%04d" % i

    async def setup(self, db) -> None:
        async def body(tr):
            each = self.TOTAL // self.n_accounts
            rem = self.TOTAL - each * self.n_accounts
            for i in range(self.n_accounts):
                tr.set(self._key(i), struct.pack("<q", each + (rem if i == 0 else 0)))

        await self._run_txn(db, body)

    async def run(self, db, cluster) -> None:
        rng = cluster.loop.rng

        counts = self._split(self.n_txns, self.n_clients)

        async def client(cid: int):
            for _ in range(counts[cid]):
                src = rng.randrange(self.n_accounts)
                dst = rng.randrange(self.n_accounts)
                amt = rng.randrange(1, 50)

                async def body(tr, src=src, dst=dst, amt=amt):
                    # Range read over the whole bank: a wide read conflict
                    # range, the thing the resolver must get right.
                    rows = await tr.get_range(b"bank/", b"bank0")
                    balances = {k: struct.unpack("<q", v)[0] for k, v in rows}
                    s, d = self._key(src), self._key(dst)
                    if balances.get(s, 0) < amt or src == dst:
                        return
                    tr.set(s, struct.pack("<q", balances[s] - amt))
                    tr.set(d, struct.pack("<q", balances[d] + amt))

                await self._run_txn(db, body)
                self.metrics.ops += 1

        await all_of(
            [
                cluster.loop.spawn(client(i), name=f"bank.client{i}")
                for i in range(self.n_clients)
            ]
        )

    async def check(self, db) -> None:
        async def body(tr):
            rows = await tr.get_range(b"bank/", b"bank0")
            total = sum(struct.unpack("<q", v)[0] for _k, v in rows)
            if total != self.TOTAL:
                raise WorkloadFailed(
                    f"bank conservation broken: total {total} != {self.TOTAL}"
                )
            negative = [k for k, v in rows if struct.unpack("<q", v)[0] < 0]
            if negative:
                raise WorkloadFailed(f"bank: negative balances {negative}")

        await self._run_txn(db, body)


class FaultInjector:
    """Seeded chaos actor (reference: the machine-kill + clogging machinery
    of SimulatedCluster): kills random generation processes and injects
    transient partitions while a workload runs. All choices come from the
    loop RNG — a seed replays the exact fault schedule."""

    def __init__(self, cluster, kill_interval: float = 2.0,
                 partition_interval: float = 1.3, partition_length: float = 0.8,
                 max_kills: int = 2, include_controller: bool = False,
                 clog_interval: float = 0.0, clog_length: float = 0.8,
                 clog_factor: float = 100.0):
        self.cluster = cluster
        self.kill_interval = kill_interval
        self.partition_interval = partition_interval
        self.partition_length = partition_length
        self.max_kills = max_kills
        # With a coordinator quorum the controller itself is fair game: a
        # rival candidate must win election and recover (the hardest
        # failure mode of the reference — CC loss).
        self.include_controller = include_controller
        # Clogging (slow-but-alive links): 0 = off.
        self.clog_interval = clog_interval
        self.clog_length = clog_length
        self.clog_factor = clog_factor
        self.kills: list[str] = []
        self.partitions = 0
        self.clogs = 0
        self._stop = False

    def stop(self) -> None:
        self._stop = True

    def _storage_procs(self) -> list[str]:
        """Actual storage process names (see SimCluster.storage_procs —
        bare "storage{i}" would silently no-op on multi-region)."""
        return self.cluster.storage_procs()

    async def run(self) -> None:
        loop = self.cluster.loop
        rng = loop.rng
        loop.spawn(self._partitioner(), name="faults.partitioner")
        if self.clog_interval > 0:
            loop.spawn(self._clogger(), name="faults.clogger")
        while not self._stop and len(self.kills) < self.max_kills:
            await loop.sleep(self.kill_interval * (0.5 + rng.random()))
            if self._stop:
                return
            gen = self.cluster.controller.generation
            victims = sorted(gen.heartbeat_eps)
            if self.include_controller and self.cluster.cc_heartbeats:
                victims.append(self.cluster.controller.identity)
            victim = victims[rng.randrange(len(victims))]
            if not self._safe_to_kill(gen, victim):
                continue  # would destroy the last durable log copy
            self.kills.append(victim)
            self.cluster.net.kill(victim)

    def _safe_to_kill(self, gen, victim: str) -> bool:
        """Never kill the LAST reachable tlog of the generation: with every
        log copy gone the durable suffix is unknowable and recovery stalls
        forever (the reference's kill machinery keeps a replica alive the
        same way — kills are permanent here, nothing reboots). Likewise a
        controller kill needs a surviving candidate to take over."""
        dead = self.cluster.loop.dead_processes
        if victim in getattr(self.cluster, "cc_heartbeats", {}):
            others = [
                p for p in self.cluster.cc_heartbeats
                if p != victim and p not in dead
            ]
            return bool(others)
        tlog_procs = [ep.process for ep in gen.tlog_eps]
        if victim not in tlog_procs:
            return True
        alive = [p for p in tlog_procs if p not in dead]
        return len(alive) > 1 or victim not in alive

    async def _partitioner(self) -> None:
        loop = self.cluster.loop
        rng = loop.rng
        while not self._stop:
            await loop.sleep(self.partition_interval * (0.5 + rng.random()))
            if self._stop:
                return
            gen = self.cluster.controller.generation
            procs = sorted(gen.heartbeat_eps) + self._storage_procs()
            a = procs[rng.randrange(len(procs))]
            b = procs[rng.randrange(len(procs))]
            if a == b:
                continue
            self.cluster.net.partition(a, b)
            self.partitions += 1
            await loop.sleep(self.partition_length)
            self.cluster.net.heal(a, b)

    async def _clogger(self) -> None:
        """Slow-but-alive links: RPCs between a random pair take ~clog_factor
        longer for clog_length — no failure detector fires, every timeout
        and ordering assumption in between is on trial (reference: sim2's
        clogging, the bug-richest fault mode)."""
        loop = self.cluster.loop
        rng = loop.rng
        while not self._stop:
            await loop.sleep(self.clog_interval * (0.5 + rng.random()))
            if self._stop:
                return
            gen = self.cluster.controller.generation
            procs = sorted(gen.heartbeat_eps) + self._storage_procs() + ["<main>"]  # client-side links clog too
            a = procs[rng.randrange(len(procs))]
            b = procs[rng.randrange(len(procs))]
            if a == b:
                continue
            self.cluster.net.clog(
                a, b, factor=self.clog_factor,
                duration=self.clog_length * (0.5 + rng.random()),
            )
            self.clogs += 1


async def run_workload(cluster, db, workload: Workload,
                       faults: FaultInjector | None = None) -> WorkloadMetrics:
    """setup → (run ∥ faults) → quiesce → check. Returns the metrics."""
    await workload.setup(db)
    fault_task = (
        cluster.loop.spawn(faults.run(), name="faults.run") if faults else None
    )
    await workload.run(db, cluster)
    if faults:
        faults.stop()
        await fault_task
        cluster.net.heal_all()
        # Quiesce: let any in-flight recovery finish before checking.
        while cluster.controller._recovering:
            await cluster.loop.sleep(0.25)
    await workload.check(db)
    return workload.metrics


class WatchesWorkload(Workload):
    """Watch semantics under concurrent mutation (reference:
    Watches.actor.cpp): watcher clients arm a watch on a key, mutator
    clients change it, and every armed watch must FIRE (spurious fires are
    legal; a hung watch is the bug). After each fire the watcher re-reads
    and re-arms. Checks: every round completed, and the final value equals
    the mutators' last write."""

    name = "watches"

    def __init__(self, seed: int = 0, n_keys: int = 4, n_rounds: int = 12):
        super().__init__(seed)
        self.n_keys = n_keys
        self.n_rounds = n_rounds

    def _key(self, i: int) -> bytes:
        return b"watch/%04d" % i

    async def setup(self, db) -> None:
        async def body(tr):
            for i in range(self.n_keys):
                tr.set(self._key(i), b"init")

        await self._run_txn(db, body)

    async def run(self, db, cluster) -> None:
        fired = [0] * self.n_keys
        done = [False] * self.n_keys

        MAX_REARMS = 200  # bounded: a wedged cluster must FAIL, not hang

        async def watcher(i: int):
            try:
                for _ in range(self.n_rounds):
                    for attempt in range(MAX_REARMS):
                        try:
                            async def arm(tr):
                                return await tr.watch(self._key(i))

                            slot = await self._run_txn(db, arm)
                            await slot
                            break
                        except FdbError as e:
                            if not e.retryable:
                                raise
                            await cluster.loop.sleep(0.05)  # re-arm
                    else:
                        raise WorkloadFailed(
                            f"watch {i}: {MAX_REARMS} re-arms exhausted"
                        )
                    fired[i] += 1
                    self.metrics.ops += 1
            finally:
                done[i] = True  # success OR failure: release the mutator

        async def mutator(i: int):
            # Keep mutating until the watcher is satisfied: a watch armed
            # just after our final write would otherwise hang forever.
            r = 0
            while not done[i]:
                async def body(tr, r=r):
                    tr.set(self._key(i), b"round/%05d" % r)

                await self._run_txn(db, body)
                r += 1
                await cluster.loop.sleep(0.02)

        await all_of(
            [cluster.loop.spawn(watcher(i), name=f"watch.w{i}")
             for i in range(self.n_keys)]
            + [cluster.loop.spawn(mutator(i), name=f"watch.m{i}")
               for i in range(self.n_keys)]
        )
        self.metrics.extra["fired"] = list(fired)
        if any(f < self.n_rounds for f in fired):
            raise WorkloadFailed(f"watches hung: fired={fired}")

    async def check(self, db) -> None:
        async def body(tr):
            for i in range(self.n_keys):
                v = await tr.get(self._key(i))
                if v is None or not v.startswith(b"round/"):
                    raise WorkloadFailed(f"watch key {i} lost: {v!r}")

        await self._run_txn(db, body)


class VersionStampWorkload(Workload):
    """Versionstamped-key ordering (reference: VersionStamp.actor.cpp):
    every txn appends via SET_VERSIONSTAMPED_KEY and records the stamp
    get_versionstamp() reports. Check: the database holds exactly the
    committed rows, under exactly the reported keys, and their key order
    equals commit order (stamps are monotone in commit version)."""

    name = "versionstamp"

    def __init__(self, seed: int = 0, n_txns: int = 40, n_clients: int = 4):
        super().__init__(seed)
        self.n_txns = n_txns
        self.n_clients = n_clients
        self._committed: list[tuple[bytes, bytes]] = []  # (stamp, payload)
        # Payloads whose txn saw CommitUnknownResult on some attempt: a
        # versionstamped append is inherently non-idempotent (each attempt
        # writes a DIFFERENT key), so a landed-but-unacked attempt plus
        # its retry legitimately leaves two rows (campaign find, seed
        # 5056; the reference's VersionStamp workload tolerates unknown
        # results the same way). Any OTHER duplicate is real corruption.
        self._maybe_dup: set[bytes] = set()

    async def run(self, db, cluster) -> None:
        from foundationdb_tpu_torch.core.errors import CommitUnknownResult

        counts = self._split(self.n_txns, self.n_clients)

        async def client(cid: int):
            for j in range(counts[cid]):
                payload = b"c%02d-%04d" % (cid, j)
                # Own retry loop instead of _run_txn: the workload must
                # OBSERVE unknown results to know which payloads may
                # duplicate; db.run hides them.
                tr = db.transaction()
                for attempt in range(100):
                    try:
                        key = b"vs/" + b"\x00" * 10 + struct.pack("<I", 3)
                        tr.atomic_op(
                            MutationType.SET_VERSIONSTAMPED_KEY, key, payload
                        )
                        await tr.commit()
                        break
                    except FdbError as e:
                        if isinstance(e, CommitUnknownResult):
                            self._maybe_dup.add(payload)
                        self.metrics.txns_retried += 1
                        await tr.on_error(e)  # raises if not retryable
                else:
                    raise FdbError("retry limit reached", code=1021)
                self.metrics.txns_committed += 1
                self._committed.append((tr.get_versionstamp(), payload))
                self.metrics.ops += 1

        await all_of(
            [cluster.loop.spawn(client(i), name=f"vs.client{i}")
             for i in range(self.n_clients)]
        )

    async def check(self, db) -> None:
        async def body(tr):
            return await tr.get_range(b"vs/", b"vs0", limit=100_000)

        rows = await self._run_txn(db, body)
        recorded = {
            b"vs/" + stamp: payload for stamp, payload in self._committed
        }
        rows_by_key = dict(rows)
        if len(rows_by_key) != len(rows):
            raise WorkloadFailed("duplicate versionstamp keys in range")
        missing = [k for k, p in recorded.items() if rows_by_key.get(k) != p]
        if missing:
            raise WorkloadFailed(
                f"versionstamp rows lost: {missing[:3]!r} "
                f"({len(rows)} rows vs {len(recorded)} committed)"
            )
        for key, payload in rows:
            if key in recorded:
                continue
            if payload not in self._maybe_dup:
                raise WorkloadFailed(
                    f"unexplained versionstamp row {key!r}={payload!r}: "
                    "not the recorded stamp and its txn never saw "
                    "commit_unknown_result"
                )
        # Stamps must be strictly monotone in commit order per client chain.
        by_payload = {p: s for s, p in self._committed}
        for cid in range(self.n_clients):
            chain = [s for p, s in sorted(by_payload.items())
                     if p.startswith(b"c%02d-" % cid)]
            if chain != sorted(chain) or len(set(chain)) != len(chain):
                raise WorkloadFailed("stamps not monotone within a client")


class ChangeFeedWorkload(Workload):
    """Change-feed correctness (reference: the change-feed variants of
    fdbserver/workloads/): register a feed over the workload's range,
    run concurrent writes, then REPLAY the feed in version order into a
    model and require the model to equal the database's final state —
    every committed mutation must appear exactly once, ordered."""

    name = "changefeed"

    def __init__(self, seed: int = 0, n_keys: int = 8, n_txns: int = 40,
                 n_clients: int = 4):
        super().__init__(seed)
        self.n_keys = n_keys
        self.n_txns = n_txns
        self.n_clients = n_clients

    def _key(self, i: int) -> bytes:
        return b"cf/%04d" % i

    async def setup(self, db) -> None:
        # Register on every storage server: each captures its shard's
        # slice of the range (clears are clipped server-side).
        for i, ss in enumerate(db.cluster.storages):
            ss.register_change_feed(b"wl-feed", b"cf/", b"cf0")

    async def run(self, db, cluster) -> None:
        rng = cluster.loop.rng
        counts = self._split(self.n_txns, self.n_clients)

        async def client(cid: int):
            for j in range(counts[cid]):
                op = rng.random()
                k = self._key(rng.randrange(self.n_keys))

                async def body(tr, op=op, k=k, cid=cid, j=j):
                    if op < 0.6:
                        tr.set(k, b"v%02d-%04d" % (cid, j))
                    elif op < 0.8:
                        tr.atomic_op(
                            MutationType.ADD, k, struct.pack("<q", 1)
                        )
                    else:
                        tr.clear(k)

                await self._run_txn(db, body)
                self.metrics.ops += 1

        await all_of(
            [cluster.loop.spawn(client(i), name=f"cf.client{i}")
             for i in range(self.n_clients)]
        )

    async def check(self, db) -> None:
        from foundationdb_tpu_torch.core.mutations import Mutation

        # Deterministic quiesce (campaign-found at seed 1052: a fixed
        # 0.5s drain lost the race against clogged/buggified pull loops
        # — the feed was read BEFORE the final mutation applied, while
        # the later range read waited for it): take a read version and
        # wait until EVERY storage has applied through it; every commit
        # is then both readable and feed-captured.
        async def rv_body(tr):
            return await tr.get_read_version()

        rv = await self._run_txn(db, rv_body)
        for ss in db.cluster.storages:
            while ss._version < rv:
                await db.cluster.loop.sleep(0.05)
        entries: list[tuple[int, Mutation]] = []
        for ss in db.cluster.storages:
            entries.extend(ss.read_change_feed(b"wl-feed", 0))
        entries.sort(key=lambda e: e[0])
        model: dict[bytes, bytes] = {}
        for _v, m in entries:
            if m.type == MutationType.SET_VALUE:
                model[m.param1] = m.param2
            elif m.type == MutationType.CLEAR_RANGE:
                for k in [k for k in model if m.param1 <= k < m.param2]:
                    del model[k]
            else:
                raise WorkloadFailed(f"feed leaked raw atomic op: {m!r}")

        async def body(tr):
            return await tr.get_range(b"cf/", b"cf0", limit=100_000)

        rows = dict(await self._run_txn(db, body))
        if model != rows:
            raise WorkloadFailed(
                f"feed replay diverged: model {len(model)} keys vs "
                f"db {len(rows)} keys"
            )


class IncrementWorkload(Workload):
    """Atomic-increment conservation (reference: Increment.actor.cpp):
    clients ADD 1 to random counters; quiesced, the counters must sum to
    the committed-op count — except that an applied-but-unknown commit
    retried by the loop legitimately double-applies (as in the
    reference, which tracks min/max expected): the sum must land in
    [ops, ops + 2*retried_txns]. Clean runs have zero retries, making
    the bound exact; lost or torn atomic ops still fail it from below."""

    name = "increment"

    def __init__(self, seed: int = 0, n_counters: int = 8, n_txns: int = 40,
                 n_clients: int = 4):
        super().__init__(seed)
        self.n_counters = n_counters
        self.n_txns = n_txns
        self.n_clients = n_clients

    def _key(self, i: int) -> bytes:
        return b"incr/%04d" % i

    async def setup(self, db) -> None:
        async def body(tr):
            tr.clear_range(b"incr/", b"incr0")  # own the prefix

        await self._run_txn(db, body)

    async def run(self, db, cluster) -> None:
        rng = cluster.loop.rng
        counts = self._split(self.n_txns, self.n_clients)

        async def client(cid: int):
            for _ in range(counts[cid]):
                i = rng.randrange(self.n_counters)
                j = rng.randrange(self.n_counters)

                async def body(tr, i=i, j=j):
                    one = struct.pack("<q", 1)
                    tr.atomic_op(MutationType.ADD, self._key(i), one)
                    tr.atomic_op(MutationType.ADD, self._key(j), one)

                await self._run_txn(db, body)
                self.metrics.ops += 2

        await all_of(
            [cluster.loop.spawn(client(i), name=f"incr.client{i}")
             for i in range(self.n_clients)]
        )

    async def check(self, db) -> None:
        async def body(tr):
            total = 0
            for i in range(self.n_counters):
                v = await tr.get(self._key(i))
                total += struct.unpack("<q", v)[0] if v is not None else 0
            return total

        # Snapshot BEFORE the read-only check txn runs: only run-phase
        # ADD transactions can double-apply, so their retries alone set
        # the tolerance (a retried check read must not widen it).
        run_retries = self.metrics.txns_retried
        total = await self._run_txn(db, body)
        slack = 2 * run_retries  # 2 ADDs per txn attempt
        if not self.metrics.ops <= total <= self.metrics.ops + slack:
            raise WorkloadFailed(
                f"increment sum {total} outside [{self.metrics.ops}, "
                f"{self.metrics.ops + slack}] (run retried {run_retries})"
            )


class SelectorCorrectnessWorkload(Workload):
    """Key-selector + limited/reverse range reads vs a sorted in-memory
    model (reference: SelectorCorrectness.actor.cpp): populate a known key
    set, then fire random firstGreaterOrEqual/lastLessThan selectors with
    random offsets and random limited scans; every answer must equal the
    model's."""

    name = "selectors"

    def __init__(self, seed: int = 0, n_keys: int = 24, n_queries: int = 60,
                 n_clients: int = 3):
        super().__init__(seed)
        self.n_keys = n_keys
        self.n_queries = n_queries
        self.n_clients = n_clients
        self.keys: list[bytes] = []

    async def setup(self, db) -> None:
        self.keys = [b"sel/%04d" % (3 * i) for i in range(self.n_keys)]

        async def body(tr):
            # Own the prefix: a previous test in the same spec file may
            # have left keys here (tests share the cluster, as in the
            # reference's multi-test TOML runs).
            tr.clear_range(b"sel/", b"sel0")
            for k in self.keys:
                tr.set(k, b"v" + k[-4:])

        await self._run_txn(db, body)

    def _model_resolve(self, anchor: bytes, or_equal: bool, offset: int) -> bytes:
        """The reference selector semantics over the sorted model."""
        import bisect

        from foundationdb_tpu_torch.runtime.shardmap import MAX_KEY

        ks = self.keys
        if offset >= 1:
            start = anchor + b"\x00" if or_equal else anchor
            i = bisect.bisect_left(ks, start) + (offset - 1)
            return ks[i] if i < len(ks) else MAX_KEY
        back = 1 - offset
        end = anchor + b"\x00" if or_equal else anchor
        i = bisect.bisect_left(ks, end) - back
        return ks[i] if i >= 0 else b""

    async def run(self, db, cluster) -> None:
        from foundationdb_tpu_torch.client.transaction import KeySelector

        rng = cluster.loop.rng
        counts = self._split(self.n_queries, self.n_clients)

        async def client(cid: int):
            for _ in range(counts[cid]):
                anchor = b"sel/%04d" % rng.randrange(3 * self.n_keys + 2)
                or_equal = rng.random() < 0.5
                offset = rng.randrange(-3, 4)
                kind = rng.random()

                async def body(tr, anchor=anchor, or_equal=or_equal,
                               offset=offset, kind=kind):
                    if kind < 0.5:
                        from foundationdb_tpu_torch.runtime.shardmap import MAX_KEY

                        got = await tr.get_key(
                            KeySelector(anchor, or_equal, offset)
                        )
                        want = self._model_resolve(anchor, or_equal, offset)
                        # A resolution escaping our prefix lands on some
                        # OTHER workload's key (the db resolves selectors
                        # over the whole keyspace); the model only knows
                        # the direction then.
                        ok = (
                            got == want
                            or (want == b"" and got < b"sel/")
                            or (want == MAX_KEY and got >= b"sel0")
                        )
                        if not ok:
                            raise WorkloadFailed(
                                f"selector({anchor!r},{or_equal},{offset}) "
                                f"= {got!r}, model says {want!r}"
                            )
                    else:
                        limit = 1 + int(kind * 10)
                        reverse = kind > 0.8
                        rows = await tr.get_range(
                            b"sel/", anchor, limit=limit, reverse=reverse
                        )
                        model = [k for k in self.keys if k < anchor]
                        if reverse:
                            model.reverse()
                        model = model[:limit]
                        if [k for k, _ in rows] != model:
                            raise WorkloadFailed(
                                f"range(sel/..{anchor!r} lim={limit} "
                                f"rev={reverse}) mismatch"
                            )

                await self._run_txn(db, body)
                self.metrics.ops += 1

        await all_of(
            [cluster.loop.spawn(client(i), name=f"sel.client{i}")
             for i in range(self.n_clients)]
        )


class BackupRestoreWorkload(_Unported):
    """Backup under live writes, restore elsewhere, compare keyspaces
    (reference: BackupToDBCorrectness.actor.cpp): a continuous backup and
    a rolling snapshot run WHILE writer clients mutate; after stop, the
    container restores into a fresh cluster on the same sim loop and the
    two keyspaces must match exactly at the restorable version.

    Not ported: constructing it raises ``NotImplementedError``.
    """

    name = "backup_restore"
    needs = "runtime/backup.py (BackupAgent, restore)"


class WriteDuringReadWorkload(Workload):
    """RYW semantics fuzz (reference: WriteDuringRead.actor.cpp): inside
    one transaction, interleave random sets / clears / clear_ranges /
    atomic ops with random gets and range reads; every read must see the
    transaction's own uncommitted mutations applied over the database
    snapshot. On commit the model becomes the expected database state."""

    name = "write_during_read"

    def __init__(self, seed: int = 0, n_keys: int = 24, n_txns: int = 20,
                 ops_per_txn: int = 12):
        super().__init__(seed)
        self.n_keys = n_keys
        self.n_txns = n_txns
        self.ops_per_txn = ops_per_txn
        self.model: dict[bytes, bytes] = {}  # committed state

    def _key(self, rng) -> bytes:
        return b"wdr/%03d" % rng.randrange(self.n_keys)

    async def setup(self, db) -> None:
        async def body(tr):
            tr.clear_range(b"wdr/", b"wdr0")

        await self._run_txn(db, body)

    async def run(self, db, cluster) -> None:
        rng = cluster.loop.rng
        for _ in range(self.n_txns):
            plan = []  # decided OUTSIDE the retry loop → deterministic replay
            for _o in range(self.ops_per_txn):
                r = rng.random()
                if r < 0.25:
                    plan.append(("set", self._key(rng),
                                 b"v%06d" % rng.randrange(1 << 20)))
                elif r < 0.35:
                    plan.append(("clear", self._key(rng), None))
                elif r < 0.45:
                    a, b = sorted((self._key(rng), self._key(rng)))
                    plan.append(("clear_range", a, b))
                elif r < 0.55:
                    plan.append(("add", self._key(rng),
                                 struct.pack("<q", rng.randrange(100))))
                elif r < 0.8:
                    plan.append(("get", self._key(rng), None))
                else:
                    a, b = sorted((self._key(rng), self._key(rng)))
                    plan.append(("get_range", a, b))

            async def body(tr, plan=plan):
                # Txn-visible model is rebuilt from a snapshot range read
                # each attempt, NOT carried across txns: an applied-but-
                # unknown commit (fault injection) double-applies ADDs on
                # retry, and a carried model would diverge from the
                # database while both are individually correct. Reading
                # the prefix keeps every in-txn RYW assertion exact.
                local = dict(await tr.get_range(b"wdr/", b"wdr0"))
                for op, a, b in plan:
                    if op == "set":
                        tr.set(a, b)
                        local[a] = b
                    elif op == "clear":
                        tr.clear(a)
                        local.pop(a, None)
                    elif op == "clear_range":
                        tr.clear_range(a, b)
                        for k in [k for k in local if a <= k < b]:
                            del local[k]
                    elif op == "add":
                        tr.atomic_op(MutationType.ADD, a, b)
                        base = (local.get(a, b"") + b"\x00" * 8)[:8]
                        total = (struct.unpack("<q", base)[0]
                                 + struct.unpack("<q", b)[0])
                        local[a] = struct.pack("<q", total)
                    elif op == "get":
                        got = await tr.get(a)
                        want = local.get(a)
                        if got != want:
                            raise WorkloadFailed(
                                f"RYW get({a!r}) = {got!r}, want {want!r}")
                    elif op == "get_range":
                        got = await tr.get_range(a, b)
                        want = sorted(
                            (k, v) for k, v in local.items() if a <= k < b)
                        if got != want:
                            raise WorkloadFailed(
                                f"RYW range [{a!r},{b!r}) = {got!r}, "
                                f"want {want!r}")
                return local

            self.model = await self._run_txn(db, body)
            self.metrics.ops += len(plan)

    async def check(self, db) -> None:
        async def body(tr):
            return await tr.get_range(b"wdr/", b"wdr0")

        rows = await self._run_txn(db, body)
        want = sorted(self.model.items())
        if rows != want:
            raise WorkloadFailed(
                f"final state {len(rows)} rows != model {len(want)} rows")


class FuzzApiWorkload(Workload):
    """Randomized API-surface fuzz vs a sequential model (reference:
    FuzzApiCorrectness.actor.cpp, narrowed to the implemented surface):
    single-client random transactions mixing mutations, snapshot and
    conflict reads, limited/reverse ranges, and key selectors; each txn's
    reads are checked against the model, and committed txns fold into it."""

    name = "fuzz_api"

    def __init__(self, seed: int = 0, n_keys: int = 40, n_txns: int = 30,
                 ops_per_txn: int = 8):
        super().__init__(seed)
        self.n_keys = n_keys
        self.n_txns = n_txns
        self.ops_per_txn = ops_per_txn
        self.model: dict[bytes, bytes] = {}

    def _key(self, rng) -> bytes:
        return b"fuzz/%03d" % rng.randrange(self.n_keys)

    async def setup(self, db) -> None:
        async def body(tr):
            tr.clear_range(b"fuzz/", b"fuzz0")

        await self._run_txn(db, body)

    async def run(self, db, cluster) -> None:
        from foundationdb_tpu_torch.client.transaction import KeySelector
        from foundationdb_tpu_torch.runtime.shardmap import MAX_KEY

        rng = cluster.loop.rng
        for _ in range(self.n_txns):
            plan = []
            for _o in range(self.ops_per_txn):
                r = rng.random()
                if r < 0.3:
                    plan.append(("set", self._key(rng),
                                 b"x%05d" % rng.randrange(99999)))
                elif r < 0.4:
                    plan.append(("clear", self._key(rng), None))
                elif r < 0.6:
                    plan.append(("get", self._key(rng),
                                 rng.random() < 0.5))  # snapshot?
                elif r < 0.8:
                    a, b = sorted((self._key(rng), self._key(rng)))
                    plan.append(("range", (a, b, rng.randrange(0, 6),
                                           rng.random() < 0.5), None))
                else:
                    plan.append(("get_key", self._key(rng),
                                 (rng.random() < 0.5, rng.randrange(-2, 3))))

            async def body(tr, plan=plan):
                # Snapshot-rebuilt per attempt (same hazard WriteDuringRead
                # documents: an applied-but-unknown commit retried by
                # db.run would diverge from a carried model).
                local = dict(await tr.get_range(b"fuzz/", b"fuzz0"))
                for op, a, b in plan:
                    if op == "set":
                        tr.set(a, b)
                        local[a] = b
                    elif op == "clear":
                        tr.clear(a)
                        local.pop(a, None)
                    elif op == "get":
                        got = await tr.get(a, snapshot=b)
                        if got != local.get(a):
                            raise WorkloadFailed(
                                f"fuzz get({a!r}) = {got!r}, "
                                f"want {local.get(a)!r}")
                    elif op == "range":
                        ra, rb, limit, reverse = a
                        got = await tr.get_range(ra, rb, limit=limit,
                                                 reverse=reverse)
                        rows = sorted(
                            (k, v) for k, v in local.items() if ra <= k < rb)
                        if reverse:
                            rows.reverse()
                        if limit > 0:
                            rows = rows[:limit]
                        if got != rows:
                            raise WorkloadFailed(
                                f"fuzz range {a} = {len(got)} rows, "
                                f"want {len(rows)}")
                    elif op == "get_key":
                        or_equal, offset = b
                        sel = KeySelector(a, or_equal, offset)
                        got = await tr.get_key(sel)
                        ks = sorted(local)
                        anchor = a + (b"\x00" if or_equal else b"")
                        if offset >= 1:
                            i = bisect.bisect_left(ks, anchor) + (offset - 1)
                            want = ks[i] if i < len(ks) else MAX_KEY
                        else:
                            i = bisect.bisect_left(ks, anchor) - (1 - offset)
                            want = ks[i] if i >= 0 else b""
                        # Clamp like the runtime: selectors resolving
                        # outside the fuzz prefix see OTHER tests' keys —
                        # only verify in-prefix answers.
                        in_prefix = (want.startswith(b"fuzz/")
                                     and got.startswith(b"fuzz/"))
                        if in_prefix and got != want:
                            raise WorkloadFailed(
                                f"fuzz get_key({a!r},{or_equal},{offset}) "
                                f"= {got!r}, want {want!r}")
                return local

            self.model = await self._run_txn(db, body)
            self.metrics.ops += len(plan)

    async def check(self, db) -> None:
        async def body(tr):
            return await tr.get_range(b"fuzz/", b"fuzz0")

        rows = await self._run_txn(db, body)
        if rows != sorted(self.model.items()):
            raise WorkloadFailed("fuzz final state diverged from model")


class DDBalanceWorkload(_Unported):
    """Reads and writes racing shard moves (reference: DDBalance.actor.cpp):
    clients hammer a key prefix while the DataDistributor is told to move
    the hot shard between storage teams; every committed write must stay
    readable throughout and afterwards. Requires data_distribution=True.

    Not ported: constructing it raises ``NotImplementedError``.
    """

    name = "dd_balance"
    needs = "runtime/data_distribution.py (DataDistributor)"


class TenantWorkload(_Unported):
    """Tenant lifecycle + isolation under concurrency (reference:
    TenantManagementWorkload.actor.cpp, narrowed): clients create/use/
    delete random tenants; every tenant's data must stay isolated and
    the final tenant list must match the model.

    Not ported: constructing it raises ``NotImplementedError``.
    """

    name = "tenants"
    needs = "client/tenant.py (Tenant, create_tenant, list_tenants)"


class IndexStressWorkload(Workload):
    """Transactional secondary index (reference: Storefront/IndexStress
    shapes): every txn writes item `data/<k> = v` AND maintains the
    index entry `idx/<v>/<k>` (clearing the previous index entry) in ONE
    transaction. Quiesced, the index and the data must be exact mirrors:
    a dangling or missing index entry means a torn multi-key txn."""

    name = "index_stress"

    def __init__(self, seed: int = 0, n_items: int = 10, n_txns: int = 30,
                 n_clients: int = 3):
        super().__init__(seed)
        self.n_items = n_items
        self.n_txns = n_txns
        self.n_clients = n_clients

    async def setup(self, db) -> None:
        async def body(tr):
            tr.clear_range(b"data/", b"data0")
            tr.clear_range(b"idx/", b"idx0")

        await self._run_txn(db, body)

    async def run(self, db, cluster) -> None:
        rng = cluster.loop.rng
        counts = self._split(self.n_txns, self.n_clients)

        async def client(cid: int):
            for _ in range(counts[cid]):
                k = b"%03d" % rng.randrange(self.n_items)
                v = b"v%05d" % rng.randrange(99999)

                async def body(tr, k=k, v=v):
                    old = await tr.get(b"data/" + k)
                    if old is not None:
                        tr.clear(b"idx/" + old + b"/" + k)
                    tr.set(b"data/" + k, v)
                    tr.set(b"idx/" + v + b"/" + k, b"")

                await self._run_txn(db, body)
                self.metrics.ops += 1

        await all_of(
            [cluster.loop.spawn(client(i), name=f"idx.client{i}")
             for i in range(self.n_clients)]
        )

    async def check(self, db) -> None:
        async def dump(tr):
            data = await tr.get_range(b"data/", b"data0")
            idx = await tr.get_range(b"idx/", b"idx0")
            return data, idx

        data, idx = await self._run_txn(db, dump)
        want_idx = sorted(
            b"idx/" + v + b"/" + k[len(b"data/"):] for k, v in data
        )
        got_idx = sorted(k for k, _ in idx)
        if got_idx != want_idx:
            dangling = set(got_idx) - set(want_idx)
            missing = set(want_idx) - set(got_idx)
            raise WorkloadFailed(
                f"index diverged: {len(dangling)} dangling, "
                f"{len(missing)} missing"
            )


class RegionFailoverWorkload(Workload):
    """Multi-region failover under live writes (reference: the
    multi-region correctness the reference covers with region-config
    simulation tests + ClusterController dc failover): clients write a
    monotone journal; mid-run the ENTIRE primary region is failed; the
    chain must re-form in the remote region from the satellite tlogs.
    Check: every ACKED write reads back (zero acked-commit loss), the
    active region flipped, and writes continued post-failover. Requires
    a cluster built with multi_region."""

    name = "region_failover"

    def __init__(self, seed: int = 0, n_txns: int = 40, n_clients: int = 2,
                 fail_after: int = 10, heal: bool = False,
                 mode: str = "fail"):
        super().__init__(seed)
        self.n_txns = n_txns
        self.n_clients = n_clients
        self.fail_after = fail_after  # acked txns before the region dies
        self.heal = heal  # heal the failed region mid-run (failback test)
        # "fail" = blackout (processes die); "partition" = the HARD mode:
        # the region stays alive-but-severed, its chain running on as a
        # zombie generation — what the known-committed/epoch fences and
        # GRV epoch confirmation exist for (see
        # tests/test_multi_region.py::test_region_partition_fences_zombie_generation).
        assert mode in ("fail", "partition"), mode
        self.mode = mode
        self._acked: list[bytes] = []
        self._failed_region = None
        self._token: str | None = None  # minted lazily on authz clusters

    def _key(self, cid: int, i: int) -> bytes:
        return b"rf/%02d/%04d" % (cid, i)

    def _tokenize(self, db, tr) -> None:
        """On an authz-armed cluster this workload plays a tenant scoped
        to its own rf/ prefix (untokened writes would be denied) — the
        AuthzAcrossRegionFailover spec composes it with the Authz
        workload's isolation probes."""
        if self._token is None:
            cluster = getattr(db, "cluster", None)
            priv = getattr(cluster, "authz_private_pem", None)
            if priv is None:
                return
            raise NotImplementedError(
                "RegionFailoverWorkload on an authz cluster needs "
                "runtime/authz.py (mint_token), which is not ported yet")
        tr.set_option("authorization_token", self._token)

    async def setup(self, db) -> None:
        async def body(tr):
            self._tokenize(db, tr)
            tr.clear_range(b"rf/", b"rf0")

        await self._run_txn(db, body)

    async def run(self, db, cluster) -> None:
        assert cluster.multi_region, "RegionFailover needs multi_region"
        counts = self._split(self.n_txns, self.n_clients)
        total_acked = [0]

        async def client(cid: int):
            for i in range(counts[cid]):
                key = self._key(cid, i)

                async def body(tr, key=key):
                    self._tokenize(db, tr)
                    tr.set(key, b"v")

                await self._run_txn(db, body)
                self._acked.append(key)
                self.metrics.ops += 1
                total_acked[0] += 1

        async def regicide():
            while total_acked[0] < self.fail_after:
                await cluster.loop.sleep(0.05)
            self._failed_region = cluster.active_region
            if self.mode == "partition":
                cluster.net.partition_region(self._failed_region + "/")
                if self.heal:
                    await cluster.loop.sleep(5.0)
                    # Partition heal: nothing died — the severed links
                    # return and the fenced replicas catch up in place.
                    cluster.net.heal_region_partition(
                        self._failed_region + "/")
            else:
                cluster.net.fail_region(self._failed_region + "/")
                if self.heal:
                    await cluster.loop.sleep(5.0)
                    cluster.heal_region(self._failed_region)

        await all_of(
            [cluster.loop.spawn(client(i), name=f"rf.client{i}")
             for i in range(self.n_clients)]
            + [cluster.loop.spawn(regicide(), name="rf.regicide")]
        )
        self._cluster = cluster

    async def check(self, db) -> None:
        c = self._cluster
        assert self._failed_region is not None, "region never failed"
        assert c.active_region != self._failed_region or self.heal, (
            "active region never flipped")

        async def body(tr):
            self._tokenize(db, tr)
            return await tr.get_range(b"rf/", b"rf0")

        rows = dict(await self._run_txn(db, body))
        missing = [k for k in self._acked if k not in rows]
        assert not missing, (
            f"{len(missing)} ACKED writes lost in region failover: "
            f"{missing[:5]}")


class AuthzWorkload(_Unported):
    """Tenant authorization under faults (reference: the authz simulation
    coverage around TokenSign/TenantAuthorizer): on an authz-enabled
    cluster, clients carrying tenant-bound tokens write and read their
    own tenant through kills/recoveries, while out-of-scope and
    dead-tenant operations are ALWAYS denied — across every generation.
    Requires [test.cluster] authz = true.

    Not ported: constructing it raises ``NotImplementedError``.
    """

    name = "authz"
    needs = "runtime/authz.py (mint_token) and client/tenant.py"


class ZipfRepairWorkload(_Unported):
    """Zipf-0.99 hot-key read-modify-write contention — the goodput
    workload of the transaction-repair subsystem (repair/engine.py).

    Every transaction reads `reads_per_txn` keys drawn from a bounded
    Zipf(theta) distribution and rewrites the hottest pick to
    read-value + 1 — a true read-modify-write, NOT an atomic ADD, so any
    unsound repair (a stale cached read surviving into a commit) loses an
    increment and breaks the invariant. With ``repair=True`` transactions
    run through ``run_repairable`` (partial re-execution at the failed
    batch's snapshot + hot-range backoff); with ``repair=False`` they take
    the canonical full-restart loop (Database.run) — same stream, so the
    goodput ratio is the repair subsystem's measured win.

    Checks (the oracle-verified serializability side of the bench):
    - sum(keys) == committed increment count (lost/duplicated update ⇔
      broken), on a cluster whose resolver is the brute-force oracle;
    - with repair on, the repair loop converged within its attempt bound
      for every commit (run_repairable raises otherwise).

    Not ported: constructing it raises ``NotImplementedError``.
    """

    name = "zipf_repair"
    needs = "repair/engine.py (run_repairable, RepairStats)"


class ConsistencyCheckWorkload(_Unported):
    """The consistency subsystem as a sim workload (reference:
    fdbserver/workloads/ConsistencyCheck.actor.cpp): run() commits a
    randomized write load like any client; check() walks the quiesced
    cluster's shard map and byte-compares every replica of every team
    through each member's own serve path (foundationdb_tpu/consistency/).
    Any divergence — torn replica, missed tag stream, bad shard move —
    fails the test with the exact shard and first divergent key.

    Not ported: constructing it raises ``NotImplementedError``.
    """

    name = "consistency_check"
    needs = "consistency/checker.py (ConsistencyChecker)"


class FailoverZipfRepairWorkload(_Unported):
    """Zipf hot-key RMW contention through the repair engine, surviving a
    DR failover mid-run — the campaign composition "DR failover
    mid-repair" (nemesis.DRSwitchover + repair/engine.py).

    Differences from ZipfRepairWorkload, both load-bearing for the
    exactly-once gate:

    - every transaction carries a unique idempotency marker read in the
      same transaction as its increment, so a commit_unknown_result retry
      (or a post-failover retry of a txn that LANDED on the primary and
      drained to the secondary) can never double-apply: sum(keys) ==
      acked commits EXACTLY, under any fault schedule;
    - clients fail over: when the switchover locks the primary
      (DatabaseLocked is definitive, not retryable) they park until the
      nemesis raises ctx.flags['failover'], then resume on the secondary
      — the repaired transaction replays there against the drained
      stream, and the marker decides landed-vs-lost exactly.

    check() audits the SURVIVING side.

    Not ported: constructing it raises ``NotImplementedError``.
    """

    name = "failover_zipf_repair"
    needs = "repair/engine.py (run_repairable, RepairStats)"


class TaskBucketWorkload(_Unported):
    """TaskBucket work-queue drain under faults (layers/taskbucket.py):
    setup enqueues ``n_tasks`` tasks; ``n_executors`` concurrent executors
    claim → execute → finish with short leases, so a claim that stalls
    across a recovery expires and another executor legally re-runs the
    task (the bucket's idempotency contract). The work transaction is an
    idempotent marker + counter ADD, making the final accounting exact:

    - counter == n_tasks (every task executed EXACTLY once in effect —
      a lease double-run is absorbed by the marker, a lost task breaks it
      from below, a double-apply from above);
    - the bucket fully drains (no task stranded in avail/ or leased/).

    On an authz-armed cluster the bucket carries the cluster system token.

    Not ported: constructing it raises ``NotImplementedError``.
    """

    name = "taskbucket"
    needs = "layers/taskbucket.py (TaskBucket)"


class YCSBWorkload(Workload):
    """YCSB core workloads B (95/5 read/update) and C (read-only) on a
    preloaded Zipf-skewed row set, driving the BATCHED read plane: each
    read op is one multi-key `tr.get_multi` (a single get_multi RPC per
    storage team), and a fraction are short range scans. Updates mutate
    EXISTING rows only — no inserts — so the storage read mirror's key
    set stays stable (value updates don't force a repack; see
    foundationdb_tpu/reads/). Checks: get_multi parity against
    sequential per-key gets on the final state, plus read-your-committed
    for every acked update."""

    name = "ycsb"

    def __init__(self, seed: int = 0, variant: str = "B", n_keys: int = 64,
                 n_txns: int = 40, n_clients: int = 4, batch: int = 8,
                 scan_fraction: float = 0.2):
        super().__init__(seed)
        if variant not in ("B", "C"):
            raise ValueError(f"YCSB variant {variant!r}: only B/C modeled")
        self.variant = variant
        self.n_keys = n_keys
        self.n_txns = n_txns
        self.n_clients = n_clients
        self.batch = batch
        self.scan_fraction = scan_fraction
        self.update_fraction = 0.05 if variant == "B" else 0.0
        self._acked: dict[bytes, bytes] = {}

    def _key(self, i: int) -> bytes:
        return b"ycsb/%06d" % i

    def _pick(self, rng) -> int:
        # Zipf-ish hot set, same shape as RandomReadWriteWorkload.
        return min(int(rng.paretovariate(1.5)) - 1, self.n_keys - 1)

    async def setup(self, db) -> None:
        async def body(tr):
            for i in range(self.n_keys):
                tr.set(self._key(i), b"init%06d" % i)

        await self._run_txn(db, body)

    async def run(self, db, cluster) -> None:
        rng = cluster.loop.rng
        counter = [0]
        counts = self._split(self.n_txns, self.n_clients)

        async def client(cid: int):
            for _ in range(counts[cid]):
                roll = rng.random()
                if roll < self.update_fraction:
                    k = self._key(self._pick(rng))
                    counter[0] += 1
                    val = b"u%08d" % counter[0]

                    async def body(tr, k=k, val=val):
                        await tr.get(k)
                        tr.set(k, val)

                    await self._run_txn(db, body)
                    self._acked[k] = val
                elif roll < self.update_fraction + self.scan_fraction:
                    lo = self._pick(rng)
                    span = 1 + rng.randrange(8)

                    async def body(tr, lo=lo, span=span):
                        return await tr.get_range(
                            self._key(lo), self._key(lo + span), limit=span)

                    await self._run_txn(db, body)
                else:
                    picks = sorted({self._pick(rng)
                                    for _ in range(self.batch)})

                    async def body(tr, picks=picks):
                        rows = await tr.get_multi(
                            [self._key(i) for i in picks])
                        if any(r is None for r in rows):
                            raise WorkloadFailed("ycsb: preloaded row gone")
                        return rows

                    await self._run_txn(db, body)
                self.metrics.ops += 1

        await all_of([
            cluster.loop.spawn(client(i), name=f"ycsb.client{i}")
            for i in range(self.n_clients)
        ])

    async def check(self, db) -> None:
        async def body(tr):
            keys = [self._key(i) for i in range(self.n_keys)]
            batched = await tr.get_multi(keys, snapshot=True)
            for k, got in zip(keys, batched):
                single = await tr.get(k, snapshot=True)
                if got != single:
                    raise WorkloadFailed(
                        f"ycsb: get_multi({k!r})={got!r} != get={single!r}")
            # Read-your-committed: C never writes; B's acked updates must
            # survive (a later acked update to the same key supersedes).
            for k, val in self._acked.items():
                cur = batched[keys.index(k)]
                if cur is None:
                    raise WorkloadFailed(f"ycsb: acked update to {k!r} lost")

        await self._run_txn(db, body)


class WatchFanOutWorkload(Workload):
    """Many watches, few writes: `watchers_per_key` clients arm a watch
    on each of `n_keys` keys (fan-out = product), then one mutation wave
    touches every watched key. Every armed watch must fire (the packed
    registry must not LOSE a fire under fan-out; spurious fires remain
    legal per the reference contract). Exercises the packed watch
    registry's one-sweep-per-version match against a large resident
    set — the cost the reads/ subsystem makes sublinear."""

    name = "watch_fanout"

    def __init__(self, seed: int = 0, n_keys: int = 8,
                 watchers_per_key: int = 4):
        super().__init__(seed)
        self.n_keys = n_keys
        self.watchers_per_key = watchers_per_key

    def _key(self, i: int) -> bytes:
        return b"wfan/%05d" % i

    async def setup(self, db) -> None:
        async def body(tr):
            for i in range(self.n_keys):
                tr.set(self._key(i), b"v0")

        await self._run_txn(db, body)

    async def run(self, db, cluster) -> None:
        MAX_REARMS = 200  # a wedged watch must fail, not hang the sim
        armed = [0]
        fired = [0]
        all_armed = Promise()

        async def watcher(i: int, w: int):
            for attempt in range(MAX_REARMS):
                try:
                    async def arm(tr):
                        return await tr.watch(self._key(i))

                    slot = await self._run_txn(db, arm)
                    armed[0] += 1
                    if armed[0] == self.n_keys * self.watchers_per_key:
                        all_armed.send(None)
                    await slot
                    fired[0] += 1
                    self.metrics.ops += 1
                    return
                except FdbError as e:
                    if not e.retryable:
                        raise
                    # Value may already differ from the armed snapshot —
                    # that immediate fire path raises nothing; only
                    # retryable transport errors land here.
                    await cluster.loop.sleep(0.05)
            raise WorkloadFailed(f"watch fan-out {i}/{w}: re-arms exhausted")

        async def mutator():
            await all_armed.future
            async def body(tr):
                for i in range(self.n_keys):
                    tr.set(self._key(i), b"v1")

            await self._run_txn(db, body)

        tasks = [
            cluster.loop.spawn(watcher(i, w), name=f"wfan.w{i}.{w}")
            for i in range(self.n_keys)
            for w in range(self.watchers_per_key)
        ]
        tasks.append(cluster.loop.spawn(mutator(), name="wfan.mutator"))
        await all_of(tasks)
        want = self.n_keys * self.watchers_per_key
        if fired[0] != want:
            raise WorkloadFailed(
                f"watch fan-out: {fired[0]}/{want} watches fired")
        self.metrics.extra["fan_out"] = want

    async def check(self, db) -> None:
        async def body(tr):
            for i in range(self.n_keys):
                if await tr.get(self._key(i)) != b"v1":
                    raise WorkloadFailed("watch fan-out: wave write lost")

        await self._run_txn(db, body)
