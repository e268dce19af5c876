"""The simulated cluster, its control plane and its client in the port
against the JAX package.

Every case is exact and runs the same script in both packages under the
same seed: each builds its ``SimCluster`` and ``open_database`` from its
own package's modules (the port's with ``device="cpu"``, oracle engines
unless named) and must leave the same trace.

- ``SimNetwork`` alone: hosting, kills, partitions, clogs and region
  faults; the delivered and failed calls and ``loop.now``.
- The coordination register (``tests/test_coordination.py``
  ``TestRegister``).
- Every scenario of ``tests/test_recovery.py``; every case of
  ``tests/test_client.py`` but its TCP case (``runtime/wire.py`` is not
  ported); the coordinated controller under kills
  (``tests/test_coordination.py``), its two Cycle cases as plain client
  actors with explicit kills; ``TimeKeeper`` (``tests/test_timekeeper.py``).
  Compared: the scenario's observations, the epochs and recovery
  versions, every storage server's version chains at its last version,
  the trace events and ``loop.now`` at the end.
- ``sim/cluster_load.py`` (the YCSB-A clients of ``chip_smoke.py`` phase
  3n) over both packages' clusters with two kills.
- Real engines: one recovery scenario and a kill run with JAX
  ``TPUConflictSet`` against the port's ``TorchConflictSet(device="cpu")``,
  each package's ``sim.cluster.new_conflict_set`` building capacity 2^10,
  batch 64 engines.
- The arms whose modules the port does not have raise
  ``NotImplementedError``; ``SimCluster()`` without ``device`` builds on
  ``cuda`` and, with no card, raises.
"""

import importlib
import json
import struct
from types import SimpleNamespace

import numpy as np
import pytest
import torch

PKGS = ("foundationdb_tpu", "foundationdb_tpu_torch")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def norm(x):
    """A JSON-comparable copy (enums, bytes and tuples by value)."""
    return json.loads(json.dumps(x, default=lambda o: (
        o.hex() if isinstance(o, bytes) else repr(o))))


def same(script):
    """Run ``script(pkg)`` in both packages; the traces must be equal."""
    want, got = (norm(script(p)) for p in PKGS)
    assert got == want
    return got


@pytest.fixture(autouse=True)
def jax_made_deterministic(monkeypatch):
    order_jax_kills(monkeypatch)


def order_jax_kills(monkeypatch):
    """The JAX package kills in the order of a set: ``Loop.kill_process``
    cancels a process's tasks as a set hashed by address orders them, and
    ``SimCluster.retire_previous`` and ``SimNetwork.fail_region`` kill
    processes as a set of names orders them (the interpreter's string
    hashing). So its runs under one seed differ once a kill wakes several
    waiters. The port kills in spawn and hosting order; the JAX modules
    are given the same order here (ROADMAP Queue 3, settled).

    Its read coalescer's brain learns a dispatch's cost from the wall
    clock (``reads/coalescer.py`` ``_dispatch``), so a simulated
    ``get_multi`` waits as long as the host is slow. The port's learns it
    on the loop's clock, as the resolver's queue does: none in the sim.
    The JAX brain is given the same zero here."""
    from foundationdb_tpu.reads import coalescer as reads_coalescer
    from foundationdb_tpu.runtime import flow
    from foundationdb_tpu.sched import coalescer as sched_coalescer
    from foundationdb_tpu.sim import cluster, network

    def spawn(self, coro, process=None, name="?"):
        if isinstance(coro, flow.Future):
            coro = flow._await_future(coro)
        if process is None:
            process = self._current.process if self._current else "<main>"
        t = flow.Task(self, coro, process, name)
        self._tasks_by_process.setdefault(process, {})[t] = None
        t.add_done_callback(
            lambda _f: self._tasks_by_process.get(process, {}).pop(t, None))
        self._ready.append((t, None))
        return t

    def retire_previous(self):
        current = set(self._gen_processes)
        for proc in dict.fromkeys(getattr(self, "_pending_retirement", [])):
            if proc in current:
                continue
            self.loop.kill_process(self.process_prefix + proc)
            self.net.unhost_process(proc)
        self._pending_retirement = []

    def fail_region(self, prefix):
        p = self.process_prefix + prefix
        self._dead_regions.add(p)
        for proc in dict.fromkeys(k[0] for k in self._objects):
            if proc.startswith(p):
                self.loop.kill_process(proc)

    def observe_dispatch(self, depth, dt_ms):
        sched_coalescer.AdaptiveCoalescer.observe_dispatch(self, depth, 0.0)

    monkeypatch.setattr(flow.Loop, "spawn", spawn)
    monkeypatch.setattr(reads_coalescer.ReadBrain, "observe_dispatch",
                        observe_dispatch)
    monkeypatch.setattr(cluster.SimCluster, "retire_previous",
                        retire_previous)
    monkeypatch.setattr(network.SimNetwork, "fail_region", fail_region)


def pkg_mods(pkg: str) -> SimpleNamespace:
    return SimpleNamespace(
        pkg=pkg, SimCluster=mod(pkg, "sim.cluster").SimCluster,
        open_database=mod(pkg, "client.ryw").open_database,
        KeySelector=mod(pkg, "client.transaction").KeySelector,
        CONFLICTING_KEYS_PREFIX=mod(
            pkg, "client.transaction").CONFLICTING_KEYS_PREFIX,
        errors=mod(pkg, "core.errors"), M=mod(pkg, "core.mutations")
        .MutationType, types=mod(pkg, "core.types"),
        flow=mod(pkg, "runtime.flow"), net=mod(pkg, "sim.network"),
        coord=mod(pkg, "runtime.coordination"),
        tk=mod(pkg, "runtime.timekeeper"),
        MAX_KEY=mod(pkg, "runtime.shardmap").MAX_KEY,
        EPOCH_VERSION_JUMP=mod(pkg, "runtime.sequencer").EPOCH_VERSION_JUMP)


def make_cluster(R, seed: int, **kw):
    kw.setdefault("engine", "oracle")
    if R.pkg == PKGS[1]:
        kw.setdefault("device", "cpu")
    c = R.SimCluster(seed=seed, **kw)
    return c, R.open_database(c)


def snapshot(c) -> dict:
    """What a scenario leaves behind: the epochs, every storage server's
    version chains at its last version, the trace and the clock."""
    g = c.controller.generation
    return {
        "epoch": g.epoch, "recovery_version": g.recovery_version,
        "controller": c.controller.identity,
        "storages": [{"version": s._version,
                      "chains": sorted(s.map._chains.items())}
                     for s in c.storages],
        "trace": list(c.loop.tracer.ring),
        "trace_counts": dict(c.loop.tracer.counts),
        "now": c.loop.now}


async def wait_for_epoch(c, epoch, interval=0.25):
    while c.controller.generation.epoch < epoch:
        await c.loop.sleep(interval)


def cluster_case(fn, seed: int, **kw):
    """``fn(R, c, db)`` (a coroutine) over each package's cluster; its
    result and the cluster's snapshot must be equal."""
    def script(pkg):
        R = pkg_mods(pkg)
        c, db = make_cluster(R, seed, **kw)
        out = c.loop.run(fn(R, c, db), timeout=600)
        return {"result": out, **snapshot(c)}

    return same(script)


# -- SimNetwork alone ---------------------------------------------------------


class Echo:
    def __init__(self, loop, name):
        self.loop, self.name = loop, name

    async def echo(self, x):
        await self.loop.sleep(0.001)
        return (self.name, x, round(self.loop.now, 9))

    async def boom(self):
        raise ValueError("boom")


def _network(pkg):
    R = pkg_mods(pkg)
    loop = R.flow.Loop(seed=7)
    net = R.net.SimNetwork(loop)
    procs = ["a", "b", "pri/x", "pri/y", "rem/z"]
    eps = {p: net.host(p, "echo", Echo(loop, p)) for p in procs}
    log = []

    async def call(src, dst, x, method="echo"):
        async def go():
            try:
                got = await getattr(eps[dst], method)(x) if method == "echo" \
                    else await getattr(eps[dst], method)()
                log.append(("ok", src, dst, got, round(loop.now, 9)))
            except Exception as e:  # noqa: BLE001 - recorded
                log.append(("err", src, dst, type(e).__name__,
                            round(loop.now, 9)))

        return await loop.spawn(go(), process=src, name=f"{src}->{dst}")

    async def main():
        for i in range(4):
            await call("a", "b", i)
        await call("a", "b", 0, "boom")
        net.partition("a", "b")
        await call("a", "b", 5)
        await call("b", "pri/x", 6)
        net.heal("a", "b")
        net.clog("a", "b", factor=50.0, duration=0.5)
        await call("a", "b", 7)
        await loop.sleep(1.0)
        await call("a", "b", 8)
        net.kill("b")
        await call("a", "b", 9)
        net.reboot("b")
        await call("a", "b", 10)
        net.partition_region("pri/")
        await call("a", "pri/x", 11)
        await call("pri/y", "pri/x", 12)
        net.heal_all()
        await call("a", "pri/x", 13)
        net.fail_region("pri/")
        await call("a", "pri/y", 14)
        await call("rem/z", "pri/x", 15)
        net.heal_region("pri/")
        await call("a", "pri/y", 16)
        net.unhost_process("rem/z")
        await call("a", "rem/z", 17)
        return [net.region_dead("pri/"), net.region_partitioned("pri/")]

    out = loop.run(main(), timeout=100)
    return {"log": log, "out": out, "now": loop.now,
            "dead": sorted(loop.dead_processes)}


def test_sim_network_equals_jax():
    got = same(_network)
    assert [e[0] for e in got["log"]].count("err") >= 6


# -- the coordination register ------------------------------------------------


def _quorum(R, n=3, seed=0):
    loop = R.flow.Loop(seed=seed)
    net = R.net.SimNetwork(loop)
    coords = [R.coord.Coordinator() for _ in range(n)]
    eps = [net.host(f"coord{i}", "coordinator", c)
           for i, c in enumerate(coords)]
    return loop, net, coords, eps


def _racing_elections(pkg):
    R = pkg_mods(pkg)
    loop, net, coords, eps = _quorum(R)
    a = R.coord.CoordinatedState(loop, eps, candidate_id=0)
    b = R.coord.CoordinatedState(loop, eps, candidate_id=1)

    async def main():
        results = []

        async def racer(cs, my_id):
            try:
                results.append((my_id, await cs.elect(my_id, None)))
            except R.coord.Deposed:
                results.append((my_id, None))

        await R.flow.all_of([loop.spawn(racer(a, "ccA"), name="raceA"),
                             loop.spawn(racer(b, "ccB"), name="raceB")])
        final = (await a.read()).value
        reigns = [r["reign"] for _id, r in results if r]
        assert len(set(reigns)) == len(reigns), "duplicate reign won"
        assert final["leader"] in ("ccA", "ccB")
        return results, final

    out = loop.run(main(), timeout=600)
    return {"out": out, "now": loop.now,
            "coords": [(c.promised, c.accepted_ballot, c.accepted_value)
                       for c in coords]}


def _deposed_writer(pkg):
    R = pkg_mods(pkg)
    loop, net, coords, eps = _quorum(R, seed=1)
    a = R.coord.CoordinatedState(loop, eps, candidate_id=0)
    b = R.coord.CoordinatedState(loop, eps, candidate_id=1)

    async def main():
        sa = await a.elect("ccA", None)
        await b.elect("ccB", None)
        try:
            await a.write_if_leader("ccA", sa["reign"], {"epoch": 99})
            return "accepted"
        except R.coord.Deposed:
            return "deposed"

    out = loop.run(main(), timeout=600)
    assert out == "deposed"
    return {"out": out, "now": loop.now,
            "values": [c.accepted_value for c in coords]}


def _minority_death(pkg):
    R = pkg_mods(pkg)
    loop, net, coords, eps = _quorum(R, seed=2)
    a = R.coord.CoordinatedState(loop, eps, candidate_id=0)

    async def main():
        net.kill("coord1")
        state = await a.elect("ccA", None)
        assert state["leader"] == "ccA"
        return state

    out = loop.run(main(), timeout=600)
    return {"out": out, "now": loop.now,
            "values": [c.accepted_value for c in coords]}


@pytest.mark.parametrize("script", [_racing_elections, _deposed_writer,
                                    _minority_death],
                         ids=["racing_elections", "deposed_writer",
                              "minority_coordinator_death"])
def test_coordination_register_equals_jax(script):
    same(script)


# -- recovery (tests/test_recovery.py) ----------------------------------------


async def _put(db, k, v):
    async def body(tr):
        tr.set(k, v)

    await db.run(body)


async def _role_kill(R, c, db, victim):
    committed = []

    async def put(i):
        await _put(db, b"k%03d" % i, b"v%03d" % i)
        committed.append(i)

    for i in range(10):
        await put(i)
    c.net.kill(victim)
    await wait_for_epoch(c, 2)
    for i in range(10, 15):
        await put(i)

    async def check(tr):
        return [await tr.get(b"k%03d" % i) for i in committed]

    got = await db.run(check)
    assert got == [b"v%03d" % i for i in committed]
    return committed


async def _tlog_salvage(R, c, db):
    c.net.partition("storage0", "tlog0")
    c.net.partition("storage1", "tlog0")
    await _put(db, b"salvage-me", b"precious")
    c.net.kill("tlog0")
    await wait_for_epoch(c, 2)

    async def check(tr):
        return await tr.get(b"salvage-me")

    got = await db.run(check)
    assert got == b"precious"
    return got


async def _versions_jump(R, c, db):
    await _put(db, b"a", b"1")
    v1 = c.sequencer.last_handed_out
    c.net.kill("master")
    await wait_for_epoch(c, 2)
    rv = c.controller.generation.recovery_version
    await _put(db, b"b", b"2")
    v2 = await db.transaction().get_read_version()
    assert rv >= v1 and v2 >= rv + R.EPOCH_VERSION_JUMP
    return [v1, rv, v2]


async def _old_read_version(R, c, db):
    await _put(db, b"x", b"1")
    tr_old = db.transaction()
    old_version = await tr_old.get_read_version()
    c.net.kill("master")
    await wait_for_epoch(c, 2)
    await _put(db, b"x", b"2")
    await _put(db, b"x", b"2")
    await c.loop.sleep(0.1)
    out = []
    for _ in range(2):
        tr = db.transaction()
        tr.set_read_version(old_version)
        try:
            out.append(await tr.get(b"x"))
        except R.errors.TransactionTooOld:
            out.append("too_old")
    assert out[0] in (b"1", "too_old") and out[1] == "too_old"
    return out


async def _client_info_refresh(R, c, db):
    old_eps = tuple(db.commit_proxies)
    c.net.kill("master")
    await wait_for_epoch(c, 2)
    await _put(db, b"post", b"recovery")
    info = await c.controller_ep.get_client_info()
    assert db.epoch == 2 and tuple(db.commit_proxies) != old_eps
    return [db.epoch, info.epoch, repr(db.commit_proxies)]


async def _concurrent_load(R, c, db):
    acked = []

    async def writer(i):
        await c.loop.sleep(i * 0.1)
        await _put(db, b"w%03d" % i, b"v")
        acked.append(i)

    async def killer():
        await c.loop.sleep(0.5)
        c.net.kill("master")

    tasks = [c.loop.spawn(writer(i)) for i in range(30)]
    await R.flow.all_of(tasks + [c.loop.spawn(killer())])
    await wait_for_epoch(c, 2)

    async def check(tr):
        return [await tr.get(b"w%03d" % i) for i in acked]

    got = await db.run(check)
    assert len(acked) == 30 and got == [b"v"] * 30
    return acked


async def _double_recovery(R, c, db):
    await _put(db, b"a", b"1")
    c.net.kill("master")
    await wait_for_epoch(c, 2)
    await _put(db, b"b", b"2")
    c.net.kill("master.e2")
    await wait_for_epoch(c, 3)
    await _put(db, b"c", b"3")

    async def check(tr):
        return [await tr.get(k) for k in (b"a", b"b", b"c")]

    got = await db.run(check)
    assert got == [b"1", b"2", b"3"]
    return got


async def _unacked_rollback(R, c, db):
    c.net.partition("commit_proxy0", "tlog1")
    orphan_acked = []

    async def orphan():
        tr = db.transaction()
        tr.set(b"orphan", b"torn")
        try:
            await tr.commit()
            orphan_acked.append(True)
        except Exception:  # noqa: BLE001 - commit_unknown_result
            pass

    t = c.loop.spawn(orphan())
    await c.loop.sleep(0.5)
    applied = c.storages[c.storage_map.tag_for_key(b"orphan")].map.latest(
        b"orphan")
    c.net.kill("tlog0")
    await wait_for_epoch(c, 2)
    c.net.heal("commit_proxy0", "tlog1")
    await t

    async def check(tr):
        got = await tr.get(b"orphan")
        tr.set(b"fresh", b"write")
        return got

    got = await db.run(check)

    async def check2(tr):
        return await tr.get(b"fresh")

    fresh = await db.run(check2)
    assert applied is None and not orphan_acked and got is None
    assert fresh == b"write"
    return [applied, orphan_acked, got, fresh]


async def _wedged_chain(R, c, db):
    await _put(db, b"before", b"1")
    c.net.partition("commit_proxy0", "tlog0")
    await _put(db, b"during", b"2")
    assert c.controller.generation.epoch >= 2

    async def check(tr):
        return [await tr.get(b"before"), await tr.get(b"during")]

    got = await db.run(check)
    assert got == [b"1", b"2"]
    return got


async def _gc_unacked_suffix(R, c, db):
    await _put(db, b"k", b"acked")
    c.net.partition("commit_proxy0", "tlog1")
    c.commit_proxies[0].controller = None

    async def orphan():
        tr = db.transaction()
        tr.set(b"k", b"unacked")
        try:
            await tr.commit()
        except Exception:  # noqa: BLE001 - never acknowledged
            pass

    async def churn():
        for _ in range(12):
            tr = db.transaction()
            tr.set(b"other", b"x")
            try:
                await tr.commit()
            except Exception:  # noqa: BLE001 - never acknowledged
                pass

    t, t2 = c.loop.spawn(orphan()), c.loop.spawn(churn())
    await c.loop.sleep(10.0)
    c.net.kill("tlog0")
    await wait_for_epoch(c, 2)
    c.net.heal("commit_proxy0", "tlog1")
    await t
    await t2

    async def check(tr):
        return await tr.get(b"k")

    got = await db.run(check)
    assert got == b"acked"
    return got


async def _tlog_trim(R, c, db):
    for i in range(20):
        await _put(db, b"t%03d" % i, b"v")
    c.net.kill("master")
    await wait_for_epoch(c, 2)
    for i in range(20, 40):
        await _put(db, b"t%03d" % i, b"v")
    await c.loop.sleep(1.0)
    n = len(c.tlogs[0]._log)
    assert n < 10
    return n


async def _stall_until_tlog(R, c, db):
    await _put(db, b"k", b"v")
    c.net.partition("cluster_controller", "tlog0")
    c.net.kill("master")
    await c.loop.sleep(5.0)
    stalled = c.controller.generation.epoch
    c.net.heal("cluster_controller", "tlog0")
    await wait_for_epoch(c, 2)

    async def check(tr):
        return await tr.get(b"k")

    got = await db.run(check)
    assert stalled == 1 and got == b"v"
    return [stalled, got]


def _victim(victim):
    async def fn(R, c, db):
        return await _role_kill(R, c, db, victim)

    return fn


#: test_recovery.py's scenarios: (function, seed, SimCluster arguments);
#: every cluster has two storage servers, two replicas.
RECOVERY = {
    "kill_master": (_victim("master"), 101, {}),
    "kill_commit_proxy0": (_victim("commit_proxy0"), 102, {}),
    "kill_resolver0": (_victim("resolver0"), 103, {}),
    "kill_grv_proxy0": (_victim("grv_proxy0"), 104, {}),
    "tlog_salvage": (_tlog_salvage, 42, {"n_tlogs": 2}),
    "versions_jump": (_versions_jump, 7, {}),
    "old_read_version": (_old_read_version, 8, {}),
    "client_info_refresh": (_client_info_refresh, 9, {}),
    "concurrent_load": (_concurrent_load, 10, {}),
    "double_recovery": (_double_recovery, 11, {}),
    "unacked_rollback": (_unacked_rollback, 13, {"n_tlogs": 2}),
    "wedged_chain": (_wedged_chain, 16, {}),
    "gc_unacked_suffix": (_gc_unacked_suffix, 15, {"n_tlogs": 2}),
    "tlog_trim": (_tlog_trim, 14, {}),
    "stall_until_tlog": (_stall_until_tlog, 12, {}),
}


@pytest.mark.parametrize("name", sorted(RECOVERY))
def test_recovery_scenario_equals_jax(name):
    fn, seed, kw = RECOVERY[name]
    got = cluster_case(fn, seed, n_storages=2, n_replicas=2, **kw)
    assert got["epoch"] >= 2


# -- the client (tests/test_client.py) ----------------------------------------


async def _set_commit_get(R, c, db):
    tr = db.transaction()
    tr.set(b"hello", b"world")
    v = await tr.commit()
    got = await db.transaction().get(b"hello")
    assert got == b"world" and v > 0
    return [v, got]


async def _run_retries_conflict(R, c, db):
    tr = db.transaction()
    tr.set(b"ctr", (0).to_bytes(8, "little"))
    await tr.commit()

    async def incr(tr):
        cur = await tr.get(b"ctr")
        tr.set(b"ctr", (int.from_bytes(cur, "little") + 1).to_bytes(
            8, "little"))

    await R.flow.all_of([c.loop.spawn(db.run(incr)) for _ in range(10)])
    n = int.from_bytes(await db.transaction().get(b"ctr"), "little")
    assert n == 10
    return n


async def _non_retryable(R, c, db):
    async def bad(tr):
        raise R.errors.FdbError("app bug", code=2000)

    try:
        await db.run(bad)
    except R.errors.FdbError as e:
        assert e.code == 2000
        return e.code
    raise AssertionError("no error")


async def _snapshot_no_conflict(R, c, db):
    tr0 = db.transaction()
    tr0.set(b"k", b"0")
    await tr0.commit()
    tr1 = db.transaction()
    await tr1.get(b"k", snapshot=True)
    tr2 = db.transaction()
    tr2.set(b"k", b"1")
    await tr2.commit()
    tr1.set(b"other", b"x")
    return await tr1.commit()


async def _conflict_not_committed(R, c, db):
    tr0 = db.transaction()
    tr0.set(b"k", b"0")
    await tr0.commit()
    tr1 = db.transaction()
    await tr1.get(b"k")
    tr2 = db.transaction()
    tr2.set(b"k", b"1")
    await tr2.commit()
    tr1.set(b"other", b"x")
    try:
        await tr1.commit()
    except R.errors.NotCommitted as e:
        return e.code
    raise AssertionError("committed")


async def _read_your_writes(R, c, db):
    tr = db.transaction()
    tr.set(b"a", b"1")
    got = [await tr.get(b"a")]
    tr.clear(b"a")
    got.append(await tr.get(b"a"))
    assert got == [b"1", None]
    return got


async def _clear_range_then_set(R, c, db):
    tr0 = db.transaction()
    for i in range(5):
        tr0.set(b"r%d" % i, b"base")
    await tr0.commit()
    tr = db.transaction()
    tr.clear_range(b"r", b"s")
    got = [await tr.get(b"r3")]
    tr.set(b"r2", b"new")
    got.append(await tr.get_range(b"r", b"s"))
    await tr.commit()
    got.append(await db.transaction().get_range(b"r", b"s"))
    assert got == [None, [(b"r2", b"new")], [(b"r2", b"new")]]
    return got


async def _atomic_fold(R, c, db):
    tr0 = db.transaction()
    tr0.set(b"n", (7).to_bytes(8, "little"))
    await tr0.commit()
    tr = db.transaction()
    tr.atomic_op(R.M.ADD, b"n", (5).to_bytes(8, "little"))
    got = [int.from_bytes(await tr.get(b"n"), "little")]
    tr.atomic_op(R.M.ADD, b"n", (1).to_bytes(8, "little"))
    got.append(int.from_bytes(await tr.get(b"n"), "little"))
    await tr.commit()
    got.append(int.from_bytes(await db.transaction().get(b"n"), "little"))
    assert got == [12, 13, 13]
    return got


async def _range_merge_limit(R, c, db):
    tr0 = db.transaction()
    for i in range(0, 10, 2):
        tr0.set(b"m%d" % i, b"base")
    await tr0.commit()
    tr = db.transaction()
    for i in range(1, 10, 2):
        tr.set(b"m%d" % i, b"ovl")
    tr.clear(b"m0")
    rows = await tr.get_range(b"m", b"n", limit=4)
    rows_r = await tr.get_range(b"m", b"n", limit=2, reverse=True)
    assert [k for k, _ in rows] == [b"m1", b"m2", b"m3", b"m4"]
    assert [k for k, _ in rows_r] == [b"m9", b"m8"]
    return [rows, rows_r]


async def _limited_after_clear(R, c, db):
    tr0 = db.transaction()
    for i in range(20):
        tr0.set(b"k%02d" % i, b"v")
    await tr0.commit()
    tr = db.transaction()
    tr.clear_range(b"k00", b"k10")
    rows = await tr.get_range(b"k00", b"k99", limit=5)
    assert [k for k, _ in rows] == [b"k%02d" % i for i in range(10, 15)]
    return rows


async def _snapshot_atomic_obligation(R, c, db):
    tr = db.transaction()
    tr.atomic_op(R.M.ADD, b"n", (1).to_bytes(8, "little"))
    await tr.get(b"n", snapshot=True)
    before = len(tr.read_ranges)
    await tr.get(b"n")
    assert len(tr.read_ranges) == before + 1
    return [before, len(tr.read_ranges)]


async def _covered_by_clear(R, c, db):
    tr = db.transaction()
    tr.clear_range(b"a", b"b")
    before = len(tr.read_ranges)
    got = await tr.get(b"ax")
    assert got is None and len(tr.read_ranges) == before
    return before


async def _unreadable_versionstamp(R, c, db):
    tr = db.transaction()
    tr.atomic_op(R.M.SET_VERSIONSTAMPED_VALUE, b"vk",
                 b"\x00" * 10 + struct.pack("<I", 0))
    codes = []
    for read in (lambda: tr.get(b"vk"), lambda: tr.get_range(b"v", b"w")):
        try:
            await read()
            codes.append(None)
        except R.errors.FdbError as e:
            codes.append(e.code)
    assert codes[0] == 1036 and codes[1] is not None
    return codes


async def _watch_failed_on_reset(R, c, db):
    tr = db.transaction()
    w = await tr.watch(b"k")
    await tr.on_error(R.errors.NotCommitted())
    assert w.done() and w.is_error()
    return [w.done(), w.is_error()]


async def _key_selectors(R, c, db):
    tr0 = db.transaction()
    for k in (b"a", b"c", b"e", b"g"):
        tr0.set(k, b"v")
    await tr0.commit()
    tr, S = db.transaction(), R.KeySelector
    got = [await tr.get_key(sel) for sel in (
        S.first_greater_or_equal(b"c"), S.first_greater_than(b"c"),
        S.last_less_than(b"c"), S.last_less_or_equal(b"c"),
        S.first_greater_or_equal(b"c") + 1, S.last_less_than(b"a"),
        S.first_greater_than(b"zzz"))]
    assert got == [b"c", b"e", b"a", b"c", b"e", b"", R.MAX_KEY]
    return got


async def _watch_fires(R, c, db):
    tr0 = db.transaction()
    tr0.set(b"w", b"0")
    await tr0.commit()
    tr = db.transaction()
    w = await tr.watch(b"w")
    await tr.commit()
    fired_early = w.done()
    tr2 = db.transaction()
    tr2.set(b"w", b"1")
    await tr2.commit()
    await w
    assert not fired_early
    return c.loop.now


async def _versionstamp_roundtrip(R, c, db):
    tr = db.transaction()
    key = b"vs/" + b"\x00" * 10 + struct.pack("<I", 3)
    tr.atomic_op(R.M.SET_VERSIONSTAMPED_KEY, key, b"payload")
    await tr.commit()
    stamp = tr.get_versionstamp()
    rows = await db.transaction().get_range(b"vs/", b"vs0")
    assert rows == [(b"vs/" + stamp, b"payload")]
    return rows


async def _guard_paths(R, c, db):
    tr = db.transaction()
    raised = []
    for fn in (lambda: tr.set(b"\xff/conf", b"x"),
               lambda: tr.clear(b"\xff\xff/status/json"),
               lambda: tr.clear_range(b"a", b"\xff\xff\xff")):
        try:
            fn()
        except R.errors.KeyOutsideLegalRange as e:
            raised.append(e.code)
    tr = db.transaction()
    big = b"v" * 90_000
    for i in range(R.types.MAX_TRANSACTION_SIZE // len(big) + 2):
        tr.set(b"k%06d" % i, big)
    try:
        await tr.commit()
    except R.errors.TransactionTooLarge as e:
        assert not e.retryable
        raised.append(e.code)
    assert raised == [2003, 2003, 2003, 2101]
    return raised


#: Status-document fields read off the wall clock or off each package's
#: own configuration, masked before the comparison.
STATUS_MASK = ("occupancy", "dispatch_occupancy")


def _mask(doc):
    if isinstance(doc, dict):
        return {k: ("<masked>" if k in STATUS_MASK else _mask(v))
                for k, v in doc.items()}
    if isinstance(doc, list):
        return [_mask(v) for v in doc]
    return doc


async def _status_json(R, c, db):
    await _put(db, b"s", b"1")
    raw = await db.transaction().get(b"\xff\xff/status/json")
    doc = json.loads(raw)
    assert doc["cluster"]["controller"]["reachable"]
    return _mask(doc)


async def _conflicting_keys(R, c, db):
    P = R.CONFLICTING_KEYS_PREFIX
    t0 = db.transaction()
    t0.set(b"ck/a", b"0")
    t0.set(b"ck/other", b"0")
    await t0.commit()
    tr = db.transaction()
    tr.set_option("report_conflicting_keys")
    await tr.get(b"ck/a")
    await tr.get(b"ck/other")
    t2 = db.transaction()
    t2.set(b"ck/a", b"1")
    await t2.commit()
    tr.set(b"ck/mine", b"x")
    try:
        await tr.commit()
        raise AssertionError("committed")
    except R.errors.NotCommitted:
        pass
    rows = await tr.get_range(P, P + b"\xff")
    point = await tr.get(P + b"ck/a")
    assert rows == [(P + b"ck/a", b"\x01"), (P + b"ck/a\x00", b"\x00")]
    assert point == b"\x01"
    return [rows, point]


async def _no_option_no_ranges(R, c, db):
    t0 = db.transaction()
    t0.set(b"nk/a", b"0")
    await t0.commit()
    tr = db.transaction()
    await tr.get(b"nk/a")
    t2 = db.transaction()
    t2.set(b"nk/a", b"1")
    await t2.commit()
    tr.set(b"nk/b", b"x")
    try:
        await tr.commit()
        raise AssertionError("committed")
    except R.errors.NotCommitted as e:
        ranges = e.conflicting_ranges
    rows = await tr.get_range(b"\xff\xff/transaction/",
                              b"\xff\xff/transaction0")
    assert ranges is None and rows == []
    return rows


async def _tag_option(R, c, db):
    await c.ratekeeper.set_tag_quota("analytics", 5.0)
    await c.loop.sleep(0.3)
    t0 = c.loop.now
    for i in range(8):
        tr = db.transaction()
        tr.set_option("tag", "analytics")
        tr.set(b"tag/k%d" % i, b"v")
        await tr.commit()
    tagged = c.loop.now - t0
    t1 = c.loop.now
    for i in range(8):
        tr = db.transaction()
        tr.set(b"tag/u%d" % i, b"v")
        await tr.commit()
    untagged = c.loop.now - t1
    assert tagged > 1.0 and c.grv_proxies[0].tag_throttled > 0
    assert untagged < 0.25 * tagged
    return [tagged, untagged, c.grv_proxies[0].tag_throttled]


#: test_client.py's cases (all but the TCP one): (function, seed).
CLIENT = {
    "set_commit_get": (_set_commit_get, 1),
    "run_retries_conflict": (_run_retries_conflict, 2),
    "non_retryable": (_non_retryable, 3),
    "snapshot_no_conflict": (_snapshot_no_conflict, 4),
    "conflict_not_committed": (_conflict_not_committed, 5),
    "read_your_writes": (_read_your_writes, 6),
    "clear_range_then_set": (_clear_range_then_set, 7),
    "atomic_fold": (_atomic_fold, 8),
    "range_merge_limit": (_range_merge_limit, 9),
    "limited_after_clear": (_limited_after_clear, 20),
    "snapshot_atomic_obligation": (_snapshot_atomic_obligation, 21),
    "covered_by_clear": (_covered_by_clear, 22),
    "unreadable_versionstamp": (_unreadable_versionstamp, 23),
    "watch_failed_on_reset": (_watch_failed_on_reset, 24),
    "key_selectors": (_key_selectors, 10),
    "watch_fires": (_watch_fires, 11),
    "versionstamp_roundtrip": (_versionstamp_roundtrip, 12),
    "guard_paths": (_guard_paths, 80),
    "status_json": (_status_json, 83),
    "conflicting_keys": (_conflicting_keys, 40),
    "no_option_no_ranges": (_no_option_no_ranges, 41),
    "tag_option": (_tag_option, 42),
}


@pytest.mark.parametrize("name", sorted(CLIENT))
def test_client_case_equals_jax(name):
    fn, seed = CLIENT[name]
    cluster_case(fn, seed)


# -- the coordinated controller under kills (tests/test_coordination.py) -----


async def _kill_controller(R, c, db):
    tr = db.transaction()
    tr.set(b"before", b"kill")
    await tr.commit()
    assert c.controller.identity == "cc0"
    c.net.kill("cc0")
    for _ in range(400):
        if c.controller.identity != "cc0" \
                and c.controller.generation.epoch >= 2:
            break
        await c.loop.sleep(0.1)
    assert c.controller.identity in ("cc1", "cc2")

    async def txn(tr):
        got = await tr.get(b"before")
        tr.set(b"after", b"reelection")
        return got

    got = await db.run(txn)
    after = await db.transaction().get(b"after")
    assert got == b"kill" and after == b"reelection"
    return [c.controller.identity, got, after]


async def _partitioned_ex_controller(R, c, db):
    cc0 = c.controller
    peers = [f"coord{i}" for i in range(3)] + ["cc1", "cc2"]
    for p in peers:
        c.net.partition("cc0", p)
    for _ in range(400):
        if c.controller is not cc0:
            break
        await c.loop.sleep(0.1)
    assert c.controller is not cc0, "no takeover happened"
    for p in peers:
        c.net.heal("cc0", p)
    leader = await cc0._confirm_leadership()
    assert not leader and cc0._deposed
    return [c.controller.identity, leader, cc0._deposed]


def _cycle(n_nodes: int, n_txns: int, n_clients: int, kill_at=None,
           kill_after_s=None):
    """The Cycle workload (reference: Cycle.actor.cpp) as plain client
    actors: keys 0..N-1 hold a permutation forming one cycle; each
    transaction rotates a random node's successor. ``kill_at`` kills the
    controller after that many finished transactions; ``kill_after_s``
    after that many virtual seconds."""
    async def fn(R, c, db):
        def key(i):
            return b"cycle/%06d" % i

        async def setup(tr):
            for i in range(n_nodes):
                tr.set(key(i), struct.pack("<q", (i + 1) % n_nodes))

        await db.run(setup)
        done, kills = [0], []

        def kill():
            kills.append((c.controller.identity, c.loop.now))
            c.net.kill(c.controller.identity)

        async def client(n):
            for _ in range(n):
                a = c.loop.rng.randrange(n_nodes)

                async def body(tr, a=a):
                    b = struct.unpack("<q", await tr.get(key(a)))[0]
                    c_ = struct.unpack("<q", await tr.get(key(b)))[0]
                    d = struct.unpack("<q", await tr.get(key(c_)))[0]
                    tr.set(key(a), struct.pack("<q", c_))
                    tr.set(key(c_), struct.pack("<q", b))
                    tr.set(key(b), struct.pack("<q", d))

                await db.run(body)
                done[0] += 1
                if done[0] == kill_at:
                    kill()

        async def timed_kill():
            await c.loop.sleep(kill_after_s)
            kill()

        per = [n_txns // n_clients + (i < n_txns % n_clients)
               for i in range(n_clients)]
        tasks = [c.loop.spawn(client(n), name=f"cycle.client{i}")
                 for i, n in enumerate(per)]
        if kill_after_s is not None:
            tasks.append(c.loop.spawn(timed_kill(), name="cycle.kill"))
        await R.flow.all_of(tasks)
        for _ in range(400):
            if c.controller.identity != "cc0":
                break
            await c.loop.sleep(0.1)

        async def check(tr):
            return [struct.unpack("<q", await tr.get(key(i)))[0]
                    for i in range(n_nodes)]

        succ = await db.run(check)
        seen, node = set(), 0
        for _ in range(n_nodes):
            assert node not in seen, "not a single cycle"
            seen.add(node)
            node = succ[node]
        assert node == 0 and len(seen) == n_nodes
        assert kills and c.controller.identity != "cc0"
        return [done[0], kills, succ]

    return fn


#: test_coordination.py's controller cases: (function, seed); each cluster
#: has three coordinators and two tlogs.
CONTROLLER = {
    "kill_controller_reelects": (_kill_controller, 201),
    "cycle_with_controller_kill": (_cycle(8, 30, 3, kill_at=10), 202),
    "explicit_controller_kill_under_cycle": (
        _cycle(8, 30, 3, kill_after_s=0.4), 203),
    "partitioned_ex_controller_deposed": (_partitioned_ex_controller, 204),
}


@pytest.mark.parametrize("name", sorted(CONTROLLER))
def test_coordinated_controller_equals_jax(name):
    fn, seed = CONTROLLER[name]
    cluster_case(fn, seed, n_coordinators=3, n_tlogs=2)


# -- TimeKeeper (tests/test_timekeeper.py) ------------------------------------


async def _timekeeper(R, c, db):
    tk = R.tk
    await c.loop.sleep(35)
    rows = await db.transaction().get_range(tk.PREFIX, tk.PREFIX_END)
    v_now = await tk.version_for_time(db.transaction(), c.loop.now)
    t2 = db.transaction()
    t2.set(b"x", b"y")
    await t2.commit()
    cv = t2.committed_version
    await c.loop.sleep(15)
    ts = await tk.time_for_version(db.transaction(), cv)
    v_early = await tk.version_for_time(db.transaction(), 12.0)
    v_none = await tk.version_for_time(db.transaction(), -1.0)
    c.net.kill("tlog0")
    await wait_for_epoch(c, 2)
    await c.loop.sleep(25)

    async def count(tr):
        return len(await tr.get_range(tk.PREFIX, tk.PREFIX_END))

    after = await db.run(count)
    assert len(rows) >= 3 and v_now is not None and 0 < ts <= c.loop.now
    assert v_early <= v_now and v_none is None and after > len(rows)
    return [rows, v_now, cv, ts, v_early, v_none, after]


def test_timekeeper_equals_jax():
    cluster_case(_timekeeper, 21, n_storages=2, n_tlogs=2)


# -- the YCSB-A clients of phase 3n -------------------------------------------


def _load(pkg, engine="oracle", wave=False, n=384, seed=3):
    from foundationdb_tpu_torch.sim.cluster_load import ClusterLoad

    R = pkg_mods(pkg)
    kw = dict(n_storages=2, n_replicas=2, n_tlogs=2, n_coordinators=3)
    if wave:
        kw.update(n_resolvers=2, wave_commit=True)
    c, db = make_cluster(R, seed, engine=engine, **kw)
    kills = ({n // 2: "resolver1"} if wave
             else {n // 3: "resolver0", 2 * n // 3: "tlog0"})
    load = ClusterLoad(c, db, kills=kills)
    s = load.run_ycsb(n, 32, 10, seed=seed)
    final = load.replay()
    got = load.read_back(sorted(final))
    assert got == final and final
    firsts = load.epoch_firsts()
    for epoch, rv in load.generations[1:]:
        assert firsts[epoch] >= rv + R.EPOCH_VERSION_JUMP
    del s["wall_s"]
    return {"summary": s, "outcomes": load.outcomes.tolist(),
            "errors": load.errors, "waves": load.waves,
            "recoveries": [{k: v for k, v in r.items()
                            if "wall" not in k and "dispatch" not in k}
                           for r in load.recoveries],
            **snapshot(c)}


@pytest.mark.parametrize("wave", [False, True], ids=["kills", "wave"])
def test_cluster_load_equals_jax(wave):
    got = same(lambda pkg: _load(pkg, wave=wave))
    s = got["summary"]
    assert s["epochs"] == ([1, 2] if wave else [1, 2, 3])
    assert s["failed"] == 0 and s["conflicts"] and s["retries"]


# -- real engines -------------------------------------------------------------


ENGINE = dict(capacity=1 << 10, batch_size=64)


@pytest.fixture
def small_engines(monkeypatch):
    """Each package's engine seam builds its card engine at capacity
    2^10, batch 64 (the JAX one on the CPU, the port's on the CPU)."""
    def patch(pkg):
        sim = mod(pkg, "sim.cluster")
        seam = sim.new_conflict_set
        if pkg == PKGS[0]:
            from foundationdb_tpu.models.conflict_set import TPUConflictSet

            def make(engine, wave_commit=None):
                if engine != "tpu":
                    return seam(engine, wave_commit)
                return TPUConflictSet(wave_commit=bool(wave_commit), **ENGINE)
        else:
            from foundationdb_tpu_torch import TorchConflictSet

            def make(engine, wave_commit=None, device=None):
                if engine != "torch":
                    return seam(engine, wave_commit, device)
                assert device == "cpu"
                return TorchConflictSet(wave_commit=bool(wave_commit),
                                        device=device, **ENGINE)

        monkeypatch.setattr(sim, "new_conflict_set", make)

    for pkg in PKGS:
        patch(pkg)


def test_recovery_over_real_engines_equals_jax(small_engines):
    """test_recovery.py's rollback scenario with real engines."""
    def script(pkg):
        R = pkg_mods(pkg)
        c, db = make_cluster(R, 13, engine="tpu" if pkg == PKGS[0]
                             else "torch", n_storages=2, n_replicas=2,
                             n_tlogs=2)
        out = c.loop.run(_unacked_rollback(R, c, db), timeout=600)
        return {"result": out, **snapshot(c)}

    same(script)


@pytest.mark.parametrize("wave", [False, True], ids=["kills", "wave"])
def test_cluster_load_over_real_engines_equals_jax_and_oracle(small_engines,
                                                              wave):
    jx = _load(PKGS[0], engine="tpu", wave=wave, n=256)
    pt = _load(PKGS[1], engine="torch", wave=wave, n=256)
    assert norm(pt) == norm(jx)
    orc = _load(PKGS[1], engine="oracle", wave=wave, n=256)
    assert np.array_equal(orc["outcomes"], pt["outcomes"])
    assert orc["summary"]["cluster_outcomes_sha256"] == \
        pt["summary"]["cluster_outcomes_sha256"]


# -- the port's own arms ------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {"recorder_path": "unused"}, {"admission": True}],
    ids=lambda kw: next(iter(kw)))
def test_unported_arms_refuse(kw):
    from foundationdb_tpu_torch.sim.cluster import SimCluster

    module = {"recorder_path": "recorder",
              "admission": "policy"}[next(iter(kw))]
    with pytest.raises(NotImplementedError, match=module):
        SimCluster(seed=0, engine="oracle", device="cpu", **kw)


def test_admission_env_refuses(monkeypatch):
    from foundationdb_tpu_torch.sim.cluster import SimCluster

    monkeypatch.setenv("FDB_TPU_ADMISSION", "1")
    with pytest.raises(NotImplementedError, match="AdmissionPolicy"):
        SimCluster(seed=0, engine="oracle", device="cpu")
    monkeypatch.setenv("FDB_TPU_ADMISSION", "0")
    SimCluster(seed=0, engine="oracle", device="cpu", timekeeper=False)


def test_default_cluster_is_on_the_card():
    """``SimCluster()`` builds its engines and read plane on ``cuda``:
    with no card it raises, and nothing falls back to the CPU."""
    from foundationdb_tpu_torch.sim.cluster import SimCluster

    if torch.cuda.is_available():
        c = SimCluster(seed=0, timekeeper=False)
        assert c.engine == "torch"
        assert all(s.read_set.device.type == "cuda" for s in c.storages)
        assert all(r.cs.device.type == "cuda" for r in c.resolvers)
        return
    with pytest.raises(RuntimeError, match="CUDA card"):
        SimCluster(seed=0)
    with pytest.raises(RuntimeError, match="CUDA card"):
        SimCluster(seed=0, engine="oracle")
