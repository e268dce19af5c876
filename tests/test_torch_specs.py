"""The simulation specs and their runner in the port against the JAX package.

Every case is exact and runs the same script in both packages under the
same seed: each builds its ``SimCluster`` and ``open_database`` from its
own package's modules (the port's with ``device="cpu"``, oracle engines
unless named) and must leave the same trace.

- The tuple layer (``layers/tuple_layer.py``): ``pack``, ``unpack``,
  ``range_of`` and ``pack_with_versionstamp`` on random tuples made from a
  numpy seed, byte for byte; the tuple cases of ``tests/test_layers.py``.
- ``load_spec`` on every file of ``tests/specs``: titles, fault knobs,
  cluster options, each workload's class and constructor arguments. The
  tests the port cannot run raise ``NotImplementedError`` naming the module
  they need; ``tests/test_specs.py``'s parsing cases.
- Every ported ``[[test]]`` of ``tests/specs`` under one seed, as
  ``sim/run.run_one`` builds it: each workload's metrics, the kills,
  partitions and clogs, the BUGGIFY sites, the epoch and recovery version,
  every storage server's version chains at its last version, the trace
  events and ``loop.now``.
- The cases of ``tests/test_workloads.py`` and ``tests/test_clog_buggify.py``
  as they stand, and ``tests/test_specs.py``'s injected TPC-C bug: the
  injected bugs are caught in both packages.
- ``sim/run.run_one`` on ``Cycle.toml`` and ``Chaos.toml`` at two seeds, and
  the port's command line on the CPU; campaign specs raise in the port.
- Real engines: ``Cycle.toml`` and ``Mixed.toml`` with JAX
  ``TPUConflictSet`` against the port's ``TorchConflictSet(device="cpu")``,
  each package's ``sim.cluster.new_conflict_set`` building capacity 2^10,
  batch 64 engines.
- No hidden fallback: the port's ``run_one`` and ``run_spec`` build on
  ``cuda`` unless asked for the CPU, and with no card they raise.
"""

import json
import os
import re
import subprocess
import sys
import uuid
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.test_torch_cluster import (
    PKGS,
    _mask,
    mod,
    norm,
    order_jax_kills,
    same,
    small_engines,  # noqa: F401  (a fixture)
    snapshot,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC_DIR = os.path.join(ROOT, "tests", "specs")
SPEC_FILES = sorted(f for f in os.listdir(SPEC_DIR) if f.endswith(".toml"))
SEED = 7

#: The workloads whose modules the port does not have, by ``testName``.
UNPORTED = {
    "BackupRestore": "runtime/backup.py",
    "DDBalance": "runtime/data_distribution.py",
    "Tenants": "client/tenant.py",
    "Authz": "runtime/authz.py",
    "ZipfRepair": "repair/engine.py",
    "FailoverZipfRepair": "repair/engine.py",
    "ConsistencyCheck": "consistency/checker.py",
    "TaskBucket": "layers/taskbucket.py",
}


@pytest.fixture(autouse=True)
def jax_made_deterministic(monkeypatch):
    order_jax_kills(monkeypatch)


def port_specs():
    return mod(PKGS[1], "sim.specs")


def needs(test: dict) -> str | None:
    """The module a ``[[test]]`` table waits for, or None if it is ported."""
    for w in test.get("workload", []):
        if w["testName"] in UNPORTED:
            return UNPORTED[w["testName"]]
    if test.get("cluster", {}).get("authz"):
        return "runtime/authz.py"
    if test.get("cluster", {}).get("dataDistribution"):
        return "runtime/data_distribution.py"
    return None


def spec_tests():
    """(file, index, title, module needed or None) of every ``[[test]]``."""
    out = []
    for f in SPEC_FILES:
        doc = port_specs().load_doc(os.path.join(SPEC_DIR, f))
        for i, t in enumerate(doc.get("test", [])):
            out.append((f, i, t.get("testTitle", "untitled"), needs(t)))
    return out


SPEC_TESTS = spec_tests()
PORTED = [(f, i, t) for f, i, t, n in SPEC_TESTS if n is None]
REFUSED = [(f, i, t, n) for f, i, t, n in SPEC_TESTS if n is not None]


def describe(spec) -> dict:
    """A spec's parse: its knobs, cluster options and workloads."""
    return norm({
        "title": spec.title, "kill_interval": spec.kill_interval,
        "partition_interval": spec.partition_interval,
        "max_kills": spec.max_kills,
        "include_controller": spec.include_controller,
        "clog_interval": spec.clog_interval, "buggify": spec.buggify,
        "buggify_aggressive": spec.buggify_aggressive,
        "cluster_opts": spec.cluster_opts,
        "workloads": [(type(w).__name__, {k: v for k, v in vars(w).items()
                                          if k != "metrics"})
                      for w in spec.workloads]})


# -- the tuple layer ----------------------------------------------------------


def tuple_mods(pkg: str):
    return mod(pkg, "layers.tuple_layer")


def int_edges() -> list[int]:
    """Integers at the encoding's size boundaries, both signs."""
    out = [0]
    for n in range(1, 10):
        top = (1 << (8 * n)) - 1
        out += [top - 1, top, top + 1]
    out += [2**63 - 1, 2**63, 2**64 - 1, 2**64, 2**100, 2**2039]
    return sorted(set(out + [-v for v in out]))


def random_tuple(T, rng: np.random.RandomState, depth: int = 0) -> tuple:
    """A tuple of random elements of every type the layer encodes."""
    edges = int_edges()
    items = []
    for _ in range(rng.randint(0, 6)):
        kind = rng.randint(0, 12 if depth < 2 else 11)
        if kind == 0:
            items.append(None)
        elif kind == 1:
            items.append(int(edges[rng.randint(len(edges))]))
        elif kind == 2:
            items.append(int(rng.randint(-2**31, 2**31)))
        elif kind == 3:
            items.append(bytes(rng.choice([0, 1, 0xFF, 0x41, 0x7F],
                                          rng.randint(0, 8)).tolist()))
        elif kind == 4:
            items.append("".join(chr(c) for c in rng.choice(
                [0, 0x41, 0xE9, 0x3B1, 0x1F600], rng.randint(0, 6))))
        elif kind == 5:
            items.append(float(rng.choice(
                [0.0, -0.0, 1.5, -2.25, 1e300, -1e-300, float("inf"),
                 float("-inf"), rng.standard_normal() * 1e6])))
        elif kind == 6:
            items.append(T.SingleFloat(float(rng.choice([0.5, -3.25, 1e30]))))
        elif kind == 7:
            items.append(bool(rng.randint(2)))
        elif kind == 8:
            items.append(uuid.UUID(bytes=rng.bytes(16)))
        elif kind == 9:
            items.append(T.Versionstamp(rng.bytes(10),
                                        int(rng.randint(0, 1 << 16))))
        elif kind == 10:
            items.append(b"\x00\xff" * int(rng.randint(1, 3)))
        else:
            items.append(random_tuple(T, rng, depth + 1))
    return tuple(items)


def plain(x):
    """A tuple's value with the layer's classes by name and value."""
    if isinstance(x, tuple):
        return ["tuple", [plain(v) for v in x]]
    if type(x).__name__ == "Versionstamp":
        return ["vs", x.tr_version, x.user_version]
    if type(x).__name__ == "SingleFloat":
        return ["f32", x.value]
    return [type(x).__name__, repr(x)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tuple_layer_on_random_tuples_equals_jax(seed):
    got = {}
    for pkg in PKGS:
        T = tuple_mods(pkg)
        rng = np.random.RandomState(seed)
        rows = []
        for _ in range(200):
            t = random_tuple(T, rng)
            b = T.pack(t)
            assert T.pack(T.unpack(b)) == b
            rows.append((b, plain(T.unpack(b)), T.range_of(t)))
        # An incomplete stamp at a random place, with and without a prefix.
        for _ in range(20):
            t = list(random_tuple(T, rng, 2))
            t.insert(rng.randint(len(t) + 1),
                     T.Versionstamp(user_version=int(rng.randint(1 << 16))))
            rows.append(T.pack_with_versionstamp(tuple(t),
                                                 prefix=rng.bytes(3)))
        got[pkg] = rows
    assert got[PKGS[1]] == got[PKGS[0]]


def layer_samples(T) -> list[tuple]:
    """The round-trip samples of ``tests/test_layers.py``."""
    return [
        (), (None,), (b"",), (b"\x00",), (b"foo\x00bar",), ("",),
        ("héllo",), ("a\x00b",), (0,), (1,), (-1,), (255,), (256,),
        (-255,), (-256,), (2**63 - 1,), (-(2**63),), (2**100,),
        (-(2**100),), (1.5,), (-1.5,), (0.0,), (float("inf"),),
        (float("-inf"),), (T.SingleFloat(2.5),), (True,), (False,),
        (uuid.UUID(int=0x1234567890ABCDEF1234567890ABCDEF),),
        (T.Versionstamp(b"\x00" * 10, 7),), ((1, b"nested", None),),
        ((1, (2, (3,))),), (1, "two", b"three", (4, None), 5.0)]


def test_layers_tuple_cases_equal_jax():
    """``tests/test_layers.py``'s tuple, versionstamp and subspace cases in
    the port, each packed key equal to JAX's."""
    J, P = tuple_mods(PKGS[0]), tuple_mods(PKGS[1])
    for a, b in zip(layer_samples(J), layer_samples(P)):
        assert P.pack(b) == J.pack(a)
        assert P.unpack(P.pack(b)) == b
    assert P.unpack(P.pack((True,))) == (True,)
    assert P.unpack(P.pack((1,)))[0] is not True
    (f,) = P.unpack(P.pack((P.SingleFloat(3.25),)))
    assert isinstance(f, P.SingleFloat) and f.value == 3.25
    vals = list(range(-300, 301))
    assert [P.pack((v,)) for v in vals] == sorted(P.pack((v,)) for v in vals)
    rng = np.random.RandomState(7)
    wide = sorted(int(v) << 20 for v in rng.randint(-2**60, 2**60, 500))
    assert [P.pack((v,)) for v in wide] == sorted(P.pack((v,)) for v in wide)
    assert [P.pack((v,)) for v in wide] == [J.pack((v,)) for v in wide]
    assert P.pack((1,)) < P.pack((1, 0)) < P.pack((2,))
    begin, end = P.range_of((1,))
    assert (begin, end) == J.range_of((1,))
    assert begin <= P.pack((1, b"x")) < end and not begin <= P.pack((1,)) < end
    with pytest.raises(P.TupleError):
        P.pack((P.Versionstamp(),))
    with pytest.raises(P.TupleError):
        P.pack_with_versionstamp((P.Versionstamp(), P.Versionstamp()))
    b = P.pack_with_versionstamp(("k", P.Versionstamp(user_version=3)),
                                 prefix=b"pfx")
    assert b == J.pack_with_versionstamp(
        ("k", J.Versionstamp(user_version=3)), prefix=b"pfx")
    s = P.Subspace(("app", 1))
    k = s.pack(("x", 2))
    assert k == J.Subspace(("app", 1)).pack(("x", 2))
    assert s.contains(k) and s.unpack(k) == ("x", 2)
    with pytest.raises(P.TupleError):
        s.unpack(b"zzz")
    assert P.Subspace(("a",))["b"][3].key() == P.pack(("a", "b", 3))
    from foundationdb_tpu_torch import layers

    assert layers.strinc(b"a\xff\xff") == b"b"
    assert sorted(layers.__all__) == sorted(
        n for n in mod(PKGS[0], "layers").__all__ if not n.startswith("Dir")
        and n != "HighContentionAllocator")


# -- parsing ------------------------------------------------------------------


@pytest.mark.parametrize("spec_file", SPEC_FILES)
def test_load_spec_equals_jax(spec_file):
    path = os.path.join(SPEC_DIR, spec_file)
    want = mod(PKGS[0], "sim.specs").load_spec(path)
    S = port_specs()
    tests = S.load_doc(path)["test"]
    assert [t.get("testTitle", "untitled") for t in tests] == \
        [s.title for s in want]
    refused = False
    for t, w in zip(tests, want):
        module = needs(t)
        if module is None:
            assert describe(S.load_test(t)) == describe(w)
            continue
        refused = True
        with pytest.raises(NotImplementedError, match=re.escape(module)):
            SimCluster = mod(PKGS[1], "sim.cluster").SimCluster
            spec = S.load_test(t)
            SimCluster(seed=0, engine="oracle", device="cpu",
                       **S.cluster_kwargs(spec))
    if refused:
        with pytest.raises(NotImplementedError, match="not ported"):
            for s in S.load_spec(path):
                mod(PKGS[1], "sim.cluster").SimCluster(
                    seed=0, engine="oracle", device="cpu",
                    **S.cluster_kwargs(s))
    else:
        assert [describe(s) for s in S.load_spec(path)] == \
            [describe(s) for s in want]


def test_refused_arms_name_their_module():
    S = port_specs()
    with pytest.raises(NotImplementedError, match="runtime/authz.py"):
        S.cluster_kwargs_from_table({"storages": 2, "authz": True})
    with pytest.raises(NotImplementedError, match="runtime/authz.py"):
        S.load_spec("""
[[test]]
[test.cluster]
authz = true
[[test.workload]]
testName = 'Cycle'
""")
    W = mod(PKGS[1], "sim.workloads")
    for name, module in UNPORTED.items():
        cls = S.WORKLOAD_REGISTRY[name][0]
        assert cls is getattr(W, cls.__name__)
        with pytest.raises(NotImplementedError, match=re.escape(module)):
            cls(seed=1)
    assert set(S.WORKLOAD_REGISTRY) == set(
        mod(PKGS[0], "sim.specs").WORKLOAD_REGISTRY)
    for name, (cls, mapping) in S.WORKLOAD_REGISTRY.items():
        jcls, jmap = mod(PKGS[0], "sim.specs").WORKLOAD_REGISTRY[name]
        assert (cls.__name__, mapping) == (jcls.__name__, jmap)
    assert S.CLUSTER_KEY_MAP == mod(PKGS[0], "sim.specs").CLUSTER_KEY_MAP
    assert S.BASE_CLUSTER == mod(PKGS[0], "sim.specs").BASE_CLUSTER


def test_load_spec_maps_params():
    (spec,) = port_specs().load_spec("""
[[test]]
testTitle = 'T'
[[test.workload]]
testName = 'Cycle'
nodeCount = 7
transactionCount = 11
""")
    (w,) = spec.workloads
    assert w.n_nodes == 7 and w.n_txns == 11


def test_unknown_workload_rejected():
    with pytest.raises(ValueError):
        port_specs().load_spec("""
[[test]]
[[test.workload]]
testName = 'NoSuchWorkload'
""")


def test_spec_knobs_arm_buggify_and_clog():
    (spec,) = port_specs().load_spec("""
[[test]]
testTitle = 'T'
buggify = true
clogInterval = 0.4
[[test.workload]]
testName = 'Cycle'
transactionCount = 5
""")
    assert spec.buggify is True and spec.clog_interval == 0.4


# -- every ported [[test]] of tests/specs -------------------------------------


def record_faults(monkeypatch) -> dict:
    """Each package's ``FaultInjector``s, as ``run_spec_test`` makes them."""
    made = {p: [] for p in PKGS}

    def recording(pkg):
        S = mod(pkg, "sim.specs")

        class Recorded(S.FaultInjector):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made[pkg].append(self)

        monkeypatch.setattr(S, "FaultInjector", Recorded)

    for p in PKGS:
        recording(p)
    return made


def spec_case(pkg: str, spec_file: str, index: int, seed: int, made: dict,
              engine: str = "oracle") -> dict:
    """One ``[[test]]`` on a fresh cluster, as ``run_one`` builds it."""
    S = mod(pkg, "sim.specs")
    path = os.path.join(SPEC_DIR, spec_file)
    kw = {"engine": engine}
    if pkg == PKGS[1]:
        spec = S.load_test(S.load_doc(path)["test"][index])
        kw["device"] = "cpu"
    else:
        spec = S.load_spec(path)[index]
    c = mod(pkg, "sim.cluster").SimCluster(seed=seed,
                                           **{**kw, **S.cluster_kwargs(spec)})
    db = mod(pkg, "client.ryw").open_database(c)
    made[pkg].clear()
    r = c.loop.run(S.run_spec_test(spec, c, db), timeout=3000)
    return {"title": r.title,
            "metrics": {n: vars(m) for n, m in r.metrics.items()},
            "kills": r.kills,
            "faults": [{"kills": f.kills, "partitions": f.partitions,
                        "clogs": f.clogs} for f in made[pkg]],
            "buggify_sites": sorted(c.loop._buggify_sites.items()),
            **snapshot(c)}


@pytest.mark.parametrize("spec_file,index,title", PORTED,
                         ids=[f"{f[:-5]}-{t}" for f, _, t in PORTED])
def test_spec_test_equals_jax(monkeypatch, spec_file, index, title):
    made = record_faults(monkeypatch)
    got = same(lambda pkg: spec_case(pkg, spec_file, index, SEED, made))
    assert got["title"] == title and got["metrics"]
    for name, m in got["metrics"].items():
        assert m["txns_committed"] > 0, name


def test_every_spec_test_is_ported_or_refused():
    """What the port cannot run yet, each with the module it waits for."""
    assert len(PORTED) == 27
    assert {(f, t): n for f, _, t, n in REFUSED} == {
        ("Authz.toml", "AuthzClean"): "runtime/authz.py",
        ("Authz.toml", "AuthzUnderFaults"): "runtime/authz.py",
        ("BackupRestore.toml", "BackupRestoreClean"): "runtime/backup.py",
        ("BackupRestore.toml", "BackupRestoreBuggify"): "runtime/backup.py",
        ("Chaos.toml", "ChaosDDMoves"): "runtime/data_distribution.py",
        ("ConsistencyCheck.toml", "ConsistencyAuditReplicated"):
            "consistency/checker.py",
        ("DDBalance.toml", "DDBalance"): "runtime/data_distribution.py",
        ("MultiRegion.toml", "AuthzAcrossRegionFailover"): "runtime/authz.py",
        ("Tenants.toml", "TenantsClean"): "client/tenant.py",
        ("Tenants.toml", "TenantsUnderFaults"): "client/tenant.py",
        ("ZipfRepair.toml", "ZipfRepairContention"): "repair/engine.py",
        ("ZipfRepair.toml", "ZipfNaiveBaseline"): "repair/engine.py",
        ("ZipfRepair.toml", "ZipfRepairMultiResolver"): "repair/engine.py"}


# -- tests/test_workloads.py and tests/test_clog_buggify.py -------------------


def pkg_ns(pkg: str) -> SimpleNamespace:
    return SimpleNamespace(
        pkg=pkg, W=mod(pkg, "sim.workloads"), S=mod(pkg, "sim.specs"),
        SimCluster=mod(pkg, "sim.cluster").SimCluster,
        open_database=mod(pkg, "client.ryw").open_database,
        fetch_status=mod(pkg, "runtime.status").fetch_status)


def make_db(R, seed: int, **kw):
    kw.setdefault("engine", "oracle")
    if R.pkg == PKGS[1]:
        kw.setdefault("device", "cpu")
    c = R.SimCluster(seed=seed, **kw)
    return c, R.open_database(c)


def ended(c, m=None, **more) -> dict:
    return {"metrics": vars(m) if m is not None else None, **more,
            **snapshot(c)}


def _cycle(R):
    c, db = make_db(R, 21, n_resolvers=2, n_storages=2)
    m = c.loop.run(R.W.run_workload(c, db, R.W.CycleWorkload(
        n_nodes=12, n_txns=40)), timeout=3000)
    assert m.txns_committed >= 40
    return ended(c, m)


def _atomic_ops(R):
    c, db = make_db(R, 22, n_storages=2)
    m = c.loop.run(R.W.run_workload(c, db, R.W.AtomicOpsWorkload(n_txns=40)),
                   timeout=3000)
    assert m.ops == 120
    return ended(c, m)


def _random_rw(R):
    c, db = make_db(R, 23, n_proxies=2, n_storages=2)
    m = c.loop.run(R.W.run_workload(c, db, R.W.RandomReadWriteWorkload(
        n_txns=60)), timeout=3000)
    assert m.ops == 60
    return ended(c, m)


def _conflict_range_bank(R):
    c, db = make_db(R, 24, n_resolvers=2)
    m = c.loop.run(R.W.run_workload(c, db, R.W.ConflictRangeWorkload(
        n_txns=32)), timeout=3000)
    assert m.txns_committed >= 32 and m.txns_retried > 0
    return ended(c, m)


def _cycle_with_faults(seed):
    def script(R):
        c, db = make_db(R, seed, n_tlogs=2, n_storages=2)
        w = R.W.CycleWorkload(seed, n_nodes=10, n_txns=32, n_clients=4)
        f = R.W.FaultInjector(c, kill_interval=0.25, partition_interval=0.3,
                              max_kills=2)
        m = c.loop.run(R.W.run_workload(c, db, w, faults=f), timeout=3000)
        assert m.txns_committed >= 32 and f.kills

        async def wait_recovery():
            while c.controller.generation.epoch < 2:
                await c.loop.sleep(0.05)
            return c.controller.generation.epoch

        assert c.loop.run(wait_recovery(), timeout=3000) >= 2
        return ended(c, m, kills=f.kills, partitions=f.partitions)

    return script


def _atomic_ops_with_faults(R):
    c, db = make_db(R, 33, n_tlogs=2)
    f = R.W.FaultInjector(c, kill_interval=0.3, partition_interval=0.3,
                          max_kills=1)
    m = c.loop.run(R.W.run_workload(c, db, R.W.AtomicOpsWorkload(
        33, n_txns=32), faults=f), timeout=3000)
    assert m.ops == 96
    return ended(c, m, kills=f.kills, partitions=f.partitions)


def _bank_with_faults(R):
    c, db = make_db(R, 34, n_tlogs=2, n_resolvers=2)
    f = R.W.FaultInjector(c, kill_interval=0.3, partition_interval=0.3,
                          max_kills=1)
    m = c.loop.run(R.W.run_workload(c, db, R.W.ConflictRangeWorkload(
        34, n_txns=24), faults=f), timeout=3000)
    assert m.txns_committed >= 24
    return ended(c, m, kills=f.kills, partitions=f.partitions)


def _status_document_shape(R):
    c, db = make_db(R, 41, n_proxies=2, n_resolvers=2, n_tlogs=2)

    async def main():
        await R.W.run_workload(c, db, R.W.RandomReadWriteWorkload(
            n_txns=20, write_fraction=1.0))
        doc = await R.fetch_status(c)
        assert doc["cluster"]["recovery_state"]["name"] == "fully_recovered"
        assert doc["workload"]["transactions"]["committed"] >= 20
        assert doc["workload"]["resolver"]["txns"] >= 20
        assert {p["role"] for p in doc["processes"].values()} == {
            "grv_proxy", "commit_proxy", "resolver", "tlog", "storage",
            "sequencer"}
        json.dumps(doc)
        return _mask(doc)

    return ended(c, doc=c.loop.run(main(), timeout=3000))


def _status_marks_dead_process(R):
    c, db = make_db(R, 42, n_proxies=2)

    async def main():
        c.net.kill("grv_proxy0")
        doc = await R.fetch_status(c)
        assert doc["processes"]["grv_proxy0"]["reachable"] is False
        assert doc["processes"]["grv_proxy1"]["reachable"] is True
        return _mask(doc)

    return ended(c, doc=c.loop.run(main(), timeout=3000))


def _status_during_recovery_epoch(R):
    c, db = make_db(R, 43)

    async def main():
        c.net.kill("master")
        while c.controller.generation.epoch < 2:
            await c.loop.sleep(0.25)

        async def body(tr):
            tr.set(b"s", b"1")

        await db.run(body)
        doc = await R.fetch_status(c)
        assert doc["cluster"]["recovery_state"]["epoch"] == 2
        assert doc["cluster"]["controller"]["recoveries_completed"] == 1
        return _mask(doc)

    return ended(c, doc=c.loop.run(main(), timeout=3000))


def _clogged_link_delivers_late(R):
    c, db = make_db(R, 201)

    async def main():
        tr = db.transaction()
        tr.set(b"k", b"v")
        await tr.commit()
        tag = c.storage_map.tag_for_key(b"k")
        c.net.clog("<main>", f"storage{tag}", factor=200.0, duration=0.5)
        t0 = c.loop.now
        assert await db.transaction().get(b"k") == b"v"
        took = c.loop.now - t0
        assert took > 0.01, took
        await c.loop.sleep(0.6)
        t1 = c.loop.now
        assert await db.transaction().get(b"k") == b"v"
        assert c.loop.now - t1 < took
        return took

    return ended(c, took=c.loop.run(main(), timeout=120))


def _cycle_under_clogging(R):
    c, db = make_db(R, 202, n_tlogs=2, n_storages=2)
    w = R.W.CycleWorkload(202, n_nodes=8, n_txns=24, n_clients=3)
    f = R.W.FaultInjector(c, max_kills=0, partition_interval=1e9,
                          clog_interval=0.02, clog_factor=100.0)
    m = c.loop.run(R.W.run_workload(c, db, w, faults=f), timeout=600)
    assert m.txns_committed >= 24 and f.clogs >= 1
    return ended(c, m, clogs=f.clogs)


def _clog_catches_stale_read(R):
    """The injected bug of ``test_clog_buggify.py``: a storage server that
    answers reads without waiting for the read version; the seeded clog
    schedule must expose it through the cycle check."""
    c, db = make_db(R, 203, n_tlogs=2, n_storages=2)

    async def skip_version_check(version):
        return None

    for s in c.storages:
        s._check_version = skip_version_check
    w = R.W.CycleWorkload(203, n_nodes=8, n_txns=30, n_clients=3)

    async def clogger():
        while c.storages[0].map.latest(b"cycle/%06d" % 7) is None:
            await c.loop.sleep(0.01)
        for _ in range(20):
            c.net.clog("storage0", "tlog0", factor=5000.0, duration=0.2)
            c.net.clog("storage0", "tlog1", factor=5000.0, duration=0.2)
            await c.loop.sleep(0.25)

    async def main():
        await w.setup(db)
        target = await c.sequencer.get_live_committed_version()
        while any(s._version < target for s in c.storages):
            await c.loop.sleep(0.01)
        t = c.loop.spawn(clogger(), name="clogger")
        await w.run(db, c)
        await t
        target = await c.sequencer.get_live_committed_version()
        while c.storages[0]._version < target:
            await c.loop.sleep(0.05)
        await w.check(db)

    with pytest.raises(R.W.WorkloadFailed) as e:
        c.loop.run(main(), timeout=600)
    return ended(c, w.metrics, caught=str(e.value))


def _buggify_disabled_and_deterministic(R):
    c, _ = make_db(R, 204)
    assert c.loop.buggify("any.site") is False
    assert not c.loop._buggify_sites
    c.loop.buggify_enabled = True
    first = c.loop.buggify("site.a")
    c2, _ = make_db(R, 204)
    c2.loop.buggify_enabled = True
    assert c2.loop.buggify("site.a") == first
    return {"first": first, "sites": sorted(c.loop._buggify_sites.items())}


def _invariants_with_buggify(R):
    c, db = make_db(R, 205, n_tlogs=2, n_storages=2)
    c.loop.buggify_enabled = True
    m = c.loop.run(R.W.run_workload(c, db, R.W.RandomReadWriteWorkload(
        205, n_keys=24, n_txns=40, n_clients=4)), timeout=600)
    assert m.txns_committed >= 40 and c.loop._buggify_sites
    return ended(c, m, sites=sorted(c.loop._buggify_sites.items()))


def _tpcc_catches_corrupt_stock(R):
    """``tests/test_specs.py``'s injected bug: a corrupt stock cell."""
    import struct

    c, db = make_db(R, 5, n_tlogs=1)
    w = R.W.TPCCNewOrderWorkload(5, n_txns=10, n_clients=2)

    async def main():
        await w.setup(db)
        await w.run(db, c)
        tr = db.transaction()
        tr.set(w.k_stock(0), struct.pack("<q", 10**6))
        await tr.commit()
        try:
            await w.check(db)
            return "checker missed it"
        except R.W.WorkloadFailed as e:
            return f"caught: {e}"

    got = c.loop.run(main(), timeout=600)
    assert got.startswith("caught")
    return ended(c, w.metrics, got=got)


WORKLOAD_CASES = {
    "cycle": _cycle, "atomic_ops": _atomic_ops, "random_rw": _random_rw,
    "conflict_range_bank": _conflict_range_bank,
    "cycle_with_faults_31": _cycle_with_faults(31),
    "cycle_with_faults_32": _cycle_with_faults(32),
    "atomic_ops_with_faults": _atomic_ops_with_faults,
    "bank_with_faults": _bank_with_faults,
    "status_document_shape": _status_document_shape,
    "status_marks_dead_process": _status_marks_dead_process,
    "status_during_recovery_epoch": _status_during_recovery_epoch,
    "clogged_link_delivers_late": _clogged_link_delivers_late,
    "cycle_under_clogging": _cycle_under_clogging,
    "clog_catches_stale_read": _clog_catches_stale_read,
    "buggify_disabled_and_deterministic": _buggify_disabled_and_deterministic,
    "invariants_with_buggify": _invariants_with_buggify,
    "tpcc_catches_corrupt_stock": _tpcc_catches_corrupt_stock,
}


@pytest.mark.parametrize("name", list(WORKLOAD_CASES))
def test_workload_case_equals_jax(name):
    same(lambda pkg: WORKLOAD_CASES[name](pkg_ns(pkg)))


# -- the runner -----------------------------------------------------------------


@pytest.mark.parametrize("spec_file", ["Cycle.toml", "Chaos.toml"])
@pytest.mark.parametrize("seed", [3, 11])
def test_run_one_equals_jax(spec_file, seed):
    path = os.path.join(SPEC_DIR, spec_file)
    _, _, want, camp = mod(PKGS[0], "sim.run").run_one(path, seed, False,
                                                       None)
    _, _, got = mod(PKGS[1], "sim.run").run_one(
        path, seed, False, None, engine="oracle", device="cpu")
    assert [r[0] for r in got] == [r[0] for r in want]
    refused = {t: n for f, _, t, n in REFUSED if f == spec_file}
    for (title, ok, detail), w in zip(got, want):
        if title in refused:
            assert not ok and "NotImplementedError" in detail
            assert refused[title] in detail
            continue
        assert (title, ok, detail) == w[:3]
        assert ok
    assert camp is False


def test_campaigns_refused():
    R = mod(PKGS[1], "sim.run")
    camp = os.path.join(SPEC_DIR, "campaigns")
    path = os.path.join(camp, sorted(os.listdir(camp))[0])
    with pytest.raises(NotImplementedError, match="sim/campaigns.py"):
        R.run_one(path, 0, False, None, engine="oracle", device="cpu")
    with pytest.raises(NotImplementedError, match="sim/nemesis.py"):
        R.main(["--campaigns", "fast"])
    with pytest.raises(NotImplementedError, match="sim/campaigns.py"):
        R.main([path, "--device", "cpu", "--engine", "oracle"])


def test_command_line_on_the_cpu(tmp_path):
    """``python -m foundationdb_tpu_torch.sim.run`` with ``--device cpu
    --engine oracle``: one line a test, its summary JSON line last."""
    out = subprocess.run(
        [sys.executable, "-m", "foundationdb_tpu_torch.sim.run",
         os.path.join(SPEC_DIR, "Cycle.toml"),
         os.path.join(SPEC_DIR, "Tenants.toml"), "--seeds", "1",
         "--seed-base", "3", "--jobs", "1", "--device", "cpu",
         "--engine", "oracle"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    lines = out.stdout.strip().splitlines()
    summary = json.loads(lines[-1])
    assert out.returncode == 1, out.stderr
    assert summary["metric"] == "sim_specs" and not summary["ok"]
    assert summary["runs"] == 2 and summary["completed"] == 2
    assert {f["title"] for f in summary["failures"]} == {
        "TenantsClean", "TenantsUnderFaults"}
    assert any("ok   " in x and "CycleWithFaults" in x for x in lines)
    assert "client/tenant.py" in out.stdout
    assert "--engine oracle --device cpu" in summary["failures"][0]["replay"]


# -- real engines -------------------------------------------------------------


@pytest.mark.parametrize("spec_file,index", [("Cycle.toml", 0),
                                             ("Mixed.toml", 0),
                                             ("Mixed.toml", 1)])
def test_spec_over_real_engines_equals_jax(monkeypatch, small_engines,
                                           spec_file, index):
    made = record_faults(monkeypatch)
    jx = spec_case(PKGS[0], spec_file, index, SEED, made, engine="tpu")
    pt = spec_case(PKGS[1], spec_file, index, SEED, made, engine="torch")
    assert norm(pt) == norm(jx)


# -- no hidden fallback ---------------------------------------------------------


def test_runner_builds_on_the_card():
    """Without a device the port's runner builds every cluster on ``cuda``:
    with no card it raises, and nothing falls back to the CPU. A fresh
    ``[test.cluster]`` cluster of ``run_spec`` takes the caller's device."""
    R, S = mod(PKGS[1], "sim.run"), port_specs()
    Loop = mod(PKGS[1], "runtime.flow").Loop
    path = os.path.join(SPEC_DIR, "Cycle.toml")
    caller = SimpleNamespace(loop=Loop(seed=0), engine="torch", device=None)
    table = os.path.join(SPEC_DIR, "Chaos.toml")
    if torch.cuda.is_available():
        _, _, out = R.run_one(path, 0, False, None)
        assert out and all(ok for _, ok, _ in out)
        return
    with pytest.raises(RuntimeError, match="CUDA card"):
        R.run_one(path, 0, False, None)
    with pytest.raises(RuntimeError, match="CUDA card"):
        R.run_one(path, 0, False, None, engine="oracle")
    text = open(table).read().split("[[test]]")[1]
    with pytest.raises(RuntimeError, match="CUDA card"):
        S.run_spec("[[test]]" + text, caller, None)
    caller.device, caller.engine = "cpu", "oracle"
    (r,) = S.run_spec("[[test]]" + text, caller, None)
    assert r.title == "ChaosCycle" and r.kills
