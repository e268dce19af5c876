"""Durability in the port against the JAX package: the tlog disk queues,
the storage engines behind the MVCC window and the whole-cluster restart
from disk (``runtime/kvstore.py``, ``native/btree.cpp``, ``sim/cluster.py``
``data_dir``).

Every case of ``tests/test_durability.py`` runs in both packages, as its
JAX source stands, with only the package name rewritten (``jax_case``):
the port's clusters are built on the CPU with oracle engines, as the JAX
defaults are, and each package writes under its own directory. Both must
pass the case's own checks, and then must be equal in:

- every cluster the case built: its epoch and recovery version, the
  restart it read from ``cluster.json`` and the tlog disk queues
  (``_bootstrap_args``), every storage server's version chains at its
  last version and its durable version, the shard map, the trace events
  and ``loop.now`` (``cluster_record``);
- every file it left: redwood files and disk queues byte for byte, sqlite
  stores row for row, ``cluster.json`` by value (``files_record``);
- every store it left, opened by either package's engine (``cross_open``).

Beyond the JAX cases: a cluster written by one package restarts in the
other; and the restart scenario with the real engines, JAX
``TPUConflictSet`` against ``TorchConflictSet(device="cpu")``.

``jax_case`` is shared by ``tests/test_torch_kvstore.py``,
``tests/test_torch_authz.py`` and ``tests/test_torch_data_distribution.py``.
"""

import hashlib
import inspect
import json
import os
import random
import sqlite3
import types

import pytest

from tests.test_torch_cluster import (
    PKGS,
    mod,
    norm,
    order_jax_kills,
    small_engines,  # noqa: F401  (a fixture)
    snapshot,
)

TESTS = os.path.dirname(os.path.abspath(__file__))
SQLITE_MAGIC = b"SQLite format 3\x00"


@pytest.fixture(autouse=True)
def jax_made_deterministic(monkeypatch):
    order_jax_kills(monkeypatch)


# -- running a JAX test file's case in both packages --------------------------

_MODULES: dict = {}


def source_module(name: str, pkg: str) -> types.ModuleType:
    """``tests/<name>.py`` for ``pkg``: its source with every
    ``foundationdb_tpu.`` import rewritten to the port's for the port, and
    its fixtures as plain functions."""
    key = (name, pkg)
    if key not in _MODULES:
        path = os.path.join(TESTS, f"{name}.py")
        src = open(path).read().replace("@pytest.fixture\n", "")
        if pkg == PKGS[1]:
            src = src.replace("foundationdb_tpu.", "foundationdb_tpu_torch.")
        m = types.ModuleType(f"_{pkg}_{name}")
        m.__file__ = path
        exec(compile(src, path, "exec"), m.__dict__)
        _MODULES[key] = m
    return _MODULES[key]


def seeded_keypair(pkg: str):
    """``generate_keypair`` made deterministic: the n-th call of a case
    returns the Ed25519 key of seed sha256("key<n>"), the same in both
    packages (the JAX function draws a random key)."""
    ed = mod(pkg, "runtime._ed25519")
    n = [0]

    def generate_keypair():
        n[0] += 1
        return ed.generate_keypair_pem(
            hashlib.sha256(b"key%d" % n[0]).digest())

    return generate_keypair


def instrument(monkeypatch, pkg: str, m, made: list, boots: list) -> None:
    """Record every ``SimCluster`` and its restart arguments; the port's
    clusters and bare storage servers default to oracle engines on the
    CPU; keys are drawn from a seed; ``os.urandom`` too."""
    sim = mod(pkg, "sim.cluster")
    init, boot = sim.SimCluster.__init__, sim.SimCluster._bootstrap_args
    port = pkg == PKGS[1]

    def cluster_init(self, *a, **kw):
        if port:
            kw.setdefault("engine", "oracle")
            kw.setdefault("device", "cpu")
        init(self, *a, **kw)
        made.append(self)

    def bootstrap_args(self):
        out = boot(self)
        boots.append(out)
        return out

    monkeypatch.setattr(sim.SimCluster, "__init__", cluster_init)
    monkeypatch.setattr(sim.SimCluster, "_bootstrap_args", bootstrap_args)
    if port:
        st = mod(pkg, "runtime.storage").StorageServer
        sinit = st.__init__

        def storage_init(self, *a, **kw):
            kw.setdefault("device", "cpu")
            sinit(self, *a, **kw)

        monkeypatch.setattr(st, "__init__", storage_init)
    keypair = seeded_keypair(pkg)
    monkeypatch.setattr(mod(pkg, "runtime.authz"), "generate_keypair",
                        keypair)
    if hasattr(m, "generate_keypair"):
        monkeypatch.setattr(m, "generate_keypair", keypair)
    monkeypatch.setattr(os, "urandom", random.Random(0).randbytes)


def cluster_record(c) -> dict:
    """What a cluster leaves behind (``test_torch_cluster.snapshot``), its
    storages' durable versions and its shard map."""
    return {**snapshot(c),
            "durable": [s._durable_version for s in c.storages],
            "shards": [(sh.range.begin, sh.range.end, list(sh.team))
                       for sh in c.storage_map.shards]}


def store_kind(path: str) -> str | None:
    with open(path, "rb") as f:
        head = f.read(16)
    if head == SQLITE_MAGIC:
        return "sqlite"
    return "redwood" if path.endswith((".rw", ".db")) else None


def sqlite_rows(path: str):
    db = sqlite3.connect(path)
    try:
        meta = db.execute("SELECT k, v FROM meta ORDER BY k").fetchall()
        rows = db.execute("SELECT k, v FROM kv ORDER BY k").fetchall()
        return meta, [(bytes(k), bytes(v)) for k, v in rows]
    finally:
        db.close()


def files_record(root: str) -> dict:
    """Every file under ``root``: sqlite stores by their rows, cluster.json
    by value, every other file by its bytes."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in sorted(files):
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, root)
            if store_kind(path) == "sqlite":
                out[rel] = ["sqlite", sqlite_rows(path)]
            elif f == "cluster.json":
                out[rel] = ["json", json.load(open(path))]
            else:
                out[rel] = ["sha256", hashlib.sha256(
                    open(path, "rb").read()).hexdigest()]
    return out


def open_load(pkg: str, path: str, engine: str):
    """``make_kvstore(path, engine).load()`` in ``pkg``, or how it failed."""
    K = mod(pkg, "runtime.kvstore")
    try:
        kv = K.make_kvstore(path, engine)
    except OSError as e:
        return ["refused", type(e).__name__]
    try:
        return ["ok", kv.load()]
    except OSError as e:
        return ["corrupt", type(e).__name__]
    finally:
        kv.close()


def cross_open(roots: dict) -> int:
    """Open every store a case left in either package's directory with
    both packages' engines: the four loads must be equal. Returns the
    number of stores."""
    n = 0
    jax_root = roots[PKGS[0]]
    for dirpath, _dirs, files in os.walk(jax_root):
        for f in sorted(files):
            rel = os.path.relpath(os.path.join(dirpath, f), jax_root)
            paths = {p: os.path.join(roots[p], rel) for p in PKGS}
            kind = store_kind(paths[PKGS[0]])
            if kind is None:
                continue
            loads = [norm(open_load(reader, paths[writer], kind))
                     for writer in PKGS for reader in PKGS]
            assert all(x == loads[0] for x in loads), (rel, loads)
            n += 1
    return n


def jax_case(monkeypatch, tmp_path, name: str, qualname: str) -> dict:
    """Run ``tests/<name>.py::<qualname>`` in both packages (the port's
    copy rewritten by ``source_module``) and hold the port to JAX: both
    pass, and their clusters, files and stores are equal. Returns the
    port's record."""
    records, roots = {}, {}
    for pkg in PKGS:
        m = source_module(name, pkg)
        made, boots = [], []
        instrument(monkeypatch, pkg, m, made, boots)
        owner, _, fn_name = qualname.rpartition(".")
        fn = getattr(getattr(m, owner)() if owner else m, fn_name)
        roots[pkg] = str(tmp_path / pkg.rsplit("_", 1)[-1])
        os.makedirs(roots[pkg])
        kwargs = {}
        for p in inspect.signature(fn).parameters:
            if p == "tmp_path":
                kwargs[p] = type(tmp_path)(roots[pkg])
            else:  # a fixture of the test module, as a plain function
                kwargs[p] = getattr(m, p)()
        fn(**kwargs)
        text = json.dumps(norm({
            "clusters": [cluster_record(c) for c in made],
            "restarts": boots, "files": files_record(roots[pkg])}))
        records[pkg] = json.loads(text.replace(roots[pkg], "<dir>"))
        monkeypatch.undo()
        order_jax_kills(monkeypatch)
    assert records[PKGS[1]] == records[PKGS[0]]
    records[PKGS[1]]["stores"] = cross_open(roots)
    return records[PKGS[1]]


def case_ids(name: str, prefix: str = "test_") -> list[str]:
    """The qualified names of ``tests/<name>.py``'s test functions and
    methods, in file order."""
    m = source_module(name, PKGS[0])
    out = []
    for attr, obj in vars(m).items():
        if attr.startswith(prefix) and callable(obj):
            out.append(attr)
        elif attr.startswith("Test") and isinstance(obj, type):
            out += [f"{attr}.{a}" for a in vars(obj) if a.startswith(prefix)]
    return out


# -- tests/test_durability.py -------------------------------------------------

DURABILITY = [q for q in case_ids("test_durability")
              if not q.startswith("TestKvStore.")]


@pytest.mark.parametrize("qualname", DURABILITY)
def test_durability_case_equals_jax(monkeypatch, tmp_path, qualname):
    rec = jax_case(monkeypatch, tmp_path, "test_durability", qualname)
    if qualname.startswith(("TestClusterRestart", "TestDurable")):
        # Every case restarts from disk into a later epoch.
        restarted = [r for r in rec["restarts"] if r]
        assert restarted and all(r["epoch"] >= 2 for r in restarted)
        assert rec["stores"] > 0


def test_every_durability_case_is_held():
    assert len(DURABILITY) == 10
    assert "TestDurableGapAcrossRecovery.test_inlife_recovery_then_crash_keeps_acked_commits" in DURABILITY
    assert "TestPurgePaths.test_abort_fetch_and_retirement_purge" in DURABILITY


# -- a cluster written by one package restarts in the other -------------------


def _write_phase(pkg: str, data_dir: str, engine: str, seed: int) -> dict:
    c = mod(pkg, "sim.cluster").SimCluster(
        seed=seed, data_dir=data_dir, storage_engine=engine, n_tlogs=2,
        n_replicas=2, engine="oracle",
        **({"device": "cpu"} if pkg == PKGS[1] else {}))
    db = mod(pkg, "client.ryw").open_database(c)

    async def main():
        for i in range(24):
            async def body(tr, i=i):
                tr.set(b"x/%03d" % i, b"v%03d" % i)
                if i % 5 == 0:
                    tr.clear(b"x/%03d" % (i // 2))

            await db.run(body)
            if i == 11:
                await c.loop.sleep(1.5)  # a flush, then more in the log
        return "ok"

    assert c.loop.run(main(), timeout=600) == "ok"
    return cluster_record(c)


def _restart_phase(pkg: str, data_dir: str, engine: str, seed: int) -> dict:
    c = mod(pkg, "sim.cluster").SimCluster(
        seed=seed, data_dir=data_dir, storage_engine=engine, n_tlogs=2,
        n_replicas=2, engine="oracle",
        **({"device": "cpu"} if pkg == PKGS[1] else {}))
    db = mod(pkg, "client.ryw").open_database(c)

    async def main():
        async def read(tr):
            return await tr.get_range(b"x/", b"x0")

        return await db.run(read)

    rows = c.loop.run(main(), timeout=600)
    g = c.controller.generation
    return {"rows": rows, "epoch": g.epoch,
            "recovery_version": g.recovery_version,
            "durable": [s._durable_version for s in c.storages],
            "loaded": [sorted(s.map._chains) for s in c.storages]}


@pytest.mark.parametrize("engine", ["ssd", "ssd-redwood-1"])
def test_restart_across_packages(tmp_path, engine):
    """JAX writes, the port restarts from its cluster.json, disk queues and
    stores; and the other way round. Both restarts equal the package's own
    restart of its own files."""
    out = {}
    for writer in PKGS:
        for reader in PKGS:
            d = str(tmp_path / f"{writer[-5:]}-{reader[-5:]}")
            _write_phase(writer, d, engine, 500)
            out[writer, reader] = norm(_restart_phase(reader, d, engine, 501))
    want = {}
    for i in range(24):
        want[b"x/%03d" % i] = b"v%03d" % i
        if i % 5 == 0:
            want.pop(b"x/%03d" % (i // 2), None)
    first = out[PKGS[0], PKGS[0]]
    assert first["rows"] == norm(sorted(want.items())) and first["epoch"] == 2
    for key, got in out.items():
        assert got == first, key


def test_restart_over_real_engines_equals_jax(tmp_path, small_engines):
    """test_durability.py's in-life recovery then crash with JAX
    ``TPUConflictSet`` and ``TorchConflictSet(device="cpu")`` (capacity
    2^10, batch 64) in every generation, before and after the restart."""
    def script(pkg):
        d = str(tmp_path / pkg)
        kw = {"engine": "tpu"} if pkg == PKGS[0] else {
            "engine": "torch", "device": "cpu"}
        SimCluster = mod(pkg, "sim.cluster").SimCluster
        c1 = SimCluster(seed=310, data_dir=d, n_tlogs=2, n_replicas=2,
                        storage_engine="ssd-redwood-1", **kw)
        db1 = mod(pkg, "client.ryw").open_database(c1)

        async def phase1():
            for i in range(20):
                tr = db1.transaction()
                tr.set(b"gap/%04d" % i, b"val%04d" % i)
                await tr.commit()
            c1.net.kill("resolver0")
            while c1.controller.generation.epoch < 2:
                await c1.loop.sleep(0.1)
            while c1.controller._recovering:
                await c1.loop.sleep(0.1)
            await db1.refresh_client_info()
            for i in range(20, 28):
                tr = db1.transaction()
                tr.set(b"gap/%04d" % i, b"val%04d" % i)
                await tr.commit()
            return "ok"

        assert c1.loop.run(phase1(), timeout=600) == "ok"
        first = cluster_record(c1)
        c2 = SimCluster(seed=311, data_dir=d, n_tlogs=2, n_replicas=2,
                        storage_engine="ssd-redwood-1", **kw)
        db2 = mod(pkg, "client.ryw").open_database(c2)

        async def check():
            tr = db2.transaction()
            out = [await tr.get(b"gap/%04d" % i) for i in range(28)]
            tr2 = db2.transaction()
            tr2.set(b"after", b"1")
            await tr2.commit()
            return out

        reads = c2.loop.run(check(), timeout=600)
        assert reads == [b"val%04d" % i for i in range(28)]
        text = json.dumps(norm({"first": first, "reads": reads,
                                "second": cluster_record(c2)}))
        return json.loads(text.replace(d, "<dir>"))

    from tests.test_torch_cluster import same

    got = same(script)
    assert got["second"]["epoch"] == 3
