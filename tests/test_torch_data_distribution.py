"""Data distribution in the port against the JAX package
(``runtime/data_distribution.py`` ``DataDistributor``, ``sim/cluster.py``'s
``data_distribution`` arm, the storage servers' fetch, purge and serve
sets).

- Every case of ``tests/test_data_distribution.py`` runs in both packages
  as its JAX source stands (``tests/test_torch_durability.jax_case``):
  both pass their own checks, and every cluster they build is equal: the
  epochs, every storage server's version chains, the shard map with its
  teams, the trace and ``loop.now``.
- Moves on a durable cluster: shards move between redwood-backed storages
  with writes running, the moved-away ranges are purged from the stores,
  and a whole-cluster restart loads each storage's store; the stores, the
  shard map and every read equal JAX's.
"""

import hashlib
import json
import os

import pytest

from tests.test_torch_cluster import PKGS, mod, norm, same
from tests.test_torch_durability import (
    case_ids,
    cluster_record,
    jax_case,
    jax_made_deterministic,  # noqa: F401  (autouse fixture)
)

DD = case_ids("test_data_distribution")


@pytest.mark.parametrize("qualname", DD)
def test_data_distribution_case_equals_jax(monkeypatch, tmp_path, qualname):
    rec = jax_case(monkeypatch, tmp_path, "test_data_distribution", qualname)
    if not qualname.startswith("TestFetchRedelivery"):
        assert rec["clusters"]


def test_every_case_is_held():
    assert len(DD) == 18
    assert "TestShardMove.test_move_shard_preserves_data_under_traffic" in DD


def _durable_moves(pkg: str, root: str, engine: str) -> dict:
    kw = {"device": "cpu"} if pkg == PKGS[1] else {}
    SimCluster = mod(pkg, "sim.cluster").SimCluster
    d = os.path.join(root, pkg)

    def cluster(seed):
        return SimCluster(seed=seed, n_storages=3, n_replicas=2,
                          data_distribution=True, data_dir=d,
                          storage_engine=engine, engine="oracle", **kw)

    c = cluster(61)
    db = mod(pkg, "client.ryw").open_database(c)
    model: dict[bytes, bytes] = {}

    async def main():
        dd = c.data_distributor
        for r in range(6):
            async def body(tr, r=r):
                for i in range(r, 48, 3):
                    tr.set(b"m/%03d" % i, b"r%d-%03d" % (r, i))
                tr.clear(b"m/%03d" % (5 * r))

            await db.run(body)
            for i in range(r, 48, 3):
                model[b"m/%03d" % i] = b"r%d-%03d" % (r, i)
            model.pop(b"m/%03d" % (5 * r), None)
            await dd.move_shard(b"m/", b"m0", (r % 3, (r + 1) % 3))
            await c.loop.sleep(0.6)  # a GC pass: purges and a flush
        return "ok"

    assert c.loop.run(main(), timeout=600) == "ok"
    first = cluster_record(c)
    c2 = cluster(62)
    db2 = mod(pkg, "client.ryw").open_database(c2)

    async def read(tr):
        return await tr.get_range(b"m/", b"m0")

    rows = c2.loop.run(db2.run(read), timeout=600)
    assert rows == sorted(model.items())
    loaded = {}
    for i in range(3):
        kv = mod(pkg, "runtime.kvstore").make_kvstore(
            os.path.join(d, f"storage{i}.db"), engine)
        loaded[i] = kv.load()
        kv.close()
    files = {f: hashlib.sha256(open(os.path.join(d, f), "rb").read())
             .hexdigest() for f in sorted(os.listdir(d))
             if engine == "ssd-redwood-1" and f.endswith((".db", ".q"))}
    text = json.dumps(norm({"first": first, "second": cluster_record(c2),
                            "rows": rows, "loaded": loaded,
                            "files": files}))
    return json.loads(text.replace(d, "<dir>"))


@pytest.mark.parametrize("engine", ["ssd-redwood-1", "ssd"])
def test_moves_on_a_durable_cluster_equal_jax(tmp_path, engine):
    got = same(lambda pkg: _durable_moves(pkg, str(tmp_path), engine))
    assert got["second"]["epoch"] == 2
    # Some storage was moved away from part of the range and purged it.
    sizes = [len(got["loaded"][str(i)][1]) for i in range(3)]
    assert min(sizes) < max(sizes)
