"""The storage engines in the port against the JAX package: the sqlite
engine and the Redwood-class B+tree (``runtime/kvstore.py`` over the port's
own build of ``native/btree.cpp``).

- Every case of ``tests/test_redwood.py`` and ``tests/test_durability.py``
  ``TestKvStore`` runs in both packages as its JAX source stands
  (``tests/test_torch_durability.jax_case``): both pass, the redwood files
  they leave are equal byte for byte, the sqlite stores row for row, and
  every store opens in either package's engine to the same rows. That
  covers torn and destroyed meta slots, a scribbled data page, an
  oversized key and the overlapping purges of one flush.
- A random stream of flushes and purges through both packages' engines at
  once: after every flush the loads are equal and the redwood files equal
  byte for byte; each package's files then open in the other.
- The loader: the port's ``native.btree()`` binds every ``extern "C"``
  entry of its copy of ``btree.cpp`` with JAX's signatures, and a build
  that cannot run raises (no engine stands in for it).
"""

import os
import random
import re

import pytest

from tests.test_torch_cluster import PKGS, mod
from tests.test_torch_durability import (
    case_ids,
    jax_case,
    jax_made_deterministic,  # noqa: F401  (autouse fixture)
)

REDWOOD = case_ids("test_redwood")


@pytest.mark.parametrize("qualname", REDWOOD)
def test_redwood_case_equals_jax(monkeypatch, tmp_path, qualname):
    rec = jax_case(monkeypatch, tmp_path, "test_redwood", qualname)
    assert rec["files"], "the case left no file"


def test_every_redwood_case_is_held():
    assert len(REDWOOD) == 11
    assert {"test_overlapping_purges_in_one_flush",
            "test_corrupt_data_page_fails_load_loudly",
            "test_meta_corruption_falls_back_to_previous_commit",
            "test_corrupt_store_refused_not_reinitialized"} <= set(REDWOOD)


def test_kvstore_flush_load_purge_equals_jax(monkeypatch, tmp_path):
    rec = jax_case(monkeypatch, tmp_path, "test_durability",
                   "TestKvStore.test_flush_load_purge")
    assert rec["stores"] == 1


def _stream(seed: int, rounds: int):
    """Random flushes: point writes, tombstones, overflow-sized values and
    range purges over 600 keys."""
    rng = random.Random(seed)
    version = 0
    for r in range(rounds):
        writes = {}
        for _ in range(rng.randrange(1, 150)):
            k = b"k%06d" % rng.randrange(600)
            x = rng.random()
            writes[k] = (None if x < 0.2 else
                         bytes([rng.randrange(256)]) * rng.randrange(5000, 40000)
                         if x < 0.25 else b"v%d-%d" % (r, rng.randrange(1000)))
        purges = []
        for _ in range(rng.randrange(0, 3)):
            b = b"k%06d" % rng.randrange(600)
            purges.append((b, b + b"\xff" if rng.random() < 0.5
                           else b"k%06d" % rng.randrange(600, 700)))
        version += rng.randrange(1, 10)
        yield writes, version, purges


@pytest.mark.parametrize("engine", ["ssd-redwood-1", "ssd"])
def test_random_stream_equal_files_and_cross_open(tmp_path, engine):
    stores, paths = {}, {}
    for pkg in PKGS:
        paths[pkg] = str(tmp_path / f"{pkg}.store")
        stores[pkg] = mod(pkg, "runtime.kvstore").make_kvstore(
            paths[pkg], engine)
    for writes, version, purges in _stream(3, 30):
        for pkg in PKGS:
            stores[pkg].flush(writes, version, purges=purges)
        loads = [stores[p].load() for p in PKGS]
        assert loads[1] == loads[0]
        assert loads[1][0] == version
        if engine == "ssd-redwood-1":
            raw = [open(paths[p], "rb").read() for p in PKGS]
            assert raw[1] == raw[0]
    want = stores[PKGS[0]].load()
    assert len(want[1]) > 100
    for s in stores.values():
        s.close()
    for writer in PKGS:
        for reader in PKGS:
            kv = mod(reader, "runtime.kvstore").make_kvstore(
                paths[writer], engine)
            assert kv.load() == want, (writer, reader)
            kv.close()


def test_btree_loader_binds_every_entry():
    from foundationdb_tpu_torch import native

    src = open(os.path.join(os.path.dirname(native.__file__),
                            "btree.cpp")).read()
    jsrc = open(os.path.join(os.path.dirname(mod(PKGS[0], "native").__file__),
                             "btree.cpp")).read()
    assert src == jsrc
    extern = src[src.index('extern "C" {'):]
    entries = re.findall(r"^\S[^\n(]*?\b(rw_\w+)\(", extern, re.M)
    assert sorted(entries) == sorted(native._SIGNATURES["btree"])
    lib = native.btree()
    assert "foundationdb_tpu_torch" in lib._name
    assert lib._name == str(native.library_path("btree"))
    assert native._flags("btree") == ("-O3", "-std=c++17", "-shared",
                                      "-fPIC", "-march=native")
    K = mod(PKGS[1], "runtime.kvstore")
    J = mod(PKGS[0], "runtime.kvstore")
    J._btree_lib()
    for fn, (args, res) in native._SIGNATURES["btree"].items():
        jf = getattr(J._BT_LIB, fn)
        assert [a.__name__ for a in args] == [
            a.__name__ for a in jf.argtypes], fn
    assert K._btree_lib() is lib and K._SCAN_CB is native.BTREE_SCAN_CB


def test_failed_btree_build_raises(monkeypatch, tmp_path):
    """No compiler: the redwood engine cannot open, and nothing stands in."""
    from foundationdb_tpu_torch import native

    K = mod(PKGS[1], "runtime.kvstore")
    monkeypatch.setattr(K, "_BT_LIB", None)
    monkeypatch.delitem(native._LIBS, "btree", raising=False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(native, "library_path",
                        lambda name: tmp_path / "empty" / f"lib{name}.so")
    monkeypatch.setattr(native.shutil, "which", lambda _name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        K.KeyValueStoreRedwood(str(tmp_path / "x.rw"))
    assert not os.path.exists(tmp_path / "x.rw")
    with pytest.raises(ValueError):
        K.make_kvstore(str(tmp_path / "y"), "rocksdb")
