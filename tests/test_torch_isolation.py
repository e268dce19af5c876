"""The port stands alone: no JAX, no JAX package, no silent CPU fallback."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from foundationdb_tpu_torch import TorchConflictSet

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "foundationdb_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def test_imports_and_resolves_with_jax_blocked():
    code = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["foundationdb_tpu"] = None
import foundationdb_tpu_torch
for m in pkgutil.walk_packages(foundationdb_tpu_torch.__path__,
                               "foundationdb_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
from foundationdb_tpu_torch import TorchConflictSet
from foundationdb_tpu_torch.core.types import KeyRange, TxnConflictInfo
pt = lambda k: KeyRange(k, k + b"\x00")
cs = TorchConflictSet(device="cpu", capacity=64, batch_size=8,
                      max_read_ranges=2, max_write_ranges=2, max_key_bytes=8)
cs.resolve([TxnConflictInfo(5, [], [pt(b"a")])], 10)
got = cs.resolve([TxnConflictInfo(5, [pt(b"a")], []),
                  TxnConflictInfo(15, [pt(b"a")], [])], 20)
assert [int(v) for v in got] == [1, 0], got
import foundationdb_tpu_torch.bench, foundationdb_tpu_torch.sched.packing
from foundationdb_tpu_torch import native
from foundationdb_tpu_torch.models.conflict_set import encode_resolve_batch
wire = encode_resolve_batch([TxnConflictInfo(5, [pt(b"a")], [pt(b"b")])])
got = cs.resolve_wire_async(wire, 30, as_array=True)()
assert got.tolist() == [1], got
assert native.keypack()._name == str(native.library_path("keypack"))
assert "foundationdb_tpu_torch" in native.keypack()._name
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_source_imports_nothing_of_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "foundationdb_tpu"), \
                f"{path}: imports {name}"


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        assert TorchConflictSet(capacity=64, batch_size=8,
                                max_key_bytes=8).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchConflictSet(capacity=64, batch_size=8, max_key_bytes=8)


@pytest.mark.parametrize("kw", [dict(wave_commit=True), dict(resident=False),
                                dict(dict_hot_capacity=32),
                                dict(spec_resolve=True)],
                         ids=lambda kw: next(iter(kw)))
def test_other_designs_name_their_roadmap_item(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item"):
        TorchConflictSet(device="cpu", **kw)


def test_cuda_wrappers_refuse_cpu_tensors():
    from foundationdb_tpu_torch import kernels

    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.build_table(torch.zeros(8, dtype=torch.int32))
