"""The port stands alone: no JAX, no JAX package, no silent CPU fallback."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
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
from foundationdb_tpu_torch.core import wavemesh
kw = dict(device="cpu", capacity=64, batch_size=8, max_read_ranges=2,
          max_write_ranges=2, max_key_bytes=8, wave_commit=True)
wv = TorchConflictSet(**kw)
ring = [TxnConflictInfo(5, [pt(b"a")], [pt(b"b")]),
        TxnConflictInfo(5, [pt(b"b")], [pt(b"a")])]
assert [int(v) for v in wv.resolve(ring, 10)] == [1, 0], wv.last_wave
assert wv.last_wave == [-2, 0]
shards = [TorchConflictSet(**kw) for _ in range(2)]
edges = [s.resolve_edges(wavemesh.clip_txns(ring, lo, hi), 10)
         for s, (lo, hi) in zip(shards, [(b"", b"b"), (b"b", b"\xff")])]
graph = wavemesh.combine_edges(edges)
assert [[int(v) for v in s.resolve_apply(graph)] for s in shards] == \
    [[1, 0], [1, 0]]
ring = [TxnConflictInfo(15, t.read_ranges, t.write_ranges) for t in ring]
got = wv.resolve_wire_window(encode_resolve_batch(ring), [20], 2)
assert got.tolist() == [[1, 0]] and wv.last_wave_window.tolist() == [[-2, 0]]
from foundationdb_tpu_torch.parallel.sharded_resolver import ShardedConflictSet
sh = ShardedConflictSet(n_shards=2, device="cpu", capacity=64, batch_size=8,
                        max_read_ranges=2, max_write_ranges=2, max_key_bytes=8,
                        splits=[b"b"], wave_commit=True)
sh.resolve([TxnConflictInfo(5, [], [pt(b"a"), pt(b"c")])], 10)
got = sh.resolve([TxnConflictInfo(5, [KeyRange(b"", b"z")], []),
                  TxnConflictInfo(15, [pt(b"c")], [])], 20)
assert [int(v) for v in got] == [1, 0] and sh.last_wave == [-1, 0], got
assert sh.exchange_stats()["wave_batches"] == 2
from foundationdb_tpu_torch.admission import RecentWritesFilter
f = RecentWritesFilter(bits_log2=10, backend="device", device="cpu")
cs.attach_admission_filter(f)
cs.resolve([TxnConflictInfo(35, [], [pt(b"q")])], 40)
assert f.recorded == 1 and f.metrics()["backend"] == "device"
nr = TorchConflictSet(device="cpu", resident=False, capacity=64,
                      batch_size=8, max_read_ranges=2, max_write_ranges=2,
                      max_key_bytes=8)
nr.resolve([TxnConflictInfo(5, [], [pt(b"a")])], 10)
got = nr.resolve([TxnConflictInfo(5, [pt(b"a")], []),
                  TxnConflictInfo(15, [pt(b"a")], [])], 20)
assert [int(v) for v in got] == [1, 0] and nr.dict_stats is None, got
nrs = ShardedConflictSet(n_shards=2, device="cpu", capacity=64, batch_size=8,
                         max_read_ranges=2, max_write_ranges=2,
                         max_key_bytes=8, splits=[b"b"], resident=False,
                         wave_commit=True)
nrs.resolve([TxnConflictInfo(5, [], [KeyRange(b"a", b"c")])], 10)
got = nrs.resolve([TxnConflictInfo(5, [KeyRange(b"", b"z")], []),
                   TxnConflictInfo(15, [pt(b"b")], [])], 20)
assert [int(v) for v in got] == [1, 0] and nrs.last_wave == [-1, 0], got
nrs.reshard([b"a\x00"])
assert nrs.shard_occupancy() == [2, 4], nrs.shard_occupancy()
got = nrs.resolve([TxnConflictInfo(5, [pt(b"b")], []),
                   TxnConflictInfo(12, [pt(b"b")], [])], 30)
assert [int(v) for v in got] == [1, 0], got
blk = ShardedConflictSet(n_shards=2, device="cpu", capacity=64, batch_size=8,
                         max_read_ranges=2, max_write_ranges=2,
                         max_key_bytes=8, splits=[b"b"], rmq="blocked")
blk.resolve([TxnConflictInfo(5, [], [KeyRange(b"a", b"c")])], 10)
got = blk.resolve([TxnConflictInfo(5, [KeyRange(b"", b"z")], []),
                   TxnConflictInfo(15, [pt(b"b")], [])], 20)
assert [int(v) for v in got] == [1, 0], got
from foundationdb_tpu_torch.reads import ReadCoalescer, TorchReadSet, WatchIndex
from foundationdb_tpu_torch.runtime.flow import Loop, Promise
from foundationdb_tpu_torch.runtime.storage import VersionedMap
vm = VersionedMap()
for i, k in enumerate([b"a", b"b", b"c"]):
    vm.write(k, 1 + i, b"v%d" % i)
rs = TorchReadSet(vm, arm="device", device="cpu")
assert rs.get_points([b"b", b"x"], 5) == [b"v1", None]
assert rs.get_ranges([(b"a", b"c", 10, False, 5)]) == [[(b"a", b"v0"),
                                                         (b"b", b"v1")]]
loop = Loop(seed=1)
rc = ReadCoalescer(loop, rs)
assert loop.run(rc.submit_points([b"c"], 5), timeout=10) == [b"v2"]
wi = WatchIndex(arm="device", device="cpu")
p = Promise()
wi.add(b"b", b"v1", p)
assert wi.sweep(6, [(b"b", b"new")]) == 1 and p.future.result() == 6
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


def test_sharded_default_device_is_cuda_and_raises_without_a_card():
    from foundationdb_tpu_torch.parallel.sharded_resolver import (
        ShardedConflictSet,
    )

    kw = dict(n_shards=2, capacity=64, batch_size=8, max_key_bytes=8)
    if torch.cuda.is_available():
        assert ShardedConflictSet(**kw).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedConflictSet(**kw)


@pytest.mark.parametrize("kw", [dict(resident=False, wave_commit=True),
                                dict(resident=False),
                                dict(resident=False, dict_hot_capacity=32),
                                dict(resident=False, spec_resolve=True)],
                         ids=lambda kw: "+".join(kw))
def test_other_designs_name_their_roadmap_item(kw):
    """The non-resident design, alone or with wave commit, tiering or
    speculation, builds on the CPU and resolves as the JAX engine of the
    same configuration does (verdicts, levels, every history leaf); the
    tiering request stays inert there, as in JAX (no mirror, no tier)."""
    from foundationdb_tpu.core.types import KeyRange as JRange
    from foundationdb_tpu.core.types import TxnConflictInfo as JTxn
    from foundationdb_tpu.models.conflict_set import TPUConflictSet
    from foundationdb_tpu_torch import convert
    from foundationdb_tpu_torch.core.types import KeyRange, TxnConflictInfo

    cfg = dict(capacity=64, batch_size=8, max_read_ranges=2,
               max_write_ranges=2, max_key_bytes=8, **kw)
    port = TorchConflictSet(device="cpu", **cfg)
    jax = TPUConflictSet(**cfg)
    assert not port.resident and not port.tiered and port.dict_stats is None
    assert jax.tiered == port.tiered
    for cv, (r, w) in enumerate([(b"a", b"b"), (b"b", b"a"), (b"a", b"c"),
                                 (b"c", b"a")], start=10):
        rows = [(5 + 4 * (cv - 10), r, w), (cv - 1, w, r)]
        got = port.resolve([TxnConflictInfo(v, [KeyRange(x, x + b"\0")],
                                            [KeyRange(y, y + b"\0")])
                            for v, x, y in rows], cv)
        want = jax.resolve([JTxn(v, [JRange(x, x + b"\0")],
                                 [JRange(y, y + b"\0")])
                            for v, x, y in rows], cv)
        assert [int(v) for v in got] == [int(v) for v in want], cv
        assert port.last_wave == jax.last_wave
    for k, v in convert.state_leaves(jax.state).items():
        assert convert.state_leaves(port.state)[k].numpy().tobytes() == \
            np.asarray(v).tobytes(), k


def test_cuda_wrappers_refuse_cpu_tensors():
    from foundationdb_tpu_torch import kernels

    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.build_table(torch.zeros(8, dtype=torch.int32))


def test_word_kernel_wrappers_refuse_cpu_tensors():
    """The K14-K16 and unpacked-paint wrappers take CUDA tensors only (the
    plain versions run for CPU tensors one level up)."""
    from foundationdb_tpu_torch import kernels

    rows = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.word_sort(rows)
    b3 = torch.zeros((2, 1, 3), dtype=torch.int32)
    m = torch.ones((2, 1), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.word_ranks(b3, b3, m, b3, b3, m)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.word_clip(b3, b3, m, b3, b3, m, rows[:2], rows[:2], True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.word_paint_keys(b3, b3, m, m[:, 0])


@pytest.mark.parametrize("kw", [dict(history="flat"), dict(history=None),
                                dict(rmq="dense"), dict(accept="wave2"),
                                dict(packed="0"), dict(packed=None),
                                dict(packed=1)],
                         ids=lambda kw: "-".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_design_arguments_are_validated(kw):
    with pytest.raises(ValueError, match=next(iter(kw))):
        TorchConflictSet(device="cpu", capacity=64, batch_size=8,
                         max_key_bytes=8, **kw)


def test_unpacked_engine_keeps_the_jax_inert_rules():
    """packed=False forces resident and spec_resolve off and leaves the
    tier inert, as JAX does under FDB_TPU_PACKED=0; nothing raises, and no
    admission filter attaches (no mirror to feed it)."""
    from foundationdb_tpu_torch.admission import RecentWritesFilter

    cs = TorchConflictSet(device="cpu", capacity=64, batch_size=8,
                          max_key_bytes=8, packed=False, resident=True,
                          spec_resolve=True, dict_hot_capacity=32)
    assert (cs.packed, cs.resident, cs.spec_resolve, cs.tiered) == (
        False, False, False, False)
    assert cs.dict_stats is None
    assert cs.spec_resolve_async([], 10) is None
    with pytest.raises(ValueError, match="resident"):
        cs.attach_admission_filter(RecentWritesFilter(bits_log2=10))


@pytest.mark.parametrize("kw", [dict(rmq="blocked"), dict(packed=False),
                                dict(rmq="blocked", resident=False)],
                         ids=lambda kw: "-".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_sharded_design_arms_name_item_10d(kw):
    """Item 10d is ported: each of these sharded arms constructs (on the
    CPU) with the arm it was given, resolves as the sparse default does,
    and ``spec_resolve=True`` still names item 15, except under
    ``packed=False``, where speculation is forced off (inert) as in JAX."""
    from foundationdb_tpu_torch.core.types import KeyRange, TxnConflictInfo
    from foundationdb_tpu_torch.parallel.sharded_resolver import (
        ShardedConflictSet,
    )

    cfg = dict(n_shards=2, device="cpu", capacity=64, batch_size=8,
               max_key_bytes=8, splits=[b"b"])
    arm = ShardedConflictSet(**cfg, **kw)
    assert arm.rmq == kw.get("rmq", "sparse")
    assert arm.packed == kw.get("packed", True)
    assert arm.resident == (kw.get("resident", True)
                            and kw.get("packed", True))
    default = ShardedConflictSet(**cfg)
    t = TxnConflictInfo
    for cs in (arm, default):
        cs.resolve([t(5, [], [KeyRange(b"a", b"c")])], 10)
    rows = [t(5, [KeyRange(b"", b"z")], []), t(15, [KeyRange(b"b", b"b\0")],
                                                 [])]
    assert [int(v) for v in arm.resolve(rows, 20)] == [
        int(v) for v in default.resolve(rows, 20)] == [1, 0]
    if kw.get("packed", True):
        with pytest.raises(NotImplementedError, match="item 15"):
            ShardedConflictSet(**cfg, **kw, spec_resolve=True)
    else:
        assert not ShardedConflictSet(**cfg, **kw,
                                      spec_resolve=True).spec_resolve


def test_blocked_kernel_wrappers_refuse_cpu_tensors():
    """K17's build, query and probe take CUDA tensors only, and the blocked
    probe of a resident engine's state on a CUDA batch launches them (no
    fallback to the plain version for a CUDA tensor)."""
    from foundationdb_tpu_torch import kernels

    v = torch.zeros(300, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.blocked_build(v)
    table = (torch.zeros((2, 256), dtype=torch.int32),) * 2 + (
        torch.zeros((2, 2), dtype=torch.int32),)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.blocked_query(v, table, v[:4], v[:4])
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.blocked_probe(v, table, v[:4], v[:4], v[:4].view(2, 2),
                              v[:4].view(2, 2),
                              torch.ones((2, 2), dtype=torch.bool), v[:2],
                              torch.ones(2, dtype=torch.bool), v[0],
                              n_used=v[0])


def test_ctypes_signatures_match_the_c_entry_points():
    """Each kernel entry's ctypes argtypes (``kernels._SIGNATURES``) list
    one pointer or int per parameter of its ``extern "C"`` function in
    ``csrc/*.cu``, the CUDA stream included: a missing pointer would pass
    the stream as a C int, its upper half whatever the stack held."""
    import ctypes
    import re

    from foundationdb_tpu_torch import kernels

    csrc = ROOT / "foundationdb_tpu_torch" / "kernels" / "csrc"
    for source, fns in kernels._SIGNATURES.items():
        text = (csrc / f"{source}.cu").read_text()
        for fn, argtypes in fns.items():
            m = re.search(r'extern "C" int ' + fn + r"\((.*?)\)\s*\{", text,
                          re.S)
            assert m, f"{source}.cu: no extern \"C\" {fn}"
            params = [p.strip() for p in m.group(1).split(",")]
            want = ["P" if "*" in p or "cudaStream_t" in p else "I"
                    for p in params]
            got = ["P" if t is ctypes.c_void_p else "I" for t in argtypes]
            assert got == want, f"{source}.cu {fn}: {got} vs {want}"


def test_wave_clock_names_match_the_c_counters():
    """``kernels.WAVE_CLOCKS`` names K6's stats-build counters in the order
    of the ``WV_CLK_*`` enum of ``csrc/wave.cu``, one name each."""
    import re

    from foundationdb_tpu_torch import kernels

    text = (ROOT / "foundationdb_tpu_torch" / "kernels" / "csrc"
            / "wave.cu").read_text()
    body = re.search(r"enum \{(.*?)\};", text, re.S).group(1)
    names = re.findall(r"WV_CLK_(\w+)", body)
    assert names[-1] == "N"
    assert len(names) - 1 == len(kernels.WAVE_CLOCKS)


def test_accept_clock_names_match_the_c_counters():
    """``kernels.ACCEPT_CLOCKS`` names K3's stats-build counters in the
    order of the ``AC_CLK_*`` enum of ``csrc/accept.cu``, one name each."""
    import re

    from foundationdb_tpu_torch import kernels

    text = (ROOT / "foundationdb_tpu_torch" / "kernels" / "csrc"
            / "accept.cu").read_text()
    body = re.search(r"enum \{(.*?)\};", text, re.S).group(1)
    names = re.findall(r"AC_CLK_(\w+)", body)
    assert names[-1] == "N"
    assert [n.lower() for n in names[:-1]] == list(kernels.ACCEPT_CLOCKS)


def test_k4_k1_tile_constants_match_the_kernels():
    """The wrappers size K4's look-back workspace and the plain twins cut
    their tiles by ``K4_TILE``/``K1_TILE`` and ``_WS_HEAD``: each equals
    the constant its kernel source compiles with."""
    import re

    from foundationdb_tpu_torch import kernels
    from foundationdb_tpu_torch.models import conflict_kernel as ck

    csrc = ROOT / "foundationdb_tpu_torch" / "kernels" / "csrc"

    def define(source, name):
        text = (csrc / source).read_text()
        return re.search(rf"#define {name} (.*?)(\s*//.*)?$", text,
                         re.M).group(1)

    assert eval(define("step_compact.cu", "TILE").replace("NT", define(
        "step_compact.cu", "NT")).replace("NI", define(
            "step_compact.cu", "NI"))) == kernels.K4_TILE == ck.K4_TILE
    assert eval(define("dict_insert.cu", "KTILE").replace("KT", define(
        "dict_insert.cu", "KT")).replace("KI", define(
            "dict_insert.cu", "KI"))) == kernels.K1_TILE == ck.K1_TILE
    assert int(define("step_compact.cu", "WS_WORDS")) == kernels._WS_HEAD
