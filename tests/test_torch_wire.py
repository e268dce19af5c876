"""The port's wire path vs the JAX package's: the encoder's bytes, the C
packer's arrays (the port builds its own copy of keypack.cpp) and
``resolve_wire`` verdicts against ``TPUConflictSet(resident=True)`` and the
brute-force oracle. Every comparison is exact. The cases are those of
tests/test_wire_pack.py: truncation, coalescing, an all-0xff end, empty
ranges, malformed, huge-count and huge-length wires.
"""

import struct

import numpy as np
import pytest
import torch

from foundationdb_tpu.core.types import KeyRange, TxnConflictInfo
from foundationdb_tpu.models.conflict_set import TPUConflictSet
from foundationdb_tpu.models.conflict_set import encode_resolve_batch as jenc
from foundationdb_tpu.sim.oracle import OracleConflictSet
from foundationdb_tpu_torch import TorchConflictSet, native
from foundationdb_tpu_torch.convert import state_leaves
from foundationdb_tpu_torch.models.conflict_set import (
    encode_resolve_batch as tenc,
)
from tests.test_conflict_oracle import rand_txn
from tests.test_torch_conflict_set import port_txn
from tests.test_wire_pack import random_txns

# Small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the CPU.
torch.set_num_threads(1)

KW = dict(capacity=1 << 10, batch_size=64, max_read_ranges=4,
          max_write_ranges=4, max_key_bytes=16)


def pair(**over):
    kw = dict(KW, **over)
    return (TPUConflictSet(resident=True, **kw),
            TorchConflictSet(device="cpu", **kw))


def port_wire(txns) -> bytes:
    return tenc([port_txn(t) for t in txns])


def same_arrays(port_bt, jax_bt):
    assert port_bt._fields == jax_bt._fields
    for name in jax_bt._fields:
        a, b = getattr(port_bt, name), np.asarray(getattr(jax_bt, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("seed,overlong,many", [(0, True, True),
                                                (1, False, True),
                                                (2, True, False)])
def test_encoder_bytes_equal(seed, overlong, many):
    txns = random_txns(np.random.default_rng(seed), 50, overlong=overlong,
                       many_ranges=many)
    assert port_wire(txns) == jenc(txns)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_c_pack_arrays_equal(seed):
    """Truncated keys (overlong), coalesced ranges (many per txn), empty
    ranges, on a nonzero base version."""
    rng = np.random.default_rng(seed)
    jcs, tcs = pair()
    jcs.base_version = tcs.base_version = 7
    txns = random_txns(rng, 64, overlong=True, many_ranges=True)
    buf = np.frombuffer(jenc(txns), np.uint8)
    jbt, joff = jcs._pack_wire(buf, 0, len(txns))
    tbt, toff = tcs._pack_wire(buf, 0, len(txns))
    assert toff == joff == buf.size
    same_arrays(tbt, jbt)


def test_wire_pack_equals_object_pack():
    rng = np.random.default_rng(3)
    _, tcs = pair()
    tcs.base_version = 0
    txns = [port_txn(t) for t in random_txns(rng, 64, overlong=True,
                                             many_ranges=True)]
    wbt, _ = tcs._pack_wire(np.frombuffer(tenc(txns), np.uint8), 0, 64)
    obt, _ = tcs._pack(txns)
    for name in obt._fields:
        assert getattr(wbt, name).tobytes() == getattr(obt, name).tobytes()


def test_truncation_all_ff_end():
    jcs, tcs = pair()
    jcs.base_version = tcs.base_version = 0
    txns = [TxnConflictInfo(
        read_version=0, read_ranges=[KeyRange(b"\x01", b"\xff" * 40)],
        write_ranges=[KeyRange(b"\xff" * 40, b"\xff" * 41)])]
    buf = np.frombuffer(jenc(txns), np.uint8)
    tbt, _ = tcs._pack_wire(buf, 0, 1)
    same_arrays(tbt, jcs._pack_wire(buf, 0, 1)[0])
    assert (tbt.read_end[0, 0] == np.iinfo(np.int32).max).all()


def test_count_txns():
    txns = random_txns(np.random.default_rng(9), 37)
    assert native.count_txns(np.frombuffer(port_wire(txns), np.uint8)) == 37


@pytest.mark.parametrize("blob", [
    struct.pack("<qii", 0, 2**30, 2**30),  # reads + writes overflow int32
    struct.pack("<qii", 0, 1, 0) + struct.pack("<ii", 2**31 - 1, 2**31 - 1),
    b"\x01\x02\x03",
], ids=["huge_counts", "huge_lengths", "short"])
def test_hostile_wire_rejected(blob):
    buf = np.frombuffer(blob, np.uint8)
    assert native.count_txns(buf) == -1
    _, tcs = pair()
    assert native.pack_batch(buf, 0, 1, tcs.codec.n_words, 0,
                             tcs._empty_batch()) == -1
    with pytest.raises(ValueError, match="malformed"):
        tcs.resolve_wire(blob, commit_version=10)
    assert tcs._last_commit == 0


def test_count_beyond_buffer_rejected_before_dispatch():
    _, tcs = pair()
    wire = port_wire(random_txns(np.random.default_rng(5), 10))
    before = tcs.state
    with pytest.raises(ValueError):
        tcs.resolve_wire(wire, commit_version=10, count=11)
    assert tcs.state is before and tcs._last_commit == 0
    assert len(tcs.resolve_wire(wire, commit_version=10, count=10)) == 10


def test_far_future_read_version_rejected():
    _, tcs = pair()
    t = TxnConflictInfo(read_version=2**40,
                        read_ranges=[KeyRange(b"a", b"b")], write_ranges=[])
    with pytest.raises(ValueError):
        tcs.resolve_wire(port_wire([t]), commit_version=10)


@pytest.mark.parametrize("seed", [3, 4])
def test_resolve_wire_equals_jax_and_oracle(seed):
    """A stream of wire batches (some larger than batch_size, so they
    chunk) through both engines and the oracle: verdicts, ``as_array``,
    headroom and every state leaf agree."""
    rng = np.random.default_rng(seed)
    jcs, tcs = pair(batch_size=32, max_key_bytes=8)
    oracle = OracleConflictSet()
    cv = 1000
    for i in range(6):
        cv += int(rng.integers(1, 50))
        txns = [rand_txn(rng, read_version=int(rng.integers(cv - 300, cv)))
                for _ in range(int(rng.integers(1, 80)))]
        wire = jenc(txns)
        want = [int(v) for v in jcs.resolve_wire(wire, cv, cv - 200)]
        if i % 2:
            got = tcs.resolve_wire_async(port_wire(txns), cv, cv - 200,
                                         as_array=True)()
            assert got.dtype == np.int8
            got = [int(v) for v in got]
        else:
            got = [int(v) for v in tcs.resolve_wire(port_wire(txns), cv,
                                                    cv - 200)]
        oracle.oldest_version = max(oracle.oldest_version, cv - 200)
        assert got == want, f"batch {i}: port vs jax"
        assert got == [int(v) for v in oracle.resolve(txns, cv)], i
        assert tcs.headroom() == jcs.headroom()
        for name, leaf in state_leaves(jcs.state).items():
            a = state_leaves(tcs.state)[name].numpy()
            assert a.tobytes() == np.asarray(leaf).tobytes(), (i, name)


def test_native_library_is_the_ports_own():
    lib = native.keypack()
    path = native.library_path("keypack")
    assert path.exists() and path.parent == native.BUILD_DIR
    assert "foundationdb_tpu_torch" in str(path)
    assert lib._name == str(path)
