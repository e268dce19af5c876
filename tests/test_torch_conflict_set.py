"""TorchConflictSet(device="cpu") vs TPUConflictSet(resident=True) vs the
brute-force oracle, verdict for verdict, on the streams of
test_conflict_oracle.py and test_resident.py.

Both packages get the same transactions, built once from one numpy draw
(each package has its own value types). After every batch the verdicts
(as ints), ``last_conflicting``, ``headroom()`` and ``overflowed`` must
agree.
"""

import numpy as np
import pytest
import torch

from foundationdb_tpu.core.types import KeyRange, TxnConflictInfo
from foundationdb_tpu.models.conflict_set import TPUConflictSet
from foundationdb_tpu.sim.oracle import OracleConflictSet
from foundationdb_tpu_torch import TorchConflictSet, convert
from foundationdb_tpu_torch.core import types as tt
from tests.test_conflict_oracle import rand_txn

# Small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the CPU.
torch.set_num_threads(1)


def port_txn(t: TxnConflictInfo) -> tt.TxnConflictInfo:
    return tt.TxnConflictInfo(
        t.read_version,
        [tt.KeyRange(r.begin, r.end) for r in t.read_ranges],
        [tt.KeyRange(w.begin, w.end) for w in t.write_ranges],
        t.report_conflicting_keys)


def ranges(lc):
    return {i: [(r.begin, r.end) for r in v] for i, v in lc.items()}


class Trio:
    """The JAX engine, the port and the oracle, driven in lockstep."""

    def __init__(self, **kw):
        self.jax = TPUConflictSet(resident=True, **kw)
        self.port = TorchConflictSet(device="cpu", **kw)
        self.oracle = OracleConflictSet()

    def resolve(self, txns, cv, oldest=None, what=""):
        want = [int(v) for v in self.jax.resolve(txns, cv, oldest)]
        got = [int(v) for v in self.port.resolve([port_txn(t) for t in txns],
                                                 cv, oldest)]
        if oldest is not None:
            self.oracle.oldest_version = max(self.oracle.oldest_version,
                                             oldest)
        oracle = [int(v) for v in self.oracle.resolve(txns, cv)]
        assert got == want, f"{what}: port vs jax"
        assert got == oracle, f"{what}: port vs oracle"
        assert ranges(self.port.last_conflicting) == ranges(
            self.jax.last_conflicting), what
        self.check(what)
        return got

    def check(self, what=""):
        assert self.port.headroom() == self.jax.headroom(), what
        assert self.port.overflowed == self.jax.overflowed, what


def pt(k: bytes) -> KeyRange:
    return KeyRange(k, k + b"\x00")


KW = dict(capacity=512, batch_size=32, max_read_ranges=4,
          max_write_ranges=4, max_key_bytes=8)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_stream_with_reports(seed):
    rng = np.random.default_rng(seed)
    trio = Trio(**KW)
    cv = 1000
    for i in range(12):
        cv += int(rng.integers(1, 50))
        txns = [rand_txn(rng, read_version=int(rng.integers(max(0, cv - 300),
                                                            cv)))
                for _ in range(int(rng.integers(1, 40)))]
        for t in txns[:: 2 + seed % 2]:
            t.report_conflicting_keys = True
        trio.resolve(txns, cv, cv - 200, f"batch {i}")


def test_chunked_batches():
    rng = np.random.default_rng(7)
    trio = Trio(**KW)
    cv = 100
    for i in range(4):
        cv += 10
        txns = [rand_txn(rng, read_version=cv - int(rng.integers(1, 20)))
                for _ in range(80)]  # three chunks
        txns[5].report_conflicting_keys = True
        trio.resolve(txns, cv, what=f"batch {i}")


def test_too_old_only_with_reads():
    trio = Trio(**KW)
    got = trio.resolve([TxnConflictInfo(1, [pt(b"a")], []),
                        TxnConflictInfo(1, [], [pt(b"b")])], 1000, 500)
    assert got == [2, 0]


def test_wide_range_limits():
    rng = np.random.default_rng(11)
    trio = Trio(capacity=512, batch_size=16, max_read_ranges=12,
                max_write_ranges=8, max_key_bytes=8)
    cv = 500
    for i in range(6):
        cv += int(rng.integers(1, 30))
        txns = [rand_txn(rng, read_version=int(rng.integers(max(0, cv - 100),
                                                            cv)), n_ranges=10)
                for _ in range(int(rng.integers(1, 16)))]
        trio.resolve(txns, cv, what=f"batch {i}")


def test_multiblock_acceptance():
    rng = np.random.default_rng(7)
    trio = Trio(capacity=4096, batch_size=1024, max_read_ranges=2,
                max_write_ranges=2, max_key_bytes=8)
    cv = 1000
    for i in range(2):
        cv += int(rng.integers(1, 50))
        txns = [rand_txn(rng, read_version=int(rng.integers(cv - 100, cv)),
                         n_ranges=2, alphabet=3, max_len=2)
                for _ in range(1024)]
        trio.resolve(txns, cv, what=f"batch {i}")


def test_tiny_delta_forces_full_repack():
    rng = np.random.default_rng(9)
    trio = Trio(dict_delta_slots=4, **KW)
    cv = 1000
    for i in range(6):
        cv += int(rng.integers(1, 50))
        txns = [rand_txn(rng, read_version=int(rng.integers(cv - 300, cv)))
                for _ in range(int(rng.integers(8, 24)))]
        trio.resolve(txns, cv, cv - 200, f"batch {i}")
    assert trio.port.dict_stats["full_repacks"] >= 2
    assert trio.port.dict_stats["full_repacks"] == \
        trio.jax.dict_stats["full_repacks"]


def test_eviction_then_reappearance():
    trio = Trio(dict_capacity=96, dict_delta_slots=48,
                **dict(KW, window_versions=120))
    hot = b"evict-me"
    cv = 1000
    for i in range(14):
        cv += 10
        txns = [TxnConflictInfo(cv - 5, [pt(hot)], [pt(hot)])] \
            if i % 7 == 0 else []
        txns += [TxnConflictInfo(cv - 5, [], [pt(f"churn{i}_{j}".encode())])
                 for j in range(8)]
        trio.resolve(txns, cv, cv - 100, f"round {i}")
    st = trio.port.dict_stats
    assert st["full_repacks"] > 0 and st["evictions"] > 0, st
    assert st["evictions"] == trio.jax.dict_stats["evictions"]


def test_gc_and_headroom_recover():
    trio = Trio(capacity=256, batch_size=16, max_key_bytes=8,
                window_versions=100)
    cv = 1000
    for i in range(30):
        cv += 10
        trio.resolve([TxnConflictInfo(cv - 5, [], [pt(f"g{i}_{j}".encode())])
                      for j in range(8)], cv, what=f"round {i}")
    h0 = trio.port.headroom()
    cv += 1000
    trio.port.advance(cv)
    trio.jax.advance(cv)
    trio.check("after advance")
    assert trio.port.headroom() > h0
    trio.port.clear_overflow()
    trio.jax.clear_overflow()
    trio.check("after clear_overflow")


def jax_snapshot(cs: TPUConflictSet) -> dict:
    """The convert.py snapshot dict, built from a JAX engine."""
    mir = cs._mirror
    return {
        "config": {f: getattr(cs, f) for f in convert.CONFIG_FIELDS}
        | {"max_key_bytes": cs.codec.max_key_bytes},
        "state": {k: np.array(v) for k, v in
                  convert.state_leaves(cs.state).items()},
        "mirror": {f: np.array(getattr(mir, f))
                   for f in convert.MIRROR_FIELDS} | {"stats": mir.stats},
        "base_version": cs.base_version,
        "oldest_version": cs.oldest_version,
        "last_commit": cs._last_commit,
    }


def test_engine_from_snapshot_continues_the_stream():
    rng = np.random.default_rng(5)
    jcs = TPUConflictSet(resident=True, **KW)

    def batch(cv):
        return [rand_txn(rng, read_version=int(rng.integers(cv - 300, cv)))
                for _ in range(int(rng.integers(8, 32)))]

    cv = 1000
    for _ in range(5):
        cv += int(rng.integers(1, 50))
        jcs.resolve(batch(cv), cv, cv - 200)
    snap = jax_snapshot(jcs)
    port = convert.engine_from_snapshot(snap, device="cpu")
    mine = convert.snapshot(port)
    for k, v in snap["state"].items():
        assert mine["state"][k].tobytes() == v.tobytes(), k
    for _ in range(5):
        cv += int(rng.integers(1, 50))
        txns = batch(cv)
        want = [int(v) for v in jcs.resolve(txns, cv, cv - 200)]
        got = [int(v) for v in port.resolve([port_txn(t) for t in txns], cv,
                                            cv - 200)]
        assert got == want
    after = convert.snapshot(port)
    for k, v in jax_snapshot(jcs)["state"].items():
        assert after["state"][k].tobytes() == v.tobytes(), k
    assert port.dict_stats["dispatches"] == jcs.dict_stats["dispatches"]


@pytest.mark.parametrize("pad", [None, 64])
def test_pack_rank_dictionary(pad):
    from foundationdb_tpu.models.conflict_set import (
        pack_rank_dictionary as jax_pack,
    )
    from foundationdb_tpu_torch.models.conflict_set import (
        pack_rank_dictionary as port_pack,
    )

    rng = np.random.default_rng(4)
    flat = rng.integers(-3, 3, size=(40, 3)).astype(np.int32)
    for got, want in zip(port_pack(flat, pad), jax_pack(flat, pad)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
