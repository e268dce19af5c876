"""The port's admission filter and its engine feed vs the JAX package's.

Exact everywhere: the port's filter (numpy and device backends; the
device backend runs K11's plain versions on the CPU) answers every probe,
exact probe, saturation and metric of ``foundationdb_tpu/admission``'s
``RecentWritesFilter`` (numpy and jax backends) bit for bit, with equal
banks, on the cases of ``tests/test_admission.py`` and a randomized stream
across bank rotations; a resident ``TorchConflictSet`` with a filter
attached feeds it exactly as ``TPUConflictSet(resident=True)`` feeds a
jax-backend filter (object, wire and two-phase wave paths, across
eviction, with rejected writes left out); a tiered engine's demotion
excludes what the filter reports recent exactly as JAX's does.
"""

import numpy as np
import pytest
import torch

from foundationdb_tpu.admission import RecentWritesFilter as JFilter
from foundationdb_tpu.admission import u64_cols_fingerprint as j_fp
from foundationdb_tpu.core.types import KeyRange, TxnConflictInfo
from foundationdb_tpu.models.conflict_set import TPUConflictSet
from foundationdb_tpu.models.conflict_set import encode_resolve_batch as jenc
from foundationdb_tpu_torch import TorchConflictSet, convert
from foundationdb_tpu_torch.admission import RecentWritesFilter as TFilter
from foundationdb_tpu_torch.admission import filter as tf
from foundationdb_tpu_torch.admission import (
    fingerprints,
    u64_cols_fingerprint,
)
from foundationdb_tpu_torch.core import wavemesh
from foundationdb_tpu_torch.models.conflict_set import (
    _rows_to_u64,
    encode_resolve_batch as tenc,
)
from tests.test_conflict_oracle import rand_txn
from tests.test_tiered_dict import KW, TIER, _hotspot_steps
from tests.test_torch_conflict_set import port_txn
from tests.test_torch_tiered import same_engine

torch.set_num_threads(1)

BACKENDS = [("jax", "numpy"), ("jax", "jax"), ("port", "numpy"),
            ("port", "device")]


def make(which, backend, **kw):
    kw.setdefault("bits_log2", 12)
    kw.setdefault("banks", 4)
    kw.setdefault("window_versions", 1000)
    if which == "jax":
        return JFilter(backend=backend, **kw)
    return TFilter(backend=backend, device="cpu", **kw)


def bits_of(f) -> np.ndarray:
    """The banks as bool [banks, nbits], whatever the package or backend."""
    if isinstance(f, TFilter):
        return convert.filter_snapshot(f)["bits"]
    return np.asarray(f._bits.bits)


def jax_snapshot(f: JFilter) -> dict:
    """A JAX filter as the port's convert snapshot."""
    return {
        "config": {"bits_log2": f.nbits.bit_length() - 1, "banks": f.banks,
                   "hashes": f.hashes, "window_versions": f.window_versions,
                   "exact_shadow": f.exact_shadow},
        "bits": bits_of(f), "bank_min": f.bank_min, "bank_max": f.bank_max,
        "_cur": f._cur, "_cur_from": f._cur_from, "delta_seq": f.delta_seq,
        "recorded": f.recorded, "rotations": f.rotations,
        "shadow": f._shadow, "delta_log": f._delta_log,
    }


class Quad:
    """The four filters in lockstep: every call returns the four answers,
    which must be equal."""

    def __init__(self, **kw):
        self.fs = [make(w, b, **kw) for w, b in BACKENDS]

    def __getattr__(self, name):
        def call(*args):
            outs = [getattr(f, name)(*args) for f in self.fs]
            for o in outs[1:]:
                if isinstance(o, np.ndarray):
                    assert o.dtype == outs[0].dtype, name
                    assert o.tolist() == outs[0].tolist(), name
                else:
                    assert o == outs[0], name
            return outs[0]

        return call

    def check(self):
        for f in self.fs[1:]:
            assert bits_of(f).tobytes() == bits_of(self.fs[0]).tobytes()
            for k in ("bank_min", "bank_max", "_cur", "_cur_from",
                      "rotations", "recorded", "delta_seq"):
                assert np.array_equal(getattr(f, k), getattr(self.fs[0], k))
            assert f._shadow == self.fs[0]._shadow
            assert f.metrics() | {"backend": 0} == \
                self.fs[0].metrics() | {"backend": 0}


# ---------------------------------------------------- filter and K11 plain


def test_fingerprints_equal_jax():
    from foundationdb_tpu.admission import fingerprints as jf

    keys = [b"", b"a", b"hot", b"\x00\xff" * 9, b"k%06d" % 7]
    assert fingerprints(keys).tobytes() == jf(keys).tobytes()
    cols = np.random.default_rng(1).integers(0, 2**63, (50, 3)).astype(
        np.uint64)
    assert u64_cols_fingerprint(cols).tobytes() == j_fp(cols).tobytes()


def test_point_hits_gate_on_read_version():
    q = Quad()
    q.record([b"hot"], 100)
    assert q.probe_keys([b"hot"], 50).tolist() == [True]
    assert q.probe_exact(b"hot", 50) == 100
    assert q.probe_keys([b"hot"], 100).tolist() == [False]
    assert q.probe_exact(b"hot", 100) is None
    assert q.probe_keys([b"cold"], 0).tolist() == [False]
    q.check()


def test_aging_across_version_windows():
    q = Quad()
    q.record([b"old"], 10)
    assert q.probe_keys([b"old"], 0).tolist() == [True]
    q.record([b"mid"], 700)
    assert q.probe_keys([b"old"], 0).tolist() == [True]
    q.record([b"new"], 10 + 4 * 250 + 1)
    assert q.probe_keys([b"old"], 0).tolist() == [False]
    assert q.probe_exact(b"old", 0) is None
    assert q.probe_keys([b"new"], 0).tolist() == [True]
    q.check()


def test_saturation_rises_and_rotation_clears():
    q = Quad(bits_log2=8)
    assert q.saturation() == 0.0
    q.record([b"k%04d" % i for i in range(200)], 100)
    assert q.saturation() > 0.5
    q.check()
    q.advance(100 + 4 * 250 + 1)
    assert q.saturation() == 0.0
    q.check()


def test_delta_feed_round_trip():
    src = Quad()
    src.record([b"a", b"b"], 100)
    src.record([b"c"], 150)
    seq, entries = src.delta_since(0)
    assert seq == 3 and len(entries) == 3
    dst = Quad()
    dst.apply_delta(entries)
    dst.apply_delta(entries)
    assert dst.probe_exact(b"a", 50) == 100
    assert dst.probe_exact(b"c", 100) == 150
    assert src.delta_since(seq) == (seq, [])
    dst.check()


def test_u64_fingerprint_matches_key_columns():
    q = Quad()
    fps = u64_cols_fingerprint(np.array([[1, 2], [3, 4]], np.uint64))
    q.record_u64(fps, 100)
    assert q.probe_u64(fps, 50).tolist() == [True, True]
    assert q.probe_u64(u64_cols_fingerprint(
        np.array([[9, 9]], np.uint64)), 50).tolist() == [False]
    q.check()


@pytest.mark.parametrize("bits_log2,banks,hashes", [(6, 3, 2), (9, 4, 3),
                                                    (12, 5, 1)])
def test_random_stream_across_rotations(bits_log2, banks, hashes):
    """Seeded records, advances and probes across many bank rotations
    (small banks: probes hit, and false positives occur)."""
    rng = np.random.default_rng(bits_log2 + banks)
    q = Quad(bits_log2=bits_log2, banks=banks, hashes=hashes,
             window_versions=600)
    v = 0
    for step in range(60):
        v += int(rng.integers(1, 60))
        if rng.random() < 0.15:
            q.advance(v)
        else:
            fps = rng.integers(0, 2**64 - 1, int(rng.integers(0, 40)),
                               dtype=np.uint64)
            q.record_u64(fps, v)
        probe = rng.integers(0, 2**64 - 1, 64, dtype=np.uint64)
        for rv in (v - 500, v - 100, v):
            q.probe_u64(probe, rv)
        if step % 10 == 0:
            q.check()
    assert q.fs[0].rotations > banks
    q.check()


def test_k11_plain_versions_on_packed_and_bool_banks():
    """K11's plain versions over bool banks against the numpy banks, and
    the bit packing the card's words use round-tripped."""
    rng = np.random.default_rng(5)
    banks, nbits = 3, 200
    ref = tf._NumpyBanks(banks, nbits)
    bits = torch.zeros((banks, nbits), dtype=torch.bool)
    for bank in (0, 2, 2, 1):
        idx = rng.integers(0, nbits, 37)
        ref.set(bank, idx)
        tf.banks_set_plain(bits, bank, torch.from_numpy(idx))
    assert np.array_equal(bits.numpy(), ref.bits)
    idx = rng.integers(0, nbits, (41, 2))
    for mask in ([True, False, True], [False] * 3, [True] * 3):
        m = np.asarray(mask)
        got = tf.banks_probe_plain(bits, torch.from_numpy(idx),
                                   torch.from_numpy(m))
        assert got.numpy().tolist() == ref.any_all_hashes(idx, m).tolist()
    assert tf.banks_count_plain(bits).tolist() == ref.bits.sum(1).tolist()
    words = tf.pack_banks(bits)
    assert words.shape == (banks, 7) and words.dtype == torch.int32
    assert torch.equal(tf.unpack_banks(words, nbits), bits)


def test_convert_carries_a_jax_filter():
    rng = np.random.default_rng(9)
    jf = make("jax", "jax", window_versions=400)
    for v in range(10, 900, 37):
        jf.record([b"k%03d" % rng.integers(0, 90)
                   for _ in range(int(rng.integers(0, 6)))], v)
    snap = jax_snapshot(jf)
    pfs = [convert.filter_from_snapshot(snap, b, device="cpu")
           for b in ("numpy", "device")]
    probes = [b"k%03d" % i for i in range(100)]
    for pf in pfs:
        assert bits_of(pf).tobytes() == bits_of(jf).tobytes()
        assert convert.filter_snapshot(pf)["bits"].tobytes() == \
            snap["bits"].tobytes()
    for v in (950, 1400):
        keys = [b"k%03d" % rng.integers(0, 90) for _ in range(4)]
        for f in (jf, *pfs):
            f.record(keys, v)
    for pf in pfs:
        for rv in (0, 500, 1000):
            assert pf.probe_keys(probes, rv).tolist() == \
                jf.probe_keys(probes, rv).tolist()
        assert pf.metrics() | {"backend": 0} == jf.metrics() | {"backend": 0}
        assert pf.delta_since(3) == jf.delta_since(3)
        assert pf.probe_exact(probes[7], 0) == jf.probe_exact(probes[7], 0)


def test_device_filter_defaults_to_cuda():
    if torch.cuda.is_available():
        assert TFilter(backend="device")._bits.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        TFilter(backend="device")
    with pytest.raises(ValueError, match="backend"):
        TFilter(backend="jax")


# ------------------------------------------------------- the engine feed


def pt(k: bytes) -> KeyRange:
    return KeyRange(k, k + b"\x00")


def txn(write_key: bytes, rv: int = 0, read_key: bytes = b"r"):
    return TxnConflictInfo(read_ranges=[pt(read_key)],
                           write_ranges=[pt(write_key)], read_version=rv)


class FedPair:
    """A JAX resident engine with a jax-backend filter and a port engine
    with a device-backend filter on the CPU, in lockstep."""

    def __init__(self, fkw=None, **kw):
        fkw = {"bits_log2": 12, "banks": 4, "window_versions": 10_000,
               **(fkw or {})}
        self.jax = TPUConflictSet(resident=True, **kw)
        self.port = TorchConflictSet(device="cpu", **kw)
        self.jf = JFilter(backend="jax", **fkw)
        self.pf = TFilter(backend="device", device="cpu", **fkw)
        self.jax.attach_admission_filter(self.jf)
        self.port.attach_admission_filter(self.pf)

    def check(self, what=""):
        assert bits_of(self.pf).tobytes() == bits_of(self.jf).tobytes(), what
        for k in ("bank_min", "bank_max", "_cur", "_cur_from", "recorded",
                  "rotations"):
            assert np.array_equal(getattr(self.pf, k),
                                  getattr(self.jf, k)), (what, k)

    def resolve(self, txns, cv, oldest=None, what=""):
        want = [int(v) for v in self.jax.resolve(txns, cv, oldest)]
        got = [int(v) for v in self.port.resolve(
            [port_txn(t) for t in txns], cv, oldest)]
        assert got == want, what
        self.check(what)
        return got

    def fp(self, key: bytes):
        rows, _ = self.port.codec.pack_ranges([(key, key + b"\x00")])
        return u64_cols_fingerprint(_rows_to_u64(np.asarray(rows, np.int32)))


def test_feed_and_eviction_interaction():
    pair = FedPair(capacity=1 << 10, batch_size=16, dict_capacity=96,
                   dict_delta_slots=16, window_versions=40)
    v = 100
    pair.resolve([txn(b"hotkey", rv=v - 1)], v)
    assert pair.pf.probe_u64(pair.fp(b"hotkey"), v - 1).tolist() == [True]
    recorded = pair.pf.recorded
    for i in range(12):
        v += 10
        pair.resolve([txn(b"churn/%04d/%d" % (i, j), rv=v - 1)
                      for j in range(8)], v, what=i)
    st = pair.port.dict_stats
    assert st["evictions"] + st["full_repacks"] > 0
    assert st == pair.jax.dict_stats
    assert pair.pf.recorded > recorded
    assert pair.pf.probe_u64(pair.fp(b"churn/0011/0"),
                             v - 1).tolist() == [True]


def test_rejected_writes_not_fed():
    pair = FedPair(capacity=1 << 10, batch_size=16)
    pair.resolve([txn(b"winner")], 100)
    loser = TxnConflictInfo(read_ranges=[pt(b"winner")],
                            write_ranges=[pt(b"loser")], read_version=50)
    assert pair.resolve([loser], 200) == [1]
    assert pair.pf.probe_u64(pair.fp(b"loser"), 0).tolist() == [False]
    assert pair.pf.probe_u64(pair.fp(b"winner"), 0).tolist() == [True]


@pytest.mark.parametrize("path", ["object", "wire", "chunked"])
def test_random_stream_feed_equals_jax(path):
    """Seeded streams with reports, chunked batches, advances (GC-only
    dispatches age the banks) and the wire path's as_array collector."""
    rng = np.random.default_rng({"object": 1, "wire": 2, "chunked": 3}[path])
    kw = dict(capacity=256, batch_size=16 if path == "chunked" else 32,
              max_read_ranges=3, max_write_ranges=3, max_key_bytes=8,
              window_versions=300)
    pair = FedPair(fkw={"bits_log2": 9, "window_versions": 200}, **kw)
    cv = 1000
    for i in range(14):
        cv += int(rng.integers(5, 40))
        if i % 5 == 4:
            pair.jax.advance(cv)
            pair.port.advance(cv)
            pair.check(i)
            continue
        txns = [rand_txn(rng, read_version=cv - int(rng.integers(1, 150)))
                for _ in range(int(rng.integers(1, 40)))]
        if path == "wire":
            want = pair.jax.resolve_wire_async(jenc(txns), cv,
                                               as_array=True)()
            got = pair.port.resolve_wire_async(
                tenc([port_txn(t) for t in txns]), cv, as_array=True)()
            assert got.tolist() == want.tolist(), i
            pair.check(i)
        else:
            pair.resolve(txns, cv, what=i)
    assert pair.pf.recorded > 0 and pair.pf.rotations > 0


def test_two_phase_wave_global_feed():
    """resolve_edges / resolve_apply on wave engines: each shard feeds the
    writes the GLOBAL schedule commits at the window's version."""
    rng = np.random.default_rng(11)
    kw = dict(capacity=256, batch_size=32, max_read_ranges=2,
              max_write_ranges=2, max_key_bytes=8, wave_commit=True)
    pairs = [FedPair(**kw) for _ in range(2)]
    bounds = [(b"", b"\x62"), (b"\x62", b"\xff")]
    cv = 100
    for i in range(6):
        cv += 10
        txns = [rand_txn(rng, read_version=cv - int(rng.integers(1, 30)))
                for _ in range(20)]
        jedges, pedges = [], []
        for p, (lo, hi) in zip(pairs, bounds):
            part = wavemesh.clip_txns([port_txn(t) for t in txns], lo, hi)
            from foundationdb_tpu.core import wavemesh as jwm

            jpart = jwm.clip_txns(txns, lo, hi)
            jedges.append(p.jax.resolve_edges(jpart, cv))
            pedges.append(p.port.resolve_edges(part, cv))
        from foundationdb_tpu.core import wavemesh as jwm

        jg, pg = jwm.combine_edges(jedges), wavemesh.combine_edges(pedges)
        for p in pairs:
            want = [int(v) for v in p.jax.resolve_apply(jg)]
            got = [int(v) for v in p.port.resolve_apply(pg)]
            assert got == want, i
            p.check(i)
    assert all(p.pf.recorded > 0 for p in pairs)


def test_filter_refused_on_a_non_resident_engine():
    cs = TorchConflictSet(device="cpu", resident=False, capacity=64,
                          batch_size=8, max_key_bytes=8)
    with pytest.raises(ValueError, match="resident engine only"):
        cs.attach_admission_filter(TFilter())


# --------------------------------------------- the tiered exclusion


@pytest.mark.parametrize("bits_log2", [6, 10])
def test_tiered_demotion_excludes_recent_writes_like_jax(bits_log2):
    """The shifting hotspot through tiered engines with filters attached:
    verdicts, every state leaf, the mirror and dict_stats equal JAX after
    every step; a saturated filter (2^6 bits) holds back victims, so its
    dict_stats differ from the unfiltered run's."""
    fkw = {"bits_log2": bits_log2, "banks": 4, "window_versions": 120}
    pair = FedPair(fkw=fkw, **TIER, **KW)
    bare = TorchConflictSet(device="cpu", **TIER, **KW)
    for i, (txns, cv, oldest) in enumerate(_hotspot_steps()):
        pair.resolve(txns, cv, oldest, f"step {i}")
        same_engine(pair.port, pair.jax, f"step {i}")
        bare.resolve([port_txn(t) for t in txns], cv, oldest)
    st = pair.port.dict_stats
    assert st["demotions"] > 0, st
    if bits_log2 == 6:
        assert st != bare.dict_stats
