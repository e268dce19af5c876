"""The port's tiered HBM/host dictionary vs the JAX package's, on the CPU.

K7's plain version (``_dict_evict_plain``) and ``apply_evict`` must equal
JAX ``_dict_evict`` / ``apply_evict`` byte for byte on seeded inputs; the
tiered engine (``dict_hot_capacity > 0``) must equal ``TPUConflictSet`` of
the same configuration verdict for verdict, with every state leaf, the
mirror's arrays and ``dict_stats`` equal after every step, on the streams
of ``tests/test_tiered_dict.py``: the shifting hotspot (demotions, then
promotions when the first hotspot returns, no full repack), the
stationary thrash regime (demotion cannot free room: full repacks), the
deferred demotion of the threaded window path, and the victim policy.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.core.types import KeyRange, TxnConflictInfo
from foundationdb_tpu.models import conflict_kernel as jck
from foundationdb_tpu.models.conflict_set import TPUConflictSet
from foundationdb_tpu.models.conflict_set import encode_resolve_batch as jenc
from foundationdb_tpu.sim.oracle import OracleConflictSet
from foundationdb_tpu_torch import TorchConflictSet
from foundationdb_tpu_torch.models import conflict_kernel as tck
from foundationdb_tpu_torch.models.conflict_set import (
    encode_resolve_batch as tenc,
)
from foundationdb_tpu_torch.sched.packing import PipelinedWindowRunner
from tests.test_conflict_oracle import rand_txn
from tests.test_tiered_dict import KW, TIER, _hot_txn, _hotspot_steps
from tests.test_torch_conflict_kernel import T, same, t_res
from tests.test_torch_conflict_set import port_txn
from tests.test_torch_window import same_state

# Small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the CPU.
torch.set_num_threads(1)

MIRROR = ("u64", "rows", "pinned", "id_at", "rank_of_id", "hot_by_id",
          "last_used_by_id")


def same_engine(port, jax, what=""):
    """Every state leaf, the mirror's arrays and dict_stats."""
    same_state(port.state, jax.state, what)
    for f in MIRROR:
        a, b = getattr(port._mirror, f), getattr(jax._mirror, f)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        assert a.tobytes() == b.tobytes(), (what, f)
    assert port._mirror.cold_n == jax._mirror.cold_n, what
    assert port.dict_stats == jax.dict_stats, what


class TieredPair:
    """A JAX and a port engine of one configuration, in lockstep."""

    def __init__(self, **kw):
        self.jax = TPUConflictSet(resident=True, **kw)
        self.port = TorchConflictSet(device="cpu", **kw)
        assert self.jax.tiered == self.port.tiered

    def resolve(self, txns, cv, oldest, what=""):
        want = [int(v) for v in self.jax.resolve(txns, cv, oldest)]
        got = [int(v) for v in self.port.resolve(
            [port_txn(t) for t in txns], cv, oldest)]
        assert got == want, f"{what}: port vs jax"
        same_engine(self.port, self.jax, what)
        return got


# ------------------------------------------------------------ K7 plain


def evict_case(name, n, e, rng):
    ev = np.full(e, tck.INT32_MAX, np.int32)
    picks = {"empty": [], "pads": [], "rank0": [0], "last": [n - 1],
             "full": sorted(rng.choice(n, e, replace=False)),
             "mid": sorted(rng.choice(np.arange(1, n - 1), 3, replace=False))}
    real = np.asarray(picks[name], np.int32)
    ev[:len(real)] = real
    return ev


@pytest.fixture(scope="module")
def jax_res():
    """A mid-stream JAX resident state (a full dictionary delta merged,
    history of both levels populated)."""
    rng = np.random.default_rng(3)
    cs = TPUConflictSet(resident=True, **KW)
    cv = 1000
    for _ in range(6):
        cv += 10
        cs.resolve([rand_txn(rng, read_version=cv - 30) for _ in range(24)],
                   cv, cv - 100)
    return cs.state


@pytest.mark.parametrize("name,e", [("empty", 0), ("pads", 8), ("rank0", 4),
                                    ("last", 4), ("full", 16), ("mid", 5)])
def test_dict_evict_and_apply_evict_equal_jax(jax_res, name, e):
    n = int(jax_res.n_keys)
    ev = evict_case(name, n, e, np.random.default_rng(e))
    want = jck._dict_evict(jax_res.dict_keys, jax_res.n_keys, jnp.asarray(ev))
    got = tck._dict_evict_plain(T(jax_res.dict_keys), T(jax_res.n_keys),
                                T(ev))
    for g, w, what in zip(got, want, ("dict_keys", "n_keys", "shift")):
        same(g, w, f"{name}: {what}")
    want = jck.apply_evict(jax_res, jnp.asarray(ev))
    got = tck.apply_evict(t_res(jax_res), T(ev))
    same_state(got, want, name)
    # The host count decides the skip: an empty delta leaves the state.
    n_ev = int((ev != tck.INT32_MAX).sum())
    res = t_res(jax_res)
    assert (tck.apply_evict(res, T(ev), n_ev) is res) == (n_ev == 0)


# ------------------------------------------------------------ engine


def test_shifting_hotspot_equals_jax():
    """The tier's intended regime: keys demote as the hotspot moves on and
    promote when it returns, with no full repack; equal to the JAX tiered
    engine after every step and to the oracle."""
    pair = TieredPair(**TIER, **KW)
    oracle = OracleConflictSet()
    for i, (txns, cv, oldest) in enumerate(_hotspot_steps()):
        got = pair.resolve(txns, cv, oldest, f"step {i}")
        oracle.oldest_version = max(oracle.oldest_version, oldest)
        assert got == [int(v) for v in oracle.resolve(txns, cv)], i
    st = pair.port.dict_stats
    assert st["tiered"] and st["full_repacks"] == 0, st
    assert st["demotions"] > 0 and st["promotions"] > 0, st
    assert st["demotion_events"] >= 3, st
    assert st["cold_tier_keys"] == st["demotions"] - st["promotions"], st
    assert st["resident_keys"] <= 384 < st["resident_keys"] \
        + st["cold_tier_keys"]
    assert not pair.port.overflowed


def test_uniform_thrash_regime_equals_jax():
    """Most hot ranks stay device-live: demotion cannot free room and the
    engine falls back to full repacks, which keep the cold tier."""
    rng = np.random.default_rng(29)
    pair = TieredPair(dict_hot_capacity=320, dict_delta_slots=192, **KW)
    cv = 1000
    for i in range(12):
        cv += int(rng.integers(1, 40))
        txns = [rand_txn(rng, read_version=int(rng.integers(max(0, cv - 200),
                                                             cv)))
                for _ in range(int(rng.integers(8, 32)))]
        pair.resolve(txns, cv, cv - 150, f"batch {i}")
    assert pair.port.dict_stats["full_repacks"] > 0
    assert not pair.port.overflowed


def hotspot_windows(prefix: bytes, n_windows: int, batch: int, seed: int):
    """[(txns, commit versions)] of 2-batch windows over a hotspot that
    walks 300 keys every 10 batches (``tests/test_tiered_dict.py:127``)."""
    rng = np.random.default_rng(seed)

    def txn(center, rv):
        ks = [prefix + b"%06d" % (center + int(rng.integers(0, 40)))
              for _ in range(3)]
        return TxnConflictInfo(
            read_version=rv,
            read_ranges=[KeyRange(k, k + b"\x00") for k in ks[:2]],
            write_ranges=[KeyRange(ks[2], ks[2] + b"\x00")])

    out, cv, bidx = [], 0, 0
    for _ in range(n_windows):
        txns, cvs = [], []
        for _ in range(2):
            cv += 10
            txns += [txn((bidx // 10) * 300, max(0, cv - 60))
                     for _ in range(batch)]
            cvs.append(cv)
            bidx += 1
        out.append((txns, cvs))
    return out


WINDOW_KW = dict(capacity=1 << 10, batch_size=16, max_read_ranges=2,
                 max_write_ranges=2, max_key_bytes=12, window_versions=100)


@pytest.mark.parametrize("threaded", [False, True])
def test_deferred_demotion_through_runner(threaded):
    """A demotion that falls due on the packing thread defers into the
    window (gate held) and runs on the dispatch thread: the runner's
    verdicts, state, mirror and dict_stats equal the JAX tiered engine's
    window path, and its verdicts the untiered port engine's."""
    windows = hotspot_windows(b"w", 24, 16, 5)
    jcs = TPUConflictSet(resident=True, dict_hot_capacity=384,
                         dict_delta_slots=128, **WINDOW_KW)
    tcs = TorchConflictSet(device="cpu", dict_hot_capacity=384,
                           dict_delta_slots=128, **WINDOW_KW)
    plain = TorchConflictSet(device="cpu", **WINDOW_KW)
    runner = PipelinedWindowRunner(tcs, threaded=threaded)
    try:
        for w, (txns, cvs) in enumerate(windows):
            runner.submit(tenc([port_txn(t) for t in txns]), cvs, 16)
            got = runner.collect_next()
            want = np.asarray(jcs.resolve_wire_window(jenc(txns), cvs, 16))
            assert np.array_equal(got, want), w
            assert np.array_equal(got, plain.resolve_wire_window(
                tenc([port_txn(t) for t in txns]), cvs, 16)), w
            same_engine(tcs, jcs, f"window {w}")
    finally:
        runner.close()
    st = tcs.dict_stats
    assert st["demotion_stalls"] > 0 and st["demotions"] > 0, st
    assert st["full_repacks"] == 0, st


def test_demote_victim_policy_equals_jax():
    """Pinned keys and keys inside the MVCC window never demote; long-cold
    unpinned keys do, and the pinned ones keep their ids."""
    pair = TieredPair(**TIER, **KW)
    rng = np.random.default_rng(11)
    cv = 1000
    for step in range(4):
        cv += 10
        pair.resolve([_hot_txn(rng, step * 200, cv - 5) for _ in range(12)],
                     cv, cv - 100, f"step {step}")
    assert pair.port._demote_now(0) == pair.jax._demote_now(0) == 0
    for cs in (pair.port, pair.jax):
        cs.advance(cv + 500, oldest_version=cv + 400)
        cs._mirror.pinned[:2] = True
    pinned_ids = pair.port._mirror.id_at[:2].copy()
    n0 = pair.port._mirror.n
    demoted = pair.port._demote_now(0)
    assert demoted == pair.jax._demote_now(0) > 0
    mir = pair.port._mirror
    assert mir.n == n0 - demoted and mir.hot_by_id[pinned_ids].all()
    assert int(mir.pinned[:mir.n].sum()) == 2
    same_engine(pair.port, pair.jax, "after the sweep")


def test_deferred_demotion_gate_order_settled_by_the_oracle():
    """ROADMAP Queue 3's departure in ``_demote_and_rank``, settled.
    JAX function: ``TPUConflictSet._demote_and_rank``
    (``foundationdb_tpu/models/conflict_set.py:1165-1170``) opens the
    mirror's gate, then re-packs the stalled window; the port re-packs,
    then opens it. Input: ``hotspot_windows(b"w", 24, 16, 5)`` on a tiered
    engine (hot tier 384, delta slots 128, ``WINDOW_KW``); windows 15 and
    20 defer a demotion. First output that differs: with the interleaving
    the JAX order allows (the packing thread, woken by the open gate,
    packs window 16 before window 15's re-pack runs) JAX's verdicts leave
    the oracle's from window 16 on; run in order, JAX equals the oracle.
    The port holds its gate closed through the re-pack (a spy sees it
    closed there, and open there in JAX), and its threaded runner with
    windows packed ahead equals the oracle and the in-order JAX run
    verdict for verdict. Neither a plain twin nor a kernel is involved:
    the difference is the host's order of gate and re-pack."""
    from foundationdb_tpu.models.conflict_set import _DemotePlan
    from tests.test_torch_window import oracle_window

    windows = hotspot_windows(b"w", 24, 16, 5)
    tier = dict(dict_hot_capacity=384, dict_delta_slots=128)

    def oracle_rows():
        oracle = OracleConflictSet()
        return [oracle_window(oracle, txns, cvs, 16,
                              WINDOW_KW["window_versions"])
                for txns, cvs in windows]

    want = oracle_rows()

    def jax_run(race: bool):
        jcs = TPUConflictSet(resident=True, **tier, **WINDOW_KW)
        real, gate_open, prepared, rows = jcs._pack_resident, [], {}, []
        for w, (txns, cvs) in enumerate(windows):
            p = prepared.pop(w, None) or jcs.pack_wire_window(jenc(txns),
                                                              cvs, 16)
            if isinstance(p.batch, _DemotePlan):
                def repack(bt, defer_repack=False, nxt=w + 1):
                    jcs._pack_resident = real
                    gate_open.append(jcs._mirror.gate.is_set())
                    if race and nxt < len(windows):
                        t2, c2 = windows[nxt]
                        prepared[nxt] = jcs.pack_wire_window(jenc(t2), c2,
                                                             16)
                    return real(bt, defer_repack)
                jcs._pack_resident = repack
            rows.append(np.asarray(jcs.dispatch_window(p)()))
            jcs._pack_resident = real
        return rows, gate_open

    in_order, gate_open = jax_run(race=False)
    assert gate_open == [True, True]
    assert all(np.array_equal(a, b) for a, b in zip(in_order, want))
    raced, _ = jax_run(race=True)
    differ = [w for w, (a, b) in enumerate(zip(raced, want))
              if not np.array_equal(a, b)]
    assert differ and differ[0] == 16, differ

    tcs = TorchConflictSet(device="cpu", **tier, **WINDOW_KW)
    real_ranked, port_gate = tcs._pack_ranked, []

    def spy(bt, defer_repack=False):
        if threading.current_thread() is threading.main_thread():
            port_gate.append(tcs._mirror.gate.is_set())
        return real_ranked(bt, defer_repack)

    tcs._pack_ranked = spy
    runner = PipelinedWindowRunner(tcs, threaded=True, max_pending=4)
    try:
        for txns, cvs in windows[:4]:
            runner.submit(tenc([port_txn(t) for t in txns]), cvs, 16)
        got = []
        for txns, cvs in windows[4:]:
            got.append(runner.collect_next())
            runner.submit(tenc([port_txn(t) for t in txns]), cvs, 16)
        got += [runner.collect_next() for _ in range(4)]
    finally:
        runner.close()
    st = tcs.dict_stats
    assert st["demotion_stalls"] > 0 and st["full_repacks"] == 0, st
    assert port_gate and not any(port_gate), port_gate
    for w, (a, b, c) in enumerate(zip(got, want, in_order)):
        assert np.array_equal(a, b) and np.array_equal(a, c), w
