"""The port's speculative window resolve vs the JAX package's, on the CPU.

The snapshot must be a deep copy and the paint-only window's plain
version (``paint_many_res_plain``) must equal JAX ``paint_many_res`` in
every state leaf. A speculative engine (``spec_resolve=True``) must equal
a serial one when every window confirms, threaded or not; under a hook
that revokes the first accepted txn of every window, depth 3 must equal
depth 1 and the JAX speculative engine with the same hook, in verdicts,
levels, ``spec_metrics`` and every state leaf (sequential and wave
engines). Also: the object path's ``spec_resolve_async``, speculation
over the tiered dictionary, and ``convert`` carrying a tiered engine.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.models import conflict_kernel as jck
from foundationdb_tpu.models.conflict_set import TPUConflictSet
from foundationdb_tpu.sched.packing import PipelinedWindowRunner as JRunner
from foundationdb_tpu_torch import TorchConflictSet, convert
from foundationdb_tpu_torch.models import conflict_kernel as tck
from foundationdb_tpu_torch.models.conflict_set import (
    encode_resolve_batch as tenc,
)
from foundationdb_tpu_torch.sched.packing import PipelinedWindowRunner
from tests.test_spec_resolve import COUNT, NWIN, _adversary, _rand_txn, _windows
from tests.test_torch_conflict_kernel import T, t_ranks, t_res
from tests.test_torch_conflict_set import jax_snapshot, port_txn
from tests.test_torch_tiered import WINDOW_KW, hotspot_windows, same_engine
from tests.test_torch_window import same_state

# Small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the CPU.
torch.set_num_threads(1)

KW = dict(capacity=1 << 12, batch_size=COUNT, max_read_ranges=4,
          max_write_ranges=2, max_key_bytes=8)


def engines(depth: int, wave: bool = False, hook=None, **kw):
    """(JAX, port) speculative engines of one configuration."""
    cfg = dict(KW, wave_commit=wave, spec_resolve=True, spec_depth=depth,
               **kw)
    pair = (TPUConflictSet(resident=True, **cfg),
            TorchConflictSet(device="cpu", **cfg))
    for cs in pair:
        cs.spec_confirm_hook = hook
    return pair


def port_windows():
    """``tests/test_spec_resolve.py``'s windows in the port's wire format
    (the same bytes: both packages encode one format)."""
    return [(np.frombuffer(wire, np.uint8), cvs) for wire, cvs in _windows()]


def run(cs, threaded: bool = False, runner=PipelinedWindowRunner):
    """Every window submitted to a runner (the port's, or the JAX one for
    a JAX engine), then collected: (verdicts stacked, levels per window).
    Unthreaded, both runners dispatch and reconcile in the same order."""
    r = runner(cs, threaded=threaded)
    out, levels = [], []
    try:
        for wire, cvs in port_windows():
            r.submit(wire, cvs, COUNT)
        for _ in range(NWIN):
            out.append(np.asarray(r.collect_next()))
            levels.append(cs.last_wave_window)
    finally:
        r.close()
    return np.stack(out), levels


def run_jax(cs):
    return run(cs, runner=JRunner)


# ------------------------------------------------------------ kernel level


def test_snapshot_is_a_deep_copy():
    res = tck.init_res(np.zeros((1, 2), np.int32), 8, 16, 4, "cpu")
    snap = tck.snapshot_res(res)
    res.hist.base.versions.fill_(7)
    res.dict_keys.fill_(3)
    assert int(snap.hist.base.versions.max()) == tck.NEG_VERSION
    assert int(snap.dict_keys[1:].min()) == tck.INT32_MAX
    assert type(snap.hist.base) is tck.ConflictState


@pytest.mark.parametrize("revoke", ["none", "first", "all"])
def test_paint_many_res_equals_jax(revoke):
    """A captured window with a dictionary delta, painted with a forced
    accept mask: every state leaf equals JAX ``paint_many_res``."""
    jcs = TPUConflictSet(resident=True, **KW)
    wins = _windows()
    for wire, cvs in wins[:2]:
        jcs.resolve_wire_window(wire, cvs, COUNT)
    prepared = jcs.pack_wire_window(*wins[2], COUNT)
    jb = prepared.batch
    rng = np.random.default_rng(len(revoke))
    acc = np.asarray(jb.ranks.txn_mask) & (rng.random((2, COUNT)) < 0.6)
    if revoke == "first":
        acc[0, np.argmax(acc[0])] = False
    elif revoke == "all":
        acc[:] = False
    rb = tck.ResidentBatch(T(jb.delta_keys), t_ranks(jb.ranks))
    assert bool((rb.delta_keys != tck.INT32_MAX).any())
    got = tck.paint_many_res(t_res(jcs.state), rb, T(acc), prepared.cvs_rel,
                             prepared.olds_rel)
    want = jck._paint_many_res_jit(jcs.state, jb, jnp.asarray(acc),
                                   prepared.cvs_rel, prepared.olds_rel)
    same_state(got, want, revoke)


# ------------------------------------------------------------ engine


@pytest.mark.parametrize("threaded", [False, True])
def test_runner_spec_parity(threaded):
    """Every window confirms: the speculative runner's verdicts equal the
    serial port engine's and the JAX serial engine's, threaded or not."""
    serial, _ = run(TorchConflictSet(device="cpu", **KW), threaded)
    spec_cs = TorchConflictSet(device="cpu", spec_resolve=True, spec_depth=3,
                               **KW)
    spec, _ = run(spec_cs, threaded)
    want, _ = run_jax(TPUConflictSet(resident=True, **KW))
    assert np.array_equal(serial, spec) and np.array_equal(spec, want)
    m = spec_cs.spec_metrics()
    assert m["spec_dispatched"] == NWIN and m["spec_repaired"] == 0, m
    assert m["spec_confirmed"] == NWIN and m["spec_depth"] == 0, m
    assert spec_cs.host_syncs == NWIN  # one read per window


@pytest.mark.parametrize("wave", [False, True])
@pytest.mark.parametrize("threaded", [False, True])
def test_adversarial_repair_equals_depth1_and_jax(wave, threaded):
    """Every window has a revoked txn: the rollback, the paint-only
    re-advance and the repair of the younger windows give depth 1's
    verdicts (and levels), and the JAX speculative engine's verdicts,
    levels, spec_metrics and state. Threaded, how many younger windows a
    repair finds in flight depends on the packing thread, so
    ``spec_flipped`` is compared only when the schedule is the JAX one."""
    jcs, port = engines(3, wave, _adversary)
    got, glv = run(port, threaded)
    base_cs = engines(1, wave, _adversary)[1]
    base, blv = run(base_cs, False)
    want, wlv = run_jax(jcs)
    assert np.array_equal(got, base) and np.array_equal(got, want)
    if wave:
        for a, b, c in zip(glv, blv, wlv):
            assert np.array_equal(a, b) and np.array_equal(a, np.asarray(c))
    m, jm = port.spec_metrics(), jcs.spec_metrics()
    if threaded:
        m.pop("spec_flipped")
        jm.pop("spec_flipped")
    assert m == jm and m["spec_repaired"] > 0, m
    same_state(port.state, jcs.state)
    same_state(port.state, base_cs.state)


def test_spec_resolve_async_object_path():
    """The object path lifted to a window of 1 through the ring, with the
    adversary: verdicts and wave schedules equal the JAX engine's; a
    reporting batch cannot speculate and resolves serially after the
    ring drains, with the same conflicting ranges."""
    rng = np.random.default_rng(3)
    jcs, port = engines(3, True, _adversary)
    v, jout, tout = 100, [], []
    for b in range(10):
        report = b % 4 == 3
        txns = [_rand_txn(rng, max(0, v - int(rng.integers(1, 60))),
                          report=report and i == 0) for i in range(COUNT)]
        jc = jcs.spec_resolve_async(txns, v)
        tc = port.spec_resolve_async([port_txn(t) for t in txns], v)
        assert (jc is None) == (tc is None) == report
        if report:
            jout.append([int(x) for x in jcs.resolve(txns, v)])
            tout.append([int(x) for x in port.resolve(
                [port_txn(t) for t in txns], v)])
            assert {i: [(r.begin, r.end) for r in rs] for i, rs in
                    port.last_conflicting.items()} == {
                i: [(r.begin, r.end) for r in rs]
                for i, rs in jcs.last_conflicting.items()}
        else:
            jout.append(jc)
            tout.append(tc)
        v += 10
    for a, b in zip(jout, tout):
        if callable(a):
            a, b = [int(x) for x in a()], [int(x) for x in b()]
            assert port.last_wave == jcs.last_wave
            assert port.last_reordered == jcs.last_reordered
        assert a == b
    jcs.reconcile_all()
    port.reconcile_all()
    assert port.spec_metrics() == jcs.spec_metrics()
    assert port.spec_metrics()["spec_repaired"] > 0
    same_state(port.state, jcs.state)


def test_tiered_spec_equals_serial_untiered():
    """Speculation over the tiered dictionary, one window collected at a
    time (the ring is empty at every demotion): verdicts equal the serial
    untiered engine's, and the engine equals the JAX tiered speculative
    engine after every window."""
    windows = hotspot_windows(b"s", 20, 16, 7)
    tier = dict(dict_hot_capacity=384, dict_delta_slots=128,
                spec_resolve=True, spec_depth=2)
    jcs = TPUConflictSet(resident=True, **tier, **WINDOW_KW)
    port = TorchConflictSet(device="cpu", **tier, **WINDOW_KW)
    plain = TorchConflictSet(device="cpu", **WINDOW_KW)
    for w, (txns, cvs) in enumerate(windows):
        wire = tenc([port_txn(t) for t in txns])
        got = port.resolve_wire_window(wire, cvs, 16)
        assert np.array_equal(got, plain.resolve_wire_window(wire, cvs, 16))
        want = jcs.resolve_wire_window(np.frombuffer(wire, np.uint8), cvs, 16)
        assert np.array_equal(got, np.asarray(want)), w
        same_engine(port, jcs, f"window {w}")
    st = port.dict_stats
    assert st["demotions"] > 0 and st["full_repacks"] == 0, st
    assert port.spec_metrics() == jcs.spec_metrics()


def test_tiered_adversarial_repair_across_demotions():
    """Every window submitted before any is collected, at depth 3 with the
    adversary: a _DemotePlan drains a ring of windows in flight (their
    snapshots hold pre-evict ranks), and the rollback, paint-only
    re-advance and repair run on an engine that has demoted. Verdicts,
    spec_metrics, every state leaf, the mirror and dict_stats equal the
    JAX tiered speculative engine's, and the verdicts depth 1's."""
    windows = hotspot_windows(b"a", 32, 16, 13)
    wires = [(tenc([port_txn(t) for t in txns]), cvs)
             for txns, cvs in windows]
    tier = dict(dict_hot_capacity=384, dict_delta_slots=128,
                spec_resolve=True, **WINDOW_KW)
    out = {}
    for name, cs, runner in (
            ("jax", TPUConflictSet(resident=True, spec_depth=3, **tier),
             JRunner),
            ("port", TorchConflictSet(device="cpu", spec_depth=3, **tier),
             PipelinedWindowRunner),
            ("depth1", TorchConflictSet(device="cpu", spec_depth=1, **tier),
             PipelinedWindowRunner)):
        cs.spec_confirm_hook = _adversary
        r = runner(cs, threaded=False)
        try:
            for wire, cvs in wires:
                r.submit(np.frombuffer(wire, np.uint8), cvs, 16)
            got = [np.asarray(r.collect_next()) for _ in wires]
        finally:
            r.close()
        cs.reconcile_all()
        out[name] = (np.stack(got), cs)
    (got, port), (want, jcs) = out["port"], out["jax"]
    assert np.array_equal(got, want) and np.array_equal(got, out["depth1"][0])
    st, m = port.dict_stats, port.spec_metrics()
    assert st["demotions"] > 0 and st["demotion_events"] >= 3, st
    assert st["full_repacks"] == 0, st
    assert m == jcs.spec_metrics() and m["spec_repaired"] > 0, m
    same_engine(port, jcs, "after the stream")


def test_convert_round_trips_a_tiered_engine():
    """A JAX tiered engine captured mid-stream continues in the port; a
    port tiered speculative engine with windows in flight is reconciled,
    captured and continued; both stay equal to the JAX engine."""
    windows = hotspot_windows(b"c", 24, 16, 9)
    tier = dict(dict_hot_capacity=384, dict_delta_slots=128)
    jcs = TPUConflictSet(resident=True, **tier, **WINDOW_KW)
    spec = TorchConflictSet(device="cpu", spec_resolve=True, spec_depth=3,
                            **tier, **WINDOW_KW)
    for txns, cvs in windows[:16]:
        wire = tenc([port_txn(t) for t in txns])
        jcs.resolve_wire_window(wire, cvs, 16)
        spec.dispatch_window(spec.pack_wire_window(wire, cvs, 16))
    assert jcs.dict_stats["demotions"] > 0
    assert spec.spec_metrics()["spec_depth"] > 0
    snap = convert.snapshot(spec)  # reconciles the ring first
    assert spec.spec_metrics()["spec_depth"] == 0
    assert snap["config"]["dict_hot_capacity"] == 384
    assert snap["config"]["spec_resolve"] and snap["config"]["spec_depth"] == 3
    from_jax = convert.engine_from_snapshot(jax_snapshot(jcs), device="cpu")
    from_port = convert.engine_from_snapshot(snap, device="cpu")
    assert from_jax.tiered and from_port.tiered and from_port.spec_resolve
    for cs in (from_jax, from_port):
        same_engine(cs, jcs, "captured")
    for w, (txns, cvs) in enumerate(windows[16:]):
        wire = tenc([port_txn(t) for t in txns])
        want = np.asarray(jcs.resolve_wire_window(wire, cvs, 16))
        for cs in (from_jax, from_port):
            assert np.array_equal(cs.resolve_wire_window(wire, cvs, 16),
                                  want), w
            same_engine(cs, jcs, f"window {w}")
