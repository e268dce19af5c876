"""The port's window path (A14 ``resolve_many_res``, ``pack_wire_window`` /
``dispatch_window``, ``PipelinedWindowRunner``, the bench's resolve
stream) vs the JAX package's, on the CPU. The window program's plain
version must equal JAX ``resolve_many_res`` in stacked verdicts and every
state leaf (``n_used``, the sticky ``overflow`` included); the engine's
window path must equal JAX ``resolve_wire_window`` and the oracle, verdict
for verdict, with equal state leaves after every window.
"""

import hashlib

import jax
import numpy as np
import pytest
import torch

from foundationdb_tpu.models import conflict_kernel as jck
from foundationdb_tpu.models.conflict_set import TPUConflictSet
from foundationdb_tpu.models.conflict_set import encode_resolve_batch as jenc
from foundationdb_tpu.sched.packing import PipelinedWindowRunner as JRunner
from foundationdb_tpu.sim.oracle import OracleConflictSet
from foundationdb_tpu_torch import TorchConflictSet, bench
from foundationdb_tpu_torch.convert import state_leaves
from foundationdb_tpu_torch.loadgen import ycsb
from foundationdb_tpu_torch.models import conflict_kernel as tck
from foundationdb_tpu_torch.models.conflict_set import (
    encode_resolve_batch as tenc,
)
from foundationdb_tpu_torch.sched.packing import PipelinedWindowRunner
from tests.test_conflict_oracle import rand_txn
from tests.test_torch_conflict_kernel import T, t_ranks, t_res
from tests.test_torch_conflict_set import port_txn

# Small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the CPU.
torch.set_num_threads(1)

KW = dict(capacity=256, batch_size=16, max_read_ranges=4,
          max_write_ranges=4, max_key_bytes=8, window_versions=300)


def same_state(port_res, jax_res, what=""):
    want = state_leaves(jax_res)
    for name, leaf in state_leaves(port_res).items():
        a = leaf.numpy() if isinstance(leaf, torch.Tensor) else leaf
        b = np.asarray(want[name])
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name)
        assert a.tobytes() == b.tobytes(), (what, name)


def make_windows(rng, n_windows, k, count, cv=1000, step=10, jump=None):
    """[(txns, commit versions)]: k·count txns per window, commit versions
    ``step`` apart; ``jump=(w, v)`` starts window w at commit version v."""
    out = []
    for w in range(n_windows):
        if jump is not None and jump[0] == w:
            cv = jump[1] - step
        cvs = []
        for _ in range(k):
            cv += step
            cvs.append(cv)
        txns = [rand_txn(rng, read_version=int(rng.integers(cvs[0] - 250,
                                                            cvs[0])))
                for _ in range(k * count)]
        out.append((txns, cvs))
    return out


def oracle_window(oracle, txns, cvs, count, window_versions):
    rows = []
    for i, cv in enumerate(cvs):
        oracle.oldest_version = max(oracle.oldest_version,
                                    cv - window_versions)
        rows.append([int(v) for v in
                     oracle.resolve(txns[i * count:(i + 1) * count], cv)])
    return np.asarray(rows, np.int8)


def drive_three(windows, count, **kw):
    """Each window through JAX, the port and the oracle; all equal, with
    equal state after every window. Returns (jax engine, port engine)."""
    cfg = dict(KW, **kw)
    jcs = TPUConflictSet(resident=True, **cfg)
    tcs = TorchConflictSet(device="cpu", **cfg)
    oracle = OracleConflictSet()
    for w, (txns, cvs) in enumerate(windows):
        want = jcs.resolve_wire_window(jenc(txns), cvs, count)
        got = tcs.resolve_wire_window(tenc([port_txn(t) for t in txns]), cvs,
                                      count)
        assert got.dtype == np.int8 and got.shape == (len(cvs), count)
        assert np.array_equal(got, want), f"window {w}: port vs jax"
        assert np.array_equal(got, oracle_window(
            oracle, txns, cvs, count, cfg["window_versions"])), w
        same_state(tcs.state, jcs.state, f"window {w}")
        assert tcs.base_version == jcs.base_version
        assert tcs.oldest_version == jcs.oldest_version
    return jcs, tcs


@pytest.mark.parametrize("k", [1, 2, 4])
def test_window_path_equals_jax_and_oracle(k):
    rng = np.random.default_rng(10 + k)
    drive_three(make_windows(rng, 4, k, 16), 16)


@pytest.mark.parametrize("k", [2, 4])
def test_window_count_below_batch_size(k):
    rng = np.random.default_rng(20 + k)
    drive_three(make_windows(rng, 3, k, 5), 5)


def test_window_forced_deferred_repack():
    rng = np.random.default_rng(31)
    jcs, tcs = drive_three(make_windows(rng, 5, 2, 16), 16,
                           dict_delta_slots=8)
    st = tcs.dict_stats
    assert st["repack_stalls"] >= 2 and st["full_repacks"] >= 2, st
    for key in ("repack_stalls", "full_repacks", "evictions", "dispatches",
                "delta_new_keys"):
        assert st[key] == jcs.dict_stats[key], key


def test_window_rebase_inside_window():
    """Window 1 crosses the rebase threshold (2^30 versions above the
    base, 710 = 1010 - window_versions) at its step 1: the rebase falls
    due inside the pack, is deferred, and runs at dispatch; step 0's
    floor, taken before it, clamps to 0."""
    rng = np.random.default_rng(41)
    windows = make_windows(rng, 3, 3, 12, jump=(1, 710 + (1 << 30) - 10))
    tcs = TorchConflictSet(device="cpu", **KW)
    tcs.resolve_wire_window(tenc([port_txn(t) for t in windows[0][0]]),
                            windows[0][1], 12)
    prep = tcs.pack_wire_window(tenc([port_txn(t) for t in windows[1][0]]),
                                windows[1][1], 12)
    assert prep.rebase_delta > 0 and prep.olds_rel[0] == 0
    drive_three(windows, 12)


def test_failed_pack_restores_bookkeeping():
    rng = np.random.default_rng(5)
    tcs = TorchConflictSet(device="cpu", **KW)
    txns, cvs = make_windows(rng, 1, 2, 8)[0]
    tcs.resolve_wire_window(tenc([port_txn(t) for t in txns]), cvs, 8)
    snap = (tcs.base_version, tcs.oldest_version, tcs._last_commit)
    stale = list(range(cvs[-1] - 1, cvs[-1] + 1))  # not advancing
    with pytest.raises(ValueError, match="advance"):
        tcs.pack_wire_window(tenc([port_txn(t) for t in txns]), stale, 8)
    with pytest.raises(ValueError, match="malformed"):
        tcs.pack_wire_window(b"\x01\x02", [cvs[-1] + 10], 1)
    assert (tcs.base_version, tcs.oldest_version, tcs._last_commit) == snap


def capture_window(k, **kw):
    """A warm JAX engine and its next packed window (repack run)."""
    rng = np.random.default_rng(50 + k)
    jcs = TPUConflictSet(resident=True, **dict(KW, **kw))
    windows = make_windows(rng, 3, k, 16)
    for txns, cvs in windows[:2]:
        jcs.resolve_wire_window(jenc(txns), cvs, 16)
    txns, cvs = windows[2]
    prep = jcs.pack_wire_window(jenc(txns), cvs, 16)
    batch = prep.batch
    if not isinstance(batch, jck.ResidentBatch):
        batch = jcs._repack_and_rank(batch)
    return jcs.state, batch, prep


@pytest.mark.parametrize("k,kw", [
    (1, {}), (2, {}), (4, {}),
    (4, dict(delta_capacity=40)),  # folds inside the window
    (4, dict(capacity=8, delta_capacity=8)),  # sticky overflow
], ids=["k1", "k2", "k4", "k4_fold", "k4_overflow"])
def test_resolve_many_res_plain_equals_jax(k, kw):
    state, batch, prep = capture_window(k, **kw)
    # JAX's own function, traced without donation so ``state`` survives.
    jv, jres = jax.jit(jck.resolve_many_res)(state, batch, prep.cvs_rel,
                                             prep.olds_rel)
    tb = tck.ResidentBatch(T(batch.delta_keys), t_ranks(batch.ranks))
    tv, tres = tck.resolve_many_res(t_res(state), tb, prep.cvs_rel,
                                    prep.olds_rel)
    assert tv.numpy().tobytes() == np.asarray(jv).tobytes()
    assert tv.shape == (k, KW["batch_size"])
    same_state(tres, jres)
    if "capacity" in kw:
        assert bool(tres.hist.base.overflow | tres.hist.delta.overflow)


def test_bench_cli_on_cpu(capsys):
    import json

    assert bench.main(["--device", "cpu", "--txns", "8192", "--window", "1",
                       "--repeats", "1", "--keys", "1024",
                       "--capacity", "65536"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["device"] == "cpu" and rec["txns"] == 8192
    assert rec["host_syncs_per_window"] == 1.0 and not rec["overflowed"]
    with pytest.raises(SystemExit, match="profile"):
        bench.main(["--device", "cpu", "--profile"])


@pytest.mark.parametrize("threaded", [True, False])
def test_runner_equals_jax_with_deferred_repacks(threaded):
    """test_resident.py's threaded case (dict_delta_slots=8): packs park on
    the mirror's gate while dispatch runs the repack; threaded equals
    inline equals JAX's runner."""
    rng = np.random.default_rng(13)
    cfg = dict(KW, dict_delta_slots=8)
    windows = make_windows(rng, 5, 2, 16)
    jcs = TPUConflictSet(resident=True, **cfg)
    jr = JRunner(jcs, threaded=False)
    tcs = TorchConflictSet(device="cpu", **cfg)
    tr = PipelinedWindowRunner(tcs, threaded=threaded)
    try:
        for txns, cvs in windows:
            jr.submit(jenc(txns), cvs, 16)
            tr.submit(tenc([port_txn(t) for t in txns]), cvs, 16)
            tr.dispatch_ready()
        want = [jr.collect_next() for _ in windows]
        got = [tr.collect_next() for _ in windows]
    finally:
        jr.close()
        tr.close()
    for w, (g, j) in enumerate(zip(got, want)):
        assert np.array_equal(g, j), f"window {w}"
    same_state(tcs.state, jcs.state)
    assert tcs.dict_stats["repack_stalls"] >= 1
    assert len(tr.pack_s) == len(windows)


def test_bench_hash_equals_jax_window_stream():
    """The port bench's verdicts_sha256 over a 4-window stream equals the
    hash of JAX resolve_wire_window over the same blob."""
    mode = ycsb.ModeConfig(2, 1, 0.5, 0.99, 64)
    n_batches, window, cap = 8, 2, 1 << 12
    blob, ends = bench.make_stream(mode, n_batches, 512, seed=7)
    rec, verdicts, _ = bench.run_wire(blob, ends, mode, n_batches, cap,
                                      "cpu", window=window, pipeline_depth=2,
                                      repeats=1, warmup=False)
    jcs = TPUConflictSet(
        resident=True, capacity=cap, batch_size=mode.batch,
        max_read_ranges=mode.n_reads, max_write_ranges=mode.n_writes,
        max_key_bytes=ycsb.KEY_BYTES, window_versions=ycsb.WINDOW)
    want = np.stack([
        jcs.resolve_wire_window(*bench.window_wire(blob, ends, mode, window,
                                                   wi), mode.batch)
        for wi in range(n_batches // window)])
    assert np.array_equal(verdicts, want)
    assert rec["verdicts_sha256"] == hashlib.sha256(
        want.tobytes()).hexdigest()
    assert rec["txns"] == n_batches * mode.batch
    assert sum(rec[k] for k in ("committed", "conflict", "too_old")) == \
        rec["txns"]
