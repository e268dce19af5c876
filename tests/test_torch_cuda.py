"""CUDA kernels vs their plain torch versions at shapes the smoke stream
never produces: B not a multiple of 32 or of the 512-txn block, wide
R x Q, compaction overflow, full repacks (rank remap) and version rebase.

Needs an NVIDIA card: each test skips without one. Imports no JAX, so it
runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from foundationdb_tpu_torch import TorchConflictSet, convert
from foundationdb_tpu_torch.core.types import KeyRange, TxnConflictInfo
from foundationdb_tpu_torch.models import conflict_kernel as ck

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def on(x, dev):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


@pytest.mark.parametrize("b,r,q", [(100, 2, 1), (64, 2, 1), (33, 3, 2),
                                   (1000, 12, 8), (1536, 2, 1)])
def test_accept_and_losers(card, b, r, q):
    rng = np.random.default_rng(b + r + q)
    space = 40
    rb = rng.integers(0, space, (b, r)).astype(np.int32)
    re_ = rb + rng.integers(0, 4, (b, r)).astype(np.int32)
    wb = rng.integers(0, space, (b, q)).astype(np.int32)
    we = wb + rng.integers(0, 4, (b, q)).astype(np.int32)
    ranks = (on(rb, card), on(re_, card), on(rng.random((b, r)) < 0.9, card)
             & (on(rb, card) < on(re_, card)), on(wb, card), on(we, card),
             on(rng.random((b, q)) < 0.7, card) & (on(wb, card) < on(we, card)))
    cand = on(rng.random(b) < 0.85, card)
    too_old = on(rng.random(b) < 0.05, card) & ~cand
    txn_mask = cand | too_old | on(rng.random(b) < 0.05, card)
    got = ck.accept(cand, too_old, txn_mask, ranks)
    want = ck.accept_plain(cand, too_old, txn_mask, ranks)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    hist_mask = on(rng.random((b, r)) < 0.1, card) & ranks[2]
    assert torch.equal(ck.loser_mask(hist_mask, ranks, *got),
                       ck.loser_mask_plain(hist_mask, ranks, *got))


@pytest.mark.parametrize("c_out", [5, 40, 200])
def test_compaction_overflow_and_min_run(card, c_out):
    rng = np.random.default_rng(c_out)
    n = 150
    keys = np.sort(rng.integers(0, 30, n - 20)).astype(np.int32)
    keys[:9] = 0
    skeys = np.concatenate([keys, np.full(20, ck.INT32_MAX, np.int32)])
    newv = rng.integers(0, 3, n).astype(np.int32)
    newv[-20:] = ck.NEG_VERSION
    for prior in (False, True):
        args = (on(skeys[:, None], card), on(newv, card), c_out,
                torch.tensor(prior, device=card))
        for g, w in zip(ck._dedup_compact(*args),
                        ck._dedup_compact_plain(*args)):
            assert torch.equal(g, w)


def pt(k: bytes) -> KeyRange:
    return KeyRange(k, k + b"\x00")


def rand_txn(rng, rv):
    def rng_range():
        a = bytes(rng.integers(97, 101, int(rng.integers(0, 4))).astype(
            np.uint8))
        b = bytes(rng.integers(97, 101, int(rng.integers(0, 4))).astype(
            np.uint8))
        a, b = sorted([a, b])
        return pt(a) if rng.random() < 0.4 else KeyRange(a, b)

    return TxnConflictInfo(
        rv, [rng_range() for _ in range(int(rng.integers(0, 4)))],
        [rng_range() for _ in range(int(rng.integers(0, 3)))],
        report_conflicting_keys=bool(rng.random() < 0.3))


def test_engine_cuda_equals_cpu_with_repacks_and_rebase(card):
    kw = dict(capacity=40, batch_size=24, max_read_ranges=2,
              max_write_ranges=2, max_key_bytes=8, dict_capacity=64,
              dict_delta_slots=12, window_versions=300)
    gpu = TorchConflictSet(device=card, **kw)
    cpu = TorchConflictSet(device="cpu", **kw)
    rng = np.random.default_rng(3)
    cv = 1000
    for i in range(24):
        cv += int(rng.integers(1, 40)) + (1 << 30 if i == 12 else 0)
        txns = [rand_txn(rng, int(rng.integers(cv - 250, cv)))
                for _ in range(int(rng.integers(1, 60)))]
        if gpu.headroom() < gpu.worst_case_growth(len(txns)):
            gpu.advance(cv, cv - 200)
            cpu.advance(cv, cv - 200)
        else:
            assert gpu.resolve(txns, cv, cv - 200) == \
                cpu.resolve(txns, cv, cv - 200), f"batch {i}"
            assert gpu.last_conflicting == cpu.last_conflicting
        a, b = convert.snapshot(gpu), convert.snapshot(cpu)
        for k, v in b["state"].items():
            assert a["state"][k].tobytes() == v.tobytes(), (i, k)
        assert gpu.overflowed == cpu.overflowed
    assert gpu.dict_stats["full_repacks"] > 0
    assert gpu.base_version > 1 << 29  # the rebase ran


@pytest.mark.parametrize("b,k", [(33, 1), (33, 3), (1000, 1), (1000, 3)])
def test_window_path_cuda_equals_cpu_with_deferred_repack(card, b, k):
    """The wire window path (threaded runner, one launch sequence per
    window) on the card against its CPU plain run: verdicts and every
    state leaf after every window, through deferred repacks."""
    from foundationdb_tpu_torch.models.conflict_set import encode_resolve_batch
    from foundationdb_tpu_torch.sched.packing import PipelinedWindowRunner

    kw = dict(capacity=max(64, 8 * b), batch_size=b, max_read_ranges=2,
              max_write_ranges=2, max_key_bytes=8, dict_delta_slots=8,
              window_versions=300)
    engines = {dev: TorchConflictSet(device=dev, **kw)
               for dev in (card, "cpu")}
    rng = np.random.default_rng(b * 10 + k)
    windows, cv = [], 1000
    for _ in range(5):
        count = b if rng.random() < 0.7 else int(rng.integers(1, b))
        txns = [rand_txn(rng, int(rng.integers(cv - 250, cv)))
                for _ in range(k * count)]
        windows.append((encode_resolve_batch(txns),
                        list(range(cv, cv + 10 * k, 10)), count))
        cv += 10 * k
    got = {}
    for dev, cs in engines.items():
        runner = PipelinedWindowRunner(cs, threaded=dev == card)
        try:
            out = []
            for w in windows:
                runner.submit(*w)
                out.append(runner.collect_next())
                out.append(convert.snapshot(cs)["state"])
        finally:
            runner.close()
        got[dev] = out
    for i, (a, c) in enumerate(zip(got[card], got["cpu"])):
        if isinstance(a, dict):
            for name, v in c.items():
                assert a[name].tobytes() == v.tobytes(), (i, name)
        else:
            assert np.array_equal(a, c), i
    stats = engines[card].dict_stats
    assert stats["repack_stalls"] > 0 and stats["full_repacks"] > 0, stats
    assert stats == engines["cpu"].dict_stats
