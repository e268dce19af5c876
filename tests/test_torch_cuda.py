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


def accept_graph(b: int, kind: str):
    """(cand, too_old, txn_mask, ranks) of one adversarial acceptance
    graph in rank space (key k is the range [k, k + 1)), numpy."""
    i = np.arange(b, dtype=np.int32)
    rk, wk = np.zeros(b, np.int32), np.zeros(b, np.int32)
    cand = np.ones(b, bool)
    write_live = np.ones(b, bool)
    if kind == "hot":  # one key read and written by all
        pass
    elif kind == "chain":  # i reads what i - 1 writes: accept, reject, ...
        rk, wk = i, i + 1
    elif kind == "cross":  # i reads what i - 512 writes: edges only
        rk, wk = i - 512 + (1 << 20), i + (1 << 20)  # across 512-txn blocks
    elif kind == "noncand":  # every overlapping writer is a non-candidate
        cand = i % 2 == 1
        write_live = ~cand
    elif kind == "nocand":
        cand[:] = False
    elif kind == "free":  # every txn a candidate, no overlap at all
        rk, wk = 2 * i, 2 * i + 1
    rb = np.stack([rk, rk + 5 * b + 7], 1).astype(np.int32)
    wb = wk[:, None].astype(np.int32)
    read_live = np.zeros((b, 2), bool)
    read_live[:, 0] = True
    ranks = (rb, rb + 1, read_live, wb, wb + 1, write_live[:, None])
    return cand, np.zeros(b, bool), np.ones(b, bool), ranks


@pytest.mark.parametrize("b", [1, 31, 33, 511, 513, 8192, 32768])
@pytest.mark.parametrize("kind", ["hot", "chain", "cross", "noncand",
                                  "nocand", "free"])
def test_accept_adversarial_graphs(card, b, kind):
    """K3 (overlap rows across the card, the settle walk over only the
    rows with edges) equals ``accept_plain`` in accepted and verdicts:
    B not a multiple of 32 or of 512, one txn, 32,768 txns; a hot key,
    an alternating chain (every row walked), chains whose edges all cross
    512-txn blocks, only non-candidate predecessors, no candidates, no
    edges. Its stats build gives the same answer and the plain twins'
    counts of edgeful and pending rows."""
    from foundationdb_tpu_torch import kernels as K

    cand, too_old, txn_mask, ranks = accept_graph(b, kind)
    args = (on(cand, card), on(too_old, card), on(txn_mask, card),
            tuple(on(x, card) for x in ranks))
    got = ck.accept(*args)
    want = ck.accept_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    clk = torch.zeros(len(K.ACCEPT_CLOCKS), dtype=torch.int64, device=card)
    stats = K.accept(*args[:3], *args[3], clocks=clk)
    for g, w in zip(stats, want):
        assert torch.equal(g, w)
    c = dict(zip(K.ACCEPT_CLOCKS, clk.tolist()))
    if b <= 8192:
        counts = ck.accept_counts(*args)
        assert c["edgeful"] == counts["edgeful_rows"]
        assert c["pending"] == counts["pending_rows"]
        assert c["walk_words"] <= counts["pending_words"]
    assert c["walk_steps"] <= c["pending"]
    assert c["overlap_t0"] <= c["overlap_t1"] <= c["prune_t1"] \
        <= c["walk_t1"]


@pytest.mark.parametrize("b,r,q", [(700, 3, 2), (2000, 40, 1), (513, 1, 9),
                                   (1500, 2, 16)])
def test_accept_generic_widths(card, b, r, q):
    """K3's generic overlap build (R, Q other than 2, 1: R past one warp,
    Q wide enough to shrink the staged tile) on dense random graphs."""
    rng = np.random.default_rng(b * r * q)
    space = 60
    rb = rng.integers(0, space, (b, r)).astype(np.int32)
    re_ = rb + rng.integers(0, 3, (b, r)).astype(np.int32)
    wb = rng.integers(0, space, (b, q)).astype(np.int32)
    we = wb + rng.integers(0, 3, (b, q)).astype(np.int32)
    ranks = (on(rb, card), on(re_, card),
             on(rng.random((b, r)) < 0.5, card) & (on(rb, card)
                                                   < on(re_, card)),
             on(wb, card), on(we, card),
             on(rng.random((b, q)) < 0.5, card) & (on(wb, card)
                                                   < on(we, card)))
    cand = on(rng.random(b) < 0.9, card)
    too_old = on(rng.random(b) < 0.05, card) & ~cand
    txn_mask = cand | too_old
    got = ck.accept(cand, too_old, txn_mask, ranks)
    want = ck.accept_plain(cand, too_old, txn_mask, ranks)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n", [1, 2, 3, 1024, 1025, 4097, 16386, 1 << 20,
                               1 << 22, (1 << 22) + 3])
def test_table_few_launches(card, n):
    """K2's table equals ``sparse_table`` bit for bit (INT32_MIN and
    INT32_MAX among the values), in one CUDA launch up to 13 levels and two
    up to 2^22 entries; a gated build with ``need`` False leaves ``out``
    untouched, in the same launches; with True it writes the table."""
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.ops.rmq import sparse_table

    rng = np.random.default_rng(n)
    v = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    v[rng.random(n) < 0.2] = ck.NEG_VERSION
    v[rng.random(n) < 0.01] = -2**31
    v[rng.random(n) < 0.01] = 2**31 - 1
    vt = on(v, card)
    want = sparse_table(vt)
    levels = K.table_levels(n)
    launches = 1 if levels <= 13 else 2 if levels <= 23 else 3
    assert torch.equal(K.build_table(vt), want)
    assert K.TABLE_KERNELS["last"] == launches
    out = torch.full_like(want, 7)
    K.build_table(vt, out=out, need=torch.zeros((), dtype=torch.bool,
                                                device=card))
    assert K.TABLE_KERNELS["last"] == launches
    assert bool((out == 7).all())
    K.build_table(vt, out=out, need=torch.ones((), dtype=torch.bool,
                                               device=card))
    assert torch.equal(out, want)
    if n > 1:  # row 0 aliasing the values: the levels above it only
        alias = want.clone()
        alias[1:] = 7
        K.build_table(alias[0], out=alias)
        assert torch.equal(alias, want)


def _rank_level(rng, c, n_used, card):
    """A ConflictState of ``n_used`` sorted distinct rank keys (row 0 =
    rank 0), INT32_MAX padded to capacity ``c``, and random versions."""
    keys = np.full((c, 1), 2**31 - 1, np.int32)
    keys[:n_used, 0] = np.sort(rng.choice(np.arange(1, 4 * c), n_used - 1,
                                          replace=False).tolist() + [0])
    vers = np.full(c, ck.NEG_VERSION, np.int32)
    vers[:n_used] = rng.integers(-50, 50, n_used)
    return ck.ConflictState(on(keys, card), on(vers, card),
                            torch.tensor(n_used, dtype=torch.int32,
                                         device=card),
                            torch.zeros((), dtype=torch.int32, device=card),
                            torch.zeros((), dtype=torch.bool, device=card))


@pytest.mark.parametrize("c,cd,b,r", [(5, 3, 40, 1), (5000, 100, 300, 2),
                                      (1 << 20, 16386, 2000, 3),
                                      (70000, 1000, 100, 33)])
def test_history_probe_at_the_key_arrays_ends(card, c, cd, b, r):
    """K2's probe (fenced searches, R slots on adjacent lanes) equals
    ``history_probe_plain`` with read slots at both ends of the key
    arrays: below every key, at rank 0, on the first and last live keys,
    among the INT32_MAX padding, past it; R of 1, 2, 3 and 33 (a lane
    group of 1, 2, 4 and 32 lanes with two slots a lane); and the flat
    history (no delta)."""
    rng = np.random.default_rng(c + r)
    base = _rank_level(rng, c, max(1, c // 2), card)
    delta = _rank_level(rng, cd, max(1, cd - 1), card)
    hist = ck.HistState(base, ck.build_table(base.versions), delta)
    bk = base.keys[:, 0].cpu().numpy()
    dk = delta.keys[:, 0].cpu().numpy()
    ends = np.array([0, 1, bk[0], bk[1 % c], bk[c // 2 - 1], bk[c // 2],
                     bk[-1], dk[0], dk[-1], dk[cd // 2], 2**31 - 2,
                     2**31 - 1], np.int64)
    pool = np.concatenate([ends, rng.integers(0, 4 * c + 2, 64)])
    qb = rng.choice(pool, (b, r)).astype(np.int32)
    qe = np.maximum(qb, rng.choice(pool, (b, r))).astype(np.int32)
    qe[rng.random((b, r)) < 0.3] = 2**31 - 1
    rbk = ck.RankBatch(
        on(qb, card), on(qe, card), on(rng.random((b, r)) < 0.8, card),
        on(np.zeros((b, 1), np.int32), card),
        on(np.zeros((b, 1), np.int32), card),
        on(np.zeros((b, 1), bool), card),
        on(rng.integers(-60, 60, b).astype(np.int32), card),
        on(rng.random(b) < 0.9, card), on(np.zeros(2 * b, np.int32), card))
    floor = torch.tensor(-40, dtype=torch.int32, device=card)
    for h in (hist, base):
        got = ck.history_probe(h, rbk, floor)
        want = ck.history_probe_plain(h, rbk, floor)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


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


# ------------------------------------------------------------ K7 (evict)


@pytest.mark.parametrize("d,w,e,n_ev", [(97, 1, 7, 5), (97, 3, 7, 7),
                                         (1000, 4, 33, 0), (1000, 5, 33, 33),
                                         (4099, 2, 513, 300), (50, 4, 1, 1)])
def test_dict_evict_and_rank_rewrite(card, d, w, e, n_ev):
    """K7 (and K1's rewrite by its shift table) against the plain version:
    the dictionary, n_keys, the shift and every rank leaf, with evictions
    at rank 0 and at rank n-1 among them."""
    rng = np.random.default_rng(d + w + e + n_ev)
    n = d - 3
    rows = np.sort(rng.integers(-1000, 1000, (d + 1, w)).astype(np.int32),
                   axis=0)
    rows[n:] = ck.INT32_MAX
    ev = np.full(e, ck.INT32_MAX, np.int32)
    pick = rng.choice(np.arange(1, n - 1), max(n_ev - 2, 0), replace=False)
    ev[:n_ev] = np.sort(np.concatenate([[0, n - 1], pick])[:n_ev])
    n_keys = torch.tensor(n, dtype=torch.int32, device=card)
    got = ck._dict_evict(on(rows, card), n_keys, on(ev, card), n_ev, n)
    want = ck._dict_evict_plain(on(rows, card), n_keys, on(ev, card))
    for g, x in zip(got, want):
        assert g.dtype == x.dtype and torch.equal(g, x)
    live = np.setdiff1d(np.arange(n), ev[:n_ev]).astype(np.int32)
    hist_keys = np.full((64, 1), ck.INT32_MAX, np.int32)
    hist_keys[:40, 0] = np.sort(rng.choice(live, min(40, live.size)))
    res = ck.init_res(rows[:n], d, 64, 16, card)
    res = res._replace(n_keys=n_keys, dict_keys=on(rows, card),
                       hist=res.hist._replace(base=res.hist.base._replace(
                           keys=on(hist_keys, card))))
    a = ck.apply_evict(ck.snapshot_res(res), on(ev, card), n_ev)
    nd, nn, shift = ck._dict_evict_plain(res.dict_keys, res.n_keys,
                                         on(ev, card))
    h = res.hist
    bk, dk, lo, hi = ck._rewrite_ranks_plain(
        [h.base.keys, h.delta.keys, res.shard_lo, res.shard_hi], shift, False)
    b = ck.ResState(nd, nn, ck.HistState(h.base._replace(keys=bk), h.base_st,
                                         h.delta._replace(keys=dk)), lo, hi)
    for (name, x), y in zip(convert.state_leaves(a).items(),
                            convert.state_leaves(b).values()):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("d,w,n,n_ev,case", [
    (4200, 4, 4100, 0, "none"), (4200, 4, 4100, 1, "one"),
    (4200, 4, 4100, 4100, "all"), (4200, 1, 4100, 2, "edges"),
    (4200, 4, 4100, 40, "runs"), (4200, 3, 4100, 700, "random"),
    (4200, 4, 4100, 700, "unaligned"), (4200, 4, 0, 0, "empty"),
    (4200, 4, 4201, 300, "full"), (5000, 9, 4990, 1000, "random"),
    (1_310_720, 4, 1_013_000, 158_464, "random")])
def test_dict_evict_tiles_adversarial(card, d, w, n, n_ev, case):
    """K7 against its tile twin and the plain version, bit for bit: no
    rank, one, every live rank, the first and last live ranks, runs
    across tiles, an empty and a full dictionary, W = 1, 3, 4 and 9, a
    dictionary whose rows are not 16-byte aligned (the word loop at
    W = 4) and the smoke's demotion shape; one CUDA kernel a call."""
    rng = np.random.default_rng(d + w + n + n_ev)
    rows = np.full((d + 1 + 1, w), ck.INT32_MAX, np.int32)
    live = np.sort(rng.integers(-2**30, 2**30, (n, w)).astype(np.int32),
                   axis=0)
    rows[:n] = live
    ev = np.full(max(n_ev, 1) + 5, ck.INT32_MAX, np.int32)
    pick = {"none": [], "one": [n // 2], "all": np.arange(n),
            "edges": [0, n - 1], "empty": [],
            "runs": [*range(2038, 2058), *range(4080, 4100)]}.get(case)
    if pick is None:
        pick = np.sort(rng.choice(n, n_ev, replace=False))
    ev[:n_ev] = pick
    buf = on(rows.reshape(-1), card)
    # "unaligned": the dictionary starts one int into its buffer.
    off = 1 if case == "unaligned" else 0
    dk = buf[off:off + (d + 1) * w].view(d + 1, w)
    n_keys = torch.tensor(n, dtype=torch.int32, device=card)
    evt = on(ev, card)
    before = ck.K.LAUNCHES["dict_evict"]
    got = ck._dict_evict(dk, n_keys, evt, n_ev, n)
    torch.cuda.synchronize()
    assert ck.K.LAUNCHES["dict_evict"] == before + 1
    for want in (ck._dict_evict_plain(dk.clone(), n_keys, evt),
                 ck.dict_evict_tiles_plain(dk.clone(), n_keys, evt, n_ev, n)):
        for g, x in zip(got, want):
            assert g.dtype == x.dtype and torch.equal(g, x), case


# ------------------------------------------------------------ K5, K6 (wave)


def wave_inputs(rng, b, r, q, space, dev):
    rb = rng.integers(0, space, (b, r)).astype(np.int32)
    re_ = rb + rng.integers(0, 4, (b, r)).astype(np.int32)
    wb = rng.integers(0, space, (b, q)).astype(np.int32)
    we = wb + rng.integers(0, 4, (b, q)).astype(np.int32)
    ranks = (on(rb, dev), on(re_, dev),
             on((rng.random((b, r)) < 0.9) & (rb < re_), dev), on(wb, dev),
             on(we, dev), on((rng.random((b, q)) < 0.7) & (wb < we), dev))
    return on(rng.random(b) < 0.85, dev), ranks


@pytest.mark.parametrize("b,r,q,space", [(100, 2, 1, 40), (33, 3, 2, 12),
                                         (1000, 12, 8, 400),
                                         (2048, 2, 1, 300), (8192, 2, 1, 9000)])
def test_wave_pred_and_level(card, b, r, q, space):
    """K5 and K6 against their plain versions on the card, bit for bit,
    stats included, and the levels against the host replay."""
    from foundationdb_tpu_torch.core import wavemesh

    rng = np.random.default_rng(b + r + q)
    cand, ranks = wave_inputs(rng, b, r, q, space, card)
    p = ck.wave_pred_matrix(cand, ranks)
    assert torch.equal(p, ck.wave_pred_matrix_plain(cand, ranks))
    too_old = on(rng.random(b) < 0.05, card) & ~cand
    tmask = cand | too_old
    st_k = torch.zeros(5, dtype=torch.int64, device=card)
    st_p = torch.zeros(5, dtype=torch.int64, device=card)
    got = ck.wave_level(cand, p, too_old, tmask, stats=st_k)
    want = ck.wave_level_plain(cand, p, too_old, tmask, stats=st_p)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(st_k, st_p)
    if b <= 2048:
        pn = p.cpu().numpy().view(np.uint32)
        bp = pn.shape[0]
        levels = wavemesh.level_wave_graph(
            bp, set(np.nonzero(cand.cpu().numpy())[0].tolist()),
            wavemesh.unpack_pred_rows(pn, bp))
        assert got[1].cpu().numpy().tolist() == levels[:b]


@pytest.mark.parametrize("shape", ["clique", "ring", "dense", "tail"])
def test_wave_level_adversarial_graphs(card, shape):
    """Many victims, long chains and cycles with tails: K6 = plain."""
    from foundationdb_tpu_torch.core import wavemesh

    n = 700
    rng = np.random.default_rng(len(shape))
    if shape == "clique":
        pred = {j: set(range(300)) - {j} for j in range(300)}
    elif shape == "ring":
        pred = {j: {(j + 1) % n} for j in range(n)}
    elif shape == "dense":
        m = rng.random((n, n)) < 0.05
        np.fill_diagonal(m, False)
        pred = {j: set(np.nonzero(m[j])[0].tolist()) for j in range(n)}
    else:
        pred = {j: {j + 1} for j in range(n - 1)}
        pred[n - 1] = {n - 50}
        pred.update({j: {j - 1, 3} for j in range(1, 40)})
    pred = {j: s for j, s in pred.items() if s}
    p = on(wavemesh.pack_pred_rows(pred, n).view(np.int32), card)
    cand = on(rng.random(n) < 0.97, card)
    st = [torch.zeros(5, dtype=torch.int64, device=card) for _ in range(2)]
    got = ck.wave_level(cand, p, stats=st[0])
    want = ck.wave_level_plain(cand, p, stats=st[1])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(st[0], st[1])


def big_graph(b: int, n: int, kind: str, rng, dev):
    """(cand bool [b], p int32 [BP, BP/32]) on ``dev``: n candidates spread
    over a batch of b txns, their edges random, one chain, one ring with
    chords, or nested small cycles; built from an edge list on the card
    (a dense [b, b] on the host would be gigabytes)."""
    bp = (b + 31) // 32 * 32
    idx = np.sort(rng.choice(b, size=n, replace=False))
    cand = np.zeros(b, bool)
    cand[idx] = True
    if kind == "random":
        e = rng.integers(0, n, (4 * n, 2))
    elif kind == "chain":
        e = np.stack([np.arange(1, n), np.arange(n - 1)], 1)
    elif kind == "ring":
        e = np.concatenate([np.stack([np.arange(n), (np.arange(n) + 1) % n],
                                     1), rng.integers(0, n, (n // 3, 2))])
    else:
        e = []
        for s in range(0, n, 9):
            t = min(n, s + int(rng.integers(2, 14)))
            e += [(j + 1, j) for j in range(s, t - 1)] + [(s, t - 1)]
        e = np.concatenate([np.array(e).reshape(-1, 2),
                            rng.integers(0, n, (n // 20 + 1, 2))])
    j, i = idx[e[:, 0]], idx[e[:, 1]]
    key = np.unique(j[j != i].astype(np.int64) * bp + i[j != i])
    j, i = key // bp, key % bp
    nw = bp // 32
    flat = torch.zeros(bp * nw, dtype=torch.int64, device=dev)
    flat.index_add_(0, on(j * nw + (i >> 5), dev), on(np.int64(1) << (i & 31),
                                                         dev))
    p = ((flat + 2**31) % 2**32 - 2**31).to(torch.int32).view(bp, nw)
    return on(cand, dev), p


@pytest.mark.parametrize("b", [32768, 57344])
@pytest.mark.parametrize("kind", ["random", "chain", "ring", "nested"])
def test_wave_level_at_big_batches(card, b, kind):
    """K6 at batches whose round state does not fit in one block's shared
    memory (it lives in global scratch): levels, verdicts and stats equal
    the plain version's."""
    rng = np.random.default_rng(b + len(kind))
    cand, p = big_graph(b, 600, kind, rng, card)
    too_old = on(rng.random(b) < 0.05, card) & ~cand
    tmask = cand | too_old
    st = [torch.zeros(5, dtype=torch.int64, device=card) for _ in range(2)]
    got = ck.wave_level(cand, p, too_old, tmask, stats=st[0])
    want = ck.wave_level_plain(cand, p, too_old, tmask, stats=st[1])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(st[0], st[1])
    assert int(st[0][1]) > (50 if kind != "chain" else 599)


@pytest.mark.parametrize("batch_size", [32768, 57344])
def test_wave_engine_at_big_batches(card, batch_size):
    """A cuda wave engine at a batch size whose K6 round state does not
    fit in one block's shared memory constructs and resolves like the CPU
    plain engine: verdicts, levels and conflicting-key reports."""
    from foundationdb_tpu_torch import kernels as K

    kw = dict(capacity=4096, max_read_ranges=4, max_write_ranges=4,
              max_key_bytes=8, wave_commit=True)
    eng = {card: TorchConflictSet(device=card, batch_size=batch_size, **kw),
           "cpu": TorchConflictSet(device="cpu", batch_size=512, **kw)}
    rng = np.random.default_rng(batch_size)
    K.reset_launches()
    for i in range(3):
        cv = 1000 + 10 * i
        txns = [rand_txn(rng, cv - 5) for _ in range(400)]
        out = {dev: ([int(v) for v in cs.resolve(txns, cv, cv - 100)],
                     cs.last_wave, cs.last_conflicting)
               for dev, cs in eng.items()}
        assert out[card] == out["cpu"], i
    assert K.LAUNCHES["wave"] >= 6


def test_wave_engine_cuda_equals_cpu(card):
    """Object (reports, chunks), wire, window and two-phase paths of a
    wave engine on the card against the CPU plain run: verdicts, levels
    and every state leaf, through repacks."""
    from foundationdb_tpu_torch.core import wavemesh
    from foundationdb_tpu_torch.models.conflict_set import encode_resolve_batch

    kw = dict(capacity=200, batch_size=24, max_read_ranges=2,
              max_write_ranges=2, max_key_bytes=8, dict_capacity=64,
              dict_delta_slots=12, window_versions=300, wave_commit=True)
    eng = {dev: TorchConflictSet(device=dev, **kw) for dev in (card, "cpu")}
    shards = {dev: [TorchConflictSet(device=dev, **kw) for _ in range(2)]
              for dev in (card, "cpu")}
    rng = np.random.default_rng(8)
    cv = 1000
    for i in range(12):
        cv += int(rng.integers(1, 40))
        txns = [rand_txn(rng, int(rng.integers(cv - 250, cv)))
                for _ in range(int(rng.integers(2, 60)))]
        out = {}
        for dev, cs in eng.items():
            if i % 3 == 0:
                v = [int(x) for x in cs.resolve(txns, cv, cv - 200)]
            elif i % 3 == 1:
                v = cs.resolve_wire_async(encode_resolve_batch(txns), cv,
                                          cv - 200, as_array=True)().tolist()
            else:
                count = min(len(txns) // 2, 24)
                v = cs.resolve_wire_window(
                    encode_resolve_batch(txns[:2 * count]), [cv, cv + 1],
                    count).tolist()
            out[dev] = (v, cs.last_wave, cs.last_reordered,
                        None if cs.last_wave_window is None
                        else cs.last_wave_window.tolist(),
                        cs.last_conflicting)
        cv += 1
        assert out[card] == out["cpu"], i
        part = txns[:24]
        got = {}
        for dev, sh in shards.items():
            edges = [s.resolve_edges(wavemesh.clip_txns(part, lo, hi), cv,
                                     cv - 200)
                     for s, (lo, hi) in zip(sh, [(b"", b"b"),
                                                 (b"b", b"\xff")])]
            graph = wavemesh.combine_edges(edges)
            got[dev] = ([e.to_wire() for e in edges],
                        [[int(x) for x in s.resolve_apply(graph)]
                         for s in sh], [s.last_wave for s in sh])
        assert got[card] == got["cpu"], i
        for a, b in [(eng[card], eng["cpu"]),
                     *zip(shards[card], shards["cpu"])]:
            sa, sb = convert.snapshot(a), convert.snapshot(b)
            for k, v in sb["state"].items():
                assert sa["state"][k].tobytes() == v.tobytes(), (i, k)
    assert eng[card].wave_stats == eng["cpu"].wave_stats
    assert eng[card].dict_stats["full_repacks"] > 0


# ------------------------------------------------- K8, K9, K10 (sharded)


def shard_bounds(s, space, empty=False):
    """[S] int32 rank bounds tiling [0, INT32_MAX); ``empty`` makes shard
    1 empty (lo == hi)."""
    cuts = sorted(np.random.default_rng(s).choice(np.arange(1, space), s - 1,
                                                  replace=False).tolist())
    if empty and s > 2:
        cuts[1] = cuts[0]
    lo = np.array([0] + cuts, np.int32)
    hi = np.array(cuts + [ck.INT32_MAX], np.int32)
    return lo, hi


def rank_batch(rng, b, r, q, space, dev):
    """A RankBatch on ``dev``: live ranges in [0, space), masked slots at
    +inf, some reads running to the +inf end."""
    def ranks(n):
        lo = rng.integers(0, space, (b, n)).astype(np.int32)
        hi = lo + rng.integers(0, 8, (b, n)).astype(np.int32)
        hi[rng.random((b, n)) < 0.05] = ck.INT32_MAX
        m = rng.random((b, n)) < 0.8
        return (np.where(m, lo, ck.INT32_MAX).astype(np.int32),
                np.where(m, hi, ck.INT32_MAX).astype(np.int32), m)

    rb, re_, rm = ranks(r)
    wb, we, wm = ranks(q)
    paint = np.argsort(np.concatenate([wb.reshape(-1), we.reshape(-1)]),
                       kind="stable").astype(np.int32)
    return ck.RankBatch(
        on(rb, dev), on(re_, dev), on(rm, dev), on(wb, dev), on(we, dev),
        on(wm, dev), on(rng.integers(0, 30, b).astype(np.int32), dev),
        on(rng.random(b) < 0.9, dev), on(paint, dev))


@pytest.mark.parametrize("b,r,q,s,empty", [(30, 2, 1, 1, False),
                                           (33, 3, 2, 4, True),
                                           (1000, 2, 1, 4, False),
                                           (8192, 2, 1, 4, False)])
def test_shard_clip(card, b, r, q, s, empty):
    rng = np.random.default_rng(b + s)
    rbk = rank_batch(rng, b, r, q, 200, card)
    lo, hi = (on(x, card) for x in shard_bounds(s, 200, empty))
    for reads in (False, True):
        got = ck.shard_clip(rbk, lo, hi, reads)
        want = ck.shard_clip_plain(rbk, lo, hi, reads)
        for g, w in zip(got, want):
            assert (g is None and w is None) or torch.equal(g, w)


@pytest.mark.parametrize("b,r,q,s", [(30, 3, 1, 4), (33, 2, 2, 3),
                                     (8192, 2, 1, 4)])
def test_shard_clip_window_buffers(card, b, r, q, s):
    """K9 as the window program launches it: buffers and checks once a
    window (``ck.WindowClip``), every step clipped into them; the vector
    path (B·Q and B·R multiples of 4) and the scalar one."""
    rng = np.random.default_rng(b + q)
    steps = [rank_batch(rng, b, r, q, 200, card) for _ in range(3)]
    window = ck.RankBatch(*(torch.stack(x) for x in zip(*steps)))
    lo, hi = (on(x, card) for x in shard_bounds(s, 200, True))
    for reads in (False, True):
        wclip = ck.WindowClip.of(window, lo, hi, reads)
        for i in range(3):
            got = wclip.step(ck._step(window, i))
            want = ck.shard_clip_plain(steps[i], lo, hi, reads)
            for g, w in zip(got, want):
                assert (g is None and w is None) or torch.equal(g, w)


def sharded_history(s, capacity, dev, seed=0):
    """A sharded engine's state after a seeded stream, copied to ``dev``
    (every shard with history, n_used up to ``capacity``)."""
    from foundationdb_tpu_torch.parallel.sharded_resolver import (
        ShardedConflictSet,
    )

    cs = ShardedConflictSet(n_shards=s, device="cpu", capacity=capacity,
                            batch_size=8 * s, max_read_ranges=2,
                            max_write_ranges=2, max_key_bytes=8,
                            auto_reshard=False, splits=[
                                bytes([97 + 4 * i]) for i in range(1, s)])
    rng = np.random.default_rng(seed)
    for i in range(6):
        cv = 100 + 10 * i
        cs.resolve([rand_txn(rng, cv - 5) for _ in range(8 * s)], cv, cv - 40)
    return type(cs.state)(*(x.to(dev) if isinstance(x, torch.Tensor)
                            else type(x)(*(y.to(dev) for y in x))
                            for x in cs.state))


# Live-prefix states shared with tests/test_torch_live_probe.py (which
# holds the plain twin of K8's and K16's algorithm to JAX on them).
I32MAX, I32MIN = ck.INT32_MAX, -(2**31)


def live_counts(rng, kind: str, s: int, c: int) -> list[int]:
    """Live rows of each of ``s`` shards of capacity ``c``: one and full
    in turns ("edge"), full but for one shard of one row ("big"), else
    random."""
    if kind == "edge":
        return [1 if d % 2 == 0 else c for d in range(s)]
    if kind == "big":
        return [1 if d == 1 else c for d in range(s)]
    return [int(x) for x in rng.integers(1, c + 1, s)]


def rank_shards(rng, counts, c, span):
    """[S, C, 1] rank histories: shard d holds counts[d] sorted distinct
    ranks in [lo[d], lo[d] + span) from lo[d], +inf past them (numpy:
    keys, versions, lo, hi)."""
    s = len(counts)
    keys = np.full((s, c, 1), I32MAX, np.int32)
    vers = np.full((s, c), ck.NEG_VERSION, np.int32)
    lo = (np.arange(s) * span).astype(np.int32)
    hi = np.append(lo[1:], I32MAX).astype(np.int32)
    for d, n in enumerate(counts):
        body = rng.choice(np.arange(lo[d] + 1, lo[d] + span), n - 1,
                          replace=False)
        keys[d, :n, 0] = np.concatenate([[lo[d]], np.sort(body)])
        vers[d, :n] = rng.integers(-5, 60, n)
    return keys, vers, lo, hi


def rank_reads(rng, b, r, lo, hi, top, width=8):
    """[B, R] read ranks (numpy: begin, end, mask): ranges of up to
    ``width`` ranks in [-3, top), and adversarial rows: all INT32_MAX,
    every shard whole, the last shard whole, to +inf, begin = end, below
    every shard."""
    rb = rng.integers(-3, top, (b, r)).astype(np.int32)
    re_ = (rb + rng.integers(0, width, (b, r))).astype(np.int32)
    mask = rng.random((b, r)) < 0.85
    rb[0], re_[0] = I32MAX, I32MAX
    rb[1, 0], re_[1, 0] = 0, I32MAX
    rb[2, 0], re_[2, 0] = lo[-1], hi[-1]
    re_[3, 0] = I32MAX
    re_[4] = rb[4]
    rb[5], re_[5] = -10, -5
    mask[:6] = True
    return rb, re_, mask


def word_shards(rng, counts, c, w, k=2):
    """[S, C, W] histories (numpy: keys, versions, lo, hi): shard d's rows
    have word 0 in [10d, 10d + 10) and the others in [-k, k], sorted and
    distinct from lo[d] = (10d, INT32_MIN, ...); hi[d] = lo[d + 1], the
    last all INT32_MAX."""
    s = len(counts)
    keys = np.full((s, c, w), I32MAX, np.int32)
    vers = np.full((s, c), ck.NEG_VERSION, np.int32)
    lo = np.full((s, w), I32MIN, np.int32)
    lo[:, 0] = 10 * np.arange(s)
    hi = np.concatenate([lo[1:], np.full((1, w), I32MAX, np.int32)])
    tail = np.stack(np.meshgrid(*[np.arange(-k, k + 1)] * (w - 1),
                                indexing="ij"), -1).reshape(-1, w - 1)
    for d, n in enumerate(counts):
        word0 = np.repeat(10 * d + np.arange(10), len(tail))
        pool = np.column_stack([word0, np.tile(tail, (10, 1))])
        rows = pool[rng.choice(len(pool), n - 1, replace=False)]
        rows = np.concatenate([lo[d:d + 1], rows]).astype(np.int32)
        keys[d, :n] = rows[np.lexsort(rows.T[::-1])]
        vers[d, :n] = rng.integers(-5, 60, n)
    return keys, vers, lo, hi


def word_reads(rng, b, r, w, s, lo, hi, k=3):
    """[B, R, W] read rows (numpy: begin, end, mask) around the shards of
    :func:`word_shards`, and the adversarial rows of :func:`rank_reads`."""
    rb = rng.integers(-k, k + 1, (b, r, w)).astype(np.int32)
    rb[..., 0] = rng.integers(-3, 10 * s + 3, (b, r))
    re_ = rng.integers(-k, k + 1, (b, r, w)).astype(np.int32)
    re_[..., 0] = rb[..., 0] + rng.integers(0, 3, (b, r))
    mask = rng.random((b, r)) < 0.85
    rb[0], re_[0] = I32MAX, I32MAX
    rb[1, 0], re_[1, 0] = I32MIN, I32MAX
    rb[2, 0], re_[2, 0] = lo[-1], hi[-1]
    re_[3, 0] = I32MAX
    re_[4] = rb[4]
    rb[5], re_[5] = -100, -90
    mask[:6] = True
    return rb, re_, mask


def live_rank_case(s, b, kind, dev, c=64):
    """(hist, RankBatch, lo, hi) of a live-prefix K8 case on ``dev``."""
    rng = np.random.default_rng(s * b + c)
    span = 3 * c
    keys, vers, lo, hi = rank_shards(rng, live_counts(rng, kind, s, c), c,
                                     span)
    if kind == "edge":
        hi[1] = lo[1]  # an empty shard: every read clips to nothing there
    rb, re_, mask = rank_reads(rng, b, 3, lo, hi, s * span + 5,
                               width=c if kind == "big" else 8)
    n_used = (keys[..., 0] != I32MAX).sum(1).astype(np.int32)
    hist = ck.ConflictState(on(keys, dev), on(vers, dev), on(n_used, dev),
                            on(np.full(s, 4, np.int32), dev),
                            on(np.zeros(s, bool), dev))
    rbk = ck.RankBatch(on(rb, dev), on(re_, dev), on(mask, dev), on(rb, dev),
                       on(re_, dev), on(np.zeros_like(mask), dev),
                       on(rng.integers(0, 60, b).astype(np.int32), dev),
                       on(rng.random(b) < 0.9, dev),
                       on(np.zeros(2 * b * 3, np.int32), dev))
    return hist, rbk, on(lo, dev), on(hi, dev)


def live_word_case(s, b, kind, dev, c=64, w=3):
    """(hist, BatchTensors, lo, hi) of a live-prefix K16 case on ``dev``;
    lo and hi None for "flat" (S = 1, no bounds)."""
    rng = np.random.default_rng(s * b + c + w)
    k = 4 if kind == "big" else 2
    keys, vers, lo, hi = word_shards(rng, live_counts(rng, kind, s, c), c, w,
                                     k)
    if kind == "edge":
        hi[1] = lo[1]
    rb, re_, mask = word_reads(rng, b, 3, w, s, lo, hi, k + 1)
    n_used = (keys[..., 0] != I32MAX).sum(1).astype(np.int32)
    hist = ck.ConflictState(on(keys, dev), on(vers, dev), on(n_used, dev),
                            on(np.full(s, 4, np.int32), dev),
                            on(np.zeros(s, bool), dev))
    bt = ck.BatchTensors(on(rb, dev), on(re_, dev), on(mask, dev),
                         on(rb, dev), on(re_, dev),
                         on(np.zeros_like(mask), dev),
                         on(rng.integers(0, 60, b).astype(np.int32), dev),
                         on(rng.random(b) < 0.9, dev))
    if kind == "flat":
        return hist, bt, None, None
    return hist, bt, on(lo, dev), on(hi, dev)


def _one_probe_launch(entry: str) -> None:
    """One entry call, two CUDA kernels as ``lp_run`` counts them at their
    launches (the live table's build and the probe), and no K2 table."""
    from foundationdb_tpu_torch import kernels as K

    e = K.ENTRY_LAUNCHES
    assert e.get(entry) == 1 and "hp_table" not in e, e
    assert K.LIVE_PROBE_KERNELS["last"] == 2, K.LIVE_PROBE_KERNELS


@pytest.mark.parametrize("b,s,empty,state", [
    (30, 1, False, "stream"), (33, 4, False, "stream"),
    (64, 4, True, "stream"), (1000, 3, True, "stream"),
    (30, 4, False, "random"), (64, 4, False, "edge"), (33, 1, False, "random"),
    (70, 4, False, "big")])
def test_shard_probe(card, b, s, empty, state):
    """K8 over the shards' live rows against its plain version and the
    plain twin of its algorithm: odd B, S = 1, an empty shard (lo == hi:
    every clipped read is empty), reads ending at the last shard's
    INT32_MAX bound; on live-prefix states, shards of 1 and C live rows,
    reads of INT32_MAX, spanning a shard or all of them, clipped empty,
    and ("big") full shards of C = 5000 rows with ranges past 512 rows (the
    top of the live table, two build tiles)."""
    from foundationdb_tpu_torch import kernels as K

    if state == "stream":
        res = sharded_history(s, 64, card, seed=b)
        rng = np.random.default_rng(b)
        hist = res.hist
        rbk = rank_batch(rng, b, 2, 1, int(res.n_keys), card)
        lo, hi = res.shard_lo.clone(), res.shard_hi.clone()
        if empty:
            hi[1] = lo[1]
    else:
        hist, rbk, lo, hi = live_rank_case(s, b, state, card,
                                           5000 if state == "big" else 64)
    floor = torch.tensor(3, dtype=torch.int32, device=card)
    K.reset_launches()
    got = ck.shard_probe(hist, rbk, lo, hi, floor)
    _one_probe_launch("sh_probe")
    want = ck.shard_probe_plain(hist, rbk, lo, hi, floor)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(ck.shard_probe_live_plain(hist, rbk, lo, hi, floor),
                    want):
        assert torch.equal(g, w)
    assert bool(want[1].any())


def or_mode_shards(rng, b, kinds, dev):
    """(cand, one shard's clipped ranks per kind): random, no live write,
    or every read and write on one key (every tile of every candidate
    column occupied)."""
    cand = on(rng.random(b) < 0.85, dev)
    shards = []
    for kind in kinds:
        _, ranks = wave_inputs(rng, b, 2, 1, max(b // 4, 40), dev)
        ranks = list(ranks)
        if kind == "none":
            ranks[5] = torch.zeros_like(ranks[5])
        elif kind == "dense":
            ranks = [torch.zeros_like(ranks[0]), torch.full_like(ranks[1], 5),
                     torch.ones_like(ranks[2]), torch.zeros_like(ranks[3]),
                     torch.full_like(ranks[4], 5), torch.ones_like(ranks[5])]
        shards.append(tuple(ranks))
    return cand, shards


@pytest.mark.parametrize("s,kinds", [
    (1, ("random",)), (1, ("dense",)), (2, ("none", "dense")),
    (4, ("random", "none", "random", "dense"))])
@pytest.mark.parametrize("b", [31, 32, 8192, 8193])
def test_k5_or_mode_exchange(card, s, kinds, b):
    """K5's OR mode (the fused exchange, K10) against the OR of the stacked
    plain matrices and the sum of their ``wave_occupied_tiles``
    (``wave_exchange_plain``): into a matrix and stats full of garbage,
    shard 0 with no live write or fully occupied, a later shard with no
    live write; through ``kernels.wave_pred_or`` and
    ``ck.shard_pred_exchange``; one CUDA kernel a shard, counted at its
    launch (the profiler, where it sees kernels, sees no more); the
    workspace left zeroed."""
    from foundationdb_tpu_torch import kernels as K

    rng = np.random.default_rng(b * 10 + s + len(kinds[0]))
    cand, shards = or_mode_shards(rng, b, kinds, card)
    want = ck.wave_exchange_plain(torch.stack(
        [ck.wave_pred_matrix_plain(cand, r) for r in shards]))
    bp = (b + 31) // 32 * 32
    p = torch.full((bp, bp // 32), -1, dtype=torch.int32, device=card)
    stats = torch.full((2,), 12345, dtype=torch.int32, device=card)

    def fused():
        for i, r in enumerate(shards):
            K.wave_pred_or(cand, *r, p, stats, i, s)
            assert K.WAVE_PRED_KERNELS["last"] == 1

    fused()
    assert torch.equal(p, want[0]) and torch.equal(stats, want[1])
    assert int(want[1][0]) > 0
    clip = ck.ShardClip(*(torch.stack([r[j] for r in shards])
                          for j in (3, 4, 5, 0, 1, 2)))
    got = ck.shard_pred_exchange(cand, clip)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.cuda.synchronize()
    assert not K._pred_workspace(card).any()
    assert _cuda_kernels(lambda: fused(), lambda: ()) <= s


@pytest.mark.parametrize("wave", [False, True])
def test_sharded_engine_cuda_equals_cpu(card, wave):
    """Object, wire and window paths of a 3-shard engine on the card
    against the CPU plain run (odd batch size: K8's psum branch), through
    a reshard that inserts bound keys: verdicts, levels and every leaf."""
    from foundationdb_tpu_torch.models.conflict_set import encode_resolve_batch
    from foundationdb_tpu_torch.parallel.sharded_resolver import (
        ShardedConflictSet,
    )

    kw = dict(n_shards=3, capacity=256, batch_size=21, max_read_ranges=2,
              max_write_ranges=2, max_key_bytes=8, window_versions=300,
              wave_commit=wave, auto_reshard=False)
    eng = {dev: ShardedConflictSet(device=dev, **kw) for dev in (card, "cpu")}
    rng = np.random.default_rng(12)
    cv = 1000
    for i in range(9):
        cv += int(rng.integers(1, 40))
        txns = [rand_txn(rng, int(rng.integers(cv - 250, cv)))
                for _ in range(int(rng.integers(2, 42)))]
        out = {}
        for dev, cs in eng.items():
            if i == 4:
                cs.reshard([b"b", b"c\x00"])
            if i % 3 == 0:
                v = [int(x) for x in cs.resolve(txns, cv, cv - 200)]
            elif i % 3 == 1:
                v = cs.resolve_wire_async(encode_resolve_batch(txns), cv,
                                          cv - 200, as_array=True)().tolist()
            else:
                count = min(len(txns) // 2, 21)
                v = cs.resolve_wire_window(
                    encode_resolve_batch(txns[:2 * count]), [cv, cv + 1],
                    count).tolist()
            out[dev] = (v, cs.last_wave, None if cs.last_wave_window is None
                        else cs.last_wave_window.tolist(),
                        cs.shard_occupancy())
        cv += 1
        assert out[card] == out["cpu"], i
        sa, sb = (convert.snapshot(e) for e in (eng[card], eng["cpu"]))
        for k, v in sb["state"].items():
            assert sa["state"][k].tobytes() == v.tobytes(), (i, k)
        assert sa["sharded"] == sb["sharded"], i
    assert eng[card].reshard_moved_shards > 0


# ------------------------------------------------------ K11 (admission)


@pytest.mark.parametrize("banks,nbits,m,n,k", [(1, 32, 1, 1, 1),
                                               (3, 200, 37, 41, 2),
                                               (5, 1 << 12, 1001, 999, 3),
                                               (4, 1 << 20, 16385, 8191, 2)])
def test_admission_banks(card, banks, nbits, m, n, k):
    """K11's set, clear, probe and count against the plain versions over
    bool banks: odd row counts, odd bank counts, a bank size below one
    word and the smoke's 2^20 bits; a set refused for bad slots or a bad
    bank."""
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.admission import filter as af

    rng = np.random.default_rng(banks * nbits + m)
    words = torch.zeros((banks, (nbits + 31) // 32), dtype=torch.int32,
                        device=card)
    bits = torch.zeros((banks, nbits), dtype=torch.bool, device=card)
    for bank in rng.integers(0, banks, 4):
        idx = on(rng.integers(0, nbits, m), card)
        K.admission_set(words, int(bank), idx, nbits)
        af.banks_set_plain(bits, int(bank), idx)
    for bad in (idx.cpu(), idx.int(), idx[None]):
        with pytest.raises((TypeError, ValueError)):
            K.admission_set(words, 0, bad, nbits)
    with pytest.raises(ValueError):
        K.admission_set(words, banks, idx, nbits)
    K.admission_clear(words, banks - 1)
    bits[banks - 1] = False
    assert torch.equal(af.unpack_banks(words, nbits), bits)
    assert torch.equal(af.pack_banks(bits), words)
    idx = on(rng.integers(0, nbits, (n, k)), card)
    for mask in (rng.random(banks) < 0.5, np.ones(banks, bool)):
        bm = on(mask, card)
        assert torch.equal(K.admission_probe(words, idx, bm, nbits),
                           af.banks_probe_plain(bits, idx, bm))
    assert K.admission_count(words).long().tolist() == \
        af.banks_count_plain(bits).tolist()


def test_device_filter_equals_numpy_filter(card):
    from foundationdb_tpu_torch.admission import RecentWritesFilter

    rng = np.random.default_rng(3)
    fs = [RecentWritesFilter(bits_log2=10, banks=3, window_versions=300,
                             backend=b, device=card if b == "device" else None)
          for b in ("numpy", "device")]
    v = 0
    for _ in range(40):
        v += int(rng.integers(1, 40))
        fps = rng.integers(0, 2**64 - 1, int(rng.integers(0, 60)),
                           dtype=np.uint64)
        probe = rng.integers(0, 2**64 - 1, 77, dtype=np.uint64)
        for f in fs:
            f.record_u64(fps, v)
        a, b = (f.probe_u64(probe, v - 100) for f in fs)
        assert a.tolist() == b.tolist()
        assert fs[0].saturation() == fs[1].saturation()


# ------------------------------------------------ K12, K13 (non-resident)


def word_rows(rng, n, w, spread):
    rows = rng.integers(-spread, spread, (n, w)).astype(np.int32)
    rows[:, : max(0, w - 2)] = 7  # a shared prefix
    rows = np.unique(rows, axis=0)
    return rows[np.lexsort(rows.T[::-1])]


def word_state(rng, c, w, n_live, dev):
    keys = np.full((c, w), ck.INT32_MAX, np.int32)
    live = word_rows(rng, 3 * n_live, w, 40)[:n_live]
    keys[: len(live)] = live
    vers = np.full(c, ck.NEG_VERSION, np.int32)
    vers[: len(live)] = rng.integers(0, 50, len(live))
    return ck.ConflictState(on(keys, dev), on(vers, dev),
                            torch.tensor(len(live), dtype=torch.int32,
                                         device=dev),
                            torch.tensor(3, dtype=torch.int32, device=dev),
                            torch.tensor(False, device=dev))


def packed_batch(rng, b, r, q, w, dev):
    """A PackedBatch with its host paint order, ranks into a dictionary
    of 2·B·(R+Q)+1 rows (the +inf row last)."""
    n = 2 * b * (r + q)
    uniq = word_rows(rng, n, w, 40)[: n // 2]
    dict_keys = np.full((n + 1, w), ck.INT32_MAX, np.int32)
    dict_keys[: len(uniq)] = uniq
    u = len(uniq)

    def pair(cols):
        a = rng.integers(0, u, (b, cols))
        z = np.minimum(a + rng.integers(0, 4, (b, cols)), u)
        return a.astype(np.int32), z.astype(np.int32)

    rb, re_ = pair(r)
    wb, we = pair(q)
    paint = np.concatenate([wb.reshape(-1), we.reshape(-1)])
    ranks = ck.RankBatch(
        on(rb, dev), on(re_, dev), on(rng.random((b, r)) < 0.9, dev),
        on(wb, dev), on(we, dev), on(rng.random((b, q)) < 0.8, dev),
        on(rng.integers(0, 60, b).astype(np.int32), dev),
        on(rng.random(b) < 0.95, dev),
        on(np.argsort(paint, kind="stable").astype(np.int32), dev))
    return ck.PackedBatch(on(dict_keys, dev), ranks)


@pytest.mark.parametrize("w,b,c", [(1, 33, 70), (4, 100, 1000),
                                   (9, 129, 300), (4, 8192, 4099)])
def test_word_search_and_probe(card, w, b, c):
    """K12 (base and delta, and flat) against its plain version at W = 1,
    4, 9, with dictionaries and batches not multiples of the block."""
    rng = np.random.default_rng(w * b)
    base, delta = word_state(rng, c, w, c // 2, card), \
        word_state(rng, 67, w, 40, card)
    pb = packed_batch(rng, b, 2, 1, w, card)
    got = ck.dict_history_search(base.keys, pb.dict_keys, delta.keys)
    want = ck.dict_history_search(base.keys, pb.dict_keys, delta.keys,
                                  plain=True)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    floor = torch.tensor(5, dtype=torch.int32, device=card)
    st = ck.build_table(base.versions)
    flat = ck.dict_history_search(base.keys, pb.dict_keys)
    # Two levels (the base's table, the delta's live rows), then the base
    # as one flat level (its versions and live rows; the card builds the
    # level's table itself).
    for s, bst, lvl in ((got, st, delta), (flat, None, base)):
        for g, x in zip(ck.packed_probe(pb.ranks, floor, s, bst,
                                        lvl.versions, lvl.n_used),
                        ck.packed_probe(pb.ranks, floor, s, bst,
                                        lvl.versions, lvl.n_used,
                                        plain=True)):
            assert torch.equal(g, x)


@pytest.mark.parametrize("b,c,cd", [(100, 500, 300), (33, 64, 64),
                                    (1000, 4096, 2100)])
def test_word_paint_fold_compact(card, b, c, cd):
    """K13's paint, fold and compaction against the plain versions at
    W = 4 (a paint and a fold that overflow at the small capacities)."""
    rng = np.random.default_rng(b + c)
    w = 4
    pb = packed_batch(rng, b, 2, 1, w, card)
    for floor_v in (0, 20):
        floor = torch.tensor(floor_v, dtype=torch.int32, device=card)
        acc = on(rng.random(b) < 0.7, card)
        st = word_state(rng, cd, w, cd // 3, card)
        want = ck._paint_and_compact_packed(
            ck.snapshot_res(st), pb.dict_keys, pb.ranks, acc, 77, floor,
            plain=True)
        got = ck._paint_and_compact_packed(ck.snapshot_res(st), pb.dict_keys,
                                           pb.ranks, acc, 77, floor)
        for g, x in zip(got, want):
            assert torch.equal(g, x)
        base, delta = word_state(rng, c, w, c // 2, card), want
        fold_want = ck._merge_delta_plain(base, delta, floor)
        ck.K.word_fold(base, delta, floor, None)
        for g, x in zip(base, fold_want):
            assert torch.equal(g, x)
    skeys = torch.cat([base.keys, delta.keys])
    order = np.lexsort(skeys.cpu().numpy().T[::-1])
    skeys = skeys[on(order, card)].contiguous()
    newv = on(rng.integers(0, 4, skeys.shape[0]).astype(np.int32), card)
    prior = torch.tensor(False, device=card)
    for c_out in (5, c):
        for g, x in zip(ck._dedup_compact(skeys, newv, c_out, prior),
                        ck._dedup_compact_plain(skeys, newv, c_out, prior)):
            assert torch.equal(g, x)


def test_width1_k4_launches_unchanged(card):
    """A resident engine still runs K4 (step_compact.cu) for its rank-space
    history and never K13; a non-resident one runs K12 and K13 and never
    K1, K4 or K2's probe."""
    from foundationdb_tpu_torch import kernels as K

    rng = np.random.default_rng(1)
    txns = [rand_txn(rng, 990) for _ in range(20)]
    kw = dict(capacity=64, batch_size=24, max_read_ranges=2,
              max_write_ranges=2, max_key_bytes=8)
    for resident in (True, False):
        cs = TorchConflictSet(device=card, resident=resident, **kw)
        K.reset_launches()
        cs.resolve(txns, 1000)
        e = K.ENTRY_LAUNCHES
        if resident:
            assert e.get("sc_paint") == 1 and "wc_paint" not in e, e
        else:
            assert e.get("wc_paint") == 1 and e.get("wp_search") == 1, e
            assert e.get("wp_probe") == 1 and "sc_paint" not in e, e
            assert "di_insert" not in e and "hp_probe" not in e, e


@pytest.mark.parametrize("wave", [False, True])
def test_non_resident_engine_cuda_equals_cpu(card, wave):
    """Object (with reports), wire and window paths of a non-resident
    engine with a tiny delta (folds) on the card against the CPU plain
    run, through advances and a rebase: verdicts, levels, every leaf."""
    from foundationdb_tpu_torch.models.conflict_set import encode_resolve_batch

    kw = dict(capacity=96, batch_size=21, max_read_ranges=2,
              max_write_ranges=2, max_key_bytes=8, window_versions=300,
              delta_capacity=30, wave_commit=wave, resident=False)
    eng = {dev: TorchConflictSet(device=dev, **kw) for dev in (card, "cpu")}
    rng = np.random.default_rng(5 + wave)
    cv = 1000
    for i in range(12):
        cv += int(rng.integers(1, 40)) + (1 << 30 if i == 8 else 0)
        txns = [rand_txn(rng, int(rng.integers(cv - 250, cv)))
                for _ in range(int(rng.integers(2, 42)))]
        out = {}
        for dev, cs in eng.items():
            if i == 5:
                cs.advance(cv, cv - 100)
                v = []
            elif i % 3 == 0:
                v = [int(x) for x in cs.resolve(txns, cv, cv - 200)]
            elif i % 3 == 1:
                v = cs.resolve_wire_async(encode_resolve_batch(txns), cv,
                                          cv - 200, as_array=True)().tolist()
            else:
                count = min(len(txns) // 2, 21)
                v = cs.resolve_wire_window(
                    encode_resolve_batch(txns[:2 * count]), [cv, cv + 1],
                    count).tolist()
            out[dev] = (v, cs.last_wave, cs.last_conflicting,
                        None if cs.last_wave_window is None
                        else cs.last_wave_window.tolist(), cs.headroom())
        cv += 1
        assert out[card] == out["cpu"], i
        sa, sb = (convert.snapshot(e) for e in (eng[card], eng["cpu"]))
        for k, v in sb["state"].items():
            assert sa["state"][k].tobytes() == v.tobytes(), (i, k)
    assert eng[card].base_version > 1 << 29


# --------------------------------------- K14-K16 and the unpacked paint


def key_rows(rng, n, w, kind):
    """[n, w] int32 rows: random words, a few distinct rows (long equal
    runs), signed extremes, or packed-looking keys with +inf pads."""
    if kind == "random":
        return rng.integers(-2**31, 2**31, (n, w), dtype=np.int64).astype(
            np.int32)
    if kind == "runs":
        base = rng.integers(-2, 2, (7, w)).astype(np.int32)
        return base[rng.integers(0, 7, n)]
    if kind == "extremes":
        return rng.choice(np.array([-2**31, -2**31 + 1, -1, 0, 1,
                                    2**31 - 2, 2**31 - 1], np.int64),
                          (n, w)).astype(np.int32)
    rows = rng.integers(-2**31, -2**31 + 4, (n, w)).astype(np.int32)
    rows[rng.random(n) < 0.3] = ck.INT32_MAX
    return rows


@pytest.mark.parametrize("n,w,kind", [(1, 4, "random"), (7, 1, "runs"),
                                      (1000, 4, "runs"), (1025, 4, "random"),
                                      (3000, 9, "extremes"),
                                      (16384, 4, "padded"),
                                      (49153, 4, "runs"),
                                      (5000, 24, "random")])
def test_word_sort(card, n, w, kind):
    """K14 against the plain sort (W stable torch.sort passes): keys and
    payloads bit for bit, so equal rows keep their input order; N of one,
    below and above a tile, not a power of two; W up to 24 words (a
    smaller shared-memory tile)."""
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.ops.lex import sort_keys_with_payload

    rng = np.random.default_rng(n + w)
    keys = on(key_rows(rng, n, w, kind), card)
    pays = [torch.arange(n, dtype=torch.int32, device=card),
            on(rng.integers(-9, 9, n).astype(np.int32), card)]
    got_k, got_p = K.word_sort(keys, pays)
    want = sort_keys_with_payload(keys, *pays)
    assert torch.equal(got_k, want[0])
    for g, x in zip(got_p, want[1:]):
        assert torch.equal(g, x)


def key_batch(rng, b, r, q, w, dev, kind="runs"):
    """A BatchTensors of [B, ., W] key rows on ``dev`` (begin <= end per
    slot, some empty, some masked and +inf padded)."""
    def rows(n):
        a = key_rows(rng, 2 * b * n, w, kind).reshape(b, n, 2, w)
        swap = ck.lex_lt(torch.from_numpy(a[:, :, 1]),
                         torch.from_numpy(a[:, :, 0])).numpy()[..., None]
        lo = np.where(swap, a[:, :, 1], a[:, :, 0])
        hi = np.where(swap, a[:, :, 0], a[:, :, 1])
        m = rng.random((b, n)) < 0.85
        lo = np.where(m[..., None], lo, ck.INT32_MAX)
        hi = np.where(m[..., None], hi, ck.INT32_MAX)
        return on(lo.astype(np.int32), dev), on(hi.astype(np.int32), dev), \
            on(m, dev)

    rb, re_, rm = rows(r)
    wb, we, wm = rows(q)
    return ck.BatchTensors(rb, re_, rm, wb, we, wm,
                           on(rng.integers(0, 30, b).astype(np.int32), dev),
                           on(rng.random(b) < 0.9, dev))


@pytest.mark.parametrize("b,r,q,w,kind", [(1, 1, 1, 4, "runs"),
                                          (33, 3, 2, 4, "extremes"),
                                          (100, 2, 1, 1, "runs"),
                                          (8192, 2, 1, 4, "random"),
                                          (500, 12, 8, 4, "runs")])
def test_word_ranks(card, b, r, q, w, kind):
    """K14's rank launch against ``endpoint_ranks_live_plain``."""
    rng = np.random.default_rng(b * w)
    bt = key_batch(rng, b, r, q, w, card, kind)
    got = ck.endpoint_ranks_live(bt)
    want = ck.endpoint_ranks_live_plain(bt)
    for g, x in zip(got, want):
        assert torch.equal(g, x)


def word_bounds(s, w, dev):
    """[S, W] shard bounds: the minimum key row, interior rows, +inf."""
    lo = np.zeros((s, w), np.int32)
    lo[:, 0] = -2**31 + np.arange(s) * 2
    lo[:, 1:] = -2**31
    hi = np.concatenate([lo[1:], np.full((1, w), ck.INT32_MAX, np.int32)])
    return on(lo, dev), on(hi, dev)


@pytest.mark.parametrize("b,s", [(30, 1), (33, 4), (8192, 4)])
def test_word_clip(card, b, s):
    rng = np.random.default_rng(b + s)
    bt = key_batch(rng, b, 2, 1, 4, card, "padded")
    lo, hi = word_bounds(s, 4, card)
    for reads in (False, True):
        got = ck.word_clip(bt, lo, hi, reads)
        want = ck.word_clip_plain(bt, lo, hi, reads)
        for g, x in zip(got, want):
            assert (g is None and x is None) or torch.equal(g, x)


def clip_case(rng, b, r, q, w, lo, hi, dev, dead=False):
    """A BatchTensors of key rows for K15: random words, signed extremes,
    the shard bounds themselves and rows differing from a bound in the last
    word only, begin <= end per slot; every mask false when ``dead``."""
    bounds = np.concatenate([lo, hi])
    near = np.repeat(bounds, 3, 0)
    near[1::3, -1] = np.maximum(near[1::3, -1].astype(np.int64) - 1,
                                -2**31).astype(np.int32)
    near[2::3, -1] = np.minimum(near[2::3, -1].astype(np.int64) + 1,
                                2**31 - 1).astype(np.int32)

    def rows(n):
        pool = np.concatenate([key_rows(rng, 2 * n, w, "extremes"),
                               key_rows(rng, 2 * n, w, "random"), near])
        a = pool[rng.integers(0, len(pool), 2 * b * n)].reshape(b, n, 2, w)
        swap = ck.lex_lt(torch.from_numpy(a[:, :, 1]),
                         torch.from_numpy(a[:, :, 0])).numpy()[..., None]
        x = np.where(swap, a[:, :, 1], a[:, :, 0])
        y = np.where(swap, a[:, :, 0], a[:, :, 1])
        m = rng.random((b, n)) < (0.0 if dead else 0.85)
        return on(x, dev), on(y, dev), on(m, dev)

    return ck.BatchTensors(*rows(r), *rows(q),
                           on(np.zeros(b, np.int32), dev),
                           on(np.ones(b, bool), dev))


@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("s", [1, 3, 4, 8])
def test_word_clip_window_buffers(card, w, s):
    """K15 as the window program launches it (``ck.WordWindowClip``:
    buffers and checks once a [k, ...] window, every step's slice clipped
    into them) against ``word_clip_plain``: W = 4 (16-byte rows) and the
    word loop; rows equal to a bound or one off in its last word;
    INT32_MIN / INT32_MAX words; a step with every mask false; B·Q and
    B·R not multiples of 4; one CUDA kernel a step. At W = 4 also rows
    that are not 16-byte aligned (the word loop) through the checked
    entry."""
    from foundationdb_tpu_torch import kernels as K

    rng = np.random.default_rng(100 * w + s)
    b, r, q, k = 37, 3, 1, 3
    rows = np.unique(np.concatenate([key_rows(rng, 4 * s, w, "extremes"),
                                     key_rows(rng, 4 * s, w, "random")]),
                     axis=0)  # sorted: the int32 words' lexicographic order
    rows = rows[(rows != -2**31).any(1)]
    pick = np.sort(rng.choice(len(rows), s - 1, replace=False))
    lo = np.concatenate([np.full((1, w), -2**31, np.int32), rows[pick]])
    hi = np.concatenate([lo[1:], np.full((1, w), ck.INT32_MAX, np.int32)])
    steps = [clip_case(rng, b, r, q, w, lo, hi, card, dead=i == 1)
             for i in range(k)]
    window = ck.BatchTensors(*(torch.stack(x) for x in zip(*steps)))
    tlo, thi = on(lo, card), on(hi, card)
    for reads in (False, True):
        wclip = ck.WordWindowClip.of(window, tlo, thi, reads)
        for i in range(k):
            before = K.ENTRY_LAUNCHES.get("wsh_clip", 0)
            got = wclip.step(ck._step_batch(window, i))
            assert K.ENTRY_LAUNCHES["wsh_clip"] == before + 1
            want = ck.word_clip_plain(steps[i], tlo, thi, reads)
            for g, x in zip(got, want):
                assert (g is None and x is None) or torch.equal(g, x)
            got = ck.word_clip(steps[i], tlo, thi, reads)
            for g, x in zip(got, want):
                assert (g is None and x is None) or torch.equal(g, x)
        step = ck._step_batch(window, 0)
        assert _cuda_kernels(lambda: wclip.step(step), lambda: ()) <= 1
    if w == 4:  # rows one word past 16-byte alignment
        def shifted(t):
            buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
            buf[1:] = t.reshape(-1)
            return buf[1:].view(t.shape)

        step = steps[0]
        odd = step._replace(**{f: shifted(getattr(step, f)) for f in (
            "read_begin", "read_end", "write_begin", "write_end")})
        got = ck.word_clip(odd, tlo, thi, True)
        want = ck.word_clip_plain(step, tlo, thi, True)
        for g, x in zip(got, want):
            assert torch.equal(g, x)


def nr_sharded(s, capacity, dev, seed=0, batch=None):
    """A non-resident sharded engine (batch size ``batch``, default 8·S)
    after a seeded stream on the CPU, its state copied to ``dev``:
    (engine, state on dev)."""
    from foundationdb_tpu_torch.parallel.sharded_resolver import (
        ShardedConflictSet,
    )

    batch = batch or 8 * s
    cs = ShardedConflictSet(n_shards=s, device="cpu", capacity=capacity,
                            batch_size=batch, max_read_ranges=2,
                            max_write_ranges=2, max_key_bytes=8,
                            resident=False, auto_reshard=False, splits=[
                                bytes([97 + i]) for i in range(1, s)])
    rng = np.random.default_rng(seed)
    for i in range(6):
        cv = 100 + 10 * i
        cs.resolve([rand_txn(rng, cv - 5) for _ in range(min(8 * s, batch))],
                   cv, cv - 40)
    return cs, ck.ConflictState(*(x.to(dev) for x in cs.state))


@pytest.mark.parametrize("b,s,clip,state", [
    (30, 1, False, "stream"), (36, 4, True, "stream"),
    (63, 3, True, "stream"), (1000, 1, False, "stream"),
    (30, 3, True, "random"), (64, 3, True, "edge"), (33, 1, False, "flat"),
    (70, 3, True, "big"), (40, 1, False, "k2_table")])
def test_word_shard_probe(card, b, s, clip, state):
    """K16 over the shards' live rows against its plain version and the
    plain twin of its algorithm, clipped to the shards or (S = 1)
    unclipped; odd B; on live-prefix states, shards of 1 and C live rows,
    reads of all INT32_MAX words, spanning a shard or all of them, clipped
    empty, ("big") full shards of C = 5000 rows of W = 4 with ranges past
    512 rows, and ("k2_table") K2's prebuilt table in place of the live
    one (the two-level engine's base)."""
    from foundationdb_tpu_torch import kernels as K

    if state == "stream":
        cs, hist = nr_sharded(s, 64, card, seed=b, batch=b)
        rng = np.random.default_rng(b)
        bt, _ = cs._pack([rand_txn(rng, 120) for _ in range(b)])
        big = ck.BatchTensors(*(on(x, card) for x in bt))
        lo = on(cs._lo, card) if clip else None
        hi = on(cs._hi, card) if clip else None
    else:
        kind = "flat" if state == "k2_table" else state
        hist, big, lo, hi = live_word_case(
            s, b, kind, card, *((5000, 4) if state == "big" else (64, 3)))
    floor = torch.tensor(103 if state == "stream" else 3, dtype=torch.int32,
                         device=card)
    K.reset_launches()
    if state == "k2_table":
        got = K.word_shard_probe(
            hist.keys, hist.versions, hist.n_used, big.read_begin,
            big.read_end, big.read_mask, big.read_version, big.txn_mask, lo,
            hi, floor, table=K.build_table(hist.versions.reshape(-1)))
        assert K.LIVE_PROBE_KERNELS["last"] == 1
    else:
        got = ck.word_shard_probe(hist, big, lo, hi, floor)
        _one_probe_launch("wsh_probe")
    want = ck.word_shard_probe_plain(hist, big, lo, hi, floor)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    for g, x in zip(ck.word_shard_probe_live_plain(hist, big, lo, hi, floor),
                    want):
        assert torch.equal(g, x)


@pytest.mark.parametrize("cap", [12, 64, 200])
def test_unpacked_paint(card, cap):
    """The unpacked paint (K13's wc_paint_keys, K12's search, K14's sort,
    K13's wc_paint_sorted) against its plain version on every shard of a
    non-resident state: rejected writes on +inf, clipped begins at lo,
    and a capacity small enough to overflow."""
    cs, hist = nr_sharded(4, cap, card, seed=cap)
    rng = np.random.default_rng(cap)
    bt, _ = cs._pack([rand_txn(rng, 150) for _ in range(32)])
    bt = ck.BatchTensors(*(on(x, card) for x in bt))
    lo, hi = on(cs._lo, card), on(cs._hi, card)
    clip = ck.word_clip(bt, lo, hi, False)
    accepted = on(rng.random(32) < 0.7, card)
    for s in range(4):
        view = ck.clip_view(bt, clip, s)
        floor = torch.tensor(112, dtype=torch.int32, device=card)
        base = ck._shard_hist(hist, s)
        got = ck._paint_and_compact(ck.ConflictState(*(x.clone()
                                                       for x in base)),
                                    view, accepted, 160, floor)
        want = ck._paint_and_compact_plain(base, view, accepted, 160, floor)
        for g, x in zip(got, want):
            assert torch.equal(g, x), s


@pytest.mark.parametrize("wave", [False, True])
def test_flat_resolve_batch_cuda_equals_cpu(card, wave):
    """The single flat engine's resolve_batch (with the report) and
    resolve_many on the card against the CPU."""
    cs, _ = nr_sharded(1, 128, "cpu", seed=4)
    rng = np.random.default_rng(9)
    state = ck.init_state(128, cs.codec.width, cs.codec.min_key, "cpu")
    gstate = ck.ConflictState(*(x.to(card) for x in state))
    for i in range(6):
        cv = 200 + 10 * i
        bt, _ = cs._pack([rand_txn(rng, cv - int(rng.integers(1, 40)))
                          for _ in range(8)])
        tb = ck.BatchTensors(*(torch.from_numpy(x) for x in bt))
        want = ck.resolve_batch(state, tb, cv, cv - 30, report=True,
                                wave=wave)
        got = ck.resolve_batch(gstate, ck.BatchTensors(*(x.to(card)
                                                         for x in tb)),
                               cv, cv - 30, report=True, wave=wave)
        for g, x in zip(got[:-1], want[:-1]):
            assert torch.equal(g.cpu(), x), i
        for g, x in zip(got[-1], want[-1]):
            assert torch.equal(g.cpu(), x), i
        state, gstate = want[-1], got[-1]


@pytest.mark.parametrize("wave", [False, True])
def test_nr_sharded_engine_cuda_equals_cpu(card, wave):
    """Object, wire and window paths of a 3-shard non-resident engine on
    the card against the CPU plain run (odd batch size), through a reshard
    into a small shard, an advance and a rebase: verdicts, levels, every
    leaf; per resolve step K16, K15 and K14 launch once and the paint of
    K13, K12 and K14 once per shard, never K1, K4, K8 or K13's packed
    paint."""
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.models.conflict_set import encode_resolve_batch
    from foundationdb_tpu_torch.parallel.sharded_resolver import (
        ShardedConflictSet,
    )

    kw = dict(n_shards=3, capacity=96, batch_size=21, max_read_ranges=2,
              max_write_ranges=2, max_key_bytes=8, window_versions=300,
              wave_commit=wave, auto_reshard=False, resident=False)
    eng = {dev: ShardedConflictSet(device=dev, **kw) for dev in (card, "cpu")}
    rng = np.random.default_rng(12)
    cv = 1000
    for i in range(12):
        cv += int(rng.integers(1, 40)) + (1 << 30 if i == 9 else 0)
        txns = [rand_txn(rng, int(rng.integers(cv - 250, cv)))
                for _ in range(int(rng.integers(2, 22)))]
        out = {}
        for dev, cs in eng.items():
            if i == 4:
                cs.reshard([b"b", b"b\x01"])
            K.reset_launches()
            if i == 7:
                cs.advance(cv, cv - 100)
                v = []
            elif i % 3 == 0:
                v = [int(x) for x in cs.resolve(txns, cv, cv - 200)]
            elif i % 3 == 1:
                v = cs.resolve_wire_async(encode_resolve_batch(txns), cv,
                                          cv - 200, as_array=True)().tolist()
            else:
                count = len(txns) // 2
                v = cs.resolve_wire_window(
                    encode_resolve_batch(txns[:2 * count]), [cv, cv + 1],
                    count).tolist()
            if dev != "cpu" and i % 3 == 0 and i != 7:
                e = K.ENTRY_LAUNCHES
                assert e.get("wsh_probe") == 1 and e.get("wsh_clip") == 1, e
                assert e.get("wc_paint_sorted") == 3, e
                assert e.get("wso_sort") == 3, e
                assert e.get("wso_ranks") == (3 if wave else 1), e
                for k in ("di_insert", "sc_paint", "sh_probe", "wc_paint",
                          "hp_probe"):
                    assert k not in e, e
            out[dev] = (v, cs.last_wave, None if cs.last_wave_window is None
                        else cs.last_wave_window.tolist(),
                        cs.shard_occupancy(), cs.headroom(), cs.overflowed)
        cv += 1
        assert out[card] == out["cpu"], i
        sa, sb = (convert.snapshot(e) for e in (eng[card], eng["cpu"]))
        for k, v in sb["state"].items():
            assert sa["state"][k].tobytes() == v.tobytes(), (i, k)
        assert sa["sharded"] == sb["sharded"], i
    assert eng[card].base_version > 1 << 29
    if wave:
        assert eng[card].exchange_stats() == eng["cpu"].exchange_stats()


# --------------------------------------- K17 and K14 at W = 1


@pytest.mark.parametrize("n", [1, 255, 256, 257, 4099, 16386, 1 << 20])
def test_blocked_build_and_query(card, n):
    """K17's build and query against ``block_table`` / ``range_max_blocked``
    bit for bit: N not a multiple of 256, one block, empty and one-block
    queries, ``bl + 1 >= bh``, bounds below 0 and past N."""
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.ops.rmq import block_table, range_max_blocked

    rng = np.random.default_rng(n)
    v = rng.integers(-1000, 1000, n).astype(np.int32)
    v[rng.random(n) < 0.3] = ck.NEG_VERSION
    nq = 20000
    lo = rng.integers(-300, n + 600, nq).astype(np.int32)
    hi = rng.integers(-300, n + 600, nq).astype(np.int32)
    m = nq // 2
    lo[:m] = rng.integers(0, n, m)
    hi[:m] = np.minimum(lo[:m] + rng.integers(-2, 700, m), n)
    vt = on(v, card)
    table = K.blocked_build(vt)
    want = block_table(vt, ck.NEG_VERSION)
    for g, w in zip(table, (want.prefix, want.suffix, want.top)):
        assert torch.equal(g, w)
    got = K.blocked_query(vt, table, on(lo, card), on(hi, card))
    assert torch.equal(got, range_max_blocked(want, on(lo, card), on(hi, card),
                                              ck.NEG_VERSION))


@pytest.mark.parametrize("flat", [False, True])
def test_blocked_probes_equal_plain(card, flat):
    """The resident probe under rmq="blocked" (K17's build, K12's rank
    search, K17's probe), two-level and flat, against its plain version
    (the other arms' blocked probes run in the engine test below)."""
    rng = np.random.default_rng(3 + flat)
    c, cd, b, r = 700, 300, 100, 3
    keys = np.sort(rng.choice(10_000, c - 1, replace=False)).astype(np.int32)

    def scalar(x, dtype=torch.int32):
        return torch.tensor(x, dtype=dtype, device=card)

    base = ck.ConflictState(
        keys=on(np.concatenate([[0], keys]).astype(np.int32)[:, None],
                card),
        versions=on(rng.integers(-5, 60, c).astype(np.int32), card),
        n_used=scalar(c), oldest=scalar(0),
        overflow=scalar(False, torch.bool))
    dk = np.sort(rng.choice(10_000, cd - 1, replace=False)).astype(np.int32)
    delta = base._replace(
        keys=on(np.concatenate([[0], dk]).astype(np.int32)[:, None], card),
        versions=on(rng.integers(-5, 60, cd).astype(np.int32), card),
        n_used=scalar(cd))
    hist = base if flat else ck.HistState(base, ck.build_table(base.versions),
                                          delta)
    rb = rng.integers(0, 10_000, (b, r)).astype(np.int32)
    rbk = ck.RankBatch(
        on(rb, card), on(rb + rng.integers(-3, 300, (b, r)).astype(np.int32),
                         card), on(rng.random((b, r)) < 0.9, card),
        None, None, None, on(rng.integers(0, 50, b).astype(np.int32), card),
        on(rng.random(b) < 0.95, card), None)
    floor = scalar(10)
    got = ck.history_probe(hist, rbk, floor, "blocked")
    want = ck.history_probe_plain(hist, rbk, floor, "blocked")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_sort_ranks_with_payload_k14_at_width_1(card):
    from foundationdb_tpu_torch.ops.lex import (
        sort_ranks_with_payload,
        sort_ranks_with_payload_plain,
    )

    rng = np.random.default_rng(11)
    for n in (1, 33, 16384, 49153):
        ranks = rng.integers(0, max(1, n // 50), n).astype(np.int32)
        ranks[rng.random(n) < 0.1] = ck.INT32_MAX
        p = [on(rng.integers(-9, 9, n).astype(np.int32), card)
             for _ in range(2)]
        got = sort_ranks_with_payload(on(ranks, card), *p)
        want = sort_ranks_with_payload_plain(on(ranks, card), *p)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("arm", [
    dict(history="batch"), dict(rmq="blocked"),
    dict(history="batch", rmq="blocked"),
    dict(resident=False, history="batch"),
    dict(resident=False, history="batch", rmq="blocked"),
    dict(packed=False), dict(packed=False, history="batch", rmq="blocked"),
    dict(packed=False, wave_commit=True), dict(accept="seq")],
    ids=lambda a: "-".join(f"{k}={v}" for k, v in a.items()))
def test_design_arm_engine_cuda_equals_cpu(card, arm):
    """Every design arm on the card against the CPU plain run: object
    (with reports), wire and window paths through advances, verdicts,
    levels, every leaf."""
    from foundationdb_tpu_torch.models.conflict_set import encode_resolve_batch

    kw = dict(capacity=128, batch_size=21, max_read_ranges=2,
              max_write_ranges=2, max_key_bytes=8, window_versions=300,
              delta_capacity=30, **arm)
    eng = {dev: TorchConflictSet(device=dev, **kw) for dev in (card, "cpu")}
    rng = np.random.default_rng(17)
    cv = 1000
    for i in range(10):
        cv += int(rng.integers(1, 40))
        txns = [rand_txn(rng, int(rng.integers(cv - 250, cv)))
                for _ in range(int(rng.integers(2, 42)))]
        out = {}
        for dev, cs in eng.items():
            if i == 5:
                cs.advance(cv, cv - 100)
                v = []
            elif i % 3 == 0:
                v = [int(x) for x in cs.resolve(txns, cv, cv - 200)]
            elif i % 3 == 1:
                v = cs.resolve_wire_async(encode_resolve_batch(txns), cv,
                                          cv - 200, as_array=True)().tolist()
            else:
                count = min(len(txns) // 2, 21)
                v = cs.resolve_wire_window(
                    encode_resolve_batch(txns[:2 * count]), [cv, cv + 1],
                    count).tolist()
            out[dev] = (v, cs.last_wave, cs.last_conflicting,
                        None if cs.last_wave_window is None
                        else cs.last_wave_window.tolist(), cs.headroom())
        cv += 1
        assert out[card] == out["cpu"], i
        sa, sb = (convert.snapshot(e) for e in (eng[card], eng["cpu"]))
        for k, v in sb["state"].items():
            assert sa["state"][k].tobytes() == v.tobytes(), (i, k)


# --------------------------------------- K17 in the sharded probes (10d)


@pytest.mark.parametrize("b,s,cap,empty", [(30, 1, 64, False),
                                           (33, 4, 96, False),
                                           (64, 4, 256, True),
                                           (1000, 3, 300, True)])
def test_blocked_shard_probe(card, b, s, cap, empty):
    """K17's sharded probe at W = 1 (the resident arm: K17's build over
    every shard's live rows, then the clip, rank search and blocked range
    max over the shard's live rows) against its plain version: odd B, C
    not a multiple of the 256-row block, an empty shard, reads ending at
    the INT32_MAX bound. One entry, two CUDA kernels counted at their
    launches; K2 and K8 do not launch."""
    from foundationdb_tpu_torch import kernels as K

    res = sharded_history(s, cap, card, seed=b)
    rng = np.random.default_rng(b)
    rbk = rank_batch(rng, b, 2, 1, int(res.n_keys), card)
    lo, hi = res.shard_lo.clone(), res.shard_hi.clone()
    if empty:
        hi[1] = lo[1]
    floor = torch.tensor(3, dtype=torch.int32, device=card)
    K.reset_launches()
    got = ck.shard_probe(res.hist, rbk, lo, hi, floor, "blocked")
    e = dict(K.ENTRY_LAUNCHES)
    assert e == {"rb_shard_probe": 1}, e
    assert K.BLOCKED_PROBE_KERNELS["last"] == 2, K.BLOCKED_PROBE_KERNELS
    want = ck.shard_probe_plain(res.hist, rbk, lo, hi, floor, "blocked")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    sparse = ck.shard_probe_plain(res.hist, rbk, lo, hi, floor)
    for g, w in zip(got, sparse):
        assert torch.equal(g, w)


@pytest.mark.parametrize("b,s,clip", [(30, 1, False), (36, 4, True),
                                      (63, 3, True)])
def test_blocked_word_shard_probe(card, b, s, clip):
    """K17's sharded probe at W = 4 (the non-resident arm) against its
    plain version, clipped to the shards or unclipped."""
    cs, hist = nr_sharded(s, 96, card, seed=b, batch=b)
    rng = np.random.default_rng(b)
    bt, _ = cs._pack([rand_txn(rng, 120) for _ in range(b)])
    big = ck.BatchTensors(*(on(x, card) for x in bt))
    lo = on(cs._lo, card) if clip else None
    hi = on(cs._hi, card) if clip else None
    floor = torch.tensor(103, dtype=torch.int32, device=card)
    got = ck.word_shard_probe(hist, big, lo, hi, floor, rmq="blocked")
    want = ck.word_shard_probe_plain(hist, big, lo, hi, floor, "blocked")
    for g, x in zip(got, want):
        assert torch.equal(g, x)


@pytest.mark.parametrize("arm", [
    dict(rmq="blocked"), dict(rmq="blocked", resident=False),
    dict(packed=False), dict(packed=False, wave_commit=True),
    dict(rmq="blocked", wave_commit=True)],
    ids=lambda a: "-".join(f"{k}={v}" for k, v in a.items()))
def test_sharded_arm_engine_cuda_equals_cpu(card, arm):
    """Each sharded design arm on the card against the CPU plain run:
    object, wire and window paths through a reshard and an advance,
    verdicts, levels, every leaf; a blocked arm launches K17's sharded
    probe (its build and probe) once a step and never K8, K16 or K2."""
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.models.conflict_set import encode_resolve_batch
    from foundationdb_tpu_torch.parallel.sharded_resolver import (
        ShardedConflictSet,
    )

    kw = dict(n_shards=3, capacity=96, batch_size=21, max_read_ranges=2,
              max_write_ranges=2, max_key_bytes=8, window_versions=300,
              auto_reshard=False, **arm)
    eng = {dev: ShardedConflictSet(device=dev, **kw) for dev in (card, "cpu")}
    rng = np.random.default_rng(21)
    cv = 1000
    for i in range(10):
        cv += int(rng.integers(1, 40))
        txns = [rand_txn(rng, int(rng.integers(cv - 250, cv)))
                for _ in range(int(rng.integers(2, 22)))]
        out = {}
        for dev, cs in eng.items():
            if i == 4:
                cs.reshard([b"b", b"b\x01"])
            K.reset_launches()
            if i == 7:
                cs.advance(cv, cv - 100)
                v = []
            elif i % 3 == 0:
                v = [int(x) for x in cs.resolve(txns, cv, cv - 200)]
            elif i % 3 == 1:
                v = cs.resolve_wire_async(encode_resolve_batch(txns), cv,
                                          cv - 200, as_array=True)().tolist()
            else:
                count = len(txns) // 2
                v = cs.resolve_wire_window(
                    encode_resolve_batch(txns[:2 * count]), [cv, cv + 1],
                    count).tolist()
            if dev != "cpu" and i % 3 == 0 and i != 7:
                e = K.ENTRY_LAUNCHES
                if arm.get("rmq") == "blocked":
                    assert e.get("rb_shard_probe") == 1, e
                    assert "rb_build" not in e and "hp_table" not in e, e
                    assert "sh_probe" not in e and "wsh_probe" not in e, e
                else:
                    assert e.get("wsh_probe") == 1 and "rb_build" not in e, e
            out[dev] = (v, cs.last_wave, None if cs.last_wave_window is None
                        else cs.last_wave_window.tolist(),
                        cs.shard_occupancy(), cs.headroom(), cs.overflowed)
        cv += 1
        assert out[card] == out["cpu"], i
        sa, sb = (convert.snapshot(e) for e in (eng[card], eng["cpu"]))
        for k, v in sb["state"].items():
            assert sa["state"][k].tobytes() == v.tobytes(), (i, k)
    if arm.get("wave_commit"):
        assert eng[card].exchange_stats() == eng["cpu"].exchange_stats()


# --------------------------------------- K12 on the read plane (B8)


@pytest.mark.parametrize("n,k,w", [(0, 5, 9), (1, 1, 9), (1000, 129, 9),
                                   (4099, 1, 3), (300, 1000, 9)])
def test_word_search_read_plane(card, n, k, w):
    """K12's search at read-plane shapes (one launch, unsorted query rows,
    W = 9, k not a multiple of the 128-thread block, an empty mirror,
    k = 1, queries equal to mirror rows and runs of equal rows) against
    the plain two-sided search, bit for bit."""
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.reads.read_set import search2

    rng = np.random.default_rng(n + k + w)
    rows = np.unique(rng.integers(-3, 3, (n, w)).astype(np.int32), axis=0)
    rows = np.concatenate([rows, rows[: len(rows) // 4]]).reshape(-1, w)
    rows = rows[np.lexsort(rows.T[::-1])] if len(rows) else rows
    q = rng.integers(-3, 4, (k, w)).astype(np.int32)
    if len(rows):
        q[: k // 2] = rows[rng.integers(0, len(rows), k // 2)]
    q[-1] = ck.INT32_MAX  # above every row
    K.reset_launches()
    got = search2(on(rows, card), on(q, card))
    assert K.ENTRY_LAUNCHES.get("wp_search") == 1
    want = search2(torch.from_numpy(rows), torch.from_numpy(q))
    for g, x in zip(got, want):
        assert torch.equal(g.cpu(), x)


def test_read_plane_on_the_card_equals_the_host_arm(card):
    """TorchReadSet and WatchIndex on the card against their host arms on
    a map with truncated equal-prefix keys: values, range rows, stats
    (pack_s aside) and fire sets; one K12 launch per search."""
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.reads import TorchReadSet, WatchIndex
    from foundationdb_tpu_torch.runtime.flow import Promise
    from foundationdb_tpu_torch.runtime.storage import VersionedMap

    rng = np.random.default_rng(8)
    vm = VersionedMap()
    keys = sorted({b"pre-%02d-%s" % (int(rng.integers(0, 30)),
                                     bytes(rng.integers(97, 100, 4)))
                   for _ in range(600)})
    for v in range(1, 5):
        for k in keys[v - 1::3]:
            vm.write(k, v, b"v%d" % v)
    dev = TorchReadSet(vm, arm="device", device=card)
    host = TorchReadSet(vm, arm="host")
    qs = [keys[int(i)] for i in rng.integers(0, len(keys), 200)] + [b"pre-"]
    reqs = [(b"pre-03", b"pre-07-b", 50, False, 3),
            (b"pre-10-aa", b"pre-2", 9, True, 4)]
    K.reset_launches()
    for rs in (dev, host):
        assert rs.get_points(qs, 3) == [rs.oracle_get(k, 3) for k in qs]
        assert rs.get_ranges(reqs) == [rs.oracle_range(*r) for r in reqs]
    assert K.ENTRY_LAUNCHES.get("wp_search") == 2
    strip = [{k: v for k, v in rs.stats.items() if k not in ("pack_s",
                                                             "uploads")}
             for rs in (dev, host)]
    assert strip[0] == strip[1] and dev.stats["uploads"] == 1
    fired = {}
    sweeps = [(v, [(keys[int(i)], b"x%d" % (i % 2))
                   for i in rng.integers(0, len(keys), 40)])
              for v in range(5, 9)]
    for arm in ("device", "1"):
        idx = WatchIndex(arm=arm, device=card if arm == "device" else None)
        log = fired.setdefault(arm, [])
        for k in keys:
            p = Promise()
            p.future.add_done_callback(lambda f, k=k, log=log:
                                       log.append((k, f.result())))
            idx.add(k, b"v1", p)
        for v, written in sweeps:
            idx.sweep(v, written)
    assert fired["device"] == fired["1"] and fired["1"]


# --- K4 (merge-path tiles, look-back, device decision) and K1 (delta-side
# search) against their plain versions -------------------------------------

T4 = ck.K4_TILE


def rank_state(rng, c, keys, vers, dev, overflow=False):
    """A width-1 history holding ``keys`` (sorted, unique, rank 0 first)
    with ``vers``, +inf / NEG_VERSION past them, in capacity ``c``."""
    k = np.full(c, ck.INT32_MAX, np.int32)
    v = np.full(c, ck.NEG_VERSION, np.int32)
    k[:len(keys)] = keys
    v[:len(keys)] = vers
    return ck.ConflictState(on(k[:, None], dev), on(v, dev),
                            torch.tensor(len(keys), dtype=torch.int32,
                                         device=dev),
                            torch.tensor(3, dtype=torch.int32, device=dev),
                            torch.tensor(overflow, device=dev))


def paint_batch(rng, b, q, space, kind, dev):
    wb = rng.integers(0, space, (b, q)).astype(np.int32)
    we = (wb + rng.integers(1, 6, (b, q))).astype(np.int32)
    mask = rng.random((b, q)) < 0.8
    acc = rng.random(b) < 0.7
    if kind == "one_rank":  # all 2BQ endpoints on one rank: one long run
        wb[:] = space // 2
        we[:] = space // 2
    elif kind == "one_rank_ranges":  # begins on one rank, ends on another
        wb[:] = space // 3
        we[:] = space // 3 + 5
        mask[:] = True
    elif kind == "none_accepted":
        acc[:] = False
    elif kind == "masked_inf":
        wb[~mask] = ck.INT32_MAX
        we[~mask] = ck.INT32_MAX
    src = np.argsort(np.concatenate([wb.reshape(-1), we.reshape(-1)]),
                     kind="stable").astype(np.int32)
    zero = np.zeros((b, 1), np.int32)
    ranks = ck.RankBatch(on(zero, dev), on(zero, dev), on(zero > 0, dev),
                         on(wb, dev), on(we, dev), on(mask, dev),
                         on(np.zeros(b, np.int32), dev),
                         on(np.ones(b, bool), dev), on(src, dev))
    return ranks, on(acc, dev)


def equal_twice(fn, want, what):
    """The kernel's answer equals the plain one on two runs (any schedule
    of the look-back gives the same bytes)."""
    for run in range(2):
        got = fn()
        for g, w in zip(got, want):
            assert torch.equal(g, w), (what, run)


@pytest.mark.parametrize("kind", ["random", "one_rank", "one_rank_ranges",
                                  "none_accepted", "below_floor",
                                  "overflow", "masked_inf"])
@pytest.mark.parametrize("c,b,q", [(16386, 8192, 1), (5000, 3001, 2),
                                   (300, 40, 1)])
def test_paint_fold_adversarial(card, kind, c, b, q):
    """K4's paint, fold and compaction against the plain versions: runs of
    equal keys longer than a tile (all endpoints on one rank; the +inf
    tails) and starting at tile edges (a base and delta of the same keys
    pair up at even rows, one extra delta row shifts them), every row
    below the floor, survivors past capacity, no accepted writes, C and
    Cd not multiples of the tile."""
    rng = np.random.default_rng(c + b + len(kind))
    live = c - 4 if kind == "overflow" else c // 3
    keys = np.concatenate([[0], np.sort(rng.choice(
        np.arange(1, 4 * c), live - 1, replace=False))]).astype(np.int32)
    vers = rng.integers(0, 60, live).astype(np.int32)
    floor = torch.tensor(1000 if kind == "below_floor" else 10,
                         dtype=torch.int32, device=card)
    ranks, acc = paint_batch(rng, b, q, 4 * c, kind, card)
    for prior in (False, True):
        st = rank_state(rng, c, keys, vers, card, prior)
        want = ck._paint_and_compact_res_plain(ck.snapshot_res(st), ranks,
                                               acc, 77, floor)

        def paint():
            return ck._paint_and_compact_res(ck.snapshot_res(st), ranks, acc,
                                             77, floor)

        equal_twice(paint, want, f"paint {kind} prior={prior}")
    if kind == "overflow":
        assert bool(want.overflow)
    # The fold: the same keys in base and delta (equal rows pair up at even
    # merged rows), then one more delta key a third of the way in (pairs
    # at odd rows past it).
    free = np.setdiff1d(np.arange(1, 4 * c), keys)
    for extra in (0, 1):
        dkeys = np.union1d(keys, free[len(free) // 3:][:extra]).astype(
            np.int32)
        cap = c if kind != "overflow" else len(keys)
        base = rank_state(rng, cap, keys, vers, card)
        delta = rank_state(rng, len(dkeys) + 3, dkeys, rng.integers(
            0, 90, len(dkeys)), card)
        want = ck._merge_delta_plain(base, delta, floor)

        def fold():
            return ck._merge_delta(ck.snapshot_res(base), delta, floor)

        equal_twice(fold, want, f"fold {kind} extra={extra}")
    # The compaction alone with runs that start exactly at tile edges and
    # runs longer than a tile.
    n = 3 * T4 + 5
    for run in (2, T4, T4 + 3, 1000):
        sk = (np.arange(n) // run).astype(np.int32)
        sk[-7:] = ck.INT32_MAX
        newv = rng.integers(0, 3, n).astype(np.int32)
        args = (on(sk[:, None], card), on(newv, card))
        for c_out in (5, n):
            prior = torch.tensor(False, device=card)
            want = ck._dedup_compact_plain(*args, c_out, prior)
            equal_twice(lambda: ck._dedup_compact(*args, c_out, prior), want,
                        f"compact run={run} c_out={c_out}")


@pytest.mark.parametrize("offset", [-1, 0])
@pytest.mark.parametrize("c", [1 << 20, 5000])
def test_gated_fold_decision_and_reset(card, c, offset):
    """``_maybe_merge`` on the card (the decision launch, the gated fold
    with the reset in its second launch, the gated table) equals
    ``_maybe_merge_plain`` with ``reclaimable`` at C // 8 - 1 and C // 8,
    and with the delta's demand just fitting and just not. When the fold
    is not needed, no state array changes."""
    rng = np.random.default_rng(c + offset)
    live = c // 2
    keys = np.concatenate([[0], np.sort(rng.choice(
        np.arange(1, 4 * c), live - 1, replace=False))]).astype(np.int32)
    vers = rng.integers(50, 90, live).astype(np.int32)
    vers[1:1 + c // 8 + offset] = 20  # expired at floor 30
    cd = 16386
    dkeys = np.concatenate([[0], np.sort(rng.choice(
        np.arange(1, 4 * c), 99, replace=False))]).astype(np.int32)
    floor = torch.tensor(30, dtype=torch.int32, device=card)
    for demand in (cd - 100, cd - 99):
        base = rank_state(rng, c, keys, vers, card)
        delta = rank_state(rng, cd, dkeys, rng.integers(40, 90, 100), card)
        hist = ck.HistState(base, ck.build_table(base.versions), delta)
        want = ck._maybe_merge_plain(ck.snapshot_res(hist), demand, floor)
        need = ck.fold_need_plain(hist, demand, floor)
        assert bool(need) == (offset == 0 or demand == cd - 99)
        assert bool(ck.K.fold_need(base.versions, delta, floor,
                                   demand)) == bool(need)
        for run in range(2):
            got = ck._maybe_merge(ck.snapshot_res(hist), demand, floor)
            for g, w in zip(_hist_leaves(got), _hist_leaves(want)):
                assert torch.equal(g, w), (demand, run)
        if not bool(need):
            for g, w in zip(_hist_leaves(got), _hist_leaves(hist)):
                assert torch.equal(g, w)


def _hist_leaves(h):
    return [*h.base, h.base_st, *h.delta]


@pytest.mark.parametrize("w", [1, 3, 4])
@pytest.mark.parametrize("m", [1, 2, 1023, 49152])
@pytest.mark.parametrize("kind", ["random", "equal", "past", "near_full"])
def test_dict_insert_merge_path(card, w, m, kind):
    """K1's insert (the delta-side search, merge-path tiles, W-word row
    copies) against ``_dict_insert_plain``, shift table included: delta
    rows equal to dictionary rows, past every live row, and n_keys near D
    so rows drop past D + 1; M + 3 delta slots, +inf padded."""
    rng = np.random.default_rng(w * 31 + m)
    d = 1 << 16 if m < 49152 else 1 << 18
    n_keys = d - m // 2 if kind == "near_full" else d // 3
    span = 1 << 12 if w > 1 else 1 << 22
    live = np.unique(rng.integers(-span, span, (2 * n_keys + 64, w)).astype(
        np.int32), axis=0)[:n_keys]
    dict_keys = np.full((d + 1, w), ck.INT32_MAX, np.int32)
    dict_keys[:len(live)] = live
    if kind == "equal":
        pool = live[rng.integers(0, len(live), m)]
    elif kind == "past":  # every delta row past every live row
        pool = np.repeat(live[-1:], m, 0)
        pool[:, -1] += 1 + np.arange(m, dtype=np.int32)
    else:
        pool = rng.integers(-span, span, (m, w)).astype(np.int32)
    delta = np.unique(pool.astype(np.int32), axis=0)
    delta_keys = np.full((m + 3, w), ck.INT32_MAX, np.int32)
    delta_keys[:len(delta)] = delta
    dk, dl = on(dict_keys, card), on(delta_keys, card)
    n = torch.tensor(len(live), dtype=torch.int32, device=card)
    want = ck._dict_insert_plain(dk, n, dl)
    for run in range(2):
        got = ck._dict_insert(dk, n, dl)
        for g, x in zip(got, want):
            assert torch.equal(g, x), (kind, run)


def _cuda_kernels(fn, setup, reps=3) -> float:
    """CUDA kernels one call of ``fn(*setup())`` launches (torch.profiler),
    copies and fills of device memory apart."""
    from torch.profiler import ProfilerActivity, profile

    args = [setup() for _ in range(reps + 1)]
    fn(*args[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for a in args[1:]:
            fn(*a)
        torch.cuda.synchronize()
    n = sum(ev.count for ev in prof.key_averages()
            if (getattr(ev, "device_time_total", None)
                or getattr(ev, "cuda_time_total", 0))
            and not ev.key.startswith(("Memcpy", "Memset")))
    return n / reps


def test_k4_launch_counts(card):
    """At most two CUDA kernels a paint, at most five a gated fold step
    whose fold is not needed (the decision, two gated fold launches, two
    gated table launches)."""
    rng = np.random.default_rng(2)
    c, cd = 1 << 20, 16386
    keys = np.concatenate([[0], np.sort(rng.choice(
        np.arange(1, 4 * c), c // 4, replace=False))]).astype(np.int32)
    base = rank_state(rng, c, keys, rng.integers(50, 90, len(keys)), card)
    delta = rank_state(rng, cd, keys[:2000], rng.integers(50, 90, 2000),
                       card)
    hist = ck.HistState(base, ck.build_table(base.versions), delta)
    ranks, acc = paint_batch(rng, 8192, 1, 4 * c, "random", card)
    floor = torch.tensor(10, dtype=torch.int32, device=card)
    paint = _cuda_kernels(
        lambda d: ck._paint_and_compact_res(d, ranks, acc, 77, floor),
        lambda: (ck.snapshot_res(delta),))
    step = _cuda_kernels(lambda h: ck._maybe_merge(h, 100, floor),
                         lambda: (hist,))
    assert not bool(ck.fold_need_plain(hist, 100, floor))
    assert paint <= 2 and step <= 5, (paint, step)


# --- K14 (merge by ranking) and K13's sorted paint (live tiles) against
# their plain versions -------------------------------------------------------


def sort_rows_of(rng, n, w, kind):
    if kind == "equal":
        return np.tile(rng.integers(-9, 9, (1, w)).astype(np.int32), (n, 1))
    if kind == "inf":
        return np.full((n, w), ck.INT32_MAX, np.int32)
    return key_rows(rng, n, w, kind)


# N around one and two tiles of 1024 rows, and of the tiles that grow past
# 24 of them (2048 rows from 24,577 at W <= 23).
K14_EDGES = [0, 1, 1023, 1024, 1025, 2047, 2048, 2049, 24576, 24577, 36863,
             36864, 36865, 49152, 49153, 57343]


@pytest.mark.parametrize("w", [1, 4, 9, 24])
@pytest.mark.parametrize("n", K14_EDGES)
@pytest.mark.parametrize("kind", ["runs", "equal", "inf", "padded"])
def test_word_sort_tile_edges(card, w, n, kind):
    """K14's sort against the plain sort at N = 0, 1 and one below, at and
    above one and two tiles (``kernels.word_sort_tile``), with four
    payloads: keys and payloads bit for bit (equal rows keep their input
    order)."""
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.ops.lex import sort_keys_with_payload

    t = K.word_sort_tile(n, w)
    assert t and n % t in (0, 1, t - 1) or n < 2
    rng = np.random.default_rng(n * 31 + w)
    keys = on(sort_rows_of(rng, n, w, kind), card)
    pays = [torch.arange(n, dtype=torch.int32, device=card)] + [
        on(rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32),
           card) for _ in range(3)]
    got_k, got_p = K.word_sort(keys, pays)
    want = sort_keys_with_payload(keys, *pays)
    assert torch.equal(got_k, want[0])
    for g, x in zip(got_p, want[1:]):
        assert torch.equal(g, x)


@pytest.mark.parametrize("w", [1, 4, 9, 24])
@pytest.mark.parametrize("kind", ["runs", "equal", "inf", "random"])
def test_word_ranks_tile_edges(card, w, kind):
    """K14's ranks and liveness masks against the plain ones with N =
    4B (R = Q = 1) below, at and above one and two tiles."""
    for n in (4, 1020, 1024, 1028, 2048, 2052, 36860, 36864, 36868, 49152):
        rng = np.random.default_rng(n + w)
        b = n // 4
        rows = on(sort_rows_of(rng, 4 * b, w, kind).reshape(4, b, 1, w),
                  card)
        masks = on(rng.random((2, b, 1)) < 0.8, card)
        bt = ck.BatchTensors(rows[0], rows[1], masks[0], rows[2], rows[3],
                             masks[1], torch.zeros(b, dtype=torch.int32,
                                                   device=card),
                             torch.ones(b, dtype=torch.bool, device=card))
        got = ck.endpoint_ranks_live(bt)
        want = ck.endpoint_ranks_live_plain(bt)
        for g, x in zip(got, want):
            assert torch.equal(g, x), n


def live_word_state(rng, c, live, w, dev, vmax=60, overflow=False):
    """A [C, W] history of ``live`` sorted distinct rows (row 0 the minimum
    key, first words from a small set so that compares reach later
    words), random versions, (+inf, NEG_VERSION) past them."""
    k = np.full((c, w), ck.INT32_MAX, np.int32)
    v = np.full(c, ck.NEG_VERSION, np.int32)
    k[0] = -2**31
    rows = np.empty((0, w), np.int32)
    while len(rows) < live - 1:
        more = rng.integers(-2**31 + 1, 2**31 - 1, (2 * live, w),
                            dtype=np.int64).astype(np.int32)
        if w > 1:
            more[:, 0] = rng.integers(-3, 3, 2 * live)
        rows = np.unique(np.concatenate([rows, more]), axis=0)
    rows = rows[:live - 1]
    rows = rows[np.lexsort(rows.T[::-1])]
    k[1:live] = rows
    v[:live] = rng.integers(0, vmax, live)
    return ck.ConflictState(on(k, dev), on(v, dev),
                            torch.tensor(live, dtype=torch.int32, device=dev),
                            torch.tensor(3, dtype=torch.int32, device=dev),
                            torch.tensor(overflow, device=dev))


def new_rows(rng, st, e2, kind):
    """(keys [2·e2, W], deltas): endpoint rows, begins then ends, a
    rejected or empty write parked on +inf with delta 0; ``hist``: every
    endpoint a history key, ``run``: every endpoint on one key, ``inf``:
    every write rejected."""
    w = st.keys.shape[1]
    live = int(st.n_used)
    hist = st.keys[:live].cpu().numpy()
    if kind in ("hist", "run"):
        pick = rng.integers(0, live, (2, e2))
        if kind == "run":
            pick[:] = live // 2
        ends = hist[pick]
    else:
        ends = rng.integers(-3, 3, (2, e2, w)).astype(np.int32)
        ends[..., 1:] = hist[rng.integers(0, live, (2, e2)), 1:]
    a, z = ends
    swap = ck.lex_lt(torch.from_numpy(z), torch.from_numpy(a)).numpy()
    a, z = np.where(swap[:, None], z, a), np.where(swap[:, None], a, z)
    valid = ck.lex_lt(torch.from_numpy(a), torch.from_numpy(z)).numpy()
    valid &= rng.random(e2) < 0.8
    if kind == "inf":
        valid[:] = False
    keys = np.concatenate([a, z])
    keys[np.concatenate([~valid, ~valid])] = ck.INT32_MAX
    d = valid.astype(np.int32)
    return keys, np.concatenate([d, -d])


def k13_against_paint_tail(st, keys, delta, cv, floor, dev):
    """K13's sorted paint (twice, on copies) against ``_paint_tail`` on
    K14's sorted rows: the whole [C, W] state, n_used, overflow, oldest.
    With no new rows, against the tile twin (``_paint_tail`` needs one)."""
    from foundationdb_tpu_torch import kernels as K

    keys, delta = on(keys, dev), on(delta, dev)
    floor = torch.tensor(floor, dtype=torch.int32, device=dev)
    if keys.shape[0]:
        cross = K.word_search(st.keys, keys)[1]
        snew, (sd, sx) = K.word_sort(keys, (delta, cross))
        soldv = st.versions[(sx - 1).clamp(min=0).long()]
        want = ck._paint_tail(st, snew, sd, soldv, sx, cv, floor)
    else:
        snew, sd, sx = keys, delta, delta.clone()
        want = ck.paint_sorted_tiles_plain(
            ck.ConflictState(*(x.cpu() for x in st)), snew.cpu(), sd.cpu(),
            sx.cpu(), cv, floor.cpu())
    for run in range(2):
        got = ck.ConflictState(*(x.clone() for x in st))
        K.word_paint_sorted(got, snew, sd, sx, cv, floor)
        for f, g, x in zip(got._fields, got, want):
            assert torch.equal(g.cpu(), x.cpu()), (f, run)
    return want


@pytest.mark.parametrize("case", ["n_used_1", "overflowed", "no_new",
                                  "all_parked", "hist_keys", "long_run",
                                  "expire_most", "random"])
@pytest.mark.parametrize("w", [1, 4, 9])
def test_word_paint_sorted_live_tiles(card, case, w):
    """K13's sorted paint against ``_paint_tail``: a history of one row;
    one whose every row is live (an overflowed shard: survivors past C);
    no new rows; every new row parked on +inf; new rows equal to history
    keys (runs across tile edges); a run of equal keys longer than a
    tile; a floor that expires most rows; random rows."""
    rng = np.random.default_rng(len(case) * 10 + w)
    c, live, e2, fl = 5000, 2000, 1500, 10
    if case == "n_used_1":
        live = 1
    elif case == "overflowed":
        live = c
    elif case == "no_new":
        e2 = 0
    elif case == "long_run":
        e2 = 3000
    elif case == "expire_most":
        fl = 55
    st = live_word_state(rng, c, live, w, card, overflow=case == "overflowed")
    kind = {"all_parked": "inf", "hist_keys": "hist",
            "long_run": "run"}.get(case, "random")
    keys, delta = new_rows(rng, st, e2, kind)
    want = k13_against_paint_tail(st, keys, delta, 77, fl, card)
    if case == "overflowed":
        assert bool(want.overflow)


def test_word_paint_sorted_work_follows_live_rows(card):
    """At equal live rows and new rows, K13's sorted paint gives the same
    live state at C = 2^18 and 2^20 (and equals ``_paint_tail`` at both)."""
    rng = np.random.default_rng(18)
    st = live_word_state(rng, 1 << 20, 20000, 4, card)
    keys, delta = new_rows(rng, st, 8192, "random")
    big = k13_against_paint_tail(st, keys, delta, 77, 10, card)
    small = ck.ConflictState(st.keys[:1 << 18].clone(),
                             st.versions[:1 << 18].clone(), *st[2:])
    got = k13_against_paint_tail(small, keys, delta, 77, 10, card)
    n = int(big.n_used)
    assert int(got.n_used) == n
    assert torch.equal(got.keys[:n], big.keys[:n])
    assert torch.equal(got.versions[:n], big.versions[:n])


def test_k13_k14_launch_counts(card):
    """At most three CUDA kernels a rank launch (N = 49,152, W = 4), a
    paint sort (16,384 rows, 2 payloads) and a sorted paint (C = 2^20)."""
    from foundationdb_tpu_torch import kernels as K

    rng = np.random.default_rng(3)
    bt = key_batch(rng, 8192, 2, 1, 4, card, "random")
    ranks = _cuda_kernels(lambda: ck.endpoint_ranks_live(bt), lambda: ())
    keys = on(key_rows(rng, 16384, 4, "padded"), card)
    pays = (torch.arange(16384, dtype=torch.int32, device=card),) * 2
    sort = _cuda_kernels(lambda: K.word_sort(keys, pays), lambda: ())
    st = live_word_state(rng, 1 << 20, 20000, 4, card)
    k, d = new_rows(rng, st, 8192, "random")
    k, d = on(k, card), on(d, card)
    snew, (sd, sx) = K.word_sort(k, (d, K.word_search(st.keys, k)[1]))
    floor = torch.tensor(10, dtype=torch.int32, device=card)
    paint = _cuda_kernels(
        lambda h: K.word_paint_sorted(h, snew, sd, sx, 77, floor),
        lambda: (ck.ConflictState(*(x.clone() for x in st)),))
    assert ranks <= 3 and sort <= 3 and paint <= 3, (ranks, sort, paint)


# ----------------- K12's block search (live prefix, branches) and K5's tiles


def search_rows(rng, kind, w, c=320, nq=300):
    """(keys [C, W] with rows past n all INT32_MAX, n, query rows): runs of
    equal rows, all-INT32_MAX queries and live +inf rows, n = 0 and n = C,
    sorted and unsorted queries, query counts around the tiles."""
    n = {"n0": 0, "full": c}.get(kind, int(rng.integers(1, c)))
    spread = 3 if kind in ("runs", "top") else 60
    keys = np.full((c, w), ck.INT32_MAX, np.int32)
    live = rng.integers(-spread, spread, (n, w)).astype(np.int32)
    keys[:n] = live[np.lexsort(live.T[::-1])]
    if kind == "top" and n > 2:
        keys[n - 2:n] = ck.INT32_MAX  # +inf rows inside the live prefix
    if kind == "tiles":
        nq = int(rng.choice([3, 4, 5, 8, 9, 15, 16, 17, 127, 128, 129]))
    q = rng.integers(-spread - 1, spread + 1, (nq, w)).astype(np.int32)
    if n:
        pick = rng.random(nq) < 0.4
        q[pick] = keys[rng.integers(0, n, int(pick.sum()))]
    q[rng.random(nq) < (0.3 if kind == "top" else 0.03)] = ck.INT32_MAX
    if kind != "unsorted":
        q = q[np.lexsort(q.T[::-1])]
    return keys, n, q


def _k12_equal(card, keys, q, live, plan, keys1=None, live1=None):
    """K12 on the card against the plain two-sided search over all rows,
    and its block counts by branch against ``word_search_tiles_plain``."""
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.ops.lex import searchsorted_words_2sided_fp

    stats = torch.zeros(3, dtype=torch.int32, device=card)
    got = K.word_search(on(keys, card), on(q, card),
                        None if keys1 is None else on(keys1, card),
                        None if live is None else live.to(card),
                        None if live1 is None else live1.to(card), stats,
                        plan)
    hists = [keys] + ([] if keys1 is None else [keys1])
    for h, keys_h in enumerate(hists):
        want = searchsorted_words_2sided_fp(torch.from_numpy(keys_h),
                                            torch.from_numpy(q))
        for g, x in zip(got[2 * h:2 * h + 2], want):
            assert torch.equal(g.cpu(), x.to(torch.int32)), (h, plan)
    twin = ck.word_search_tiles_plain(
        torch.from_numpy(keys), torch.from_numpy(q),
        None if keys1 is None else torch.from_numpy(keys1), live, live1,
        plan)
    assert torch.equal(stats.cpu(), twin[4]), (stats, twin[4], plan)
    return stats.cpu()


@pytest.mark.parametrize("w", [1, 4, 9, 24])
@pytest.mark.parametrize("kind", ["runs", "top", "n0", "full", "unsorted",
                                  "tiles"])
def test_k12_search_live_prefix_and_branches(card, kind, w):
    """K12 given a live count, at its own plan and at plans that force each
    branch (direct, staged, global; a span just over the budget), and in
    the two-history form with a shorter second live prefix: the answers
    equal the plain search over all C rows, the branch counts equal the
    block algorithm's twin."""
    rng = np.random.default_rng(len(kind) * 31 + w)
    keys, n, q = search_rows(rng, kind, w)
    live = torch.tensor(n, dtype=torch.int32)
    seen = torch.zeros(3, dtype=torch.int32)
    for plan in (None, (16, 0), (128, 0), (16, 160 * w), (32, 200 * 1024)):
        seen += _k12_equal(card, keys, q, live, plan)
    assert seen[0] > 0 and seen[1] + seen[2] > 0, seen
    keys2 = keys.copy()
    keys2[n // 3:] = ck.INT32_MAX
    for plan in (None, (64, 4096)):
        _k12_equal(card, keys, q, live, plan, keys2,
                   torch.tensor(n // 3, dtype=torch.int32))


def test_k12_span_just_over_the_shared_budget(card):
    """Two tiles of 16 sorted rows whose spans are the budget's rows and
    one more: one staged block, one global block, equal answers."""
    w, budget = 4, 40
    keys = np.stack([np.arange(320, dtype=np.int32)] * w, 1)
    q = keys[np.concatenate([np.linspace(10, 10 + budget - 1, 16),
                             np.linspace(100, 100 + budget, 16)]).astype(int)]
    # The shared bytes hold the tile's 16 rows, then the budget's rows.
    stats = _k12_equal(card, keys, q, None, (16, (16 + budget) * 4 * w))
    assert stats.tolist() == [0, 1, 1]


def test_k12_search_at_the_main_path_shapes(card):
    """K12 at the shapes of its callers, one CUDA kernel a call (counted
    at its launch; the profiler, where it sees kernels, sees no more): the
    engine's sorted dictionary (49,153 rows, W = 4) into a 2^20-row base
    and a 16,386-row delta with live counts (staged blocks), a paint's
    16,384 unsorted rows into 2^20 (direct), the read plane's 341 rows of
    W = 9 into a full mirror, 20,000 unsorted rows (global blocks)."""
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.ops.lex import searchsorted_words_2sided_fp

    rng = np.random.default_rng(14)
    base = live_word_state(rng, 1 << 20, 700_000, 4, card)
    delta = live_word_state(rng, 16386, 5000, 4, card)
    rows = torch.cat([base.keys[: 700_000], delta.keys[:5000]])
    pick = torch.from_numpy(rng.integers(0, rows.shape[0], 49152)).to(card)
    dict_keys = torch.cat([rows[pick], torch.full((1, 4), ck.INT32_MAX,
                                                  dtype=torch.int32,
                                                  device=card)])
    order = np.lexsort(dict_keys.cpu().numpy().T[::-1])
    dict_keys = dict_keys[torch.from_numpy(order).to(card)].contiguous()
    mirror = live_word_state(rng, 300_000, 300_000, 9, card).keys
    cases = [
        ("engine", base, dict_keys, delta, "staged"),
        ("paint", base, dict_keys[torch.randperm(49153, device=card)
                                  [:16384]].contiguous(), None, "direct"),
        ("unsorted", base, dict_keys[torch.randperm(49153, device=card)
                                     [:20000]].contiguous(), None, "global"),
        ("reads", None, mirror[torch.from_numpy(rng.integers(
            0, 300_000, 341)).to(card)].contiguous(), None, "direct")]
    for label, h0, q, h1, branch in cases:
        keys0 = mirror if h0 is None else h0.keys
        args = (keys0, q, None if h1 is None else h1.keys,
                None if h0 is None else h0.n_used,
                None if h1 is None else h1.n_used)
        stats = torch.zeros(3, dtype=torch.int32, device=card)
        got = K.word_search(*args, stats=stats)
        for hist, out in ((keys0, got[:2]), (None if h1 is None
                                             else h1.keys, got[2:])):
            if hist is None:
                continue
            for g, x in zip(out, searchsorted_words_2sided_fp(hist, q)):
                assert torch.equal(g, x.to(torch.int32)), label
        counts = dict(zip(K.WP_BRANCHES, stats.tolist()))
        assert counts[branch] == max(counts.values()), (label, counts)
        assert K.WORD_SEARCH_KERNELS["last"] == 1, label
        assert _cuda_kernels(lambda: K.word_search(*args), lambda: ()) <= 1


@pytest.mark.parametrize("kind", ["random", "b_not_32", "no_live_write",
                                  "wide", "dense", "empty_live", "noncand",
                                  "big"])
def test_k5_tiles_adversarial(card, kind):
    """K5 against its plain version and its tile twin on B not a multiple
    of 32, rows with no live write, R wide enough to shrink the tile,
    every interval equal, live empty intervals, few candidates and the
    smoke's B = 8192; one CUDA kernel a call (counted at its launch; the
    profiler, where it sees kernels, sees no more)."""
    from foundationdb_tpu_torch import kernels as K

    rng = np.random.default_rng(len(kind))
    b, r, q, space = {"b_not_32": (161, 3, 2, 90), "wide": (700, 40, 1, 900),
                      "dense": (130, 2, 2, 1), "big": (8192, 2, 1, 9000)
                      }.get(kind, (300, 2, 1, 200))
    cand, ranks = wave_inputs(rng, b, r, q, space, "cpu")
    ranks = list(ranks)
    if kind == "no_live_write":
        ranks[5] &= torch.from_numpy(rng.random((b, q)) < 0.4)
    elif kind == "dense":
        ranks = [torch.zeros((b, r), dtype=torch.int32),
                 torch.full((b, r), 5, dtype=torch.int32),
                 torch.ones((b, r), dtype=torch.bool),
                 torch.zeros((b, q), dtype=torch.int32),
                 torch.full((b, q), 5, dtype=torch.int32),
                 torch.ones((b, q), dtype=torch.bool)]
    elif kind == "empty_live":
        ranks[1] = ranks[0].clone()
        ranks[2] = torch.from_numpy(rng.random((b, r)) < 0.9)
    elif kind == "noncand":
        cand = torch.from_numpy(rng.random(b) < 0.05)
    want = ck.wave_pred_matrix_plain(cand, tuple(ranks))
    if kind != "big":
        assert torch.equal(ck.wave_pred_tiles_plain(cand, tuple(ranks)), want)
    cc, rc = cand.to(card), tuple(x.to(card) for x in ranks)
    assert torch.equal(ck.wave_pred_matrix(cc, rc).cpu(), want)
    K.wave_pred(cc, *rc)
    assert K.WAVE_PRED_KERNELS["last"] == 1
    assert _cuda_kernels(lambda: K.wave_pred(cc, *rc), lambda: ()) <= 1


# --------------------------------------- K17 over the live rows


def live_versions(rng, c, n, dev):
    """A history level's versions [C] with n live rows (the rest
    NEG_VERSION, as every writer leaves them) and its 0-dim n_used."""
    v = rng.integers(-1000, 1000, c).astype(np.int32)
    v[rng.random(c) < 0.3] = ck.NEG_VERSION
    v[n:] = ck.NEG_VERSION
    return on(v, dev), torch.tensor(n, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("c,n", [(1, 1), (300, 1), (300, 255), (300, 256),
                                 (4099, 4000), (16386, 16386),
                                 (1 << 20, 300_000), (1 << 20, 1 << 20)])
def test_blocked_live_build_and_query(card, c, n):
    """K17's live build (one CUDA kernel, no K2 launch: its last block
    builds the top) and query over [0, n_used) against the plain twin
    (``block_table_live``: its live blocks and levels bit for bit) and
    against the JAX ``range_max_blocked`` over all C rows: queries past
    n_used, ending at C, empty, inside one block, across the top; and a
    full history (n_used = C) equals ``block_table`` in every block."""
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.ops.rmq import (
        block_table,
        block_table_live,
        range_max_blocked,
        range_max_blocked_live,
    )

    rng = np.random.default_rng(c + n)
    v, n_used = live_versions(rng, c, n, card)
    K.reset_launches()
    table = K.blocked_build(v, n_used)
    assert K.ENTRY_LAUNCHES == {"rb_build": 1}, K.ENTRY_LAUNCHES
    assert _cuda_kernels(lambda: K.blocked_build(v, n_used), lambda: ()) <= 1
    live = block_table_live(v, n, ck.NEG_VERSION)
    nb = -(-n // 256)
    levels = K.table_levels(nb)
    assert torch.equal(table[0][:nb], live.prefix)
    assert torch.equal(table[1][:nb], live.suffix)
    assert torch.equal(table[2][:levels, :nb], live.top)
    if n == c:
        full = block_table(v, ck.NEG_VERSION)
        for g, w in zip(K.blocked_build(v), (full.prefix, full.suffix,
                                             full.top)):
            assert torch.equal(g, w)
    nq = 20000
    lo = rng.integers(0, c + 1, nq).astype(np.int32)
    hi = np.minimum(lo + rng.integers(-2, 700, nq), c).astype(np.int32)
    lo[:100] = rng.integers(n, c + 1, 100)  # at or past the live rows
    hi[100:200] = c  # ending at C
    hi[200:300] = lo[200:300]  # empty
    lo[300:400] = 0  # whole prefixes, across the top
    hi[300:400] = rng.integers(0, c + 1, 100)
    lo_t, hi_t = on(lo, card), on(hi, card)
    got = K.blocked_query(v, table, lo_t, hi_t, n_used)
    assert torch.equal(got, range_max_blocked_live(live, lo_t, hi_t, n,
                                                   ck.NEG_VERSION))
    assert torch.equal(got, range_max_blocked(
        block_table(v, ck.NEG_VERSION), lo_t, hi_t, ck.NEG_VERSION))


@pytest.mark.parametrize("flat,n_frac", [(True, 1.0), (True, 0.4),
                                         (False, 0.5), (False, 1.0)])
def test_blocked_probe_over_live_rows(card, flat, n_frac):
    """The resident blocked probe (K17's live build, K12's rank search,
    K17's probe with a transaction's slots on adjacent lanes) on levels
    whose rows past n_used are (+inf, NEG_VERSION), R = 3 and R = 40
    slots, against its plain version over all rows."""
    from foundationdb_tpu_torch import kernels as K

    rng = np.random.default_rng(int(10 * n_frac) + flat)
    c, cd = 5000, 700

    def level(cap, frac):
        n = max(1, int(cap * frac))
        keys = np.full((cap, 1), ck.INT32_MAX, np.int32)
        keys[1:n, 0] = np.sort(rng.choice(10_000, n - 1, replace=False))
        keys[0, 0] = 0
        v, n_used = live_versions(rng, cap, n, card)
        return ck.ConflictState(
            keys=on(keys, card), versions=v, n_used=n_used,
            oldest=torch.tensor(0, dtype=torch.int32, device=card),
            overflow=torch.tensor(False, device=card))

    base = level(c, 1.0)
    delta = level(cd if not flat else c, n_frac)
    hist = delta if flat else ck.HistState(base, ck.build_table(
        base.versions), delta)
    floor = torch.tensor(10, dtype=torch.int32, device=card)
    for b, r in ((100, 3), (37, 40)):
        rb = rng.integers(0, 10_500, (b, r)).astype(np.int32)
        re_ = rb + rng.integers(-3, 2000, (b, r)).astype(np.int32)
        re_[0] = ck.INT32_MAX
        rbk = ck.RankBatch(
            on(rb, card), on(re_, card), on(rng.random((b, r)) < 0.9, card),
            None, None, None,
            on(rng.integers(-1000, 1000, b).astype(np.int32), card),
            on(rng.random(b) < 0.95, card), None)
        K.reset_launches()
        got = ck.history_probe(hist, rbk, floor, "blocked")
        e = K.ENTRY_LAUNCHES
        assert e.get("rb_build") == 1 and e.get("rb_probe") == 1, e
        assert "hp_table" not in e, e
        want = ck.history_probe_plain(hist, rbk, floor, "blocked")
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("b,s,state", [
    (30, 1, "random"), (33, 4, "random"), (64, 4, "edge"), (70, 4, "big"),
    (1000, 3, "random"), (300, 80, "big")])
def test_blocked_live_shard_probe(card, b, s, state):
    """K17's sharded probe at W = 1 and W = 3 on live-prefix states
    (shards of 1 and C live rows, an empty shard, reads of INT32_MAX,
    spanning a shard or all of them, clipped empty; "big": full shards of
    C = 5000 (W = 1 and 4) with ranges across the top; at S = 80 the
    build's grid is one block a shard, which scans both of a full shard's
    tiles and builds its top with no ticket) against the plain twin of its
    algorithm (``rmq="blocked"``) and the per-shard plain probe over all
    rows: two CUDA kernels a call, counted at their launches."""
    from foundationdb_tpu_torch import kernels as K

    c = 5000 if state == "big" else 300
    hist, rbk, lo, hi = live_rank_case(s, b, state, card, c)
    floor = torch.tensor(3, dtype=torch.int32, device=card)
    K.reset_launches()
    got = ck.shard_probe(hist, rbk, lo, hi, floor, "blocked")
    assert K.ENTRY_LAUNCHES == {"rb_shard_probe": 1}, K.ENTRY_LAUNCHES
    assert K.BLOCKED_PROBE_KERNELS["last"] == 2
    want = ck.shard_probe_plain(hist, rbk, lo, hi, floor, "blocked")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(ck.shard_probe_live_plain(hist, rbk, lo, hi, floor,
                                              rmq="blocked"), want):
        assert torch.equal(g, w)
    assert _cuda_kernels(lambda: ck.shard_probe(hist, rbk, lo, hi, floor,
                                                "blocked"), lambda: ()) <= 2
    hist, bt, lo, hi = live_word_case(
        s, b, state, card, *((5000, 4) if state == "big" else (64, 3)))
    got = ck.word_shard_probe(hist, bt, lo, hi, floor, rmq="blocked")
    assert K.BLOCKED_PROBE_KERNELS["last"] == 2
    want = ck.word_shard_probe_plain(hist, bt, lo, hi, floor, "blocked")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# --- K13's packed paint and width-W fold over the live rows, K12's probe
# over a live table: against their plain twins, with their launch counts


def _cpu(tree):
    if tree is None or isinstance(tree, torch.Tensor):
        return None if tree is None else tree.cpu()
    return type(tree)(*(_cpu(x) for x in tree))


def _clone(st):
    return ck.ConflictState(*(x.clone() for x in st))


def packed_case(rng, st, b, q, kind, r=2):
    """(PackedBatch on st's device, accepted [B]): a sorted dictionary of
    history keys and new rows (+inf padded, the +inf row last), rank
    ranges (empty ones among them), the host's paint order; ``hist``:
    every write endpoint a history key, ``run``: every write on one pair
    of ranks (a run of equal rows past a tile), ``rejected``: every write
    rejected, ``full``: every write accepted, one rank wide, on keys not
    in the history (a full history then overflows)."""
    dev = st.keys.device
    w = st.keys.shape[1]
    live = int(st.n_used)
    hist = st.keys[:live].cpu().numpy()
    n = 2 * b * (r + q)
    more = rng.integers(-2**31 + 1, 2**31 - 1, (n, w),
                        dtype=np.int64).astype(np.int32)
    if w > 1:
        more[:, 0] = rng.integers(-3, 3, n)
    rows = np.concatenate([hist[rng.integers(0, live, n // 2)], more])
    if kind == "full":  # no history keys: each write adds boundaries
        rows = more
    rows = np.unique(rows[~(rows == ck.INT32_MAX).all(1)], axis=0)[:n]
    if kind == "hist":
        rows = np.unique(hist[~(hist == ck.INT32_MAX).all(1)], axis=0)[:n]
    u = len(rows)
    dict_keys = np.full((n + 1, w), ck.INT32_MAX, np.int32)
    dict_keys[:u] = rows

    def pairs(cols, lo=0, hi=4):
        a = rng.integers(0, u, (b, cols))
        z = np.minimum(a + rng.integers(lo, hi, (b, cols)), u)
        return a.astype(np.int32), z.astype(np.int32)

    rb, re_ = pairs(r)
    wb, we = pairs(q, *((1, 2) if kind == "full" else (0, 4)))
    if kind == "run":
        wb[:], we[:] = u // 2, min(u // 2 + 1, u)
    acc = rng.random(b) < {"rejected": 0.0, "full": 1.0}.get(kind, 0.7)
    paint = np.concatenate([wb.reshape(-1), we.reshape(-1)])
    ranks = ck.RankBatch(
        on(rb, dev), on(re_, dev), on(rng.random((b, r)) < 0.9, dev),
        on(wb, dev), on(we, dev), on(rng.random((b, q)) < 0.85, dev),
        on(rng.integers(0, 70, b).astype(np.int32), dev),
        on(rng.random(b) < 0.95, dev),
        on(np.argsort(paint, kind="stable").astype(np.int32), dev))
    return ck.PackedBatch(on(dict_keys, dev), ranks), on(acc, dev)


def poison_tail(st, rng):
    """A copy of ``st`` whose rows past n_used hold random keys and
    versions newer than any: a kernel that reads only the live rows gives
    the answer it gives on ``st``."""
    k, v = st.keys.clone(), st.versions.clone()
    n, (c, w) = int(st.n_used), st.keys.shape
    k[n:] = on(rng.integers(-2**31, 2**31 - 1, (c - n, w), dtype=np.int64)
               .astype(np.int32), st.keys.device)
    v[n:] = 1 << 30
    return ck.ConflictState(k, v, *(x.clone() for x in st[2:]))


K13_PAINT_CASES = ["random", "n_used_1", "full", "rejected", "hist", "run",
                   "expire_all", "q0"]


@pytest.mark.parametrize("case", K13_PAINT_CASES)
@pytest.mark.parametrize("w", [1, 4, 9])
def test_k13_packed_paint_live_tiles(card, case, w):
    """K13's packed paint (the new rows' gather, the sorted paint's tiles
    over the live rows, the finish; twice, on copies) against its tile
    twin and the plain paint: a history of one row, a full one whose
    survivors overflow, every write rejected, endpoints on history keys, a
    run of equal endpoints past a tile, a floor past every version, no
    write slots; three CUDA kernels a call (two with no write slots),
    counted at their launches."""
    from foundationdb_tpu_torch import kernels as K

    rng = np.random.default_rng(K13_PAINT_CASES.index(case) * 10 + w)
    c = 5000
    live = {"n_used_1": 1, "full": c}.get(case, 2000)
    st = live_word_state(rng, c, live, w, card)
    b, q = (700, 0) if case == "q0" else (700, 2)
    pb, acc = packed_case(rng, st, b, q, case)
    fl = 100 if case == "expire_all" else 10
    floor = torch.tensor(fl, dtype=torch.int32, device=card)
    rs = K.word_search(st.keys, pb.dict_keys, live0=st.n_used)[1]
    want = ck.packed_paint_tiles_plain(_cpu(st), pb.dict_keys.cpu(),
                                       _cpu(pb.ranks), acc.cpu(), 77, fl,
                                       rs.cpu())
    if q:  # the plain paint (``_paint_tail``) needs a new row
        plain = ck._paint_and_compact_packed(
            _cpu(st), pb.dict_keys.cpu(), _cpu(pb.ranks), acc.cpu(), 77, fl,
            rs.cpu(), plain=True)
        for f, g, x in zip(want._fields, plain, want):
            assert torch.equal(g, x), (case, f)
    for run in range(2):
        got = ck._paint_and_compact_packed(_clone(st), pb.dict_keys,
                                           pb.ranks, acc, 77, floor, rs)
        assert K.WORD_COMPACT_KERNELS["wc_paint"] == (3 if q else 2)
        for f, g, x in zip(want._fields, got, want):
            assert torch.equal(g.cpu(), x), (case, f, run)
    if case == "full":
        assert bool(want.overflow)


K13_FOLD_CASES = ["random", "equal_keys", "n_used_1", "full", "expire_all",
                  "all_inf"]


def fold_case(rng, case, w, card, c=5000, cd=700):
    live = {"n_used_1": 1, "full": c}.get(case, 2000)
    base = live_word_state(rng, c, live, w, card)
    if case == "all_inf":
        base = ck.ConflictState(torch.full_like(base.keys, ck.INT32_MAX),
                                torch.full_like(base.versions,
                                                ck.NEG_VERSION),
                                torch.ones_like(base.n_used), *base[3:])
    nd = 1 if case == "n_used_1" else 300
    delta = live_word_state(rng, cd, nd, w, card, vmax=90)
    if case == "equal_keys":  # delta rows on base keys
        k = delta.keys.clone()
        pick = np.sort(rng.choice(np.arange(1, live), nd - 1, replace=False))
        k[1:nd] = base.keys[on(pick, card)]
        delta = ck.ConflictState(k, *delta[1:])
    fl = {"expire_all": 100}.get(case, 20)
    return base, delta, fl


@pytest.mark.parametrize("case", K13_FOLD_CASES)
@pytest.mark.parametrize("w", [2, 4, 9])
def test_k13_word_fold_live_tiles(card, case, w):
    """K13's width-W fold over the live rows of base and delta: the
    forced fold with the reset (``advance_hist``'s) and the gated step
    (``_maybe_merge``: the decision, the tiles, the finish, then K2's
    gated table) with the fold needed and not needed, against the tile
    twin and the plain fold; when not needed no array changes. Two CUDA
    kernels a forced fold, three a gated step, counted at their
    launches. (A width-1 history folds with K4.)"""
    from foundationdb_tpu_torch import kernels as K

    rng = np.random.default_rng(K13_FOLD_CASES.index(case) * 10 + w)
    base, delta, fl = fold_case(rng, case, w, card)
    floor = torch.tensor(fl, dtype=torch.int32, device=card)
    hist = ck.HistState(base, ck.build_table(base.versions), delta)
    want = ck.word_fold_step_tiles_plain(_cpu(hist), None, floor.cpu())
    plain_b = ck._merge_delta_plain(_cpu(base), _cpu(delta), floor.cpu())
    for f, g, x in zip(plain_b._fields, plain_b, want.base):
        assert torch.equal(g, x), (case, f)
    for run in range(2):
        b2, d2 = _clone(base), _clone(delta)
        K.word_fold(b2, d2, floor, None, reset_delta=True)
        assert K.WORD_COMPACT_KERNELS["wc_fold"] == 2
        for g, x in zip((*b2, *d2), (*want.base, *want.delta)):
            assert torch.equal(g.cpu(), x), (case, run)
    needs = set()
    # Not needed (a floor that expires few base rows, room for the
    # demand), then needed (a demand past the delta's room).
    for demand, f in ((0, 0), (delta.keys.shape[0], fl)):
        f = torch.tensor(f, dtype=torch.int32, device=card)
        need = bool(ck.fold_need_plain(hist, demand, f))
        needs.add(need)
        want = ck.word_fold_step_tiles_plain(_cpu(hist), demand, f.cpu())
        got = ck._maybe_merge(ck.HistState(_clone(base), hist.base_st.clone(),
                                           _clone(delta)), demand, f)
        assert K.WORD_COMPACT_KERNELS["wc_fold_step"] == 3
        for g, x in zip(_hist_leaves(got), _hist_leaves(want)):
            assert torch.equal(g.cpu(), x), (case, demand)
        if not need:
            for g, x in zip(_hist_leaves(got), _hist_leaves(hist)):
                assert torch.equal(g, x), (case, demand)
    assert needs == {False, True}, needs


@pytest.mark.parametrize("w", [2, 4, 9])
def test_k13_word_compact_tiles(card, w):
    """K13's compaction (the tiles' compaction mode and the finish) against
    its tile twin and the plain compaction on the sorted rows of two
    histories (runs, +inf rows), at a capacity that overflows and one that
    does not: two CUDA kernels a call."""
    from foundationdb_tpu_torch import kernels as K

    rng = np.random.default_rng(w)
    base, delta, _ = fold_case(rng, "equal_keys", w, card, c=3000, cd=500)
    rows = torch.cat([base.keys, delta.keys])
    skeys = rows[on(np.lexsort(rows.cpu().numpy().T[::-1]), card)].contiguous()
    newv = on(rng.integers(0, 4, skeys.shape[0]).astype(np.int32), card)
    for c_out in (5, 3000):
        for prior in (False, True):
            pr = torch.tensor(prior, device=card)
            want = ck.word_compact_tiles_plain(skeys.cpu(), newv.cpu(), c_out,
                                               pr.cpu())
            for g, x in zip(ck._dedup_compact_plain(skeys.cpu(), newv.cpu(),
                                                    c_out, pr.cpu()), want):
                assert torch.equal(g, x)
            got = ck._dedup_compact(skeys, newv, c_out, pr)
            assert K.WORD_COMPACT_KERNELS["wc_compact"] == 2
            for g, x in zip(got, want):
                assert torch.equal(g.cpu(), x), (c_out, prior)


K12_PROBE_CASES = ["random", "n_used_1", "full", "hist", "flat_2_20"]


@pytest.mark.parametrize("case", K12_PROBE_CASES)
@pytest.mark.parametrize("w", [1, 4, 9])
def test_k12_probe_over_live_table(card, case, w):
    """K12's probe (a range-max table over the per-batch level's live rows,
    then the level probe by rank) against its twin and the plain probe:
    two levels (the base with its K2 table) and one flat level, a level
    of one row, a full one, slots on history keys, and a flat history of
    C = 2^20 with 20,000 live rows at the main path's batch (B = 8192, R
    = 2): two CUDA kernels a call, counted at their launches."""
    from foundationdb_tpu_torch import kernels as K

    rng = np.random.default_rng(K12_PROBE_CASES.index(case) * 10 + w)
    big = case == "flat_2_20"
    c, b = (1 << 20, 8192) if big else (5000, 700)
    live = {"n_used_1": 1, "full": c}.get(case, 20000 if big else 2000)
    base = live_word_state(rng, c, live, w, card, vmax=90)
    delta = live_word_state(rng, 700, 1 if case == "n_used_1" else 300, w,
                            card, vmax=90)
    pb, _ = packed_case(rng, base, b, 1, case)
    floor = torch.tensor(12, dtype=torch.int32, device=card)
    ranks = pb.ranks
    levels = [("flat", None, base)]
    if not big:
        levels.append(("two-level", ck.build_table(base.versions), delta))
    for label, base_st, lvl in levels:
        if base_st is None:
            s = ck.dict_history_search(lvl.keys, pb.dict_keys,
                                       live_b=lvl.n_used)
        else:
            s = ck.dict_history_search(base.keys, pb.dict_keys, lvl.keys,
                                       live_b=base.n_used, live_d=lvl.n_used)
        got = ck.packed_probe(ranks, floor, s, base_st, lvl.versions,
                              lvl.n_used)
        assert K.WORD_PROBE_KERNELS["last"] == 2
        want = ck.level_probe_live_plain(
            _cpu(ranks), floor.cpu(), _cpu(s),
            None if base_st is None else base_st.cpu(), lvl.versions.cpu(),
            lvl.n_used.cpu())
        plain = ck.packed_probe(ranks, floor, s, base_st, lvl.versions,
                                lvl.n_used, plain=True)
        for g, x, y in zip(got, want, plain):
            assert torch.equal(g.cpu(), x), (case, label)
            assert torch.equal(y.cpu(), x), (case, label)


def test_k12_k13_read_only_live_rows(card):
    """The paint, the fold and the probe read no row past a level's
    n_used: with those rows poisoned (random keys, versions newer than
    any) each gives its answer on the clean level, and the paint and the
    fold leave the poisoned rows past the old n_used as they were."""
    from foundationdb_tpu_torch import kernels as K

    rng = np.random.default_rng(17)
    c, w = 1 << 18, 4
    st = live_word_state(rng, c, 3000, w, card)
    pb, acc = packed_case(rng, st, 1000, 2, "random")
    floor = torch.tensor(10, dtype=torch.int32, device=card)
    rs = K.word_search(st.keys, pb.dict_keys, live0=st.n_used)[1]
    clean = ck._paint_and_compact_packed(_clone(st), pb.dict_keys, pb.ranks,
                                         acc, 77, floor, rs)
    dirty = poison_tail(st, rng)
    tail = dirty.keys[3000:].clone(), dirty.versions[3000:].clone()
    got = ck._paint_and_compact_packed(dirty, pb.dict_keys, pb.ranks, acc,
                                       77, floor, rs)
    n = max(int(clean.n_used), 3000)  # rows the paint may write
    assert int(got.n_used) == int(clean.n_used)
    assert torch.equal(got.keys[:n], clean.keys[:n])
    assert torch.equal(got.versions[:n], clean.versions[:n])
    assert torch.equal(got.keys[n:], tail[0][n - 3000:])
    assert torch.equal(got.versions[n:], tail[1][n - 3000:])
    # The fold: a poisoned base and delta.
    base, delta, fl = fold_case(rng, "random", w, card, c=c, cd=4096)
    floor = torch.tensor(fl, dtype=torch.int32, device=card)
    b_clean, d_clean = _clone(base), _clone(delta)
    K.word_fold(b_clean, d_clean, floor, None, reset_delta=True)
    b_dirty, d_dirty = poison_tail(base, rng), poison_tail(delta, rng)
    nb, nd = int(base.n_used), int(delta.n_used)
    b_tail, d_tail = b_dirty.keys[nb:].clone(), d_dirty.keys[nd:].clone()
    K.word_fold(b_dirty, d_dirty, floor, None, reset_delta=True)
    assert int(b_dirty.n_used) == int(b_clean.n_used)
    m = max(int(b_clean.n_used), nb)
    assert torch.equal(b_dirty.keys[:m], b_clean.keys[:m])
    assert torch.equal(b_dirty.versions[:m], b_clean.versions[:m])
    assert torch.equal(b_dirty.keys[m:], b_tail[m - nb:])
    assert torch.equal(d_dirty.keys[:nd], d_clean.keys[:nd])
    assert torch.equal(d_dirty.keys[nd:], d_tail)
    # The probe: a poisoned flat level (searched over its live rows).
    lvl = live_word_state(rng, c, 3000, w, card, vmax=90)
    pb, _ = packed_case(rng, lvl, 2000, 1, "random")
    s = ck.dict_history_search(lvl.keys, pb.dict_keys, live_b=lvl.n_used)
    want = ck.packed_probe(pb.ranks, floor, s, None, lvl.versions, lvl.n_used)
    got = ck.packed_probe(pb.ranks, floor, s, None,
                          poison_tail(lvl, rng).versions, lvl.n_used)
    for g, x in zip(got, want):
        assert torch.equal(g, x)


def test_k12_k13_launch_counts(card):
    """By the profiler, at most: three CUDA kernels a packed paint, three a
    gated fold step whose fold is not needed, two a forced fold, two a
    probe with its table (C = 2^20, the main path's batch)."""
    from foundationdb_tpu_torch import kernels as K

    rng = np.random.default_rng(5)
    st = live_word_state(rng, 16386, 3000, 4, card)
    pb, acc = packed_case(rng, st, 8192, 1, "random")
    floor = torch.tensor(10, dtype=torch.int32, device=card)
    rs = K.word_search(st.keys, pb.dict_keys, live0=st.n_used)[1]
    paint = _cuda_kernels(
        lambda d: ck._paint_and_compact_packed(d, pb.dict_keys, pb.ranks,
                                               acc, 77, floor, rs),
        lambda: (_clone(st),))
    base = live_word_state(rng, 1 << 20, 20000, 4, card)
    delta = live_word_state(rng, 16386, 3000, 4, card)
    need = torch.empty((), dtype=torch.bool, device=card)
    step = _cuda_kernels(
        lambda: K.word_fold(base, delta, floor, need, reset_delta=True,
                            demand=0), lambda: ())
    assert not bool(need)
    forced = _cuda_kernels(
        lambda b, d: K.word_fold(b, d, floor, None, reset_delta=True),
        lambda: (_clone(base), _clone(delta)))
    s = ck.dict_history_search(base.keys, pb.dict_keys, live_b=base.n_used)
    probe = _cuda_kernels(
        lambda: ck.packed_probe(pb.ranks, floor, s, None, base.versions,
                                base.n_used), lambda: ())
    assert paint <= 3 and step <= 3 and forced <= 2 and probe <= 2, (
        paint, step, forced, probe)


def test_commit_path_on_the_card_equals_cpu_and_oracle(card):
    """Run (a) of chip_smoke.py's phase 3m at 2^12 keys and 2,048 commits:
    one generation of the commit path on one loop over the card engine
    (the storage servers' read plane on the card) gives the outcomes,
    reads, roles' metrics and engine leaves of the same run over the plain
    versions on the CPU, and the outcomes of the run over the oracle;
    every acknowledged write reads back; K1-K4 and K12 launch."""
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch import server
    from foundationdb_tpu_torch.sim.commit_path import CommitPath
    from foundationdb_tpu_torch.sim.oracle import IndexedOracleConflictSet

    def run(engine, device):
        cp = CommitPath([engine], seed=5, storage_kw={"device": device})
        K.reset_launches()
        s = cp.run_ycsb(2048, 128, 12, seed=5)
        v = cp.settle()
        final = cp.replay()
        assert cp.read_back(v, sorted(final)) == final and final
        return cp, s, dict(K.LAUNCHES)

    gpu, s, launches = run(server.make_conflict_set("torch",
                                                    wave_commit=False),
                           None)
    assert all(launches[k] > 0 for k in ("dict_insert", "history_probe",
                                         "accept", "step_compact",
                                         "word_probe")), launches
    cpu, s_cpu, _ = run(server.make_conflict_set("torch", wave_commit=False,
                                                 device="cpu"), "cpu")
    orc, s_orc, _ = run(IndexedOracleConflictSet(), "cpu")
    for k in ("commit_outcomes_sha256", "reads_sha256"):
        assert s[k] == s_cpu[k] == s_orc[k], k
    assert s["other"] == 0 and s["committed"] and s["conflict"]
    assert gpu.metrics() == cpu.metrics()
    m = gpu.metrics()["resolvers"][0]
    assert m["txns_rejected_fail_safe"] == 0 and not gpu.engines[0].overflowed
    want = convert.snapshot(cpu.engines[0])["state"]
    for k, v in convert.snapshot(gpu.engines[0])["state"].items():
        assert v.tobytes() == want[k].tobytes(), k


def test_cluster_on_the_card_equals_cpu_and_oracle(card):
    """Run (a) of chip_smoke.py's phase 3n at 2^12 keys, 2,048
    transactions and one kill: one simulated cluster (coordinators, the
    controller, two tlogs, two storage servers in one team) with its
    engines and read plane on the card, the resolver killed halfway, gives
    the outcomes (every attempt's error code, the epochs and recovery
    versions) of the same run on the CPU and over the oracle; every
    acknowledged write reads back through tr.get_multi; K1-K4 and K12
    launch in both generations."""
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.client.ryw import open_database
    from foundationdb_tpu_torch.sim.cluster import SimCluster
    from foundationdb_tpu_torch.sim.cluster_load import ClusterLoad

    def run(engine, device):
        c = SimCluster(seed=5, engine=engine, device=device, n_storages=2,
                       n_replicas=2, n_tlogs=2, n_coordinators=3)
        load = ClusterLoad(c, open_database(c), kills={1024: "resolver0"})
        launches = []
        recruit = c.recruit_generation

        def recruit_and_count(**kw):
            launches.append(dict(K.LAUNCHES, **K.ENTRY_LAUNCHES))
            K.reset_launches()
            return recruit(**kw)

        c.recruit_generation = recruit_and_count
        K.reset_launches()
        s = load.run_ycsb(2048, 128, 12, seed=5)
        launches.append(dict(K.LAUNCHES, **K.ENTRY_LAUNCHES))
        final = load.replay()
        assert load.read_back(sorted(final)) == final and final
        assert all(r.cs.overflowed is False for r in c.resolvers
                   if hasattr(r.cs, "overflowed"))
        return s, launches

    s, launches = run("torch", None)
    assert s["epochs"] == [1, 2] and s["failed"] == 0 and s["conflicts"]
    for gen in launches:
        assert all(gen[k] > 0 for k in ("dict_insert", "history_probe",
                                        "accept", "step_compact",
                                        "wp_search")), gen
    s_cpu, _ = run("torch", "cpu")
    s_orc, _ = run("oracle", "cpu")
    assert s["cluster_outcomes_sha256"] == s_cpu["cluster_outcomes_sha256"] \
        == s_orc["cluster_outcomes_sha256"]


def test_spec_runs_on_the_card_equal_cpu_and_oracle(card):
    """A small phase 3o of chip_smoke.py: Cycle.toml through the port's
    ``sim.run.run_one`` and run (b)'s spec at a tenth of its sizes (four
    workloads under kills, partitions, clogs and BUGGIFY on 2 resolvers),
    each with every engine and read plane on the card, give the
    ``spec_outcomes_sha256`` of the same runs over the plain versions on
    the CPU and over the oracle given the engine's ranges; each passes the
    smoke's checks (every workload's own check, no transaction given up,
    no fail-safe, K1-K4 in every generation that resolved a transaction),
    and (b) launches K12 and kills at least once."""
    import chip_smoke as smoke

    for run, kw in (("a", {"files": ["Cycle.toml"]}), ("b", {"div": 10})):
        got = {e: smoke.specs_run(run, e, 5, **kw)
               for e in ("cuda", "cpu", "oracle")}
        smoke.check_spec_run(run, got["cuda"])
        shas = {e: r["spec_outcomes_sha256"] for e, r in got.items()}
        assert len(set(shas.values())) == 1, shas
        if run == "b":
            assert got["cuda"]["launches"].get("wp_search", 0) > 0
            assert got["cuda"]["tests"][0]["recoveries"]
