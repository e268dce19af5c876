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
    got = ck._dict_evict(on(rows, card), n_keys, on(ev, card), n_ev)
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


@pytest.mark.parametrize("b,s,empty", [(30, 1, False), (33, 4, False),
                                       (64, 4, True), (1000, 3, True)])
def test_shard_probe(card, b, s, empty):
    """K8 (with K2's table over the S histories) against its plain
    version: odd B (the psum branch), S = 1, an empty shard (lo == hi:
    every clipped read is empty), and reads ending at the last shard's
    INT32_MAX bound."""
    res = sharded_history(s, 64, card, seed=b)
    rng = np.random.default_rng(b)
    n_keys = int(res.n_keys)
    rbk = rank_batch(rng, b, 2, 1, n_keys, card)
    lo, hi = res.shard_lo.clone(), res.shard_hi.clone()
    if empty:
        hi[1] = lo[1]
    floor = torch.tensor(3, dtype=torch.int32, device=card)
    got = ck.shard_probe(res.hist, rbk, lo, hi, floor)
    want = ck.shard_probe_plain(res.hist, rbk, lo, hi, floor)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(want[1].any())


@pytest.mark.parametrize("s,bp,empty", [(1, 32, False), (3, 64, True),
                                        (4, 1024, True)])
def test_wave_exchange(card, s, bp, empty):
    """K10 against its plain version: S = 1, odd shard counts, and a shard
    whose matrix is all zero (no occupied tile)."""
    rng = np.random.default_rng(s * bp)
    ps = rng.integers(0, 2**32, (s, bp, bp // 32), dtype=np.uint64).astype(
        np.uint32)
    ps[:, rng.random(bp) < 0.5] = 0  # whole rows empty: empty tiles too
    ps[:, :32] = 0
    if empty:
        ps[1] = 0
    t = on(ps.view(np.int32), card)
    got = ck.wave_exchange(t)
    want = ck.wave_exchange_plain(t)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


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
    word and the smoke's 2^20 bits."""
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
    for dv in (delta.versions, None):
        s = got if dv is not None else ck.dict_history_search(base.keys,
                                                              pb.dict_keys)
        for g, x in zip(ck.packed_probe(pb.ranks, floor, s, st, dv),
                        ck.packed_probe(pb.ranks, floor, s, st, dv,
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


@pytest.mark.parametrize("b,s,clip", [(30, 1, False), (36, 4, True),
                                      (63, 3, True), (1000, 1, False)])
def test_word_shard_probe(card, b, s, clip):
    """K16 (with K2's table over the S histories) against its plain
    version, clipped to the shards or (S = 1) unclipped; odd B."""
    cs, hist = nr_sharded(s, 64, card, seed=b, batch=b)
    rng = np.random.default_rng(b)
    bt, _ = cs._pack([rand_txn(rng, 120) for _ in range(b)])
    big = ck.BatchTensors(*(on(x, card) for x in bt))
    lo = on(cs._lo, card) if clip else None
    hi = on(cs._hi, card) if clip else None
    floor = torch.tensor(103, dtype=torch.int32, device=card)
    got = ck.word_shard_probe(hist, big, lo, hi, floor)
    want = ck.word_shard_probe_plain(hist, big, lo, hi, floor)
    for g, x in zip(got, want):
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
    the S·C versions, then the clip, rank search and blocked range max at
    the shard's offset) against its plain version: odd B, C not a
    multiple of the 256-row block (blocks straddle shards), an empty
    shard, reads ending at the INT32_MAX bound. K2 builds only the top
    table (never an S·C sparse table) and K8 does not launch."""
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
    assert e.get("rb_build") == 1 and e.get("rb_shard_probe") == 1, e
    assert e.get("hp_table", 0) <= 1 and "sh_probe" not in e, e
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
    verdicts, levels, every leaf; a blocked arm launches K17's build and
    sharded probe once a step and never K8 or K16."""
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
                    assert e.get("rb_build") == 1, e
                    assert e.get("rb_shard_probe") == 1, e
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
    """K12 at the shapes of its callers, one CUDA kernel a call: the
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
        assert _cuda_kernels(lambda: K.word_search(*args), lambda: ()) == 1


@pytest.mark.parametrize("kind", ["random", "b_not_32", "no_live_write",
                                  "wide", "dense", "empty_live", "noncand",
                                  "big"])
def test_k5_tiles_adversarial(card, kind):
    """K5 against its plain version and its tile twin on B not a multiple
    of 32, rows with no live write, R wide enough to shrink the tile,
    every interval equal, live empty intervals, few candidates and the
    smoke's B = 8192; one CUDA kernel a call."""
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
    assert _cuda_kernels(lambda: K.wave_pred(cc, *rc), lambda: ()) == 1
