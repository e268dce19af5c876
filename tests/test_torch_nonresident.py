"""The port's packed non-resident engine vs the JAX package's, on the CPU.

Exact everywhere. The W-word two-sided search equals JAX
``searchsorted_words_2sided_fp`` on shared-prefix and random rows; the
port's ``_pack_dict`` (and the fused ``kp_pack_window``) equals JAX
``_pack_dict`` leaf for leaf; every B4 function's plain version (the
dictionary search, the hist probe, the too-old mask, the paint, the
W-word fold, ``advance_hist``, rebase, ``resolve_batch_hist_packed`` with
its report, ``resolve_many_hist_packed``, the paint-only window and the
speculation scratch probe) equals its JAX line on states captured from a
JAX ``TPUConflictSet(resident=False)``; and ``TorchConflictSet(
resident=False)`` equals that engine and ``sim/oracle`` on the object,
report, wire and window paths, the wave and two-phase paths, and
speculation with a revoking hook, in verdicts, ``last_conflicting``,
levels, ``spec_metrics`` and every state leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.core import wavemesh as jwm
from foundationdb_tpu.core.types import KeyRange, TxnConflictInfo
from foundationdb_tpu.models import conflict_kernel as jck
from foundationdb_tpu.models.conflict_set import TPUConflictSet
from foundationdb_tpu.models.conflict_set import encode_resolve_batch as jenc
from foundationdb_tpu.ops.lex import searchsorted_words_2sided_fp as j2s
from foundationdb_tpu.sched.packing import PipelinedWindowRunner as JRunner
from foundationdb_tpu.sim.oracle import OracleConflictSet
from foundationdb_tpu_torch import TorchConflictSet, convert, native
from foundationdb_tpu_torch.core import wavemesh
from foundationdb_tpu_torch.models import conflict_kernel as tck
from foundationdb_tpu_torch.models.conflict_set import (
    encode_resolve_batch as tenc,
    upload,
)
from foundationdb_tpu_torch.ops.lex import searchsorted_words_2sided_fp
from foundationdb_tpu_torch.sched.packing import PipelinedWindowRunner
from tests.test_conflict_oracle import rand_txn
from tests.test_spec_resolve import COUNT, NWIN, _adversary, _windows
from tests.test_torch_conflict_kernel import T, same, same_state, t_hist
from tests.test_torch_conflict_set import port_txn, ranges
from tests.test_torch_window import make_windows, oracle_window

torch.set_num_threads(1)

# The JAX lines under test, jitted (one compile per shape, not per op).
J = {name: jax.jit(getattr(jck, name)) for name in (
    "_dict_history_search", "_paint_and_compact_packed", "_merge_delta",
    "_maybe_merge", "advance_hist", "_history_conflict_ranges_packed")}
J["hist_ranges"] = jax.jit(jck._history_conflict_ranges_hist_packed)

KW = dict(capacity=96, batch_size=24, max_read_ranges=3, max_write_ranges=2,
          max_key_bytes=8, window_versions=300)


def same_hist(port, jax, what=""):
    for k, v in convert.state_leaves(jax).items():
        same(convert.state_leaves(port)[k], v, f"{what}: {k}")


def jax_snapshot(cs: TPUConflictSet) -> dict:
    """The convert.py snapshot of a JAX non-resident engine."""
    return {
        "config": {f: getattr(cs, f, 0) for f in convert.CONFIG_FIELDS}
        | {"max_key_bytes": cs.codec.max_key_bytes, "spec_resolve": cs.spec},
        "state": {k: np.array(v) for k, v in
                  convert.state_leaves(cs.state).items()},
        "base_version": cs.base_version,
        "oldest_version": cs.oldest_version,
        "last_commit": cs._last_commit,
    }


class Trio:
    """JAX, port and oracle non-resident engines in lockstep."""

    def __init__(self, **kw):
        cfg = dict(KW, **kw)
        self.wv = cfg["window_versions"]
        self.jax = TPUConflictSet(resident=False, **cfg)
        self.port = TorchConflictSet(device="cpu", resident=False, **cfg)
        self.oracle = OracleConflictSet()

    def resolve(self, txns, cv, oldest=None, what=""):
        want = [int(v) for v in self.jax.resolve(txns, cv, oldest)]
        got = [int(v) for v in self.port.resolve([port_txn(t) for t in txns],
                                                 cv, oldest)]
        self.oracle.oldest_version = max(self.oracle.oldest_version,
                                         cv - self.wv, oldest or 0)
        assert got == want, f"{what}: port vs jax"
        if not self.port.wave_commit:  # the oracle is sequential order
            assert got == [int(v) for v in self.oracle.resolve(txns, cv)], \
                what
        assert ranges(self.port.last_conflicting) == \
            ranges(self.jax.last_conflicting), what
        if self.port.wave_commit:
            assert self.port.last_wave == self.jax.last_wave, what
        same_hist(self.port.state, self.jax.state, what)
        return got


# --------------------------------------------------------- search, pack


def shared_prefix_rows(rng, n, w, distinct):
    rows = np.zeros((n, w), np.int32)
    rows[:, : w - 1] = rng.integers(-2, 2, (1, w - 1))
    rows[:, w - 1] = rng.integers(-distinct, distinct, n)
    rows[rng.random(n) < 0.1] = tck.INT32_MAX
    return rows


@pytest.mark.parametrize("w,kind", [(1, "random"), (3, "random"),
                                    (4, "shared"), (9, "shared"),
                                    (5, "random")])
def test_searchsorted_2sided_equals_jax(w, kind):
    rng = np.random.default_rng(w)
    if kind == "shared":
        keys, q = (shared_prefix_rows(rng, n, w, 6) for n in (70, 40))
    else:
        keys = rng.integers(-3, 3, (70, w)).astype(np.int32)
        q = rng.integers(-3, 3, (40, w)).astype(np.int32)
    keys = keys[np.lexsort(keys.T[::-1])]
    for sk in (keys, keys[:1], keys[:0]):
        got = searchsorted_words_2sided_fp(T(sk), T(q))
        want = j2s(jnp.asarray(sk), jnp.asarray(q))
        for g, x in zip(got, want):
            same(g, x, f"w={w} n={len(sk)}")


def make_txns(rng, n, cv):
    return [rand_txn(rng, read_version=cv - int(rng.integers(1, 120)))
            for _ in range(n)]


@pytest.mark.parametrize("k", [None, 3])
def test_pack_dict_equals_jax(k):
    """Per batch (and per step of a [k]-leading window) the dictionary and
    every rank leaf; the paint order sorts the write ranks."""
    rng = np.random.default_rng(4)
    jcs = TPUConflictSet(resident=False, **KW)
    tcs = TorchConflictSet(device="cpu", resident=False, **KW)
    jcs.base_version = tcs.base_version = 900
    steps = [make_txns(rng, int(rng.integers(1, 24)), 1000)
             for _ in range(k or 1)]
    jb = [jcs._pack(s) for s in steps]
    tb = [tcs._pack([port_txn(t) for t in s])[0] for s in steps]
    if k is None:
        want, hb = jcs._pack_dict(jb[0]), tcs._pack_dict(tb[0])
    else:
        want = jcs._pack_dict(jck.BatchTensors(*(np.stack(x)
                                                  for x in zip(*jb))))
        hb = tcs._pack_dict(type(tb[0])(*(np.stack(x) for x in zip(*tb))))
    same(hb.delta_keys, want.dict_keys, "dict_keys")
    for f in ("read_begin", "read_end", "read_mask", "write_begin",
              "write_end", "write_mask", "read_version", "txn_mask"):
        same(hb.ranks[tck.RankBatch._fields.index(f)], getattr(want, f), f)
    lead = () if k is None else (k,)
    wb, we, src = hb.ranks[3], hb.ranks[4], hb.ranks[8]
    paint = np.concatenate([wb.reshape(*lead, -1), we.reshape(*lead, -1)],
                           -1)
    assert (np.diff(np.take_along_axis(paint, src, -1), axis=-1) >= 0).all()


def test_kp_pack_window_equals_pack_dict():
    rng = np.random.default_rng(8)
    tcs = TorchConflictSet(device="cpu", resident=False, **KW)
    tcs.base_version = 900
    k, count = 3, 20
    txns = [port_txn(t) for t in make_txns(rng, k * count, 1000)]
    buf = np.frombuffer(tenc(txns), np.uint8)
    bt = tcs._empty_batch(k)
    got = tcs._pack_window_native(buf, bt, count)
    ref = tcs._empty_batch(k)
    off = 0
    for i in range(k):
        off = native.pack_batch(buf, off, count, tcs.codec.n_words, 900,
                                type(ref)(*(a[i] for a in ref)))
    want = tcs._pack_dict(ref)
    for a, b in zip((got.delta_keys, *got.ranks),
                    (want.delta_keys, *want.ranks)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert got.demand == want.demand and got.n_new == want.n_new == 0


# ------------------------------------------------------ B4 plain functions


@pytest.fixture(scope="module")
def captured():
    """[(jax hist before, jax PackedBatch, port PackedBatch, cv, oldest)]
    over a JAX non-resident stream with folds (a tiny delta)."""
    rng = np.random.default_rng(6)
    kw = dict(KW, delta_capacity=26)
    jcs = TPUConflictSet(resident=False, **kw)
    tcs = TorchConflictSet(device="cpu", resident=False, **kw)
    out, cv = [], 1000
    for i in range(6):
        cv += int(rng.integers(5, 40))
        txns = make_txns(rng, int(rng.integers(8, 24)), cv)
        for t in txns[::4]:
            t.report_conflicting_keys = True
        jcs._begin_resolve(cv, cv - 150)
        tcs.base_version = jcs.base_version
        pb = jcs._pack_dict(jcs._pack(txns))
        hb = tcs._pack_dict(tcs._pack([port_txn(t) for t in txns])[0])
        before = jax_tree(jcs.state)
        cvr, oldr = cv - jcs.base_version, jcs.oldest_version \
            - jcs.base_version
        jcs.state = jck._resolve_hist_packed_jit(
            jcs.state, pb, jnp.int32(cvr), jnp.int32(oldr))[-1]
        out.append((before, pb, upload(hb, torch.device("cpu"), packed=True),
                    hb, cvr, oldr))
    return out


def jax_tree(h):
    return jax.tree.map(lambda x: jnp.array(x, copy=True), h)


def test_dict_search_probe_and_too_old(captured):
    for i, (jh, pb, tpb, _hb, _cv, old) in enumerate(captured):
        rs_b, ls_b = J["_dict_history_search"](jh.base.keys, pb.dict_keys)
        rs_d, ls_d = J["_dict_history_search"](jh.delta.keys, pb.dict_keys)
        s = tck.dict_history_search(T(jh.base.keys), tpb.dict_keys,
                                    T(jh.delta.keys))
        for g, w in zip(s, (ls_b, rs_b, ls_d, rs_d)):
            same(g, w, f"step {i}: search")
        jfloor, jto = jck.too_old_mask_packed(jh.delta, pb, jnp.int32(old))
        floor, to = tck.too_old_mask_packed(t_hist(jh).delta, tpb.ranks, old)
        same(floor, jfloor)
        same(to, jto)
        want = J["hist_ranges"](jh.base, jh.base_st, jh.delta, pb, rs_b, ls_b,
                                rs_d, ls_d)
        got = tck._history_conflict_ranges_hist_packed(
            T(jh.base_st), T(jh.delta.versions), tpb.ranks, s)
        same(got, want, f"step {i}: hist mask")
        to2, hm, cand = tck.packed_probe(tpb.ranks, floor, s, T(jh.base_st),
                                         T(jh.delta.versions),
                                         T(jh.delta.n_used))
        same(hm, want)
        same(to2, jto)
        same(cand, np.asarray(pb.txn_mask & ~jto & ~want.any(1)))
        flat = J["_history_conflict_ranges_packed"](jh.base, pb)
        sb = tck.dict_history_search(T(jh.base.keys), tpb.dict_keys)
        same(tck._history_conflict_ranges_hist_packed(
            tck.sparse_table(T(jh.base.versions)), None, tpb.ranks, sb), flat)


def test_paint_fold_advance_rebase(captured):
    rng = np.random.default_rng(2)
    for i, (jh, pb, tpb, _hb, cv, old) in enumerate(captured):
        acc = rng.random(pb.txn_mask.shape[0]) < 0.7
        floor = jnp.maximum(jh.delta.oldest, jnp.int32(old))
        want = J["_paint_and_compact_packed"](jh.delta, pb, jnp.asarray(acc),
                                              jnp.int32(cv), floor)
        got = tck._paint_and_compact_packed(
            t_hist(jh).delta, tpb.dict_keys, tpb.ranks, T(acc), cv, T(floor))
        same_state(got, want, f"step {i}: paint")
        same_state(tck._merge_delta_plain(t_hist(jh).base, t_hist(jh).delta,
                                          T(floor)),
                   J["_merge_delta"](jh.base, jh.delta, floor), "merge")
        for demand in (0, 40):
            same_hist(tck._maybe_merge_plain(t_hist(jh), demand, T(floor)),
                      J["_maybe_merge"](jh, jnp.int32(demand), floor),
                      f"step {i}: maybe_merge {demand}")
    jh = captured[-1][0]
    same_hist(tck.advance_hist(t_hist(jh), 2000, 1500),
              J["advance_hist"](jh, jnp.int32(2000), jnp.int32(1500)))
    same_hist(tck.rebase_res(t_hist(jh), 700),
              jck._rebase_hist_jit(jax_tree(jh), jnp.int32(700)))


@pytest.mark.parametrize("wave", [False, True])
def test_resolve_batch_and_window_equal_jax(captured, wave):
    for i, (jh, pb, tpb, hb, cv, old) in enumerate(captured):
        fn = (jck._resolve_report_hist_packed_wave_jit if wave
              else jck._resolve_report_hist_packed_jit)
        want = fn(jax_tree(jh), pb, jnp.int32(cv), jnp.int32(old))
        got = tck.resolve_batch_hist_packed(t_hist(jh), tpb, cv, old,
                                            report=True, demand=hb.demand,
                                            wave=wave)
        for g, w in zip(got[:-1], want[:-1]):
            same(g, w, f"step {i}")
        same_hist(got[-1], want[-1], f"step {i}")
    # A window of the first three captured batches from the first state.
    jh = captured[0][0]
    pbs = jck.PackedBatch(*(np.stack([np.asarray(getattr(c[1], f))
                                      for c in captured[:3]])
                            for f in jck.PackedBatch._fields))
    tpbs = tck.PackedBatch(torch.stack([c[2].dict_keys for c in captured[:3]]),
                           tck.RankBatch(*(torch.stack(x) for x in zip(
                               *[c[2].ranks for c in captured[:3]]))))
    cvs = np.asarray([c[4] for c in captured[:3]], np.int32)
    olds = np.asarray([c[5] for c in captured[:3]], np.int32)
    fn = (jck._resolve_many_hist_packed_wave_jit if wave
          else jck._resolve_many_hist_packed_jit)
    want = fn(jax_tree(jh), pbs, jnp.asarray(cvs), jnp.asarray(olds))
    got = tck.resolve_many_hist_packed(t_hist(jh), tpbs, cvs, olds,
                                       wave=wave)
    for g, w in zip(got[:-1], want[:-1]):
        same(g, w, "window")
    same_hist(got[-1], want[-1], "window")
    acc = np.random.default_rng(3).random((3, tpbs.ranks.txn_mask.shape[1])) \
        < 0.6
    same_hist(tck.paint_many_hist_packed(t_hist(jh), tpbs, T(acc), cvs, olds),
              jck._paint_many_hist_packed_jit(
                  jax_tree(jh), pbs, jnp.asarray(acc), jnp.asarray(cvs),
                  jnp.asarray(olds)),
              "paint_many")


def test_spec_scratch_probe_equals_jax(captured):
    pbs = [jck.PackedBatch(*(np.stack([np.asarray(getattr(c[1], f))
                                       for c in captured[j:j + 2]])
                             for f in jck.PackedBatch._fields))
           for j in (0, 2, 4)]
    tpbs = [tck.PackedBatch(
        torch.stack([c[2].dict_keys for c in captured[j:j + 2]]),
        tck.RankBatch(*(torch.stack(x) for x in zip(
            *[c[2].ranks for c in captured[j:j + 2]])))) for j in (0, 2, 4)]
    b = pbs[0].txn_mask.shape[1]
    rej = np.zeros((2, b), bool)
    rej[0, :3] = True
    scratch_j = jck.init_state(64, 3, captured[0][1].dict_keys[0])
    scratch_t = tck.init_state(64, 3, T(captured[0][1].dict_keys[0]), "cpu")
    same_state(scratch_t, scratch_j)
    scratch_j = jck._spec_mark_rejected_jit(scratch_j, pbs[0],
                                            jnp.asarray(rej))
    scratch_t = tck.spec_mark_rejected(scratch_t, tpbs[0], T(rej))
    same_state(scratch_t, scratch_j, "scratch")
    for pj, pt in zip(pbs, tpbs):
        assert bool(tck.spec_dep_window(scratch_t, pt)) == bool(
            jck._spec_dep_window_jit(scratch_j, pj))


# ------------------------------------------------------------- the engine


def pt(k: bytes) -> KeyRange:
    return KeyRange(k, k + b"\x00")


@pytest.mark.parametrize("wave", [False, True])
def test_object_path_equals_jax_and_oracle(wave):
    """Reports, chunked batches, folds (a tiny delta), advances (GC-only
    dispatches) and headroom."""
    rng = np.random.default_rng(10 + wave)
    trio = Trio(wave_commit=wave, delta_capacity=30)
    cv = 1000
    for i in range(12):
        cv += int(rng.integers(5, 40))
        if i == 6:
            trio.jax.advance(cv, cv - 100)
            trio.port.advance(cv, cv - 100)
            trio.oracle.oldest_version = cv - 100
            same_hist(trio.port.state, trio.jax.state, "advance")
            continue
        txns = make_txns(rng, int(rng.integers(1, 50)), cv)
        for t in txns[::3]:
            t.report_conflicting_keys = not wave
        trio.resolve(txns, cv, cv - 200, f"batch {i}")
        assert trio.port.headroom() == trio.jax.headroom()
        assert trio.port.overflowed == trio.jax.overflowed
    assert trio.port.dict_stats is None and trio.jax.dict_stats is None


def test_wire_path_and_rebase_equal_jax():
    rng = np.random.default_rng(12)
    cfg = dict(KW, window_versions=100)
    jcs = TPUConflictSet(resident=False, **cfg)
    tcs = TorchConflictSet(device="cpu", resident=False, **cfg)
    cv = 1000
    for i in range(8):
        cv += int(rng.integers(5, 40)) if i != 4 else (1 << 30) + 5
        txns = make_txns(rng, int(rng.integers(1, 40)), cv)
        want = jcs.resolve_wire_async(jenc(txns), cv, as_array=True)()
        got = tcs.resolve_wire_async(tenc([port_txn(t) for t in txns]), cv,
                                     as_array=True)()
        assert got.tolist() == want.tolist(), i
        same_hist(tcs.state, jcs.state, i)
        assert tcs.base_version == jcs.base_version
    assert tcs.base_version > 1 << 29  # the jump rebased


@pytest.mark.parametrize("threaded", [False, True])
def test_window_path_through_runner_equals_jax_and_oracle(threaded):
    rng = np.random.default_rng(14)
    k, count = 3, 20
    windows = make_windows(rng, 5, k, count, jump=(3, (1 << 30) + 2000))
    cfg = dict(KW, delta_capacity=40)
    jcs = TPUConflictSet(resident=False, **cfg)
    tcs = TorchConflictSet(device="cpu", resident=False, **cfg)
    oracle = OracleConflictSet()
    runner = PipelinedWindowRunner(tcs, threaded=threaded)
    try:
        for txns, cvs in windows:
            runner.submit(np.frombuffer(tenc([port_txn(t) for t in txns]),
                                        np.uint8), cvs, count)
        for w, (txns, cvs) in enumerate(windows):
            got = runner.collect_next()
            want = jcs.resolve_wire_window(jenc(txns), cvs, count)
            assert np.array_equal(got, want), w
            assert np.array_equal(got, oracle_window(
                oracle, txns, cvs, count, cfg["window_versions"])), w
    finally:
        runner.close()
    same_hist(tcs.state, jcs.state)


def test_two_phase_wave_equals_jax():
    rng = np.random.default_rng(16)
    cfg = dict(KW, wave_commit=True)
    bounds = [(b"", b"\x62"), (b"\x62", b"\xff")]
    jshards = [TPUConflictSet(resident=False, **cfg) for _ in bounds]
    tshards = [TorchConflictSet(device="cpu", resident=False, **cfg)
               for _ in bounds]
    cv = 1000
    for i in range(6):
        cv += 10
        txns = make_txns(rng, 20, cv)
        jg = jwm.combine_edges([s.resolve_edges(jwm.clip_txns(txns, lo, hi),
                                                cv)
                                for s, (lo, hi) in zip(jshards, bounds)])
        tg = wavemesh.combine_edges([
            s.resolve_edges(wavemesh.clip_txns([port_txn(t) for t in txns],
                                               lo, hi), cv)
            for s, (lo, hi) in zip(tshards, bounds)])
        for js, ts in zip(jshards, tshards):
            j = [int(v) for v in js.resolve_apply(jg)]
            t = [int(v) for v in ts.resolve_apply(tg)]
            assert t == j, i
            assert ts.last_wave == js.last_wave, i
            same_hist(ts.state, js.state, i)


def spec_engines(depth, wave=False, hook=_adversary):
    cfg = dict(capacity=1 << 12, batch_size=COUNT, max_read_ranges=4,
               max_write_ranges=2, max_key_bytes=8, wave_commit=wave,
               spec_resolve=True, spec_depth=depth)
    pair = (TPUConflictSet(resident=False, **cfg),
            TorchConflictSet(device="cpu", resident=False, **cfg))
    for cs in pair:
        cs.spec_confirm_hook = hook
    return pair


def run_windows(cs, windows, count, runner=PipelinedWindowRunner):
    r = runner(cs, threaded=False)
    out, levels = [], []
    try:
        for wire, cvs in windows:
            r.submit(np.frombuffer(wire, np.uint8), cvs, count)
        for _ in windows:
            out.append(np.asarray(r.collect_next()))
            levels.append(cs.last_wave_window)
    finally:
        r.close()
    return np.stack(out), levels


@pytest.mark.parametrize("wave", [False, True])
def test_spec_adversarial_repair_equals_depth1_and_jax(wave):
    jcs, port = spec_engines(3, wave)
    got, glv = run_windows(port, _windows(), COUNT)
    base_cs = spec_engines(1, wave)[1]
    base, blv = run_windows(base_cs, _windows(), COUNT)
    want, wlv = run_windows(jcs, _windows(), COUNT, JRunner)
    assert np.array_equal(got, base) and np.array_equal(got, want)
    if wave:
        for a, b, c in zip(glv, blv, wlv):
            assert np.array_equal(a, b) and np.array_equal(a, np.asarray(c))
    m = port.spec_metrics()
    assert m == jcs.spec_metrics() and m["spec_repaired"] > 0, m
    same_hist(port.state, jcs.state)
    same_hist(port.state, base_cs.state)
    assert m["spec_dispatched"] == NWIN


def disjoint_windows():
    """Three 2-batch windows: window 0 writes ``a`` keys, window 1 reads
    only ``b`` keys (clean), window 2 reads the whole ``a`` range
    (dependent)."""
    def txn(read, write, rv):
        return TxnConflictInfo(read_version=rv, read_ranges=[read],
                               write_ranges=[pt(write)])

    wins, cv = [], 1000
    for w, wk in enumerate([b"a", b"c", b"d"]):
        cvs, txns = [], []
        for s in range(2):
            cv += 5
            cvs.append(cv)
            txns += [txn(KeyRange(b"a", b"b") if w == 2 else
                         pt(b"xb"[w:w + 1] + b"%d" % j),
                         wk + b"%d%d" % (s, j), cv - 20) for j in range(4)]
        wins.append((jenc(txns), cvs))
    return wins


def test_dependency_probe_paint_only_and_re_resolve():
    """With the first accepted txn of window 0 revoked, the probe finds
    window 1 clean (repaired paint-only: its verdicts stand) and window 2
    dependent (re-resolved); a spy on the port's calls shows both, and
    everything equals JAX and a depth-1 engine."""
    def hook(seq, verdicts):
        return _adversary(seq, verdicts) if seq == 0 else None

    jcs, port = spec_engines(3, hook=hook)
    calls = []
    paint, resolve = port._paint_window, port._resolve_window
    port._paint_window = lambda p, *a: calls.append(("paint", p.seq)) \
        or paint(p, *a)
    port._resolve_window = lambda *a: calls.append(("resolve",)) \
        or resolve(*a)
    deps = []
    probe = port._spec_dep_windows
    port._spec_dep_windows = lambda *a: deps.append(probe(*a)) or deps[-1]
    got, _ = run_windows(port, disjoint_windows(), 4)
    want, _ = run_windows(jcs, disjoint_windows(), 4, JRunner)
    base_cs = spec_engines(1, hook=hook)[1]
    base, _ = run_windows(base_cs, disjoint_windows(), 4)
    assert np.array_equal(got, want) and np.array_equal(got, base)
    assert deps == [[False, True]], deps
    assert ("paint", 1) in calls and calls.count(("resolve",)) == 4, calls
    assert port.spec_metrics() == jcs.spec_metrics()
    same_hist(port.state, jcs.state)
    same_hist(port.state, base_cs.state)


def test_spec_object_path_equals_serial():
    rng = np.random.default_rng(18)
    cfg = dict(KW, spec_resolve=True, spec_depth=2)
    spec = TorchConflictSet(device="cpu", resident=False, **cfg)
    jcs = TPUConflictSet(resident=False, **cfg)
    cv = 1000
    for i in range(6):
        cv += 10
        txns = make_txns(rng, 20, cv)
        got = spec.spec_resolve_async([port_txn(t) for t in txns], cv)()
        want = jcs.spec_resolve_async(txns, cv)()
        assert [int(v) for v in got] == [int(v) for v in want], i
    same_hist(spec.state, jcs.state)


def test_convert_carries_a_jax_non_resident_engine():
    rng = np.random.default_rng(20)
    jcs = TPUConflictSet(resident=False, **KW)
    cv = 1000
    for _ in range(4):
        cv += 20
        jcs.resolve(make_txns(rng, 20, cv), cv)
    port = convert.engine_from_snapshot(jax_snapshot(jcs), device="cpu")
    assert not port.resident and port._mirror is None
    for _ in range(4):
        cv += 20
        txns = make_txns(rng, 20, cv)
        assert [int(v) for v in port.resolve([port_txn(t) for t in txns],
                                             cv)] == \
            [int(v) for v in jcs.resolve(txns, cv)]
    same_hist(port.state, jcs.state)
    snap = convert.snapshot(port)
    assert "mirror" not in snap and not snap["config"]["resident"]
    again = convert.engine_from_snapshot(snap, device="cpu")
    same_hist(again.state, jcs.state)


def test_bench_resident_0_on_cpu(capsys):
    """``python -m foundationdb_tpu_torch.bench --resident 0`` on the CPU:
    one JSON line, the resident engine's verdict hash, no dict_stats."""
    import json

    from foundationdb_tpu_torch import bench

    args = ["--device", "cpu", "--txns", "2048", "--window", "2",
            "--repeats", "1", "--keys", "2048", "--capacity", "4096"]
    recs = []
    for extra in ([], ["--resident", "0"]):
        assert bench.main(args + extra) == 0
        recs.append(json.loads(capsys.readouterr().out.strip()))
    assert recs[1]["resident"] is False and recs[1]["dict_stats"] is None
    assert recs[0]["verdicts_sha256"] == recs[1]["verdicts_sha256"]
    assert recs[1]["txns"] == recs[0]["txns"] > 0
