"""The port's read plane vs the JAX package's, on the CPU.

``foundationdb_tpu_torch.reads`` (``TorchReadSet``, ``WatchIndex``,
``ReadCoalescer``), ``runtime.flow``, ``runtime.storage.VersionedMap`` and
``sched.coalescer`` against ``foundationdb_tpu/reads/``, its runtime and
its brain, byte for byte: the versioned map's keys, chains and
``struct_seq``; read values, range rows and ``stats`` (``pack_s`` aside,
a wall time) of every arm (the port's device arm runs its plain search on
the CPU) against ``TPUReadSet`` on both of its arms and the scalar
oracle, on the stream of ``python -m foundationdb_tpu.reads``'s
selfcheck (seed 0, 800 keys of 1-23 bytes, misses, 30% ranges); the plain
two-sided W-word search against the JAX one on padded mirrors; watch
fire sets and ``stats`` of the three arms on ``bench_watch_parity``'s
stream and ``tests/test_reads.py``'s cancel cases; the brains' decisions
over a recorded sequence; the coalescer and the Flow loop under one seed;
and ``convert``'s carry-over of a JAX storage server's map and watches.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.core.keypack import INT32_MAX, KeyCodec as JCodec
from foundationdb_tpu.core.mutations import Mutation, MutationType as M
from foundationdb_tpu.ops import lex as jlex
from foundationdb_tpu.reads import bench as jbench
from foundationdb_tpu.reads.coalescer import ReadBrain as JBrain
from foundationdb_tpu.reads.coalescer import ReadCoalescer as JCoalescer
from foundationdb_tpu.reads.read_set import TPUReadSet
from foundationdb_tpu.reads.watches import WatchIndex as JWatch
from foundationdb_tpu.runtime import flow as jflow
from foundationdb_tpu.runtime.storage import StorageServer
from foundationdb_tpu.runtime.storage import VersionedMap as JMap
from foundationdb_tpu.sched.coalescer import AdaptiveCoalescer as JAdaptive
from foundationdb_tpu.sched.coalescer import quantized_depths as jdepths
from foundationdb_tpu_torch import convert
from foundationdb_tpu_torch.core.keypack import KeyCodec
from foundationdb_tpu_torch.ops import lex as tlex
from foundationdb_tpu_torch.reads import ReadCoalescer, TorchReadSet, WatchIndex
from foundationdb_tpu_torch.reads.coalescer import ReadBrain
from foundationdb_tpu_torch.runtime import flow as tflow
from foundationdb_tpu_torch.runtime.storage import VersionedMap
from foundationdb_tpu_torch.sched.coalescer import (
    AdaptiveCoalescer,
    quantized_depths,
)

torch.set_num_threads(1)

#: The port's arms, each as (label, constructor arguments).
READ_ARMS = [("device-cpu", dict(arm="device", device="cpu")),
             ("host", dict(arm="host"))]


def no_pack_s(stats: dict) -> dict:
    return {k: v for k, v in stats.items() if k != "pack_s"}


# --------------------------------------------------------------------------
# VersionedMap
# --------------------------------------------------------------------------


def test_versioned_map_equals_jax():
    """Writes (new keys, same-version rewrites, tombstones), range purges,
    rollbacks and GC on both maps: keys, chains and struct_seq equal after
    every operation, and ``at``/``latest``/``range_keys`` agree."""
    rng = random.Random(11)
    j, t = JMap(), VersionedMap()
    keys = [bytes(rng.randrange(97, 105) for _ in range(rng.randrange(1, 4)))
            for _ in range(60)]
    v = 0
    for step in range(300):
        op = rng.random()
        if op < 0.75:
            v += rng.randrange(0, 2)
            k = rng.choice(keys)
            val = None if rng.random() < 0.1 else b"%d" % step
            for m in (j, t):
                m.write(k, max(v, 1), val)
        elif op < 0.85:
            a, b = sorted(rng.sample(keys, 2))
            for m in (j, t):
                m.purge_range(a, b)
        elif op < 0.93:
            r = max(0, v - rng.randrange(0, 4))
            for m in (j, t):
                m.rollback(r)
            v = max(v, r)
        else:
            f = max(0, v - rng.randrange(0, 6))
            for m in (j, t):
                m.gc(f)
        assert t._keys == j._keys and t._chains == j._chains, step
        assert t.struct_seq == j.struct_seq, step
    for k in keys:
        assert t.latest(k) == j.latest(k)
        for ver in range(0, v + 2, 3):
            assert t.at(k, ver) == j.at(k, ver)
    assert t.range_keys(b"b", b"f") == j.range_keys(b"b", b"f")


# --------------------------------------------------------------------------
# TorchReadSet against TPUReadSet and the oracle
# --------------------------------------------------------------------------


def selfcheck_store(seed: int = 0):
    """reads/__main__.py's selfcheck store and op stream: a JAX storage
    server with 800 keys of 1-23 bytes, three versions of updates, and
    150 ops (30% ranges, point batches with a miss)."""
    rng = random.Random(seed)
    loop = jflow.Loop(seed=seed)
    ss = StorageServer(loop, tag=0, tlog_ep=None)
    keys = sorted({bytes(rng.randrange(256)
                         for _ in range(rng.randrange(1, 24)))
                   for _ in range(800)})
    ss._apply(1, [Mutation(M.SET_VALUE, k, b"v0%s" % k[:4]) for k in keys])
    for v in (2, 3, 4):
        ss._apply(v, [Mutation(M.SET_VALUE, rng.choice(keys), b"v%d" % v)
                      for _ in range(60)])
    stream = []
    for _ in range(150):
        ver = rng.randrange(1, 5)
        if rng.random() < 0.3:
            a, b = sorted([rng.choice(keys), rng.choice(keys)])
            stream.append(("range", a, b + b"\x00", rng.randrange(0, 20),
                           ver))
        else:
            stream.append(("points",
                           [rng.choice(keys)
                            for _ in range(rng.randrange(1, 9))]
                           + [bytes([rng.randrange(256)])], ver))
    return ss, keys, stream


def run_ops(rs, stream) -> list:
    """The stream through one engine, one search per op (the JAX
    ``_oracle_shaped_engine``), with reverse scans on every third range."""
    out = []
    for i, op in enumerate(stream):
        if op[0] == "points":
            out.append(rs.get_points(op[1], op[2]))
        else:
            _, b, e, lim, ver = op
            out.append(rs.get_ranges([(b, e, lim, i % 3 == 0, ver)])[0])
    return out


@pytest.mark.parametrize("label,kw", READ_ARMS, ids=[a for a, _ in READ_ARMS])
def test_read_set_equals_jax_and_the_oracle(label, kw):
    ss, keys, stream = selfcheck_store()
    vmap = convert.versioned_map_from_jax(ss.map)
    port = TorchReadSet(vmap, KeyCodec(), **kw)
    got = run_ops(port, stream)
    oracle = [[port.oracle_get(k, op[2]) for k in op[1]]
              if op[0] == "points" else
              port.oracle_range(op[1], op[2], op[3], i % 3 == 0, op[4])
              for i, op in enumerate(stream)]
    assert got == oracle
    for device in (False, True):
        jrs = TPUReadSet(ss.map, device=device)
        assert run_ops(jrs, stream) == got, device
        want = no_pack_s(jrs.stats)
        if device != (kw["arm"] == "device"):  # the other arm uploads not
            want["uploads"] = port.stats["uploads"]
        assert no_pack_s(port.stats) == want, device
    assert port.stats["uploads"] == (1 if kw["arm"] == "device" else 0)
    # A batched dispatch: every point and range of the stream in one call
    # each, at per-key versions.
    flat = [(k, op[2]) for op in stream if op[0] == "points" for k in op[1]]
    pts = port.get_points([k for k, _ in flat], [v for _, v in flat])
    assert pts == [port.oracle_get(k, v) for k, v in flat]
    reqs = [(op[1], op[2], op[3], False, op[4]) for op in stream
            if op[0] == "range"]
    assert port.get_ranges(reqs) == TPUReadSet(ss.map).get_ranges(reqs)


def test_truncated_keys_walk_runs_and_the_mirror_rebuilds_on_struct_changes():
    """Keys longer than max_key_bytes pack to equal rows (runs longer than
    one that the confirm loop walks, range bounds low until the exact
    advance); a write to an existing key costs no rebuild, a new key, a
    purge and a rollback do, on both packages alike."""
    rng = random.Random(5)
    jm = JMap()
    base = [b"prefix-%02d-" % i for i in range(6)]
    keys = sorted({p + bytes(rng.randrange(97, 100) for _ in range(3))
                   for p in base for _ in range(6)})
    for k in keys:
        jm.write(k, 1, b"a" + k[-3:])
    tm = convert.versioned_map_from_jax(jm)
    jcodec, codec = JCodec(max_key_bytes=8), KeyCodec(max_key_bytes=8)
    port = [TorchReadSet(tm, codec, **kw) for _, kw in READ_ARMS]
    jax_ = [TPUReadSet(jm, jcodec, device=d) for d in (False, True)]
    queries = keys[::3] + [b"prefix-01-zzz", b"prefix-0", b"q"]
    reqs = [(b"prefix-01-", b"prefix-03-b", 100, False, 3),
            (b"prefix-02-ab", b"prefix-05", 7, True, 3)]
    for step in range(4):
        want = jax_[0].get_points(queries, 3)
        assert want == [jax_[0].oracle_get(k, 3) for k in queries]
        wr = jax_[0].get_ranges(reqs)
        for rs in port + jax_[1:]:
            assert rs.get_points(queries, 3) == want
            assert rs.get_ranges(reqs) == wr
        # step 0: a value update; 1: a new key; 2: a purge; 3: a rollback.
        for m in (jm, tm):
            if step == 0:
                m.write(keys[0], 2, b"upd")
            elif step == 1:
                m.write(b"prefix-01-new", 2, b"new")
            elif step == 2:
                m.purge_range(b"prefix-04-", b"prefix-05-")
        if step == 2:
            for m in (jm, tm):
                m.rollback(1)
        stats = [no_pack_s(rs.stats) for rs in port + jax_]
        assert all(s["rebuilds"] == stats[0]["rebuilds"] for s in stats)
    assert port[0].stats["rebuilds"] == 3 == port[0].stats["uploads"]


def test_empty_universe_and_zero_queries():
    jm = JMap()
    tm = convert.versioned_map_from_jax(jm)
    for (_, kw), d in zip(READ_ARMS, (True, False)):
        rs, jrs = TorchReadSet(tm, **kw), TPUReadSet(jm, device=d)
        for r in (rs, jrs):
            assert r.get_points([b"a", b""], 5) == [None, None]
            assert r.get_points([], 5) == []
            assert r.get_ranges([(b"", b"\xff", 10, False, 5)]) == [[]]
            assert r.get_ranges([]) == []
        assert no_pack_s(rs.stats) == no_pack_s(jrs.stats)
        assert rs.stats["probes"] == 0


def test_default_device_is_cuda_and_raises_without_a_card():
    """The read plane's device arms default to the card, as every port
    entry point does; the host arms need none."""
    vm = VersionedMap()
    if torch.cuda.is_available():
        assert TorchReadSet(vm).device.type == "cuda"
        assert WatchIndex().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchReadSet(vm)
    with pytest.raises(RuntimeError, match="CUDA"):
        WatchIndex()
    assert TorchReadSet(vm, arm="host").device is None
    assert WatchIndex(arm="1").device is None
    with pytest.raises(ValueError, match="arm"):
        TorchReadSet(vm, arm="1")
    with pytest.raises(ValueError, match="arm"):
        WatchIndex(arm="host")


# --------------------------------------------------------------------------
# The plain two-sided search on padded mirrors
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,k", [(0, 5), (1, 8), (37, 0), (64, 40), (100, 9)])
def test_two_sided_search_equals_jax_on_padded_mirrors(n, k):
    """The JAX device arm's shapes: a mirror of n rows padded to a power
    of two with INT32_MAX rows, queries padded to at least 8 slots with
    INT32_MAX (some equal to a pad row), duplicate and truncated rows; an
    empty mirror and k = 0 queries too."""
    rng = np.random.default_rng(n * 100 + k)
    w = 3
    rows = np.unique(rng.integers(-2, 2, (n, w)).astype(np.int32), axis=0)
    rows = np.concatenate([rows, rows[: len(rows) // 3]])
    rows = rows[np.lexsort(rows.T[::-1])] if len(rows) else rows.reshape(0, w)
    cap = max(1, 1 << max(0, (len(rows) - 1).bit_length()))
    padded = np.full((cap, w), INT32_MAX, np.int32)
    padded[: len(rows)] = rows
    q = rng.integers(-3, 3, (k, w)).astype(np.int32)
    slots = max(8, 1 << max(0, (k - 1).bit_length()))
    qpad = np.full((slots, w), INT32_MAX, np.int32)
    qpad[:k] = q
    for mirror in (padded, rows.reshape(-1, w)):
        want = jlex.searchsorted_words_2sided_fp(jnp.asarray(mirror),
                                                 jnp.asarray(qpad))
        got = tlex.searchsorted_words_2sided_fp(torch.from_numpy(mirror),
                                                torch.from_numpy(qpad))
        for g, wv in zip(got, want):
            assert g.dtype == torch.int32
            assert np.array_equal(g.numpy(), np.asarray(wv))
        # The read arm's clamp to n leaves every bound in [0, n].
        lo = np.minimum(np.asarray(want[0])[:k], len(rows))
        assert np.array_equal(np.minimum(got[0].numpy()[:k], len(rows)), lo)


# --------------------------------------------------------------------------
# WatchIndex
# --------------------------------------------------------------------------


def watch_stream(n_keys=120, versions=25, seed=7):
    """``bench_watch_parity``'s keys and stream (at the selfcheck's size:
    120 keys, 25 versions)."""
    rng = random.Random(seed)
    keys = [jbench._wkey(i) for i in range(n_keys)]
    stream = []
    for v in range(1, versions + 1):
        stream.append((v, [(rng.choice(keys),
                            b"new%d" % rng.randrange(4)
                            if rng.random() < 0.8 else None)
                           for _ in range(rng.randrange(1, 12))]))
    return keys, stream


def run_watches(idx, promise, keys, stream):
    """Arm every key, sweep the stream: (fired (key, version) sorted,
    stats, the index)."""
    fired = []

    def hook(k):
        p = promise()
        p.future.add_done_callback(
            lambda f, k=k: fired.append((k, f.result())))
        return p

    for k in keys:
        idx.add(k, b"expect", hook(k))
    for v, written in stream:
        idx.sweep(v, written)
    return sorted(fired), dict(idx.stats), idx


def same_watch_index(p, j, what=""):
    assert p._sorted == j._sorted and p._pending == j._pending, what
    assert p._dead == j._dead and p.count == j.count, what
    assert {k: [e for e, _ in v] for k, v in p._by_key.items()} == {
        k: [e for e, _ in v] for k, v in j._by_key.items()}, what
    assert p.stats == j.stats, what


@pytest.mark.parametrize("arm", ["0", "1", "device"])
def test_watch_arms_fire_and_count_as_jax(arm):
    """Each port arm against the JAX arm of the same name on
    ``bench_watch_parity``'s stream, and against the final-value oracle:
    fire sets, stats and the index. The JAX device arm searches eagerly
    (one compile per written-key count), so it runs the first 2 versions;
    the port's device arm runs the whole stream beside JAX's packed host
    arm "1", which counts no uploads and is otherwise identical."""
    keys, stream = watch_stream()
    kw = {"device": "cpu"} if arm == "device" else {}
    short = stream[:2] if arm == "device" else stream
    got = run_watches(WatchIndex(arm=arm, **kw), tflow.Promise, keys, short)
    want = run_watches(JWatch(arm=arm), jflow.Promise, keys, short)
    assert got[0] == want[0] and got[1] == want[1]
    same_watch_index(got[2], want[2], arm)
    full = run_watches(WatchIndex(arm=arm, **kw), tflow.Promise, keys, stream)
    host = run_watches(JWatch(arm="0" if arm == "0" else "1"), jflow.Promise,
                       keys, stream)
    if arm == "device":
        assert full[1]["uploads"] == full[1]["consolidations"] > 0
        full[2].stats["uploads"] = 0
    same_watch_index(full[2], host[2], arm)
    alive = {k: b"expect" for k in keys}
    oracle = []
    for v, written in stream:
        final = dict(written)
        for k, val in final.items():
            if k in alive and val != alive[k]:
                oracle.append((k, v))
                del alive[k]
    assert full[0] == host[0] == sorted(oracle) and oracle


class _Log:
    """A promise stand-in that logs (tag, value) when sent."""

    def __init__(self, tag, log):
        self.tag, self.log = tag, log

    def send(self, v):
        self.log.append((self.tag, v))


@pytest.mark.parametrize("arm", ["0", "1", "device"])
def test_cancel_range_cases_equal_jax(arm):
    """tests/test_reads.py's cancel cases (O(log n + hits) after a
    consolidation, after an add burst, over the pending tail, a sweep
    after them, a same-version rewrite back) on both packages: returned
    entries, the index, ``_dead`` and every stats counter."""
    kw = {"device": "cpu"} if arm == "device" else {}
    logs = ([], [])
    # The port's device arm against JAX's packed host arm "1" (identical
    # but for the uploads; the JAX device arm compiles per written-key
    # count and is held to the port in the test above).
    idxs = (JWatch(arm="1" if arm == "device" else arm),
            WatchIndex(arm=arm, **kw))
    results = ([], [])

    def both(fn):
        for i, idx in enumerate(idxs):
            results[i].append(fn(idx, logs[i]))

    both(lambda idx, log: [idx.add(b"ck/%05d" % i, None, _Log(i, log))
                           for i in range(600)])
    both(lambda idx, log: idx.sweep(1, [(b"zz-absent", b"x")]))
    both(lambda idx, log: sorted((k, e) for k, e, _ in idx.cancel_range(
        b"ck/00100", b"ck/00110")))
    both(lambda idx, log: [idx.add(b"ck/%05d" % i, b"e", _Log(i, log))
                           for i in range(600, 630)])
    both(lambda idx, log: sorted((k, e) for k, e, _ in idx.cancel_range(
        b"ck/00610", b"ck/00620")))
    both(lambda idx, log: idx._consolidate())
    both(lambda idx, log: sorted((k, e) for k, e, _ in idx.cancel_range(
        b"ck/00000", b"ck/00090")))
    both(lambda idx, log: idx.sweep(2, [(b"ck/00095", b"v"),
                                        (b"ck/00605", b"e"),
                                        (b"ck/00625", b"f"),
                                        (b"ck/00095", None)]))
    both(lambda idx, log: idx.add(b"k", b"a", _Log("k", log)))
    both(lambda idx, log: idx.sweep(7, [(b"k", b"b"), (b"k", b"a")]))
    both(lambda idx, log: idx.sweep(8, [(b"k", b"b")]))
    # Enough tombstones to prune the index on the next consolidation.
    both(lambda idx, log: sorted((k, e) for k, e, _ in idx.cancel_range(
        b"ck/00090", b"ck/00500")))
    both(lambda idx, log: idx.sweep(9, [(b"ck/00550", b"z")]))
    assert results[0] == results[1]
    assert logs[0] == logs[1]
    if arm == "device":
        st = idxs[1].stats
        assert st["uploads"] == st["consolidations"]
        st["uploads"] = 0
    same_watch_index(idxs[1], idxs[0], arm)
    assert idxs[1].stats["consolidations"] >= 3


@pytest.mark.parametrize("arm", ["1", "device"])
def test_watch_index_from_jax_carries_a_storage_servers_watches(arm):
    """A JAX storage server's armed watches (consolidated, a pending tail,
    tombstones; its index is on the packed host arm "1") carried to the
    port's arm "1" and its device arm on the CPU: the next sweeps fire the
    same (key, version) sets with the same stats (the device arm counts
    an upload at each consolidation besides)."""
    loop = jflow.Loop(seed=3)
    ss = StorageServer(loop, tag=0, tlog_ep=None)
    wi = ss.watches
    jlog = []
    for i in range(200):
        wi.add(b"w/%04d" % i, b"x", _Log(i, jlog))
    wi.sweep(1, [(b"w/0001", b"y")])
    for i in range(200, 220):
        wi.add(b"w/%04d" % i, None, _Log(i, jlog))
    wi.cancel_range(b"w/0010", b"w/0020")
    tlog = []
    assert wi.arm == "1"
    kw = {"device": "cpu"} if arm == "device" else {}
    port = convert.watch_index_from_jax(
        wi, lambda k, e: _Log(int(k[2:]), tlog), arm=arm, **kw)
    assert port.arm == arm
    same_watch_index(port, wi, "carried")
    stream = [(2, [(b"w/0005", b"z"), (b"w/0210", b"q"), (b"w/0015", b"z")]),
              (3, [(b"w/0100", b"x"), (b"w/0101", None)])]
    c0 = wi.stats["consolidations"]
    for v, written in stream:
        assert port.sweep(v, written) == wi.sweep(v, written)
    assert tlog == jlog[1:] and len(tlog) == 3
    if arm == "device":
        assert port.stats["uploads"] == wi.stats["consolidations"] - c0 > 0
        port.stats["uploads"] = wi.stats["uploads"]
    same_watch_index(port, wi, "after sweeps")


def test_versioned_map_from_jax_copies():
    loop = jflow.Loop(seed=1)
    ss = StorageServer(loop, tag=0, tlog_ep=None)
    ss._apply(1, [Mutation(M.SET_VALUE, b"a", b"1"),
                  Mutation(M.SET_VALUE, b"b", b"2")])
    ss._apply(2, [Mutation(M.SET_VALUE, b"a", b"3")])
    vm = convert.versioned_map_from_jax(ss.map)
    assert (vm._keys, vm._chains, vm.struct_seq) == (
        ss.map._keys, ss.map._chains, ss.map.struct_seq)
    vm.write(b"a", 3, b"4")
    vm.write(b"c", 3, b"5")
    assert ss.map.at(b"a", 9) == b"3" and ss.map._keys == [b"a", b"b"]


# --------------------------------------------------------------------------
# The brains, the coalescer and the loop
# --------------------------------------------------------------------------


def test_brains_decide_as_jax():
    """AdaptiveCoalescer and ReadBrain over one recorded sequence of
    arrivals, dispatch observations and speculation repairs: every
    decision, target depth, wait hint and fitted cost equal JAX's."""
    rng = random.Random(2)
    assert quantized_depths(48) == jdepths(48)
    pairs = [(AdaptiveCoalescer(budget_ms=b, max_window=mw, spec_depth=sd),
              JAdaptive(budget_ms=b, max_window=mw, spec_depth=sd))
             for b, mw, sd in ((50.0, 32, 0), (2.0, 16, 3), (0.0, 8, 0))]
    pairs += [(ReadBrain(budget_ms=b, max_window=64),
               JBrain(budget_ms=b, max_window=64)) for b in (0.25, 0.0)]
    now = 0.0
    for step in range(400):
        now += rng.expovariate(2.0)
        queued, age = rng.randrange(0, 70), rng.uniform(0, 3)
        obs = (rng.randrange(1, 40), rng.uniform(0.01, 5.0))
        rep = rng.random() < 0.3
        for t, j in pairs:
            for x in (t, j):
                x.note_arrival(now)
                if step % 3 == 0:
                    x.observe_dispatch(*obs)
                if step % 7 == 0:
                    x.note_misspec(rep)
            assert t.decide(queued, age) == j.decide(queued, age), step
            assert t.wait_hint_ms(queued, age) == j.wait_hint_ms(queued, age)
            assert t.target_depth() == j.target_depth()
            assert t.effective_spec_depth() == j.effective_spec_depth()
            assert (t.cost.overhead_ms, t.cost.per_batch_ms) == (
                j.cost.overhead_ms, j.cost.per_batch_ms)


def coalesced_run(flow, coalescer_cls, read_set, stream, n_clients=12,
                  budget_ms=0.25, seed=4, loop_clock=False):
    """``stream`` through ``n_clients`` closed-loop clients on a Loop of
    ``flow`` through a coalescer: (answers, requests per dispatch, stats,
    the read set's stats). ``loop_clock`` feeds the brain each dispatch's
    cost on the loop's clock (none on a simulated loop), as the port's
    coalescer does, in place of the JAX coalescer's wall time."""
    loop = flow.Loop(seed=seed)
    rc = coalescer_cls(loop, read_set, budget_ms=budget_ms, max_window=8)
    if loop_clock:
        brain, observe = rc.brain, type(rc.brain).observe_dispatch
        brain.observe_dispatch = lambda depth, _ms: observe(brain, depth, 0.0)
    sizes = []
    dispatch = rc._dispatch

    def counted(batch, oldest_ms):
        sizes.append(len(batch))
        return dispatch(batch, oldest_ms)

    rc._dispatch = counted
    answers = [None] * len(stream)
    nxt = [0]

    async def client():
        while nxt[0] < len(stream):
            i = nxt[0]
            nxt[0] += 1
            op = stream[i]
            if op[0] == "points":
                answers[i] = await rc.submit_points(op[1], op[2])
            else:
                answers[i] = await rc.submit_range(*op[1:4], False, op[4])

    loop.run(flow.all_of([loop.spawn(client(), name=f"c{i}")
                          for i in range(n_clients)]), timeout=1e6)
    return answers, sizes, dict(rc.stats), dict(read_set.stats)


@pytest.mark.parametrize("budget_ms", [0.25, 0.0])
def test_read_coalescer_equals_jax_under_one_seed(budget_ms):
    ss, _keys, stream = selfcheck_store(seed=1)
    vmap = convert.versioned_map_from_jax(ss.map)
    got = coalesced_run(tflow, ReadCoalescer,
                        TorchReadSet(vmap, arm="device", device="cpu"),
                        stream, budget_ms=budget_ms)
    want = coalesced_run(jflow, JCoalescer, TPUReadSet(ss.map, device=True),
                         stream, budget_ms=budget_ms, loop_clock=True)
    assert got[0] == want[0]
    assert got[1] == want[1] and sum(got[1]) == len(stream)
    assert len(got[1]) < len(stream)  # the coalescer batched
    for k in ("dispatches", "requests", "point_reads", "range_reads",
              "errors"):
        assert got[2][k] == want[2][k], k
    assert no_pack_s(got[3]) == no_pack_s(want[3])
    oracle = TorchReadSet(vmap, arm="host")
    for op, ans in zip(stream, got[0]):
        if op[0] == "points":
            assert ans == [oracle.oracle_get(k, op[2]) for k in op[1]]
        else:
            assert ans == oracle.oracle_range(*op[1:4], False, op[4])


def actor_program(flow) -> list:
    """A small actor program on a Loop of ``flow``: timers, spawns under
    named processes, all_of, any_of, a kill, a broken promise and RNG
    draws; returns the order of its events."""
    loop = flow.Loop(seed=9)
    log = []

    async def worker(i, dt):
        try:
            for j in range(3):
                await loop.sleep(dt * loop.rng.random())
                log.append(("tick", i, j, round(loop.now, 9)))
            return i
        except flow.ActorCancelled:
            log.append(("cancelled", i))
            raise

    async def main():
        # One task in the killed process: a kill cancels a process's
        # tasks in set order, which neither loop fixes.
        ts = [loop.spawn(worker(i, 0.5 + i), process=f"p{int(i == 3)}",
                         name=f"w{i}") for i in range(4)]
        first = await flow.any_of([t for t in ts])
        log.append(("first", first))
        loop.kill_process("p1")
        p = flow.Promise()
        p.broken()
        try:
            await p.future
        except flow.BrokenPromise as e:
            log.append(("broken", e.code))
        done = await flow.all_of([ts[0], ts[2], flow.ready(7)])
        log.append(("all", done, round(loop.now, 9)))
        for t in ts:
            log.append(("state", t.done(), t.is_error()))
        return "end"

    log.append(("result", loop.run(main())))
    return log


def test_flow_loop_orders_events_as_jax():
    got, want = actor_program(tflow), actor_program(jflow)
    assert got == want and ("result", "end") in got
    assert any(e[0] == "cancelled" for e in got)
