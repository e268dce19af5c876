"""K7, the tiered dictionary's demotion, against the JAX package on the CPU.

The plain twin of K7's tile algorithm (``dict_evict_tiles_plain``: source
tiles, two searches a tile into the sorted evict vector, marks and their
exclusive count, the tail written without reads), K7's plain version and
``apply_evict`` must equal JAX ``_dict_evict`` / ``apply_evict`` byte for
byte at the edges (no rank, one rank, every live rank, the first and the
last live rank, runs across tile boundaries, an evict vector with no
padding) at W = 1 and W = 4 and at tiles of 8, 64 and K7's 2048 rows.
A tiered engine whose demotion events span four or more chunks of
``dict_demote_batch`` ranks makes one K7 launch an event and must equal
the JAX engine, which evicts chunk by chunk, in every state leaf, the
mirror and ``dict_stats`` (``demotion_bytes`` included) after every step,
on the object path and on the deferred window path.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationdb_tpu.models import conflict_kernel as jck
from foundationdb_tpu.models.conflict_set import TPUConflictSet
from foundationdb_tpu.models.conflict_set import encode_resolve_batch as jenc
from foundationdb_tpu_torch import TorchConflictSet
from foundationdb_tpu_torch import kernels as K
from foundationdb_tpu_torch.models import conflict_kernel as tck
from foundationdb_tpu_torch.models.conflict_set import (
    encode_resolve_batch as tenc,
)
from foundationdb_tpu_torch.sched.packing import PipelinedWindowRunner
from tests.test_tiered_dict import KW, _hotspot_steps
from tests.test_torch_conflict_kernel import T, same, t_res
from tests.test_torch_conflict_set import port_txn
from tests.test_torch_tiered import WINDOW_KW, hotspot_windows, same_engine
from tests.test_torch_window import same_state

# Small shapes: one intra-op thread keeps the parallel test workers from
# oversubscribing the CPU.
torch.set_num_threads(1)

D, N = 2200, 2100  # dictionary capacity, live keys: two K7 tiles
TILES = (8, 64, tck.K7_TILE)


def evict_ranks(name: str, rng) -> np.ndarray:
    """The case's evict vector: strictly increasing live ranks, INT32_MAX
    padded to E (no padding for "full")."""
    picks = {
        "empty": [], "one": [int(rng.integers(1, N - 1))], "first": [0],
        "last": [N - 1], "all": list(range(N)),
        # runs over the boundaries of 8-, 64- and 2048-row tiles
        "runs": [*range(5, 12), *range(60, 70), *range(2040, 2060)],
        "full": sorted(rng.choice(N, 300, replace=False)),
    }
    real = np.asarray(picks[name], np.int32)
    e = len(real) if name == "full" else len(real) + 7
    ev = np.full(e, tck.INT32_MAX, np.int32)
    ev[:len(real)] = real
    return ev


def jax_res(w: int, ev: np.ndarray, rng):
    """A JAX ResState with N sorted W-word keys in a [D+1, W] dictionary,
    its history ranks drawn from the ranks ``ev`` keeps."""
    rows = np.unique(rng.integers(-10**6, 10**6, (3 * N, w)).astype(np.int32),
                     axis=0)[:N]
    res = jck.init_res(rows, D, 64, 16)
    live = np.setdiff1d(np.arange(N), ev[ev != tck.INT32_MAX])
    keys = np.full((64, 1), tck.INT32_MAX, np.int32)
    if live.size:
        keys[:40, 0] = np.sort(rng.choice(live, 40))
    base = res.hist.base._replace(keys=jnp.asarray(keys))
    return res._replace(hist=res.hist._replace(base=base))


@pytest.mark.parametrize("w", [1, 4])
@pytest.mark.parametrize("name", ["empty", "one", "first", "last", "all",
                                  "runs", "full"])
def test_evict_twin_and_apply_evict_equal_jax(name, w):
    rng = np.random.default_rng(len(name) * 10 + w)
    ev = evict_ranks(name, rng)
    jres = jax_res(w, ev, rng)
    n_ev = int((ev != tck.INT32_MAX).sum())
    want = jck._dict_evict(jres.dict_keys, jres.n_keys, jnp.asarray(ev))
    got = tck._dict_evict_plain(T(jres.dict_keys), T(jres.n_keys), T(ev))
    for g, x, what in zip(got, want, ("dict_keys", "n_keys", "shift")):
        same(g, x, f"plain: {what}")
    for tile in TILES:
        got = tck.dict_evict_tiles_plain(T(jres.dict_keys), T(jres.n_keys),
                                         T(ev), n_ev, N, tile)
        for g, x, what in zip(got, want, ("dict_keys", "n_keys", "shift")):
            same(g, x, f"tile {tile}: {what}")
    want = jck.apply_evict(jres, jnp.asarray(ev))
    same_state(tck.apply_evict(t_res(jres), T(ev), n_ev, N), want, name)
    same_state(tck.apply_evict(t_res(jres), T(ev)), want, name)
    # The shift of the twin rewrites the ranks as the plain one does.
    res = t_res(jres)
    nd, nn, shift = tck.dict_evict_tiles_plain(res.dict_keys, res.n_keys,
                                               T(ev), n_ev, N, 64)
    if n_ev:
        same_state(tck._rewrite_res_ranks(res, shift, False, nd, nn), want,
                   f"{name}: rewrite by the twin's shift")
    with pytest.raises(ValueError, match="host counts"):
        tck._dict_evict(res.dict_keys, res.n_keys, T(ev), n_ev, N - 1)


def test_k7_tile_matches_the_kernel():
    """K7_TILE is the kernel's ETILE (ET threads x EI rows), its mask
    words one bit a row."""
    text = (Path(K.__file__).resolve().parent / "csrc"
            / "dict_evict.cu").read_text()

    def define(name):
        return int(re.search(rf"#define {name} \(?(\d+)", text).group(1))

    assert define("ET") * define("EI") == tck.K7_TILE == K.K7_TILE
    assert define("ET") % 32 == 0 and tck.K7_TILE % 32 == 0


# ------------------------------------------------- multi-chunk events


class Counted:
    """``tck.apply_evict`` counted: the real ranks of each call."""

    def __init__(self, monkeypatch):
        self.n_ev = []
        real = tck.apply_evict

        def counted(res, ev, n_ev=None, n_live=None):
            self.n_ev.append(int((ev != tck.INT32_MAX).sum()))
            return real(res, ev, n_ev, n_live)

        monkeypatch.setattr(tck, "apply_evict", counted)


TIER4 = dict(dict_hot_capacity=384, dict_delta_slots=128,
             dict_demote_batch=8)


def test_multi_chunk_events_equal_jax_chunks(monkeypatch):
    """The shifting hotspot with evict chunks of 8 ranks: every demotion
    event is one K7 call however many chunks it spans (four or more on
    some), and the engine equals the JAX engine (one ``_evict_fn`` call a
    chunk) after every step, ``demotion_bytes`` = 4·8 a chunk."""
    counted = Counted(monkeypatch)
    jcs = TPUConflictSet(resident=True, **TIER4, **KW)
    chunks = []
    jev = jcs._evict_fn

    def jax_chunk(state, ev):
        chunks.append(int((np.asarray(ev) != tck.INT32_MAX).sum()))
        return jev(state, ev)

    jcs._evict_fn = jax_chunk
    tcs = TorchConflictSet(device="cpu", **TIER4, **KW)
    for i, (txns, cv, oldest) in enumerate(_hotspot_steps()):
        want = [int(v) for v in jcs.resolve(txns, cv, oldest)]
        got = [int(v) for v in tcs.resolve([port_txn(t) for t in txns], cv,
                                           oldest)]
        assert got == want, i
        same_engine(tcs, jcs, f"step {i}")
    st = tcs.dict_stats
    assert st["demotion_events"] == len(counted.n_ev) >= 3, st
    assert max(counted.n_ev) > 3 * 8, counted.n_ev  # four chunks or more
    assert sum(counted.n_ev) == sum(chunks) == st["demotions"]
    assert st["demotion_bytes"] == 4 * 8 * len(chunks)
    assert len(chunks) > len(counted.n_ev)


@pytest.mark.parametrize("threaded", [False, True])
def test_multi_chunk_deferred_demotion_equals_jax(monkeypatch, threaded):
    """The deferred demotion of the window path, evict chunks of 16 ranks:
    one K7 call an event, the runner's verdicts, state, mirror and
    dict_stats equal to the JAX tiered engine's window path."""
    counted = Counted(monkeypatch)
    tier = dict(dict_hot_capacity=384, dict_delta_slots=128,
                dict_demote_batch=16)
    jcs = TPUConflictSet(resident=True, **tier, **WINDOW_KW)
    tcs = TorchConflictSet(device="cpu", **tier, **WINDOW_KW)
    runner = PipelinedWindowRunner(tcs, threaded=threaded)
    try:
        for w, (txns, cvs) in enumerate(hotspot_windows(b"w", 24, 16, 5)):
            runner.submit(tenc([port_txn(t) for t in txns]), cvs, 16)
            got = runner.collect_next()
            want = np.asarray(jcs.resolve_wire_window(jenc(txns), cvs, 16))
            assert np.array_equal(got, want), w
            same_engine(tcs, jcs, f"window {w}")
    finally:
        runner.close()
    st = tcs.dict_stats
    assert st["demotion_stalls"] > 0, st
    assert st["demotion_events"] == len(counted.n_ev) > 0, st
    assert max(counted.n_ev) > 16, counted.n_ev  # more than one chunk
    assert st["demotion_bytes"] == 4 * 16 * sum(-(-n // 16)
                                                for n in counted.n_ev)
