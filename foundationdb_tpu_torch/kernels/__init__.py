"""ctypes bindings of the hand-written CUDA kernels, with their launch counts.

Each wrapper checks device, dtype, shape and contiguity, allocates outputs
and scratch with ``torch.empty``, launches on the current CUDA stream, and
raises if the C entry returns a CUDA error. K9 also has an unchecked
launch into given buffers (``shard_clip_into``), for a window program
that checks and allocates once a window. ``LAUNCHES`` holds one integer
per kernel source, ``ENTRY_LAUNCHES`` one per C entry point; a wrapper
adds one to both where it calls into its library and nowhere else. The
libraries are built (build.py) the first time any wrapper runs, never at
import.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from foundationdb_tpu_torch.kernels import build
from foundationdb_tpu_torch.ops.rmq import RMQ_BLOCK

LAUNCHES = {name: 0 for name in build.SOURCES}
ENTRY_LAUNCHES: dict[str, int] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "dict_insert": {
        "di_insert": [_P, _I, _P, _I, _I, _P, _P, _P, _P],
        "di_rewrite": [_P, _I, _P, _I, _P, _I, _P, _I, _P, _I, _I, _P],
        "di_rebase": [_P, _I, _P, _I, _I, _P],
    },
    "dict_evict": {
        "de_evict": [_P, _I, _I, _P, _I, _P, _P, _P, _P, _P],
    },
    "history_probe": {
        "hp_table": [_P, _I, _I, _P, _P, _P, _P],
        "hp_probe": [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                     _P, _P, _P, _P],
    },
    "accept": {
        "ac_accept": [_P] * 9 + [_I] * 3 + [_P] * 6,
        "ac_losers": [_P] * 9 + [_I] * 3 + [_P] * 3,
    },
    "step_compact": {
        "sc_paint": [_P, _P, _I] + [_P] * 8 + [_I] * 3 + [_P] * 4,
        "sc_fold": [_P, _P, _I] + [_P] * 5 + [_I] + [_P] * 3 + [_I]
        + [_P] * 5,
        "sc_fold_step": [_P, _P, _I] + [_P] * 5 + [_I] + [_P] * 4 + [_I]
        + [_P] * 4,
        "sc_compact": [_P, _P, _I, _I] + [_P] * 7,
        "sc_need": [_P, _I, _P, _P, _I, _I, _P, _P, _P],
        "sc_reset": [_P, _I, _I] + [_P] * 6,
    },
    "wave": {
        "wv_pred": [_P] * 7 + [_I] * 4 + [_P] * 2,
        "wv_level": [_P] * 4 + [_I] * 2 + [_P] * 7,
    },
    "shard": {
        "sh_clip": [_P] * 6 + [_I] * 3 + [_P] * 2 + [_I] * 2 + [_P] * 7,
        "sh_probe": [_P, _I, _P, _I] + [_P] * 8 + [_I] * 2 + [_P] * 5,
        "sh_exchange": [_P, _I, _I, _I, _P, _P, _P],
    },
    "word_probe": {
        "wp_search": [_P, _I, _P, _P, _I, _P, _P] + [_I] * 4 + [_P] * 6,
        "wp_probe": [_P, _I, _P, _P, _P, _I, _P, _P] + [_P] * 6 + [_I] * 2
        + [_P] * 4,
    },
    "word_compact": {
        "wc_paint": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
        "wc_fold": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                    _P, _P, _P, _P, _P],
        "wc_compact": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                       _P],
        "wc_paint_keys": [_P] * 4 + [_I] * 3 + [_P] * 3,
        "wc_paint_sorted": [_P, _P, _I, _I] + [_P] * 6 + [_I] * 2
        + [_P] * 4,
    },
    "word_sort": {
        "wso_sort": [_P, _I, _I] + [_P] * 4 + [_I] + [_P] * 11,
        "wso_ranks": [_P] * 4 + [_I] * 3 + [_P] * 13,
    },
    "word_shard": {
        "wsh_clip": [_P] * 6 + [_I] * 4 + [_P] * 2 + [_I] * 2 + [_P] * 7,
        "wsh_probe": [_P, _I, _I, _P, _I] + [_P] * 8 + [_I] * 2 + [_P] * 5,
    },
    "rmq_blocked": {
        "rb_build": [_P, _I, _I, _P, _P, _P, _P],
        "rb_query": [_P, _I, _P, _P, _P, _I, _I, _P, _P, _I, _P, _P],
        "rb_probe": [_P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _I, _I, _P, _P,
                     _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P,
                     _P],
        "rb_shard_probe": [_P, _I, _I, _P, _I, _P, _P, _P, _I, _I, _I]
        + [_P] * 8 + [_I] * 2 + [_P] * 5,
    },
    "admission": {
        "ad_set": [_P, _I, _I, _P, _I, _P],
        "ad_clear": [_P, _I, _I, _P],
        "ad_probe": [_P, _I, _I, _P, _I, _I, _P, _P, _P],
        "ad_count": [_P, _I, _I, _P, _P],
    },
}
_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[str, ctypes._CFuncPtr] = {}  # entry point -> bound function


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    ENTRY_LAUNCHES.clear()


def ensure_built() -> None:
    """Build (if needed) and load all kernel libraries."""
    if len(_LIBS) == len(_SIGNATURES):
        return
    paths = build.build_all()
    for name, fns in _SIGNATURES.items():
        lib = ctypes.CDLL(str(paths[name]))
        for fn, argtypes in fns.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
            _FNS[fn] = f
        _LIBS[name] = lib


def _call(source: str, fn: str, device: torch.device, *args) -> None:
    """Launch entry ``fn`` of ``source`` on the current stream of
    ``device``. The bound function is looked up once (the build runs at
    the first launch only) and the raw stream handle is read without
    building a Stream object: a launch's host cost is this call."""
    f = _FNS.get(fn)
    if f is None:
        ensure_built()
        f = _FNS[fn]
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    rc = f(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{source}.cu {fn}: CUDA error {rc}")
    LAUNCHES[source] += 1
    ENTRY_LAUNCHES[fn] = ENTRY_LAUNCHES.get(fn, 0) + 1


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _check(t: torch.Tensor, dtype: torch.dtype, name: str,
           shape: tuple | None = None) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")


_i32, _bool, _i8, _i64 = torch.int32, torch.bool, torch.int8, torch.int64


def table_levels(n: int) -> int:
    return max(1, math.ceil(math.log2(n))) + 1


# ----------------------------------------------------------------- K1


def dict_insert(dict_keys: torch.Tensor, delta_keys: torch.Tensor):
    """(merged dictionary [D+1, W], shift int32 [D+1])."""
    d1, w = dict_keys.shape
    m = delta_keys.shape[0]
    _check(dict_keys, _i32, "dict_keys")
    _check(delta_keys, _i32, "delta_keys", (m, w))
    out = torch.empty_like(dict_keys)
    work = torch.empty(d1 + m, dtype=_i32, device=dict_keys.device)
    shift, q = work[:d1], work[d1:]
    _call("dict_insert", "di_insert", dict_keys.device, _ptr(dict_keys), d1,
          _ptr(delta_keys), m, w, _ptr(shift), _ptr(out), _ptr(q))
    return out, shift


def rewrite_ranks(arrays: list, table: torch.Tensor, remap: bool) -> None:
    """In place on up to four int32 rank arrays."""
    if len(arrays) > 4:
        raise ValueError("at most four rank arrays per launch")
    _check(table, _i32, "table")
    args = []
    for i, a in enumerate(arrays):
        _check(a, _i32, f"ranks[{i}]")
        args += [_ptr(a), a.numel()]
    args += [None, 0] * (4 - len(arrays))
    _call("dict_insert", "di_rewrite", table.device, *args, _ptr(table),
          table.numel(), int(remap))


def rebase_versions(arrays: list, delta: int) -> None:
    """In place: v -> NEG_VERSION if v < delta else v - delta."""
    if not 0 < delta < 2**31 or len(arrays) > 2:
        raise ValueError("rebase takes 1-2 arrays and 0 < delta < 2**31")
    args = []
    for i, a in enumerate(arrays):
        _check(a, _i32, f"versions[{i}]")
        args += [_ptr(a), a.numel()]
    args += [None, 0] * (2 - len(arrays))
    _call("dict_insert", "di_rebase", arrays[0].device, *args, int(delta))


# ----------------------------------------------------------------- K7


def dict_evict(dict_keys: torch.Tensor, n_keys: torch.Tensor,
               evict_ranks: torch.Tensor, n_ev: int):
    """(compacted dictionary [D+1, W], new n_keys 0-dim, shift int32 [D+1]
    with shift[r] = -(evicted ranks <= r)); ``evict_ranks`` [E] holds
    strictly increasing ranks, INT32_MAX padded, ``n_ev`` of them real."""
    d1, w = dict_keys.shape
    e = evict_ranks.shape[0]
    _check(dict_keys, _i32, "dict_keys")
    _check(n_keys, _i32, "n_keys", ())
    _check(evict_ranks, _i32, "evict_ranks", (e,))
    if not 0 <= n_ev <= e:
        raise ValueError(f"n_ev {n_ev} outside [0, {e}]")
    dev = dict_keys.device
    out = torch.empty_like(dict_keys)
    new_n = torch.empty((), dtype=_i32, device=dev)
    shift = torch.empty(d1, dtype=_i32, device=dev)
    _call("dict_evict", "de_evict", dev, _ptr(dict_keys), d1, w,
          _ptr(evict_ranks), int(n_ev), _ptr(n_keys), _ptr(out), _ptr(new_n),
          _ptr(shift))
    return out, new_n, shift


# ----------------------------------------------------------------- K2


# CUDA kernel launches made by the last ``build_table`` (hp_table reports
# them: a group of levels a launch, two for N up to 2^22).
TABLE_KERNELS = {"last": 0}


def build_table(values: torch.Tensor, out: torch.Tensor | None = None,
                need: torch.Tensor | None = None) -> torch.Tensor:
    """Sparse table [L, N] over values (into ``out`` if given; skipped on
    the device when the 0-dim bool ``need`` is False)."""
    n = values.shape[0]
    _check(values, _i32, "values", (n,))
    if n == 0:
        return values.new_zeros((1, 0))
    levels = table_levels(n)
    if out is None:
        out = torch.empty((levels, n), dtype=_i32, device=values.device)
    _check(out, _i32, "table", (levels, n))
    if need is not None:
        _check(need, _bool, "need", ())
    launched = ctypes.c_int(0)
    _call("history_probe", "hp_table", values.device, _ptr(values), n, levels,
          _ptr(out), _ptr(need), ctypes.addressof(launched))
    TABLE_KERNELS["last"] = launched.value
    return out


def history_probe(base_keys, base_st, delta_keys, delta_st, read_begin,
                  read_end, read_mask, read_version, txn_mask, floor):
    """(too_old bool [B], hist_mask bool [B, R], cand bool [B]); a flat
    history passes ``delta_keys`` and ``delta_st`` None."""
    b, r = read_begin.shape
    c = base_keys.shape[0]
    cd = 0 if delta_keys is None else delta_keys.shape[0]
    _check(base_keys, _i32, "base.keys", (c, 1))
    _check(base_st, _i32, "base_st", (table_levels(c), c))
    if (delta_keys is None) != (delta_st is None):
        raise ValueError("give the delta's keys and table, or neither")
    if delta_keys is not None:
        _check(delta_keys, _i32, "delta.keys", (cd, 1))
        _check(delta_st, _i32, "delta_st", (table_levels(cd), cd))
    _check(read_begin, _i32, "read_begin")
    _check(read_end, _i32, "read_end", (b, r))
    _check(read_mask, _bool, "read_mask", (b, r))
    _check(read_version, _i32, "read_version", (b,))
    _check(txn_mask, _bool, "txn_mask", (b,))
    _check(floor, _i32, "floor", ())
    dev = read_begin.device
    too_old = torch.empty(b, dtype=_bool, device=dev)
    cand = torch.empty(b, dtype=_bool, device=dev)
    hist_mask = torch.empty((b, r), dtype=_bool, device=dev)
    _call("history_probe", "hp_probe", dev, _ptr(base_keys), c, _ptr(base_st),
          _ptr(delta_keys), cd, _ptr(delta_st), _ptr(read_begin),
          _ptr(read_end), _ptr(read_mask), _ptr(read_version), _ptr(txn_mask),
          _ptr(floor), b, r, _ptr(hist_mask), _ptr(too_old), _ptr(cand))
    return too_old, hist_mask, cand


# ----------------------------------------------------------------- K3


def _check_ranks(rb, re_, read_live, wb, we, write_live):
    b, r = rb.shape
    q = wb.shape[1]
    _check(rb, _i32, "read_begin")
    _check(re_, _i32, "read_end", (b, r))
    _check(read_live, _bool, "read_live", (b, r))
    _check(wb, _i32, "write_begin", (b, q))
    _check(we, _i32, "write_end", (b, q))
    _check(write_live, _bool, "write_live", (b, q))
    return b, r, q


# K3's stats build writes these int64 counters (accept.cu, AC_CLK_*): the
# globaltimer spans (ns) of the overlap, prune and walk launches, the rows
# with a candidate predecessor, the pending rows, the relaxation rounds, the
# rows the serial walk visits and their words, and the walk kernel's
# clock64 cycles by phase.
ACCEPT_CLOCKS = ("overlap_t0", "overlap_t1", "prune_t0", "prune_t1",
                 "walk_t0", "walk_t1", "edgeful", "pending", "rounds",
                 "walk_steps", "walk_words", "prefix_cycles", "stage_cycles",
                 "round_cycles", "walking_cycles")


def accept(cand, too_old, txn_mask, rb, re_, read_live, wb, we, write_live,
           verdicts=None, clocks=None):
    """(accepted bool [B], verdicts int8 [B]); the verdicts are written
    into ``verdicts`` when it is given. ``clocks`` (int64
    [len(ACCEPT_CLOCKS)]) runs the stats build and takes this launch's
    phase counters."""
    b, r, q = _check_ranks(rb, re_, read_live, wb, we, write_live)
    for name, t in (("cand", cand), ("too_old", too_old),
                    ("txn_mask", txn_mask)):
        _check(t, _bool, name, (b,))
    dev = cand.device
    nw = (b + 31) // 32
    scratch = torch.empty(b * nw + 2 * b + 3 * nw, dtype=_i32, device=dev)
    rows, aux = scratch[:b * nw], scratch[b * nw:]
    accepted = torch.empty(b, dtype=_bool, device=dev)
    if verdicts is None:
        verdicts = torch.empty(b, dtype=_i8, device=dev)
    _check(verdicts, _i8, "verdicts", (b,))
    if clocks is not None:
        _check(clocks, _i64, "clocks", (len(ACCEPT_CLOCKS),))
    _call("accept", "ac_accept", dev, _ptr(cand), _ptr(too_old),
          _ptr(txn_mask), _ptr(rb), _ptr(re_), _ptr(read_live), _ptr(wb),
          _ptr(we), _ptr(write_live), b, r, q, _ptr(rows), _ptr(aux),
          _ptr(accepted), _ptr(verdicts), _ptr(clocks))
    return accepted, verdicts


def loser_mask(hist_mask, accepted, verdicts, rb, re_, read_live, wb, we,
               write_live):
    """int32 bit patterns [B] (bit c: read slot c lost) when R <= 32, else
    bool [B, R] — pack_loser_mask's layout."""
    b, r, q = _check_ranks(rb, re_, read_live, wb, we, write_live)
    _check(hist_mask, _bool, "hist_mask", (b, r))
    _check(accepted, _bool, "accepted", (b,))
    _check(verdicts, _i8, "verdicts", (b,))
    dev = hist_mask.device
    losers = torch.empty((b, r), dtype=_bool, device=dev)
    packed = torch.empty(b, dtype=_i32, device=dev) if r <= 32 else None
    _call("accept", "ac_losers", dev, _ptr(hist_mask), _ptr(accepted),
          _ptr(verdicts), _ptr(rb), _ptr(re_), _ptr(read_live), _ptr(wb),
          _ptr(we), _ptr(write_live), b, r, q, _ptr(losers), _ptr(packed))
    return losers if packed is None else packed


# ----------------------------------------------------------------- K4


def _check_state(st, name: str):
    c = st.keys.shape[0]
    _check(st.keys, _i32, f"{name}.keys", (c, 1))
    _check(st.versions, _i32, f"{name}.versions", (c,))
    _check(st.n_used, _i32, f"{name}.n_used", ())
    _check(st.oldest, _i32, f"{name}.oldest", ())
    _check(st.overflow, _bool, f"{name}.overflow", ())
    return c


def _scratch(n: int, dev, count: int):
    return [torch.empty(n, dtype=_i32, device=dev) for _ in range(count)]


#: Merged rows a K4 tile (step_compact.cu TILE) and output rows a K1 tile
#: (dict_insert.cu KTILE).
K4_TILE = 2048
K1_TILE = 2048
#: Merged rows of K13's sorted-paint tile (word_compact.cu PT, one a
#: thread).
K13_TILE = 256


def word_sort_tile(n: int, w: int) -> int:
    """Rows of K14's sort tile for ``n`` rows of ``w`` words (word_sort.cu
    ``tile_rows``): the smallest power of two from 1024 that cuts ``n``
    into at most 24 tiles, within the largest (<= 2048) whose two head
    arrays, indices and rows at an odd stride fit in 227 KB less 1 KB; 0
    if not even 256 rows fit."""
    cap = next((t for t in (2048, 1024, 512, 256)
                if t * (20 + 4 * (w | 1)) <= 231424), 0)
    t = min(cap, 1024)
    while t < cap and -(-n // t) > 24:
        t *= 2
    return t


_WS_HEAD = 8  # step_compact.cu WS_WORDS
_WORKSPACE = threading.local()


def _workspace(dev, n: int, scratch: int = 0):
    """K4's workspace for ``n`` merged rows: (the look-back state, int64:
    a ticket, the decision's counters, two words a tile; zeroed when made
    and left zeroed by every K4 call that runs to its end; the survivors'
    scratch, int32 [``scratch``]). One per device, stream and thread, so
    two K4 calls never share it out of stream order, and a call allocates
    nothing once it has grown."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (index, torch._C._cuda_getCurrentRawStream(index))
    cache = getattr(_WORKSPACE, "by_stream", None)
    if cache is None:
        cache = _WORKSPACE.by_stream = {}
    words = _WS_HEAD + 2 * -(-n // K4_TILE)
    ws, sc = cache.get(key, (None, None))
    if ws is None or ws.numel() < words:
        ws = torch.zeros(max(words, 1024), dtype=_i64, device=dev)
    if sc is None or sc.numel() < scratch:
        sc = torch.empty(max(scratch, 1 << 16), dtype=_i32, device=dev)
    cache[key] = ws, sc
    return ws, sc


def paint(state, wb, we, write_mask, accepted, paint_src, cv: int,
          floor) -> None:
    """Paint in place into ``state`` (a width-1 ConflictState): two
    launches."""
    c = _check_state(state, "state")
    b, q = wb.shape
    _check(wb, _i32, "write_begin")
    _check(we, _i32, "write_end", (b, q))
    _check(write_mask, _bool, "write_mask", (b, q))
    _check(accepted, _bool, "accepted", (b,))
    _check(paint_src, _i32, "paint_src", (2 * b * q,))
    _check(floor, _i32, "floor", ())
    dev = wb.device
    ws, scratch = _workspace(dev, c + 2 * b * q, 2 * c)
    _call("step_compact", "sc_paint", dev, _ptr(state.keys),
          _ptr(state.versions), c, _ptr(state.n_used), _ptr(state.overflow),
          _ptr(state.oldest), _ptr(wb), _ptr(we), _ptr(write_mask),
          _ptr(accepted), _ptr(paint_src), b, q, int(cv), _ptr(floor),
          _ptr(scratch), _ptr(ws))


def fold(base, delta, floor, need, reset_delta: bool = False,
         demand: int | None = None) -> None:
    """Fold ``delta`` into ``base`` in place, skipped on the device when the
    0-dim bool ``need`` is False (None: fold always). With ``demand`` (the
    gated step, entry ``sc_fold_step``) ``need`` is an output: the
    decision (``fold_need``'s kernel) writes it first, from the same call,
    and the delta is reset. With ``reset_delta`` the delta is reset to its
    min-key row at the floor (``_reset_delta``) in the fold's second
    launch. Two launches, three with the decision."""
    c = _check_state(base, "base")
    cd = _check_state(delta, "delta")
    _check(floor, _i32, "floor", ())
    if need is not None:
        _check(need, _bool, "need", ())
    dev = base.keys.device
    ws, scratch = _workspace(dev, c + cd, 2 * c)
    args = (_ptr(base.keys), _ptr(base.versions), c, _ptr(base.n_used),
            _ptr(base.overflow), _ptr(base.oldest), _ptr(delta.keys),
            _ptr(delta.versions), cd, _ptr(delta.overflow),
            _ptr(delta.n_used), _ptr(delta.oldest))
    if demand is None:
        _call("step_compact", "sc_fold", dev, *args, int(reset_delta),
              _ptr(floor), _ptr(need), _ptr(scratch), _ptr(ws))
    elif need is None or not reset_delta:
        raise ValueError("the gated step writes need and resets the delta")
    else:
        _call("step_compact", "sc_fold_step", dev, *args, _ptr(floor),
              int(demand), _ptr(need), _ptr(scratch), _ptr(ws))


def fold_need(base_versions, delta, floor, demand: int) -> torch.Tensor:
    """The gated fold's decision as a 0-dim bool on the card (one launch,
    no host sync): ``delta.n_used + demand > Cd`` or at least max(C // 8,
    1) of ``base_versions`` in (NEG_VERSION, floor]. Any key width."""
    c = base_versions.shape[0]
    _check(base_versions, _i32, "base.versions", (c,))
    _check(delta.n_used, _i32, "delta.n_used", ())
    _check(floor, _i32, "floor", ())
    dev = base_versions.device
    need = torch.empty((), dtype=_bool, device=dev)
    _call("step_compact", "sc_need", dev, _ptr(base_versions), c, _ptr(floor),
          _ptr(delta.n_used), int(demand), delta.keys.shape[0], _ptr(need),
          _ptr(_workspace(dev, 0)[0]))
    return need


def reset_delta(delta, floor, need) -> None:
    """``_reset_delta`` in place at any key width (gated on ``need``; None
    means always): one launch. K4's fold fuses it; K13's fold needs it."""
    cd, w = delta.keys.shape
    _check(delta.keys, _i32, "delta.keys")
    _check(delta.versions, _i32, "delta.versions", (cd,))
    _check(delta.n_used, _i32, "delta.n_used", ())
    _check(delta.oldest, _i32, "delta.oldest", ())
    _check(floor, _i32, "floor", ())
    if need is not None:
        _check(need, _bool, "need", ())
    _call("step_compact", "sc_reset", delta.keys.device, _ptr(delta.keys), cd,
          w, _ptr(delta.versions), _ptr(delta.n_used), _ptr(delta.oldest),
          _ptr(floor), _ptr(need))


def compact(skeys, newv, c_out: int, prior_overflow):
    """_dedup_compact of sorted width-1 keys: (keys [c_out, 1], versions
    [c_out], n_used, overflow)."""
    n = skeys.shape[0]
    _check(skeys, _i32, "skeys", (n, 1))
    _check(newv, _i32, "newv", (n,))
    _check(prior_overflow, _bool, "prior_overflow", ())
    if n < 1 or c_out < 1:
        raise ValueError("compact needs n >= 1 and c_out >= 1")
    dev = skeys.device
    ok = torch.empty((c_out, 1), dtype=_i32, device=dev)
    ov = torch.empty(c_out, dtype=_i32, device=dev)
    n_used = torch.empty((), dtype=_i32, device=dev)
    overflow = torch.empty((), dtype=_bool, device=dev)
    _call("step_compact", "sc_compact", dev, _ptr(skeys), _ptr(newv), n, c_out,
          _ptr(prior_overflow), _ptr(ok), _ptr(ov), _ptr(n_used),
          _ptr(overflow), _ptr(_workspace(dev, n)[0]))
    return ok, ov, n_used, overflow


# ----------------------------------------------------------------- K5, K6

# K6's stats build writes these int64 counters (wave.cu, WV_CLK_*): the
# prologue's and the level kernel's globaltimer spans (ns), the level
# kernel's clock64 cycles by phase, then counts of the whole leveling.
WAVE_CLOCKS = ("prologue_t0", "prologue_t1", "level_t0", "level_t1",
               "cycles", "init", "wave_rounds", "stall_rounds",
               "stall_prefix", "stall_walk", "stall_rescan", "stall_release",
               "walk_steps", "prefix_reused", "rescans", "rescan_words",
               "decrements")


def _wave_scratch(bp: int) -> int:
    """int32 words of K6's scratch (wv_level in wave.cu): the successor
    rows, the in-degrees, the round state and the first wave."""
    nw = bp // 32
    return bp * nw + 5 * bp + 3 * nw


# wave.cu's K5: writer rows a block; shared bytes its tile may fill.
PRED_ROWS = 256
_PRED_SMEM = 48 * 1024


def wave_pred_tile(r: int, q: int, nw: int) -> int:
    """Words of K5's reader tile (wave.cu ``pred_tile``): up to 32, fewer
    when 32 read intervals a word of ``r`` slots would pass 48 KB beside
    the block's ``PRED_ROWS`` rows of ``q`` write intervals; at most the
    ``nw`` words of a row."""
    fixed = PRED_ROWS * 8 * q + 32 * 4
    tw = (_PRED_SMEM - fixed) // (256 * r) if r > 0 else 32
    return min(max(tw, 1), 32, nw)


def wave_pred(cand, rb, re_, read_live, wb, we, write_live, out=None):
    """Packed predecessor rows int32 [BP, BP/32], BP = B rounded up to 32
    (bit i of row j: a read of txn i overlaps a write of txn j; candidate
    columns only, diagonal clear); written into ``out`` when given."""
    b, r, q = _check_ranks(rb, re_, read_live, wb, we, write_live)
    _check(cand, _bool, "cand", (b,))
    bp = (b + 31) // 32 * 32
    rows = out
    if rows is None:
        rows = torch.empty((bp, bp // 32), dtype=_i32, device=cand.device)
    _check(rows, _i32, "rows", (bp, bp // 32))
    _call("wave", "wv_pred", cand.device, _ptr(cand), _ptr(rb), _ptr(re_),
          _ptr(read_live), _ptr(wb), _ptr(we), _ptr(write_live), b, r, q, bp,
          _ptr(rows))
    return rows


def wave_level(cand, p, too_old=None, txn_mask=None, stats=None, level=None,
               verdicts=None, clocks=None):
    """(accepted bool [B], level int32 [B], verdicts int8 [B] or None):
    the wave schedule of the candidates over the packed predecessor rows
    ``p``; the verdicts need ``too_old`` and ``txn_mask``. ``level`` and
    ``verdicts`` are written in place when given; ``stats`` (int64 [5])
    accumulates (batches, rounds, victims, max rounds, max victims).
    ``clocks`` (int64 [len(WAVE_CLOCKS)]) runs the stats build and takes
    this launch's phase counters. Any batch size: the round state moves to
    global scratch when it outgrows shared memory."""
    b = cand.shape[0]
    bp = p.shape[0]
    _check(cand, _bool, "cand", (b,))
    _check(p, _i32, "p", (bp, bp // 32))
    if bp % 32 or bp < b:
        raise ValueError(f"p: {bp} rows for {b} txns (want a multiple of 32)")
    dev = cand.device
    if level is None:
        level = torch.empty(b, dtype=_i32, device=dev)
    _check(level, _i32, "level", (b,))
    if (too_old is None) != (txn_mask is None):
        raise ValueError("the verdicts need both too_old and txn_mask")
    if too_old is not None:
        _check(too_old, _bool, "too_old", (b,))
        _check(txn_mask, _bool, "txn_mask", (b,))
        if verdicts is None:
            verdicts = torch.empty(b, dtype=_i8, device=dev)
        _check(verdicts, _i8, "verdicts", (b,))
    elif verdicts is not None:
        raise ValueError("verdicts need too_old and txn_mask")
    if stats is not None:
        _check(stats, _i64, "stats", (5,))
    if clocks is not None:
        _check(clocks, _i64, "clocks", (len(WAVE_CLOCKS),))
    accepted = torch.empty(b, dtype=_bool, device=dev)
    scratch = torch.empty(_wave_scratch(bp), dtype=_i32, device=dev)
    _call("wave", "wv_level", dev, _ptr(p), _ptr(cand), _ptr(too_old),
          _ptr(txn_mask), b, bp, _ptr(level), _ptr(accepted), _ptr(verdicts),
          _ptr(stats), _ptr(scratch), _ptr(clocks))
    return accepted, level, verdicts


# ----------------------------------------------------------------- K8-K10


def shard_clip_out(s: int, b: int, r: int, q: int, reads: bool, device):
    """K9's outputs, carved from ONE allocation: (write_begin, write_end
    int32 [S, B, Q], write_mask bool [S, B, Q], read_begin, read_end int32
    [S, B, R], read_mask bool [S, B, R]), the read three None unless
    ``reads``. The int32 views come first, so each starts 16-byte aligned
    when S·B·Q and S·B·R are multiples of 4 (K9's vector path)."""
    nq, nr = s * b * q, (s * b * r if reads else 0)
    buf = torch.empty(4 * (2 * nq + 2 * nr) + nq + nr, dtype=torch.uint8,
                      device=device)
    ints = buf[:4 * (2 * nq + 2 * nr)].view(_i32)
    masks = buf[4 * (2 * nq + 2 * nr):].view(_bool)
    out = [ints[:nq].view(s, b, q), ints[nq:2 * nq].view(s, b, q),
           masks[:nq].view(s, b, q)]
    if not reads:
        return tuple(out) + (None, None, None)
    return tuple(out) + (ints[2 * nq:2 * nq + nr].view(s, b, r),
                         ints[2 * nq + nr:].view(s, b, r),
                         masks[nq:].view(s, b, r))


def check_shard_clip(rb, re_, read_mask, wb, we, write_mask, lo, hi,
                     reads: bool, out) -> None:
    """K9's checks of a batch of rank arrays ([B, R] / [B, Q], or a window
    of them, [k, B, R] / [k, B, Q]: every step's slice is then contiguous
    too), the shard bounds and the outputs ``out`` (``shard_clip_out``)."""
    lead = rb.shape[:-2]
    b, r = rb.shape[-2:]
    q = wb.shape[-1]
    _check(rb, _i32, "read_begin")
    _check(re_, _i32, "read_end", (*lead, b, r))
    _check(read_mask, _bool, "read_mask", (*lead, b, r))
    _check(wb, _i32, "write_begin", (*lead, b, q))
    _check(we, _i32, "write_end", (*lead, b, q))
    _check(write_mask, _bool, "write_mask", (*lead, b, q))
    s = lo.shape[0]
    _check(lo, _i32, "shard_lo", (s,))
    _check(hi, _i32, "shard_hi", (s,))
    for name, t, dtype, width in (
            ("write_begin", out[0], _i32, q), ("write_end", out[1], _i32, q),
            ("write_mask", out[2], _bool, q), ("read_begin", out[3], _i32, r),
            ("read_end", out[4], _i32, r), ("read_mask", out[5], _bool, r)):
        if t is None:
            if reads:
                raise ValueError(f"out {name}: needed with reads")
            continue
        _check(t, dtype, f"out {name}", (s, b, width))


def shard_clip_into(rb, re_, read_mask, wb, we, write_mask, lo, hi,
                    reads: bool, out) -> None:
    """K9 into ``out``, unchecked: the window program's launch of each
    step, after ``check_shard_clip`` of the window's arrays."""
    s, b, q = out[0].shape
    _call("shard", "sh_clip", lo.device, rb.data_ptr(), re_.data_ptr(),
          read_mask.data_ptr(), wb.data_ptr(), we.data_ptr(),
          write_mask.data_ptr(), b, rb.shape[-1], q, lo.data_ptr(),
          hi.data_ptr(), s, int(reads), out[0].data_ptr(),
          out[1].data_ptr(), out[2].data_ptr(), _ptr(out[3]), _ptr(out[4]),
          _ptr(out[5]))


def shard_clip(rb, re_, read_mask, wb, we, write_mask, lo, hi, reads: bool):
    """K9: the batch clipped to each shard's rank interval [lo[s], hi[s]):
    (write_begin, write_end int32 [S, B, Q], write_mask bool [S, B, Q],
    read_begin, read_end int32 [S, B, R], read_mask bool [S, B, R]); the
    read three are None unless ``reads``. A clipped mask is the mask and
    begin < end after the clamp."""
    b, r = rb.shape
    out = shard_clip_out(lo.shape[0], b, r, wb.shape[1], reads, lo.device)
    check_shard_clip(rb, re_, read_mask, wb, we, write_mask, lo, hi, reads,
                     out)
    shard_clip_into(rb, re_, read_mask, wb, we, write_mask, lo, hi, reads,
                    out)
    return out


def shard_probe(keys, table, read_begin, read_end, read_mask, read_version,
                txn_mask, lo, hi, floor):
    """K8: (too_old bool [B], hist_conflict bool [B], cand bool [B]) over
    the S flat shard histories ``keys`` [S, C, 1] with ``table`` the
    sparse table [L, S*C] of their versions; ``floor`` (0-dim) is the
    too-old floor."""
    s, c = keys.shape[0], keys.shape[1]
    b, r = read_begin.shape
    _check(keys, _i32, "keys", (s, c, 1))
    _check(table, _i32, "table", (table_levels(s * c), s * c))
    _check(read_begin, _i32, "read_begin")
    _check(read_end, _i32, "read_end", (b, r))
    _check(read_mask, _bool, "read_mask", (b, r))
    _check(read_version, _i32, "read_version", (b,))
    _check(txn_mask, _bool, "txn_mask", (b,))
    _check(lo, _i32, "shard_lo", (s,))
    _check(hi, _i32, "shard_hi", (s,))
    _check(floor, _i32, "floor", ())
    dev = keys.device
    words = torch.empty((b + 31) // 32, dtype=_i32, device=dev)
    too_old, hist, cand = (torch.empty(b, dtype=_bool, device=dev)
                           for _ in range(3))
    _call("shard", "sh_probe", dev, _ptr(keys), c, _ptr(table), s,
          _ptr(read_begin), _ptr(read_end), _ptr(read_mask),
          _ptr(read_version), _ptr(txn_mask), _ptr(lo), _ptr(hi),
          _ptr(floor), b, r, _ptr(words), _ptr(too_old), _ptr(hist),
          _ptr(cand))
    return too_old, hist, cand


def wave_exchange(ps, stats=None):
    """K10: (the OR of the S packed predecessor matrices ``ps`` [S, BP,
    BP/32] as int32 [BP, BP/32], int32 [2] stats: the occupied 32x32-bit
    tiles summed over the shards, and S·(BP/32)·(BP/32)); the stats go
    into ``stats`` when given."""
    s, bp, nw = ps.shape
    _check(ps, _i32, "ps", (s, bp, bp // 32))
    if bp % 32 or bp == 0:
        raise ValueError(f"ps: {bp} rows (want a positive multiple of 32)")
    dev = ps.device
    if stats is None:
        stats = torch.empty(2, dtype=_i32, device=dev)
    _check(stats, _i32, "stats", (2,))
    p = torch.empty((bp, nw), dtype=_i32, device=dev)
    _call("shard", "sh_exchange", dev, _ptr(ps), s, bp, nw, _ptr(p),
          _ptr(stats))
    return p, stats


# ----------------------------------------------------------------- K11


def _check_words(words: torch.Tensor, nbits: int) -> tuple[int, int]:
    banks, nw = words.shape
    _check(words, _i32, "banks", (banks, (nbits + 31) // 32))
    return banks, nw


def admission_set(words, bank: int, idx, nbits: int) -> None:
    """In place: slot ``idx[i]`` (int64 [m], each in [0, nbits)) of bank
    ``bank`` set in the packed banks ``words`` int32 [banks, nw]."""
    banks, nw = _check_words(words, nbits)
    _check(idx, _i64, "idx", (idx.shape[0],))
    if not 0 <= bank < banks:
        raise ValueError(f"bank {bank} outside [0, {banks})")
    _call("admission", "ad_set", words.device, _ptr(words), nw, int(bank),
          _ptr(idx), idx.shape[0])


def admission_clear(words, bank: int) -> None:
    """In place: bank ``bank`` of the packed banks zeroed."""
    banks, nw = words.shape
    _check(words, _i32, "banks")
    if not 0 <= bank < banks:
        raise ValueError(f"bank {bank} outside [0, {banks})")
    _call("admission", "ad_clear", words.device, _ptr(words), nw, int(bank))


def admission_probe(words, idx, bank_mask, nbits: int):
    """bool [n]: all k slots of row i (``idx`` int64 [n, k]) set in some
    bank that ``bank_mask`` (bool [banks]) selects."""
    banks, nw = _check_words(words, nbits)
    n, k = idx.shape
    _check(idx, _i64, "idx", (n, k))
    _check(bank_mask, _bool, "bank_mask", (banks,))
    out = torch.empty(n, dtype=_bool, device=words.device)
    _call("admission", "ad_probe", words.device, _ptr(words), banks, nw,
          _ptr(idx), n, k, _ptr(bank_mask), _ptr(out))
    return out


def admission_count(words):
    """int32 [banks]: the set bits of each packed bank."""
    banks, nw = words.shape
    _check(words, _i32, "banks")
    counts = torch.zeros(banks, dtype=_i32, device=words.device)
    _call("admission", "ad_count", words.device, _ptr(words), banks, nw,
          _ptr(counts))
    return counts


# ----------------------------------------------------------------- K12


# word_probe.cu's search: 4 warps a block; blocks of one wave at full
# occupancy (132 SMs x 16 blocks); the SM's shared memory.
WP_THREADS = 128
WP_WAVE_BLOCKS = 132 * 16
_SM_SMEM, _BLOCK_SMEM = 233472, 232448
#: Branches of K12's search, in the order of its block counts (WP_DIRECT,
#: WP_STAGED, WP_GLOBAL in word_probe.cu).
WP_BRANCHES = ("direct", "staged", "global")


def word_search_plan(n1: int, c_sum: int, w: int) -> tuple[int, int]:
    """(tile, shared bytes) of K12's search of ``n1`` query rows of ``w``
    words into one or two histories of ``c_sum`` rows in all. A tile of 4
    or 8 queries (one or two a warp) while the grid fits one wave of
    4-warp blocks: each searched directly, no shared memory. Past that, a
    tile of 128 (one query a thread of the block): room for its query rows
    and the spans of an evenly spread sorted tile twice over (rows per
    query: 2·c_sum / n1), within one wave's share of the SM's 228 KB."""
    for tile in (4, 8):
        if -(-n1 // tile) <= WP_WAVE_BLOCKS:
            return tile, 0
    tile = 128
    per_sm = -(-(-(-n1 // tile)) // 132)  # blocks an SM holds at once
    # Each block also holds 1 KB the card reserves and the static words.
    cap = min(_BLOCK_SMEM, (_SM_SMEM // per_sm - 1024 - 128) // 128 * 128)
    want = tile * (-(-2 * c_sum // n1) + 1) * w * 4
    return tile, max(0, min(cap, want, c_sum * w * 4)) // 16 * 16


def word_search(keys0, dict_keys, keys1=None, live0=None, live1=None,
                stats=None, plan=None):
    """(ls0, rs0, ls1, rs1) int32 [N+1]: the left and right insertion
    points of every dictionary row ``dict_keys`` [N+1, W] in the sorted
    [C, W] ``keys0`` and, when given, ``keys1`` (else None, None).
    ``live0``/``live1``: 0-dim int32 live row counts of ``keys0``/``keys1``
    (their n_used), read on the device; rows at and past it must all be
    INT32_MAX words. None: every row counts as live. ``stats`` (int32
    [3]): adds the blocks of each branch (``WP_BRANCHES``). ``plan``:
    (tile, shared bytes) in place of :func:`word_search_plan`'s."""
    n1, w = dict_keys.shape
    _check(dict_keys, _i32, "dict_keys")
    c0 = keys0.shape[0]
    _check(keys0, _i32, "keys0", (c0, w))
    c1 = 0
    if keys1 is not None:
        c1 = keys1.shape[0]
        _check(keys1, _i32, "keys1", (c1, w))
    for name, live in (("live0", live0), ("live1", live1)):
        if live is not None:
            _check(live, _i32, name, ())
    if live1 is not None and keys1 is None:
        raise ValueError("live1 without keys1")
    if stats is not None:
        _check(stats, _i32, "stats", (len(WP_BRANCHES),))
    dev = dict_keys.device
    out = torch.empty((4 if keys1 is not None else 2, n1), dtype=_i32,
                      device=dev)
    ls0, rs0 = out[0], out[1]
    ls1, rs1 = (out[2], out[3]) if keys1 is not None else (None, None)
    tile, smem = plan or word_search_plan(n1, c0 + c1, w)
    if tile not in (4, 8, 16, 32, 64, 128) or not 0 <= smem <= _BLOCK_SMEM:
        raise ValueError(f"plan {(tile, smem)}: want a tile of 4..128 "
                         "queries (a power of two) and <= 227 KB")
    _call("word_probe", "wp_search", dev, _ptr(keys0), c0, _ptr(live0),
          _ptr(keys1), c1, _ptr(live1), _ptr(dict_keys), n1, w, tile, smem,
          _ptr(ls0), _ptr(rs0), _ptr(ls1), _ptr(rs1), _ptr(stats))
    return ls0, rs0, ls1, rs1


def word_probe(st0, ls0, rs0, st1, ls1, rs1, read_begin, read_end,
               read_mask, read_version, txn_mask, floor):
    """(too_old bool [B], hist_mask bool [B, R], cand bool [B]): the read
    slots' rank bounds gathered from K12's search of the base (``st0``
    its sparse table [L, C], ``ls0``/``rs0``) and, unless ``st1`` is None
    (a flat history), the delta's; ``floor`` is the 0-dim too-old floor."""
    b, r = read_begin.shape
    n1 = ls0.shape[0]
    c0 = st0.shape[1]
    _check(st0, _i32, "st0", (table_levels(c0), c0))
    _check(ls0, _i32, "ls0", (n1,))
    _check(rs0, _i32, "rs0", (n1,))
    c1 = 0
    if st1 is not None:
        c1 = st1.shape[1]
        _check(st1, _i32, "st1", (table_levels(c1), c1))
        _check(ls1, _i32, "ls1", (n1,))
        _check(rs1, _i32, "rs1", (n1,))
    _check(read_begin, _i32, "read_begin")
    _check(read_end, _i32, "read_end", (b, r))
    _check(read_mask, _bool, "read_mask", (b, r))
    _check(read_version, _i32, "read_version", (b,))
    _check(txn_mask, _bool, "txn_mask", (b,))
    _check(floor, _i32, "floor", ())
    dev = read_begin.device
    too_old = torch.empty(b, dtype=_bool, device=dev)
    cand = torch.empty(b, dtype=_bool, device=dev)
    hist_mask = torch.empty((b, r), dtype=_bool, device=dev)
    _call("word_probe", "wp_probe", dev, _ptr(st0), c0, _ptr(ls0), _ptr(rs0),
          _ptr(st1), c1, _ptr(ls1), _ptr(rs1), _ptr(read_begin),
          _ptr(read_end), _ptr(read_mask), _ptr(read_version),
          _ptr(txn_mask), _ptr(floor), b, r, _ptr(hist_mask), _ptr(too_old),
          _ptr(cand))
    return too_old, hist_mask, cand


# ----------------------------------------------------------------- K13


def _check_word_state(st, name: str):
    c, w = st.keys.shape
    _check(st.keys, _i32, f"{name}.keys", (c, w))
    _check(st.versions, _i32, f"{name}.versions", (c,))
    _check(st.n_used, _i32, f"{name}.n_used", ())
    _check(st.oldest, _i32, f"{name}.oldest", ())
    _check(st.overflow, _bool, f"{name}.overflow", ())
    return c, w


def word_paint(state, dict_keys, rs, wb, we, write_mask, accepted, paint_src,
               cv: int, floor) -> None:
    """Paint in place into ``state`` (a [C, W] ConflictState): the
    accepted writes' endpoints gathered from ``dict_keys`` [N+1, W] by
    rank, in the host's ``paint_src`` order, merged at their cross ranks
    ``rs`` [N+1] (K12's right search of the dictionary into the state)."""
    c, w = _check_word_state(state, "state")
    n1 = dict_keys.shape[0]
    b, q = wb.shape
    _check(dict_keys, _i32, "dict_keys", (n1, w))
    _check(rs, _i32, "rs", (n1,))
    _check(wb, _i32, "write_begin")
    _check(we, _i32, "write_end", (b, q))
    _check(write_mask, _bool, "write_mask", (b, q))
    _check(accepted, _bool, "accepted", (b,))
    _check(paint_src, _i32, "paint_src", (2 * b * q,))
    _check(floor, _i32, "floor", ())
    dev = wb.device
    n2 = 2 * b * q
    n = c + n2
    snew = torch.empty((n2, w), dtype=_i32, device=dev)
    mk = torch.empty((n, w), dtype=_i32, device=dev)
    mv, t0, t1 = _scratch(n, dev, 3)
    bsum = torch.empty((n + 1023) // 1024, dtype=_i32, device=dev)
    _call("word_compact", "wc_paint", dev, _ptr(state.keys),
          _ptr(state.versions), c, w, _ptr(state.n_used),
          _ptr(state.overflow), _ptr(state.oldest), _ptr(dict_keys), _ptr(rs),
          _ptr(wb), _ptr(we), _ptr(write_mask), _ptr(accepted),
          _ptr(paint_src), b, q, int(cv), _ptr(floor), _ptr(snew), _ptr(mk),
          _ptr(mv), _ptr(t0), _ptr(t1), _ptr(bsum))


def word_fold(base, delta, floor, need) -> None:
    """Fold the [Cd, W] ``delta`` into the [C, W] ``base`` in place
    (skipped on the device when the 0-dim bool ``need`` is False; None
    means always)."""
    c, w = _check_word_state(base, "base")
    cd, wd = _check_word_state(delta, "delta")
    if wd != w:
        raise ValueError(f"base width {w} != delta width {wd}")
    _check(floor, _i32, "floor", ())
    if need is not None:
        _check(need, _bool, "need", ())
    dev = base.keys.device
    n = c + cd
    mk = torch.empty((n, w), dtype=_i32, device=dev)
    mv, t0, t1 = _scratch(n, dev, 3)
    bsum = torch.empty((n + 1023) // 1024, dtype=_i32, device=dev)
    _call("word_compact", "wc_fold", dev, _ptr(base.keys),
          _ptr(base.versions), c, w, _ptr(base.n_used), _ptr(base.overflow),
          _ptr(base.oldest), _ptr(delta.keys), _ptr(delta.versions), cd,
          _ptr(delta.overflow), _ptr(floor), _ptr(need), _ptr(mk), _ptr(mv),
          _ptr(t0), _ptr(t1), _ptr(bsum))


def word_compact(skeys, newv, c_out: int, prior_overflow):
    """_dedup_compact of sorted [n, W] rows: (keys [c_out, W], versions
    [c_out], n_used, overflow)."""
    n, w = skeys.shape
    _check(skeys, _i32, "skeys", (n, w))
    _check(newv, _i32, "newv", (n,))
    _check(prior_overflow, _bool, "prior_overflow", ())
    if n < 1 or c_out < 1:
        raise ValueError("compact needs n >= 1 and c_out >= 1")
    dev = skeys.device
    ok = torch.empty((c_out, w), dtype=_i32, device=dev)
    ov = torch.empty(c_out, dtype=_i32, device=dev)
    n_used = torch.empty((), dtype=_i32, device=dev)
    overflow = torch.empty((), dtype=_bool, device=dev)
    t0, t1 = _scratch(n, dev, 2)
    bsum = torch.empty((n + 1023) // 1024, dtype=_i32, device=dev)
    _call("word_compact", "wc_compact", dev, _ptr(skeys), _ptr(newv), n, w,
          c_out, _ptr(prior_overflow), _ptr(ok), _ptr(ov), _ptr(n_used),
          _ptr(overflow), _ptr(t0), _ptr(t1), _ptr(bsum))
    return ok, ov, n_used, overflow


def word_paint_keys(wb, we, write_mask, accepted):
    """(keys int32 [2BQ, W], delta int32 [2BQ]): the accepted writes'
    endpoint rows of [B, Q, W] ``wb``/``we``, begins then ends, a rejected
    or empty write on the +inf row with delta 0 (the unpacked paint's
    new endpoints)."""
    b, q, w = wb.shape
    _check(wb, _i32, "write_begin")
    _check(we, _i32, "write_end", (b, q, w))
    _check(write_mask, _bool, "write_mask", (b, q))
    _check(accepted, _bool, "accepted", (b,))
    dev = wb.device
    keys = torch.empty((2 * b * q, w), dtype=_i32, device=dev)
    delta = torch.empty(2 * b * q, dtype=_i32, device=dev)
    _call("word_compact", "wc_paint_keys", dev, _ptr(wb), _ptr(we),
          _ptr(write_mask), _ptr(accepted), b, q, w, _ptr(keys), _ptr(delta))
    return keys, delta


def word_paint_sorted(state, snew, sdelta, scross, cv: int, floor) -> None:
    """The unpacked paint's tail in place into ``state`` (a [C, W]
    ConflictState): the sorted new rows ``snew`` [n2, W] with their
    coverage deltas and cross ranks into the state (K14's output) merged
    in, the commit version painted where coverage is positive, GC to the
    0-dim ``floor``, compaction: two launches over the live rows
    [0, ``n_used``) only, which relies on every row past ``n_used``
    holding (+inf, NEG_VERSION), as every writer of a history leaves it.
    K4's workspace holds the look-back state and the scratch."""
    c, w = _check_word_state(state, "state")
    n2 = snew.shape[0]
    _check(snew, _i32, "snew", (n2, w))
    _check(sdelta, _i32, "sdelta", (n2,))
    _check(scross, _i32, "scross", (n2,))
    _check(floor, _i32, "floor", ())
    dev = snew.device
    # Look-back words for K13's tiles, and the survivors' scratch.
    tiles = -(-(c + n2) // K13_TILE)
    ws, scratch = _workspace(dev, tiles * K4_TILE, c * (w + 1))
    _call("word_compact", "wc_paint_sorted", dev, _ptr(state.keys),
          _ptr(state.versions), c, w, _ptr(state.n_used),
          _ptr(state.overflow), _ptr(state.oldest), _ptr(snew), _ptr(sdelta),
          _ptr(scross), n2, int(cv), _ptr(floor), _ptr(scratch), _ptr(ws))


# ----------------------------------------------------------------- K14


def _sort_scratch(n: int, w: int, dev):
    """K14's scratch for n rows of w words, carved from K4's per-stream
    workspace (a K14 call needs it only while it runs): the tiles' sorted
    rows [n, w], their heads (int64 [n, 2]), original indices and slots
    [n], and each tile's first differing word. The views are kept per
    shape while the workspace's scratch stays the same, so a call's host
    cost is two lookups."""
    m = max(n, 1)
    sizes = (4 * m, m * w, m, m, n // 256 + 1)
    sc = _workspace(dev, 0, sum(sizes))[1]
    views = getattr(_WORKSPACE, "sort_views", None)
    if views is None or views[0] is not sc:
        views = _WORKSPACE.sort_views = (sc, {})
    got = views[1].get((n, w))
    if got is None:
        th, tk, ti, pos, tf = torch.split(sc[:sum(sizes)], sizes)
        got = views[1][n, w] = (tk.view(m, w), th.view(_i64).view(m, 2), ti,
                                pos, tf)
    return got


def word_sort(keys, payloads=()):
    """(sorted keys [N, W], [sorted payloads]): the stable lexicographic
    sort of the [N, W] int32 rows ``keys`` carrying up to four int32 [N]
    payload columns (lax.sort's order, equal rows in input order)."""
    n, w = keys.shape
    _check(keys, _i32, "keys", (n, w))
    if len(payloads) > 4:
        raise ValueError("at most four payload columns per sort")
    for i, p in enumerate(payloads):
        _check(p, _i32, f"payload[{i}]", (n,))
    dev = keys.device
    out = torch.empty_like(keys)
    outs = [torch.empty(n, dtype=_i32, device=dev) for _ in payloads]
    tk, th, ti, pos, tf = _sort_scratch(n, w, dev)
    ins = [_ptr(p) for p in payloads] + [None] * (4 - len(payloads))
    ptrs = [_ptr(o) for o in outs] + [None] * (4 - len(outs))
    _call("word_sort", "wso_sort", dev, _ptr(keys), n, w, *ins,
          len(payloads), _ptr(out), *ptrs, _ptr(tk), _ptr(th), _ptr(ti),
          _ptr(pos), _ptr(tf))
    return out, outs


def word_ranks(rb, re_, read_mask, wb, we, write_mask):
    """(rb, re int32 [B, R], read_live bool [B, R], wb, we int32 [B, Q],
    write_live bool [B, Q]): every endpoint row of the [B, R, W] reads and
    [B, Q, W] writes ranked into the sorted multiset of all of them
    (searchsorted left, so equal rows share a rank), and the liveness
    masks (mask and begin rank < end rank)."""
    b, r, w = rb.shape
    q = wb.shape[1]
    _check(rb, _i32, "read_begin", (b, r, w))
    _check(re_, _i32, "read_end", (b, r, w))
    _check(read_mask, _bool, "read_mask", (b, r))
    _check(wb, _i32, "write_begin", (b, q, w))
    _check(we, _i32, "write_end", (b, q, w))
    _check(write_mask, _bool, "write_mask", (b, q))
    dev = rb.device
    n = 2 * b * (r + q)
    ranks = torch.empty(n, dtype=_i32, device=dev)
    nr, nq = b * r, b * q
    orb, ore, owb, owe = (ranks[:nr].view(b, r), ranks[nr:2 * nr].view(b, r),
                          ranks[2 * nr:2 * nr + nq].view(b, q),
                          ranks[2 * nr + nq:].view(b, q))
    live = torch.empty(nr + nq, dtype=_bool, device=dev)
    rlive, wlive = live[:nr].view(b, r), live[nr:].view(b, q)
    tk, th, ti, _, tf = _sort_scratch(n, w, dev)
    _call("word_sort", "wso_ranks", dev, _ptr(rb), _ptr(re_), _ptr(wb),
          _ptr(we), nr, nq, w, _ptr(read_mask), _ptr(write_mask), _ptr(orb),
          _ptr(ore), _ptr(owb), _ptr(owe), _ptr(rlive), _ptr(wlive),
          _ptr(tk), _ptr(th), _ptr(ti), _ptr(tf))
    return orb, ore, rlive, owb, owe, wlive


# ----------------------------------------------------------------- K15, K16


def word_clip(rb, re_, read_mask, wb, we, write_mask, lo, hi, reads: bool):
    """K15: the [B, ., W] full-key batch clipped to each shard's [lo[s],
    hi[s]) (``lo``/``hi`` [S, W]): (write_begin, write_end int32 [S, B, Q,
    W], write_mask bool [S, B, Q], read_begin, read_end int32 [S, B, R,
    W], read_mask bool [S, B, R]); the read three are None unless
    ``reads``. A clipped mask is the mask and begin < end after the
    clamp."""
    b, r, w = rb.shape
    q = wb.shape[1]
    _check(rb, _i32, "read_begin", (b, r, w))
    _check(re_, _i32, "read_end", (b, r, w))
    _check(read_mask, _bool, "read_mask", (b, r))
    _check(wb, _i32, "write_begin", (b, q, w))
    _check(we, _i32, "write_end", (b, q, w))
    _check(write_mask, _bool, "write_mask", (b, q))
    s = lo.shape[0]
    _check(lo, _i32, "shard_lo", (s, w))
    _check(hi, _i32, "shard_hi", (s, w))
    dev = lo.device
    owb, owe = (torch.empty((s, b, q, w), dtype=_i32, device=dev)
                for _ in range(2))
    owm = torch.empty((s, b, q), dtype=_bool, device=dev)
    orb = ore = orm = None
    if reads:
        orb, ore = (torch.empty((s, b, r, w), dtype=_i32, device=dev)
                    for _ in range(2))
        orm = torch.empty((s, b, r), dtype=_bool, device=dev)
    _call("word_shard", "wsh_clip", dev, _ptr(rb), _ptr(re_),
          _ptr(read_mask), _ptr(wb), _ptr(we), _ptr(write_mask), b, r, q, w,
          _ptr(lo), _ptr(hi), s, int(reads), _ptr(owb), _ptr(owe),
          _ptr(owm), _ptr(orb), _ptr(ore), _ptr(orm))
    return owb, owe, owm, orb, ore, orm


def word_shard_probe(keys, table, read_begin, read_end, read_mask,
                     read_version, txn_mask, lo, hi, floor):
    """K16: (too_old bool [B], hist_mask bool [B, R], hist_conflict bool
    [B], cand bool [B]) over the S flat [C, W] shard histories ``keys``
    [S, C, W], ``table`` the sparse table [L, S*C] of their versions; each
    read slot is clipped to the shard's [lo[s], hi[s]) (``lo``/``hi``
    [S, W], or both None for no clip); ``hist_mask`` ORs a slot's conflict
    over the shards; ``floor`` (0-dim) is the too-old floor."""
    s, c, w = keys.shape
    b, r, _ = read_begin.shape
    _check(keys, _i32, "keys", (s, c, w))
    _check(table, _i32, "table", (table_levels(s * c), s * c))
    _check(read_begin, _i32, "read_begin", (b, r, w))
    _check(read_end, _i32, "read_end", (b, r, w))
    _check(read_mask, _bool, "read_mask", (b, r))
    _check(read_version, _i32, "read_version", (b,))
    _check(txn_mask, _bool, "txn_mask", (b,))
    if (lo is None) != (hi is None):
        raise ValueError("shard bounds: give both lo and hi, or neither")
    if lo is not None:
        _check(lo, _i32, "shard_lo", (s, w))
        _check(hi, _i32, "shard_hi", (s, w))
    _check(floor, _i32, "floor", ())
    dev = keys.device
    hist_mask = torch.empty((b, r), dtype=_bool, device=dev)
    too_old, hist, cand = (torch.empty(b, dtype=_bool, device=dev)
                           for _ in range(3))
    _call("word_shard", "wsh_probe", dev, _ptr(keys), c, w, _ptr(table), s,
          _ptr(read_begin), _ptr(read_end), _ptr(read_mask),
          _ptr(read_version), _ptr(txn_mask), _ptr(lo), _ptr(hi),
          _ptr(floor), b, r, _ptr(hist_mask), _ptr(too_old), _ptr(hist),
          _ptr(cand))
    return too_old, hist_mask, hist, cand


# ----------------------------------------------------------------- K17


def blocked_build(values):
    """(prefix int32 [NB, 256], suffix int32 [NB, 256], top int32 [L, NB]):
    the blocked structure over ``values`` [N] (K17's build, then K2's
    sparse-table build in place over the block maxima)."""
    n = values.shape[0]
    _check(values, _i32, "values", (n,))
    if n == 0:
        raise ValueError("blocked_build needs n >= 1")
    nb = -(-n // RMQ_BLOCK)
    dev = values.device
    prefix = torch.empty((nb, RMQ_BLOCK), dtype=_i32, device=dev)
    suffix = torch.empty((nb, RMQ_BLOCK), dtype=_i32, device=dev)
    top = torch.empty((table_levels(nb), nb), dtype=_i32, device=dev)
    _call("rmq_blocked", "rb_build", dev, _ptr(values), n, nb, _ptr(prefix),
          _ptr(suffix), _ptr(top))
    build_table(top[0], out=top)
    return prefix, suffix, top


def _check_blocked(values, table):
    n = values.shape[0]
    prefix, suffix, top = table
    nb = -(-n // RMQ_BLOCK)
    _check(values, _i32, "values", (n,))
    _check(prefix, _i32, "prefix", (nb, RMQ_BLOCK))
    _check(suffix, _i32, "suffix", (nb, RMQ_BLOCK))
    _check(top, _i32, "top", (table_levels(nb), nb))
    return n, nb


def blocked_query(values, table, lo, hi):
    """int32 [Nq]: max(values[lo:hi]) per query over the blocked structure
    ``table`` (blocked_build's), empty -> NEG_VERSION, out-of-range
    indices clamped as the JAX range_max_blocked clamps them."""
    n, nb = _check_blocked(values, table)
    nq = lo.shape[0]
    _check(lo, _i32, "lo", (nq,))
    _check(hi, _i32, "hi", (nq,))
    prefix, suffix, top = table
    out = torch.empty(nq, dtype=_i32, device=values.device)
    _call("rmq_blocked", "rb_query", values.device, _ptr(values), n,
          _ptr(prefix), _ptr(suffix), _ptr(top), nb, top.shape[0], _ptr(lo),
          _ptr(hi), nq, _ptr(out))
    return out


def blocked_probe(values, table, rs_d, ls_d, rows_b, rows_e, read_mask,
                  read_version, txn_mask, floor, base_st=None, rs_b=None,
                  ls_b=None, idx_b=None, idx_e=None):
    """(too_old bool [B], hist_mask bool [B, R], cand bool [B]): the history
    probe whose newest write per read slot is the blocked range max over
    ``values`` (``table`` blocked_build's) at [max(rs_d - 1, 0), ls_d),
    and, with ``base_st`` (a base's sparse table [L, C]), also the base's
    at [max(rs_b - 1, 0), ls_b). The bounds arrays are indexed by the slot
    (a search of the slots' own endpoints) or, with ``idx_b``/``idx_e``
    (the slots' dictionary ranks, int32 [B, R]), by its rank. A slot is
    live when its mask is set and ``rows_b`` < ``rows_e`` ([B, R, W]
    endpoint rows, or [B, R] ranks)."""
    n, nb = _check_blocked(values, table)
    b, r = read_mask.shape
    w = 1 if rows_b.dim() == 2 else rows_b.shape[2]
    _check(rows_b, _i32, "rows_b", tuple(rows_b.shape))
    _check(rows_e, _i32, "rows_e", tuple(rows_b.shape))
    if rows_b.shape[:2] != (b, r):
        raise ValueError(f"rows_b: expected [{b}, {r}(, W)], got "
                         f"{tuple(rows_b.shape)}")
    _check(read_mask, _bool, "read_mask", (b, r))
    _check(read_version, _i32, "read_version", (b,))
    _check(txn_mask, _bool, "txn_mask", (b,))
    _check(floor, _i32, "floor", ())
    m = rs_d.shape[0]
    _check(rs_d, _i32, "rs_d", (m,))
    _check(ls_d, _i32, "ls_d", (m,))
    if (idx_b is None) != (idx_e is None):
        raise ValueError("give both rank arrays, or neither")
    if idx_b is None and m != b * r:
        raise ValueError(f"bounds by slot need {b * r} rows, got {m}")
    if idx_b is not None:
        _check(idx_b, _i32, "idx_b", (b, r))
        _check(idx_e, _i32, "idx_e", (b, r))
    cb = lb = 0
    if base_st is not None:
        lb, cb = base_st.shape
        _check(base_st, _i32, "base_st", (table_levels(cb), cb))
        _check(rs_b, _i32, "rs_b", (m,))
        _check(ls_b, _i32, "ls_b", (m,))
    prefix, suffix, top = table
    dev = read_mask.device
    too_old = torch.empty(b, dtype=_bool, device=dev)
    cand = torch.empty(b, dtype=_bool, device=dev)
    hist_mask = torch.empty((b, r), dtype=_bool, device=dev)
    _call("rmq_blocked", "rb_probe", dev, _ptr(base_st), cb, lb, _ptr(rs_b),
          _ptr(ls_b), _ptr(values), n, _ptr(prefix), _ptr(suffix), _ptr(top),
          nb, top.shape[0], _ptr(rs_d), _ptr(ls_d), _ptr(idx_b), _ptr(idx_e),
          _ptr(rows_b), _ptr(rows_e), w, _ptr(read_mask), _ptr(read_version),
          _ptr(txn_mask), _ptr(floor), b, r, _ptr(hist_mask), _ptr(too_old),
          _ptr(cand))
    return too_old, hist_mask, cand


def blocked_shard_probe(keys, values, table, read_begin, read_end, read_mask,
                        read_version, txn_mask, lo, hi, floor):
    """(too_old bool [B], hist_mask bool [B, R], hist_conflict bool [B],
    cand bool [B]): K16's sharded probe with K17's range max. ``keys``
    [S, C, W] are the S flat shard histories, ``values`` [S*C] their
    versions as one array and ``table`` blocked_build's structure over it;
    the read rows ``read_begin``/``read_end`` [B, R, W] are clipped to each
    shard's [lo[s], hi[s]) (``lo``/``hi`` [S, W], or both None for no
    clip); ``hist_mask`` ORs a slot's conflict over the shards; ``floor``
    (0-dim) is the too-old floor. Ranks are rows of W = 1."""
    s, c, w = keys.shape
    b, r, _ = read_begin.shape
    n, nb = _check_blocked(values, table)
    if n != s * c:
        raise ValueError(f"values: expected {s * c} versions, got {n}")
    _check(keys, _i32, "keys", (s, c, w))
    _check(read_begin, _i32, "read_begin", (b, r, w))
    _check(read_end, _i32, "read_end", (b, r, w))
    _check(read_mask, _bool, "read_mask", (b, r))
    _check(read_version, _i32, "read_version", (b,))
    _check(txn_mask, _bool, "txn_mask", (b,))
    if (lo is None) != (hi is None):
        raise ValueError("shard bounds: give both lo and hi, or neither")
    if lo is not None:
        _check(lo, _i32, "shard_lo", (s, w))
        _check(hi, _i32, "shard_hi", (s, w))
    _check(floor, _i32, "floor", ())
    prefix, suffix, top = table
    dev = keys.device
    hist_mask = torch.empty((b, r), dtype=_bool, device=dev)
    too_old, hist, cand = (torch.empty(b, dtype=_bool, device=dev)
                           for _ in range(3))
    _call("rmq_blocked", "rb_shard_probe", dev, _ptr(keys), c, w,
          _ptr(values), n, _ptr(prefix), _ptr(suffix), _ptr(top), nb,
          top.shape[0], s, _ptr(read_begin), _ptr(read_end), _ptr(read_mask),
          _ptr(read_version), _ptr(txn_mask), _ptr(lo), _ptr(hi),
          _ptr(floor), b, r, _ptr(hist_mask), _ptr(too_old), _ptr(hist),
          _ptr(cand))
    return too_old, hist_mask, hist, cand
