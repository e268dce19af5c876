"""ctypes bindings of the hand-written CUDA kernels, with their launch counts.

Each wrapper checks device, dtype, shape and contiguity, allocates outputs
and scratch with ``torch.empty``, launches on the current CUDA stream, and
raises if the C entry returns a CUDA error. ``LAUNCHES`` holds one integer
per kernel source, ``ENTRY_LAUNCHES`` one per C entry point; a wrapper
adds one to both where it calls into its library and nowhere else. The
libraries are built (build.py) the first time any wrapper runs, never at
import.
"""

from __future__ import annotations

import ctypes
import math

import torch

from foundationdb_tpu_torch.kernels import build

LAUNCHES = {name: 0 for name in build.SOURCES}
ENTRY_LAUNCHES: dict[str, int] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "dict_insert": {
        "di_insert": [_P, _I, _P, _I, _I, _P, _P, _P],
        "di_rewrite": [_P, _I, _P, _I, _P, _I, _P, _I, _P, _I, _I, _P],
        "di_rebase": [_P, _I, _P, _I, _I, _P],
    },
    "history_probe": {
        "hp_table": [_P, _I, _I, _P, _P, _P],
        "hp_probe": [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                     _P, _P, _P, _P],
    },
    "accept": {
        "ac_accept": [_P] * 9 + [_I] * 3 + [_P] * 4,
        "ac_losers": [_P] * 9 + [_I] * 3 + [_P] * 3,
    },
    "step_compact": {
        "sc_paint": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                     _P, _P, _P, _P, _P, _P, _P, _P],
        "sc_fold": [_P, _P, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                    _P, _P, _P, _P],
        "sc_compact": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    },
}
_LIBS: dict[str, ctypes.CDLL] = {}


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
        _LIBS[name] = lib


def _call(source: str, fn: str, device: torch.device, *args) -> None:
    ensure_built()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(_LIBS[source], fn)(*args, stream)
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


_i32, _bool, _i8 = torch.int32, torch.bool, torch.int8


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
    shift = torch.empty(d1, dtype=_i32, device=dict_keys.device)
    _call("dict_insert", "di_insert", dict_keys.device, _ptr(dict_keys), d1,
          _ptr(delta_keys), m, w, _ptr(shift), _ptr(out))
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


# ----------------------------------------------------------------- K2


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
    _call("history_probe", "hp_table", values.device, _ptr(values), n, levels,
          _ptr(out), _ptr(need))
    return out


def history_probe(base_keys, base_st, delta_keys, delta_st, read_begin,
                  read_end, read_mask, read_version, txn_mask, floor):
    """(too_old bool [B], hist_mask bool [B, R], cand bool [B])."""
    b, r = read_begin.shape
    c, cd = base_keys.shape[0], delta_keys.shape[0]
    _check(base_keys, _i32, "base.keys", (c, 1))
    _check(base_st, _i32, "base_st", (table_levels(c), c))
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


def accept(cand, too_old, txn_mask, rb, re_, read_live, wb, we, write_live,
           verdicts=None):
    """(accepted bool [B], verdicts int8 [B]); the verdicts are written
    into ``verdicts`` when it is given."""
    b, r, q = _check_ranks(rb, re_, read_live, wb, we, write_live)
    for name, t in (("cand", cand), ("too_old", too_old),
                    ("txn_mask", txn_mask)):
        _check(t, _bool, name, (b,))
    dev = cand.device
    rows = torch.empty(b * ((b + 31) // 32), dtype=_i32, device=dev)
    accepted = torch.empty(b, dtype=_bool, device=dev)
    if verdicts is None:
        verdicts = torch.empty(b, dtype=_i8, device=dev)
    _check(verdicts, _i8, "verdicts", (b,))
    _call("accept", "ac_accept", dev, _ptr(cand), _ptr(too_old),
          _ptr(txn_mask), _ptr(rb), _ptr(re_), _ptr(read_live), _ptr(wb),
          _ptr(we), _ptr(write_live), b, r, q, _ptr(rows), _ptr(accepted),
          _ptr(verdicts))
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


def paint(state, wb, we, write_mask, accepted, paint_src, cv: int,
          floor) -> None:
    """Paint in place into ``state`` (a width-1 ConflictState)."""
    c = _check_state(state, "state")
    b, q = wb.shape
    _check(wb, _i32, "write_begin")
    _check(we, _i32, "write_end", (b, q))
    _check(write_mask, _bool, "write_mask", (b, q))
    _check(accepted, _bool, "accepted", (b,))
    _check(paint_src, _i32, "paint_src", (2 * b * q,))
    _check(floor, _i32, "floor", ())
    dev = wb.device
    n = c + 2 * b * q
    snew, mk, mv, t0, t1 = _scratch(2 * b * q, dev, 1) + _scratch(n, dev, 4)
    bsum = torch.empty((n + 1023) // 1024, dtype=_i32, device=dev)
    _call("step_compact", "sc_paint", dev, _ptr(state.keys),
          _ptr(state.versions), c, _ptr(state.n_used), _ptr(state.overflow),
          _ptr(state.oldest), _ptr(wb), _ptr(we), _ptr(write_mask),
          _ptr(accepted), _ptr(paint_src), b, q, int(cv), _ptr(floor),
          _ptr(snew), _ptr(mk), _ptr(mv), _ptr(t0), _ptr(t1), _ptr(bsum))


def fold(base, delta, floor, need) -> None:
    """Fold ``delta`` into ``base`` in place (skipped on the device when the
    0-dim bool ``need`` is False; None means always)."""
    c = _check_state(base, "base")
    cd = _check_state(delta, "delta")
    _check(floor, _i32, "floor", ())
    if need is not None:
        _check(need, _bool, "need", ())
    dev = base.keys.device
    n = c + cd
    mk, mv, t0, t1 = _scratch(n, dev, 4)
    bsum = torch.empty((n + 1023) // 1024, dtype=_i32, device=dev)
    _call("step_compact", "sc_fold", dev, _ptr(base.keys),
          _ptr(base.versions), c, _ptr(base.n_used), _ptr(base.overflow),
          _ptr(base.oldest), _ptr(delta.keys), _ptr(delta.versions), cd,
          _ptr(delta.overflow), _ptr(floor), _ptr(need), _ptr(mk), _ptr(mv),
          _ptr(t0), _ptr(t1), _ptr(bsum))


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
    t0, t1 = _scratch(n, dev, 2)
    bsum = torch.empty((n + 1023) // 1024, dtype=_i32, device=dev)
    _call("step_compact", "sc_compact", dev, _ptr(skeys), _ptr(newv), n, c_out,
          _ptr(prior_overflow), _ptr(ok), _ptr(ov), _ptr(n_used),
          _ptr(overflow), _ptr(t0), _ptr(t1), _ptr(bsum))
    return ok, ov, n_used, overflow
