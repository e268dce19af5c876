"""The port's native libraries, built at first use: the wire packer
(keypack.cpp), the CPU SkipList conflict engine (skiplist.cpp, the
baseline of ``models/cpu_conflict_set.py``) and the Redwood-class
copy-on-write B+tree (btree.cpp, the ``ssd-redwood-1`` engine of
``runtime/kvstore.py``).

Each source is compiled with ``g++ -O3 -std=c++17 -shared -fPIC`` (the
skiplist and the B+tree also with ``-march=native``, as the JAX package
builds its copies) into ``_build/`` beside this file and loaded with ctypes. The
library name carries a hash of the source and its flags, so an edited
source is rebuilt and an unchanged one reused. There is no Python
fallback: a missing compiler or a failed build raises.

``count_txns`` validates a whole wire buffer; ``pack_batch`` packs ``count``
transactions from a byte offset into padded batch arrays that the caller
allocates (and keeps alive, C-contiguous, until their data is uploaded);
``pack_window`` packs k such batches and each one's sorted unique
endpoint-key dictionary and ranks (the non-resident engine's pack).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_VOIDP = ctypes.c_void_p
_I64P = ctypes.POINTER(ctypes.c_int64)
_I8P = ctypes.POINTER(ctypes.c_int8)
EXTRA_FLAGS = {"skiplist": ("-march=native",), "btree": ("-march=native",)}
# rw_scan's row callback: (key, key length, value, value length, context).
BTREE_SCAN_CB = ctypes.CFUNCTYPE(None, _VOIDP, ctypes.c_uint64, _VOIDP,
                                 ctypes.c_uint64, _VOIDP)
_KEYPACK = {
    "kp_pack_batch": [_U8P, _I64, _I64, _INT, _INT, _INT, _INT, _INT, _I64,
                      _I32P, _I32P, _U8P, _I32P, _I32P, _U8P, _I32P, _U8P],
    "kp_count_txns": [_U8P, _I64, _I64],
    "kp_pack_window": [_U8P, _I64, _I64, _INT, _INT, _INT, _INT, _INT, _INT,
                       _I64, _I32P, _I32P, _U8P, _I32P, _I32P, _U8P, _I32P,
                       _U8P, _I32P, _I32P, _I32P, _I32P, _I32P],
}
# (argtypes, restype) of each library's entries.
_SIGNATURES = {
    "keypack": {fn: (args, _I64) for fn, args in _KEYPACK.items()},
    "skiplist": {
        "cs_create": ([], _VOIDP),
        "cs_destroy": ([_VOIDP], None),
        "cs_node_count": ([_VOIDP], _I64),
        # blob, ranges [n, 4] (boff, blen, eoff, elen; a txn's reads, then
        # its writes), read counts, write counts, read versions, n, commit
        # version, oldest version, verdicts out (int8).
        "cs_resolve": ([_VOIDP, ctypes.c_char_p, _I64P, _I32P, _I32P, _I64P,
                        ctypes.c_int32, _I64, _I64, _I8P], None),
    },
    "btree": {
        "rw_open": ([ctypes.c_char_p], _VOIDP),
        "rw_durable_version": ([_VOIDP], _I64),
        # handle, n writes, key blob + offsets [n + 1], value blob +
        # offsets, tombstones (uint8) [n], n purges, purge begin blob +
        # offsets, purge end blob + offsets, version.
        "rw_flush": ([_VOIDP, _I64, _U8P, _I64P, _U8P, _I64P, _U8P, _I64,
                      _U8P, _I64P, _U8P, _I64P, _I64], _I64),
        "rw_scan": ([_VOIDP, BTREE_SCAN_CB, _VOIDP], _I64),
        "rw_page_count": ([_VOIDP], _I64),
        "rw_close": ([_VOIDP], None),
    },
}


def _flags(name: str) -> tuple:
    return CXX_FLAGS + EXTRA_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    h = hashlib.sha256((SRC_DIR / f"{name}.cpp").read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def _build(name: str) -> Path:
    out = library_path(name)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: the native {name} library "
                           "cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([cxx, *_flags(name), str(SRC_DIR / f"{name}.cpp"), "-o",
                        str(tmp)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed for {name}.cpp (exit "
                           f"{r.returncode}):\n{r.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built on the first call), its entries
    bound by ``_SIGNATURES``."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build(name)))
            for fn, (argtypes, restype) in _SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _LIBS[name] = lib
        return lib


def keypack() -> ctypes.CDLL:
    """The loaded keypack library (built on the first call)."""
    return load("keypack")


def skiplist() -> ctypes.CDLL:
    """The loaded CPU SkipList library (built on the first call)."""
    return load("skiplist")


def btree() -> ctypes.CDLL:
    """The loaded B+tree storage engine library (built on the first call)."""
    return load("btree")


def _ptr(a: np.ndarray, dtype, ctype):
    if a.dtype != dtype or not a.flags.c_contiguous:
        raise ValueError(f"expected a C-contiguous {np.dtype(dtype)} array, "
                         f"got {a.dtype} (contiguous={a.flags.c_contiguous})")
    return a.ctypes.data_as(ctype)


def as_wire(wire) -> np.ndarray:
    """A wire batch (bytes, bytearray or uint8 array) as a uint8 array."""
    if isinstance(wire, (bytes, bytearray, memoryview)):
        return np.frombuffer(wire, dtype=np.uint8)
    buf = np.asarray(wire)
    if buf.dtype != np.uint8 or buf.ndim != 1:
        raise ValueError("a wire batch is a 1-D uint8 buffer")
    return np.ascontiguousarray(buf)


def count_txns(buf: np.ndarray, offset: int = 0) -> int:
    """Transactions in ``buf[offset:]``, or -1 when any record is
    malformed (every count and length is checked against the buffer)."""
    return int(keypack().kp_count_txns(_ptr(buf, np.uint8, _U8P), buf.size,
                                       offset))


def pack_batch(buf: np.ndarray, offset: int, count: int, n_words: int,
               base_version: int, bt) -> int:
    """Pack ``count`` transactions from ``buf[offset:]`` into the padded
    batch ``bt`` (a HostBatch of one batch: arrays [B, R, W], [B, R],
    [B, Q, W], [B, Q], [B], prefilled INT32_MAX / False / 0). Returns the
    offset past the last transaction, or -1 on malformed input."""
    b, r, w = bt.read_begin.shape
    q = bt.write_begin.shape[1]
    want = ((b, r, w), (b, r, w), (b, r), (b, q, w), (b, q, w), (b, q), (b,),
            (b,))
    if (w != n_words + 1
            or tuple(a.shape for a in bt) != want or not 0 <= count <= b):
        raise ValueError(f"batch arrays {[a.shape for a in bt]} do not fit "
                         f"n_words={n_words}, count={count}")
    i32 = lambda a: _ptr(a, np.int32, _I32P)  # noqa: E731
    u8 = lambda a: _ptr(a.view(np.uint8), np.uint8, _U8P)  # noqa: E731
    return int(keypack().kp_pack_batch(
        _ptr(buf, np.uint8, _U8P), buf.size, offset, count, b, r, q, n_words,
        base_version, i32(bt.read_begin), i32(bt.read_end), u8(bt.read_mask),
        i32(bt.write_begin), i32(bt.write_end), u8(bt.write_mask),
        i32(bt.read_version), u8(bt.txn_mask)))


def pack_window(buf: np.ndarray, offset: int, k: int, count: int,
                n_words: int, base_version: int, bt, dict_keys: np.ndarray,
                rb_rank: np.ndarray, re_rank: np.ndarray, wb_rank: np.ndarray,
                we_rank: np.ndarray) -> int:
    """Pack k batches of ``count`` transactions from ``buf[offset:]`` into
    the [k]-leading padded batch ``bt`` (prefilled as for ``pack_batch``),
    with each batch's dictionary ``dict_keys`` [k, N + 1, W] (prefilled
    INT32_MAX; N = 2·B·(R + Q)) and the ranks [k, B, R] / [k, B, Q] of its
    endpoints: bit for bit the non-resident engine's ``_pack_dict``.
    Returns the offset past the last batch, or -1 on malformed input."""
    kk, b, r, w = bt.read_begin.shape
    q = bt.write_begin.shape[2]
    if (kk != k or w != n_words + 1 or not 0 <= count <= b
            or dict_keys.shape != (k, 2 * b * (r + q) + 1, w)
            or rb_rank.shape != (k, b, r) or re_rank.shape != (k, b, r)
            or wb_rank.shape != (k, b, q) or we_rank.shape != (k, b, q)):
        raise ValueError("window arrays do not fit k, count and n_words")
    i32 = lambda a: _ptr(a, np.int32, _I32P)  # noqa: E731
    u8 = lambda a: _ptr(a.view(np.uint8), np.uint8, _U8P)  # noqa: E731
    return int(keypack().kp_pack_window(
        _ptr(buf, np.uint8, _U8P), buf.size, offset, k, count, b, r, q,
        n_words, base_version, i32(bt.read_begin), i32(bt.read_end),
        u8(bt.read_mask), i32(bt.write_begin), i32(bt.write_end),
        u8(bt.write_mask), i32(bt.read_version), u8(bt.txn_mask),
        i32(dict_keys), i32(rb_rank), i32(re_rank), i32(wb_rank),
        i32(we_rank)))
