"""The port's native wire packer (keypack.cpp), built at first use.

``keypack.cpp`` is compiled with ``g++ -O3 -std=c++17 -shared -fPIC``
into ``_build/`` beside this file and loaded with ctypes. The library name
carries a hash of the source, so an edited source is rebuilt and an
unchanged one reused. There is no Python fallback: a missing compiler or a
failed build raises.

``count_txns`` validates a whole wire buffer; ``pack_batch`` packs ``count``
transactions from a byte offset into padded batch arrays that the caller
allocates (and keeps alive, C-contiguous, until their data is uploaded).
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
_SIGNATURES = {
    "kp_pack_batch": [_U8P, _I64, _I64, _INT, _INT, _INT, _INT, _INT, _I64,
                      _I32P, _I32P, _U8P, _I32P, _I32P, _U8P, _I32P, _U8P],
    "kp_count_txns": [_U8P, _I64, _I64],
}


def library_path(name: str) -> Path:
    digest = hashlib.sha256((SRC_DIR / f"{name}.cpp").read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def _build(name: str) -> Path:
    out = library_path(name)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: the native {name} packer cannot "
                           "be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([cxx, *CXX_FLAGS, str(SRC_DIR / f"{name}.cpp"), "-o",
                        str(tmp)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed for {name}.cpp (exit "
                           f"{r.returncode}):\n{r.stderr}")
    os.replace(tmp, out)
    return out


def keypack() -> ctypes.CDLL:
    """The loaded keypack library (built on the first call)."""
    with _LOCK:
        lib = _LIBS.get("keypack")
        if lib is None:
            lib = ctypes.CDLL(str(_build("keypack")))
            for fn, argtypes in _SIGNATURES.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = _I64
            _LIBS["keypack"] = lib
        return lib


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
