"""Python wrapper over the C++ skiplist ConflictSet (the CPU baseline).

The port's copy of the JAX package's ``models/cpu_conflict_set.py``, over
its own build of ``native/skiplist.cpp``. Same ``resolve`` contract as
``TorchConflictSet``, so a resolver can be configured with either engine
(the reference's ``newConflictSet()`` seam) and the bench can race them
on one stream (``foundationdb_tpu_torch/bench.py --baseline``).
"""

from __future__ import annotations

import ctypes

import numpy as np

from foundationdb_tpu_torch import native
from foundationdb_tpu_torch.core.types import TxnConflictInfo, Verdict

_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I8P = ctypes.POINTER(ctypes.c_int8)


class CPUSkipListConflictSet:
    def __init__(self) -> None:
        self._lib = native.skiplist()
        self._ptr = self._lib.cs_create()
        self.oldest_version = 0
        self._last_commit = 0

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.cs_destroy(self._ptr)
            self._ptr = None

    @property
    def node_count(self) -> int:
        return int(self._lib.cs_node_count(self._ptr))

    def resolve(
        self,
        txns: list[TxnConflictInfo],
        commit_version: int,
        oldest_version: int | None = None,
    ) -> list[Verdict]:
        if commit_version <= self._last_commit:
            raise ValueError("commit versions must advance")
        self._last_commit = commit_version
        if oldest_version is not None:
            self.oldest_version = max(self.oldest_version, oldest_version)
        verdicts = self.resolve_marshalled(*self._marshal(txns),
                                           commit_version)
        return [Verdict(int(x)) for x in verdicts]

    def resolve_marshalled(self, blob: bytes, ranges: np.ndarray,
                           rc: np.ndarray, wc: np.ndarray, rv: np.ndarray,
                           commit_version: int,
                           out: np.ndarray | None = None) -> np.ndarray:
        """One batch already in the C ABI (``_marshal``'s or the bench's
        ``marshal_cpu_batches``' layout): verdicts int8 [n] (into ``out``
        when given), at ``self.oldest_version``. Checks nothing about the
        versions: ``resolve`` does."""
        n = len(rc)
        if out is None:
            out = np.zeros(n, np.int8)
        self._lib.cs_resolve(
            self._ptr, blob, ranges.ctypes.data_as(_I64P),
            rc.ctypes.data_as(_I32P), wc.ctypes.data_as(_I32P),
            rv.ctypes.data_as(_I64P), n, commit_version,
            self.oldest_version, out.ctypes.data_as(_I8P))
        return out

    @staticmethod
    def _marshal(txns: list[TxnConflictInfo]):
        parts: list[bytes] = []
        pos = 0

        def add(key: bytes) -> tuple[int, int]:
            nonlocal pos
            parts.append(key)
            off = pos
            pos += len(key)
            return off, len(key)

        rows: list[int] = []
        rc = np.zeros(len(txns), np.int32)
        wc = np.zeros(len(txns), np.int32)
        rv = np.zeros(len(txns), np.int64)
        for i, t in enumerate(txns):
            rv[i] = t.read_version
            rc[i] = len(t.read_ranges)
            wc[i] = len(t.write_ranges)
            for r in list(t.read_ranges) + list(t.write_ranges):
                bo, bl = add(r.begin)
                eo, el = add(r.end)
                rows += [bo, bl, eo, el]
        ranges = np.asarray(rows, np.int64).reshape(-1, 4)
        return b"".join(parts), np.ascontiguousarray(ranges), rc, wc, rv
