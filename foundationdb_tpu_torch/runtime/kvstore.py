"""Persistent storage engine behind the MVCC window.

A copy of ``foundationdb_tpu/runtime/kvstore.py`` for the port, its imports
rewritten to the port's modules; names and behaviour are the JAX module's.
The redwood engine binds the port's own build of ``native/btree.cpp``
(``foundationdb_tpu_torch.native.btree()``, compiled with the JAX flags at
first use); a failed build raises, and no engine stands in for it. Both
engines' files are the JAX engines' files: a store written by one package
opens in the other.

Reference: fdbserver/KeyValueStoreSQLite.actor.cpp — the reference's
default ssd engine IS SQLite (a B-tree of key/value pairs plus commit
batching); this uses the stdlib sqlite3 the same way. The storage server
keeps its versioned window in memory (VersionedMap) and periodically
makes a consistent prefix durable here at a version that can never be
rolled back (<= known_committed); restart loads the durable snapshot and
resumes pulling from that version.
"""

from __future__ import annotations

import os
import sqlite3


class KeyValueStoreSQLite:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._db = sqlite3.connect(path)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB NOT NULL)"
        )
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS meta (k TEXT PRIMARY KEY, v INTEGER)"
        )
        self._db.commit()

    @property
    def durable_version(self) -> int:
        row = self._db.execute(
            "SELECT v FROM meta WHERE k = 'durable_version'"
        ).fetchone()
        return int(row[0]) if row else 0

    def flush(
        self,
        writes: dict[bytes, bytes | None],
        version: int,
        purges: list[tuple[bytes, bytes]] | None = None,
    ) -> None:
        """One atomic commit: apply the dirty set (and any moved-away range
        purges) and advance the durable version marker together (a crash
        leaves either the old snapshot or the new one, never a mix — the
        engine's whole job)."""
        cur = self._db.cursor()
        for b, e in purges or []:
            cur.execute("DELETE FROM kv WHERE k >= ? AND k < ?", (b, e))
        for k, v in writes.items():
            if v is None:
                cur.execute("DELETE FROM kv WHERE k = ?", (k,))
            else:
                cur.execute(
                    "INSERT INTO kv (k, v) VALUES (?, ?) "
                    "ON CONFLICT(k) DO UPDATE SET v = excluded.v",
                    (k, v),
                )
        cur.execute(
            "INSERT INTO meta (k, v) VALUES ('durable_version', ?) "
            "ON CONFLICT(k) DO UPDATE SET v = excluded.v",
            (version,),
        )
        self._db.commit()

    def load(self) -> tuple[int, list[tuple[bytes, bytes]]]:
        version = self.durable_version
        rows = [
            (bytes(k), bytes(v))
            for k, v in self._db.execute("SELECT k, v FROM kv ORDER BY k")
        ]
        return version, rows

    def close(self) -> None:
        self._db.close()


class KeyValueStoreRedwood:
    """Redwood-class engine: the native copy-on-write page B+tree
    (native/btree.cpp; reference: fdbserver/VersionedBTree.actor.cpp —
    the reference's current-generation ssd engine). Same contract as the
    sqlite engine: flush() is one atomic commit (COW pages fsync'd
    before the checksummed dual-slot meta flips the root), load()
    returns the durable snapshot in key order."""

    def __init__(self, path: str):
        import ctypes

        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lib = _btree_lib()
        self._h = self._lib.rw_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open redwood file {path}")

    @property
    def durable_version(self) -> int:
        return int(self._lib.rw_durable_version(self._h))

    def flush(
        self,
        writes: dict[bytes, bytes | None],
        version: int,
        purges: list[tuple[bytes, bytes]] | None = None,
    ) -> None:
        import ctypes

        import numpy as np

        ks = list(writes.keys())
        vs = [writes[k] for k in ks]
        tomb = np.asarray([1 if v is None else 0 for v in vs], np.uint8)
        if len(tomb) == 0:
            tomb = np.zeros(1, np.uint8)
        kb, ko = _blob([k for k in ks])
        vb, vo = _blob([v if v is not None else b"" for v in vs])
        pb, pbo = _blob([b for b, _e in (purges or [])])
        pe, peo = _blob([e for _b, e in (purges or [])])
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        rc = self._lib.rw_flush(
            self._h, len(ks),
            kb.ctypes.data_as(u8p), ko.ctypes.data_as(i64p),
            vb.ctypes.data_as(u8p), vo.ctypes.data_as(i64p),
            tomb.ctypes.data_as(u8p),
            len(purges or []),
            pb.ctypes.data_as(u8p), pbo.ctypes.data_as(i64p),
            pe.ctypes.data_as(u8p), peo.ctypes.data_as(i64p),
            version,
        )
        if rc != 0:
            raise OSError(f"redwood flush failed rc={rc}")

    def load(self) -> tuple[int, list[tuple[bytes, bytes]]]:
        import ctypes

        rows: list[tuple[bytes, bytes]] = []

        @_SCAN_CB
        def cb(kp, klen, vp, vlen, _ctx):
            rows.append((ctypes.string_at(kp, klen),
                         ctypes.string_at(vp, vlen)))

        if self._lib.rw_scan(self._h, cb, None) != 0:
            # An incomplete snapshot must never masquerade as a small
            # one — the storage server would resume from it and the
            # missing keys would be lost silently.
            raise OSError(f"redwood load failed: corrupt store {self.path}")
        return self.durable_version, rows

    def close(self) -> None:
        if self._h:
            self._lib.rw_close(self._h)
            self._h = None


def make_kvstore(path: str, engine: str = "sqlite"):
    """Engine factory (reference: the `ssd` / `ssd-redwood-1` storage
    engine choice in DatabaseConfiguration)."""
    if engine in ("redwood", "ssd-redwood-1"):
        return KeyValueStoreRedwood(path)
    if engine in ("sqlite", "ssd", "ssd-2"):
        return KeyValueStoreSQLite(path)
    raise ValueError(f"unknown storage engine {engine!r}")


_BT_LIB = None
# The rw_scan callback type, kept at module level as long as the library.
_SCAN_CB = None


def _btree_lib():
    global _BT_LIB, _SCAN_CB
    if _BT_LIB is None:
        from foundationdb_tpu_torch import native

        _SCAN_CB = native.BTREE_SCAN_CB
        _BT_LIB = native.btree()
    return _BT_LIB


def _blob(items: list[bytes]):
    import numpy as np

    offs = np.zeros(len(items) + 1, np.int64)
    for i, b in enumerate(items):
        offs[i + 1] = offs[i] + len(b)
    data = (np.frombuffer(b"".join(items), np.uint8)
            if items and offs[-1] else np.zeros(1, np.uint8))
    return np.ascontiguousarray(data), offs
