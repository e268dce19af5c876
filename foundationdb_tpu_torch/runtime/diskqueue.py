"""Durable append-only queue for the tlog (reference: fdbserver/DiskQueue).

A copy of ``foundationdb_tpu/runtime/diskqueue.py`` for the port, its imports rewritten to
the port's modules; names and behaviour are the JAX module's. Its file is
the JAX module's file: a record's classes (the tlog's ``Mutation`` and
``MutationType``) are pickled under the JAX package's module names, byte
for byte what the JAX module writes for the same record (``_dumps``), and
read back as the port's classes (``_Unpickler``), so either package's
restart reads the other's queues. Nothing of the JAX package is imported:
its names are only written and read as text.

Records are length-prefixed, CRC-protected pickled payloads appended to a
single file and fsync'd in batches. Recovery replays the file front to
back and stops at the first torn/corrupt record, truncating the garbage —
exactly the reference DiskQueue's recovery contract (a crash mid-write
loses only the unacknowledged suffix, never acknowledged data, because
the tlog acks a push only after fsync).
"""

from __future__ import annotations

import io
import os
import pickle
import struct
import zlib

_HDR = struct.Struct("<II")  # payload length, crc32
_PORT, _JAX = "foundationdb_tpu_torch.", "foundationdb_tpu."
# The JAX name of each port module pickled so far, one str object each:
# pickle memoizes a module name by identity, as it does the JAX class's
# shared ``__module__``.
_JAX_NAMES: dict[str, str] = {}


class _Pickler(pickle._Pickler):
    """The pure-Python pickler at protocol 4 (``pickle.dumps``'s default),
    batching a list or dict of more than one item as the C pickler does
    (a last batch of one item too between MARK and APPENDS or SETITEMS),
    so that it writes the C pickler's bytes; every port class is saved
    under its JAX module's name."""

    def _batch_appends(self, items, *rest):
        if type(items) is not list or len(items) <= 1:
            return super()._batch_appends(items, *rest)
        for i in range(0, len(items), self._BATCHSIZE):
            self.write(pickle.MARK)
            for x in items[i:i + self._BATCHSIZE]:
                self.save(x)
            self.write(pickle.APPENDS)

    def _batch_setitems(self, items, *rest):
        pairs = list(items)
        if len(pairs) <= 1:
            return super()._batch_setitems(iter(pairs), *rest)
        for i in range(0, len(pairs), self._BATCHSIZE):
            self.write(pickle.MARK)
            for k, v in pairs[i:i + self._BATCHSIZE]:
                self.save(k)
                self.save(v)
            self.write(pickle.SETITEMS)

    def save_global(self, obj, name=None):
        module = getattr(obj, "__module__", None) or ""
        if not module.startswith(_PORT):
            return super().save_global(obj, name)
        jax = _JAX_NAMES.setdefault(module, _JAX + module[len(_PORT):])
        self.save(jax)
        self.save(name or obj.__qualname__)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _Unpickler(pickle.Unpickler):
    """Reads a record written by either package as the port's classes."""

    def find_class(self, module, name):
        if module.startswith(_JAX):
            module = _PORT + module[len(_JAX):]
        return super().find_class(module, name)


def _short_unicode(text: str) -> bytes:
    raw = text.encode()
    return pickle.SHORT_BINUNICODE + bytes([len(raw)]) + raw


# A tlog record, (version, {tag: [Mutation, ...]}), names its one port
# module once, as a string before its first class: the C pickler's bytes
# with that string renamed are the JAX module's bytes.
_RENAME = (_short_unicode(_PORT + "core.mutations"),
           _short_unicode(_JAX + "core.mutations"))
_SHRINK = len(_RENAME[0]) - len(_RENAME[1])
_FRAME_TARGET = 64 * 1024  # the C pickler's frame size target


def _dumps(record: object) -> bytes:
    """``record`` pickled as the JAX module pickles its record: the C
    pickler's bytes with the port's module name renamed where that is
    exact (the first frame, whose length then shrinks, does not end
    within the renaming's bytes of the frame size target, no other port
    name is left, and the bytes read back to ``record``); otherwise the
    pure-Python ``_Pickler``."""
    raw = pickle.dumps(record, 4)
    at = raw.find(_RENAME[0])
    if at < 0 and _PORT.encode() not in raw:
        return raw
    if at >= 0:
        out = raw[:at] + _RENAME[1] + raw[at + len(_RENAME[0]):]
        framed = out[2:3] == pickle.FRAME
        n = int.from_bytes(raw[3:11], "little") if framed else 0
        if framed:
            out = out[:3] + (n - _SHRINK).to_bytes(8, "little") + out[11:]
        if (not framed or (at < 11 + n and not _FRAME_TARGET <= n
                           < _FRAME_TARGET + _SHRINK)) \
                and _PORT.encode() not in out and _loads(out) == record:
            return out
    buf = io.BytesIO()
    _Pickler(buf, 4).dump(record)
    return buf.getvalue()


def _loads(payload: bytes) -> object:
    return _Unpickler(io.BytesIO(payload)).load()


class DiskQueue:
    def __init__(self, path: str, preserve: bool = False):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # Truncate on create by default: every queue belongs to exactly one
        # brand-new tlog generation. A leftover same-named file (crash
        # between queue creation and the cluster-meta swap, then a
        # same-epoch re-recruit) must not get a second seed appended onto
        # its stale contents. preserve=True (deployed restart resuming the
        # SAME chain, TLog.from_disk) appends instead — truncating there
        # would open a crash window that loses every acked commit.
        self._f = open(path, "ab" if preserve else "wb")

    def append(self, record: object) -> None:
        payload = _dumps(record)
        self._f.write(_HDR.pack(len(payload), zlib.crc32(payload)))
        self._f.write(payload)

    def fsync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def rewrite(self, records: list[object]) -> None:
        """Compaction: atomically replace the file's contents with `records`
        (the un-popped suffix) — the pop-side space reclamation the
        reference DiskQueue does with its ring buffer."""
        tmp_path = self.path + ".tmp"
        with open(tmp_path, "wb") as tmp:
            for r in records:
                payload = _dumps(r)
                tmp.write(_HDR.pack(len(payload), zlib.crc32(payload)))
                tmp.write(payload)
            tmp.flush()
            os.fsync(tmp.fileno())
        self._f.close()
        os.replace(tmp_path, self.path)
        self._f = open(self.path, "ab")

    def read_all(self) -> list[object]:
        """Every intact record of the LIVE file, no truncation side
        effect — the tlog SPILL read path (spilled entries live only on
        disk; the appender fsyncs before every ack, so the tail is never
        torn while the queue is live)."""
        self._f.flush()
        with open(self.path, "rb") as f:
            data = f.read()
        out, _good_end = _parse_records(data)
        return out

    def close(self) -> None:
        self._f.close()

    @staticmethod
    def recover(path: str) -> list[object]:
        """All intact records; truncates a torn tail in place."""
        if not os.path.exists(path):
            return []
        with open(path, "rb") as f:
            data = f.read()
        out, good_end = _parse_records(data)
        if good_end < len(data):
            with open(path, "r+b") as f:
                f.truncate(good_end)
        return out


def _parse_records(data: bytes) -> tuple[list[object], int]:
    """ONE frame parser for both the crash-recovery and live spill-read
    paths (they must never diverge on what counts as an intact record):
    → (records, end offset of the last intact record)."""
    out: list[object] = []
    good_end = 0
    pos = 0
    while pos + _HDR.size <= len(data):
        length, crc = _HDR.unpack_from(data, pos)
        end = pos + _HDR.size + length
        if end > len(data):
            break  # torn final record
        payload = data[pos + _HDR.size : end]
        if zlib.crc32(payload) != crc:
            break  # corruption: everything after is untrustworthy
        out.append(_loads(payload))
        good_end = end
        pos = end
    return out, good_end
