"""Core value types: verdicts, key ranges, per-transaction conflict info.

A copy of the conflict engine's value types from
``foundationdb_tpu/core/types.py`` (which mirror the reference's
fdbserver/ConflictSet.h and fdbclient/FDBTypes.h). The port keeps its own
copy so that it never imports the JAX package.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from foundationdb_tpu_torch.core.errors import InvertedRange


class Verdict(enum.IntEnum):
    """Resolver verdict for one transaction in a batch.

    Values are the on-device int8 encoding; 0 is the common fast path, so a
    padded/masked txn slot defaults to COMMITTED and is filtered host-side.
    """

    COMMITTED = 0
    CONFLICT = 1
    TOO_OLD = 2


@dataclass(frozen=True)
class KeyRange:
    """Half-open byte-string key range [begin, end)."""

    begin: bytes
    end: bytes

    def __post_init__(self):
        if self.end < self.begin:
            raise InvertedRange(f"inverted range {self.begin!r} > {self.end!r}")

    @property
    def empty(self) -> bool:
        return self.begin == self.end

    def contains(self, key: bytes) -> bool:
        return self.begin <= key < self.end

    def overlaps(self, other: "KeyRange") -> bool:
        return self.begin < other.end and other.begin < self.end


def single_key_range(key: bytes) -> KeyRange:
    """The conflict range for a point read/write: [key, keyAfter(key))."""
    return KeyRange(key, key + b"\x00")


def strinc(key: bytes) -> bytes:
    """First key not prefixed by `key` (reference: flow strinc()).

    Strips trailing 0xff bytes then increments the last byte; an all-0xff or
    empty key has no upper bound and raises.
    """
    stripped = key.rstrip(b"\xff")
    if not stripped:
        raise ValueError(f"strinc has no result for {key!r}")
    return stripped[:-1] + bytes([stripped[-1] + 1])


@dataclass
class TxnConflictInfo:
    """One transaction's resolver-visible payload.

    Mirrors CommitTransactionRef's read_conflict_ranges / write_conflict_ranges
    / read_snapshot_version (reference: fdbclient/CommitTransaction.h).
    """

    read_version: int
    read_ranges: list[KeyRange] = field(default_factory=list)
    write_ranges: list[KeyRange] = field(default_factory=list)
    # report_conflicting_keys: when True the resolver also returns which read
    # ranges lost (reference: report_conflicting_keys option).
    report_conflicting_keys: bool = False
