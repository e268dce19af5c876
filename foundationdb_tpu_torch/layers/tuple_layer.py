"""Tuple layer: order-preserving encoding of typed tuples into byte keys.

A copy of ``foundationdb_tpu/layers/tuple_layer.py`` for the port, its imports
rewritten to the port's modules; names and behaviour are the JAX module's.

Reference: fdbclient/Tuple.cpp and the cross-binding tuple spec
(design/tuple.md in the reference tree). The encoding is a public wire
format shared by every fdb binding, so the byte layout here matches it
exactly: the guarantee is that ``pack(a) < pack(b)`` (bytewise) iff
``a < b`` under the tuple layer's semantic ordering (elements compared
left-to-right, by type code then value).

Type codes implemented (the complete set the reference's bindings emit):
null, bytes, unicode, nested tuple, integers (arbitrary width, negative
and positive), float32, float64, bool, UUID, versionstamp.
"""

from __future__ import annotations

import struct
import uuid as _uuid
from dataclasses import dataclass

from foundationdb_tpu_torch.core.errors import FdbError

# Type codes (reference: fdbclient/Tuple.cpp constants).
NULL_CODE = 0x00
BYTES_CODE = 0x01
STRING_CODE = 0x02
NESTED_CODE = 0x05
NEG_INT_START = 0x0B  # arbitrary-precision negative
INT_ZERO_CODE = 0x14
POS_INT_END = 0x1D  # arbitrary-precision positive
FLOAT_CODE = 0x20
DOUBLE_CODE = 0x21
FALSE_CODE = 0x26
TRUE_CODE = 0x27
UUID_CODE = 0x30
VERSIONSTAMP_CODE = 0x33

_ESCAPE = b"\x00\xff"
_SIZE_LIMITS = [(1 << (8 * i)) - 1 for i in range(9)]


class TupleError(FdbError):
    """Malformed tuple encoding or unpackable element (error 2041)."""

    code = 2041


@dataclass(frozen=True)
class Versionstamp:
    """An 80-bit transaction versionstamp plus a 16-bit user version.

    Reference: fdbclient Versionstamp in Tuple.cpp. ``tr_version`` is None
    for an *incomplete* stamp: pack_with_versionstamp() records its offset
    so SET_VERSIONSTAMPED_KEY fills it at commit time.
    """

    tr_version: bytes | None = None
    user_version: int = 0

    def __post_init__(self):
        if self.tr_version is not None and len(self.tr_version) != 10:
            raise TupleError("versionstamp must be 10 bytes")
        if not 0 <= self.user_version <= 0xFFFF:
            raise TupleError("user_version out of range")

    @property
    def complete(self) -> bool:
        return self.tr_version is not None

    def to_bytes(self) -> bytes:
        tr = self.tr_version if self.complete else b"\xff" * 10
        return tr + struct.pack(">H", self.user_version)

    # Ordering matches the packed encoding: incomplete stamps (0xff-filled)
    # sort after every complete one. dataclass(order=True) would TypeError
    # comparing None tr_version against bytes.
    def __lt__(self, other: "Versionstamp") -> bool:
        return self.to_bytes() < other.to_bytes()

    def __le__(self, other: "Versionstamp") -> bool:
        return self.to_bytes() <= other.to_bytes()

    def __gt__(self, other: "Versionstamp") -> bool:
        return self.to_bytes() > other.to_bytes()

    def __ge__(self, other: "Versionstamp") -> bool:
        return self.to_bytes() >= other.to_bytes()


def _find_terminator(b: bytes, pos: int) -> int:
    """Index of the 0x00 terminator of an escaped byte string at `pos`
    (a 0x00 followed by 0xff is an escaped NUL, not the end)."""
    while True:
        idx = b.find(b"\x00", pos)
        if idx < 0:
            raise TupleError("unterminated byte string in tuple")
        if idx + 1 >= len(b) or b[idx + 1] != 0xFF:
            return idx
        pos = idx + 2


def _encode_int(v: int, out: bytearray) -> None:
    if v == 0:
        out.append(INT_ZERO_CODE)
        return
    if v > 0:
        n = (v.bit_length() + 7) // 8
        if n <= 8:
            out.append(INT_ZERO_CODE + n)
            out += v.to_bytes(n, "big")
        else:
            # Arbitrary precision: code, 1-byte length, magnitude.
            out.append(POS_INT_END)
            mag = v.to_bytes(n, "big")
            if n > 255:
                raise TupleError("integer magnitude exceeds 255 bytes")
            out.append(n)
            out += mag
    else:
        m = -v
        n = (m.bit_length() + 7) // 8
        if n <= 8:
            # Ones'-complement within n bytes so bigger (less negative)
            # values sort later.
            out.append(INT_ZERO_CODE - n)
            out += (_SIZE_LIMITS[n] - m).to_bytes(n, "big")
        else:
            out.append(NEG_INT_START)
            if n > 255:
                raise TupleError("integer magnitude exceeds 255 bytes")
            out.append(n ^ 0xFF)
            out += ((1 << (8 * n)) - 1 - m).to_bytes(n, "big")


def _float_sort_bytes(raw: bytes) -> bytes:
    """IEEE bits transposed so bytewise order matches numeric order:
    positive numbers get the sign bit flipped, negatives are inverted."""
    if raw[0] & 0x80:
        return bytes(b ^ 0xFF for b in raw)
    return bytes([raw[0] ^ 0x80]) + raw[1:]


def _float_unsort_bytes(raw: bytes) -> bytes:
    if raw[0] & 0x80:
        return bytes([raw[0] ^ 0x80]) + raw[1:]
    return bytes(b ^ 0xFF for b in raw)


def _encode(item, out: bytearray, versionstamp_slot: list, nested: bool) -> None:
    if item is None:
        if nested:
            out += b"\x00\xff"
        else:
            out.append(NULL_CODE)
    elif isinstance(item, bool):  # before int: bool is an int subclass
        out.append(TRUE_CODE if item else FALSE_CODE)
    elif isinstance(item, bytes):
        out.append(BYTES_CODE)
        out += item.replace(b"\x00", _ESCAPE)
        out.append(0x00)
    elif isinstance(item, str):
        out.append(STRING_CODE)
        out += item.encode("utf-8").replace(b"\x00", _ESCAPE)
        out.append(0x00)
    elif isinstance(item, int):
        _encode_int(item, out)
    elif isinstance(item, float):
        out.append(DOUBLE_CODE)
        out += _float_sort_bytes(struct.pack(">d", item))
    elif isinstance(item, SingleFloat):
        out.append(FLOAT_CODE)
        out += _float_sort_bytes(struct.pack(">f", item.value))
    elif isinstance(item, _uuid.UUID):
        out.append(UUID_CODE)
        out += item.bytes
    elif isinstance(item, Versionstamp):
        out.append(VERSIONSTAMP_CODE)
        if not item.complete:
            versionstamp_slot.append(len(out))
        out += item.to_bytes()
    elif isinstance(item, (tuple, list)):
        out.append(NESTED_CODE)
        for sub in item:
            _encode(sub, out, versionstamp_slot, nested=True)
        out.append(0x00)
    else:
        raise TupleError(f"unpackable tuple element type {type(item).__name__}")


@dataclass(frozen=True)
class SingleFloat:
    """Wrapper marking a value to encode as float32 (code 0x20); bare
    Python floats encode as float64 like the reference bindings."""

    value: float


def pack(t: tuple) -> bytes:
    """Encode `t`; raises if it contains an incomplete Versionstamp."""
    out = bytearray()
    slot: list = []
    for item in t:
        _encode(item, out, slot, nested=False)
    if slot:
        raise TupleError("incomplete versionstamp in pack(); use pack_with_versionstamp")
    return bytes(out)


def pack_with_versionstamp(t: tuple, prefix: bytes = b"") -> bytes:
    """Encode `t` containing exactly one incomplete Versionstamp and append
    the 4-byte little-endian offset of its 10-byte hole, the trailer the
    SET_VERSIONSTAMPED_KEY mutation consumes (core/mutations.py)."""
    out = bytearray(prefix)
    slot: list = []
    for item in t:
        _encode(item, out, slot, nested=False)
    if len(slot) != 1:
        raise TupleError(f"expected exactly 1 incomplete versionstamp, found {len(slot)}")
    return bytes(out) + struct.pack("<I", slot[0])


def _take(b: bytes, pos: int, n: int) -> bytes:
    """Exactly n payload bytes at pos, or TupleError on truncation (so a
    corrupt key never silently decodes to a wrong value)."""
    if pos + n > len(b):
        raise TupleError(f"truncated tuple encoding: need {n} bytes at {pos}")
    return b[pos : pos + n]


def _decode(b: bytes, pos: int, nested: bool):
    code = b[pos]
    if code == NULL_CODE:
        if nested and pos + 1 < len(b) and b[pos + 1] == 0xFF:
            return None, pos + 2
        return None, pos + 1
    if code == BYTES_CODE:
        end = _find_terminator(b, pos + 1)
        return b[pos + 1 : end].replace(_ESCAPE, b"\x00"), end + 1
    if code == STRING_CODE:
        end = _find_terminator(b, pos + 1)
        return b[pos + 1 : end].replace(_ESCAPE, b"\x00").decode("utf-8"), end + 1
    if code == NEG_INT_START:
        n = _take(b, pos + 1, 1)[0] ^ 0xFF
        mag = int.from_bytes(_take(b, pos + 2, n), "big")
        return mag - ((1 << (8 * n)) - 1), pos + 2 + n
    if code == POS_INT_END:
        n = _take(b, pos + 1, 1)[0]
        return int.from_bytes(_take(b, pos + 2, n), "big"), pos + 2 + n
    if NEG_INT_START < code < INT_ZERO_CODE:
        n = INT_ZERO_CODE - code
        return int.from_bytes(_take(b, pos + 1, n), "big") - _SIZE_LIMITS[n], pos + 1 + n
    if code == INT_ZERO_CODE:
        return 0, pos + 1
    if INT_ZERO_CODE < code <= INT_ZERO_CODE + 8:
        n = code - INT_ZERO_CODE
        return int.from_bytes(_take(b, pos + 1, n), "big"), pos + 1 + n
    if code == FLOAT_CODE:
        return SingleFloat(struct.unpack(">f", _float_unsort_bytes(_take(b, pos + 1, 4)))[0]), pos + 5
    if code == DOUBLE_CODE:
        return struct.unpack(">d", _float_unsort_bytes(_take(b, pos + 1, 8)))[0], pos + 9
    if code == FALSE_CODE:
        return False, pos + 1
    if code == TRUE_CODE:
        return True, pos + 1
    if code == UUID_CODE:
        return _uuid.UUID(bytes=_take(b, pos + 1, 16)), pos + 17
    if code == VERSIONSTAMP_CODE:
        raw = _take(b, pos + 1, 12)
        tr, user = raw[:10], struct.unpack(">H", raw[10:])[0]
        return Versionstamp(None if tr == b"\xff" * 10 else tr, user), pos + 13
    if code == NESTED_CODE:
        items = []
        pos += 1
        while True:
            if pos >= len(b):
                raise TupleError("unterminated nested tuple")
            if b[pos] == 0x00 and not (pos + 1 < len(b) and b[pos + 1] == 0xFF):
                return tuple(items), pos + 1
            item, pos = _decode(b, pos, nested=True)
            items.append(item)
    raise TupleError(f"unknown tuple type code {code:#04x} at offset {pos}")


def unpack(b: bytes) -> tuple:
    items = []
    pos = 0
    while pos < len(b):
        item, pos = _decode(b, pos, nested=False)
        items.append(item)
    return tuple(items)


def range_of(t: tuple) -> tuple[bytes, bytes]:
    """[begin, end) covering every key whose tuple encoding extends `t`.

    Reference: Tuple::range() — prefix + 0x00 .. prefix + 0xff, exploiting
    that no element's first type-code byte is 0x00 except null itself,
    whose encoding *is* 0x00, so 0x00/0xff bracket all extensions.
    """
    p = pack(t)
    return p + b"\x00", p + b"\xff"


# Re-exported so layer users get the one canonical strinc (defined alongside
# the other key helpers; raises ValueError on all-0xff keys).
from foundationdb_tpu_torch.core.types import strinc  # noqa: E402


class Subspace:
    """A fixed key prefix under which tuples are packed.

    Reference: the Subspace class every binding ships (e.g.
    bindings/python/fdb/subspace_impl.py in the reference tree).
    """

    def __init__(self, prefix_tuple: tuple = (), raw_prefix: bytes = b""):
        self._prefix = raw_prefix + pack(prefix_tuple)

    def key(self) -> bytes:
        """The subspace's raw prefix. A METHOD, matching the reference
        python binding's Subspace.key() (porting apps call it)."""
        return self._prefix

    def pack(self, t: tuple = ()) -> bytes:
        return self._prefix + pack(t)

    def pack_with_versionstamp(self, t: tuple) -> bytes:
        return pack_with_versionstamp(t, prefix=self._prefix)

    def unpack(self, key: bytes) -> tuple:
        if not self.contains(key):
            raise TupleError("key is not within this subspace")
        return unpack(key[len(self._prefix) :])

    def contains(self, key: bytes) -> bool:
        return key.startswith(self._prefix)

    def range(self, t: tuple = ()) -> slice:
        """slice(begin, end) covering all tuples under this prefix — a
        SLICE, like the reference binding, so ``tr[sub.range()]`` works."""
        p = self._prefix + pack(t)
        return slice(p + b"\x00", p + b"\xff")

    def subspace(self, t: tuple) -> "Subspace":
        return Subspace(raw_prefix=self.pack(t))

    def __getitem__(self, item) -> "Subspace":
        return self.subspace((item,))

    def __repr__(self) -> str:
        return f"Subspace(raw_prefix={self._prefix!r})"
