"""Pure-Python Ed25519 (RFC 8032) fallback for runtime/authz.py.

A copy of ``foundationdb_tpu/runtime/_ed25519.py`` for the port, its
imports rewritten to the port's modules; names and behaviour are the JAX
module's.

This container class of deployment has no ``cryptography`` wheel, but the
authz subsystem (and every campaign/test that arms it) needs real
signatures: HMAC would collapse the asymmetric model (processes hold only
the PUBLIC key; a storage server must not be able to mint tokens).

Wire/PEM compatibility is exact: Ed25519 PKCS#8 private and SPKI public
keys are a fixed ASN.1 prefix plus the 32 raw key bytes, so keys and
tokens produced here verify under ``cryptography`` and vice versa — a
mixed fleet (some processes with the wheel, some without) interoperates.

Performance: one verify is one double-scalarmult on bigint extended
coordinates (~5ms CPython). TokenAuthority caches verified tokens, so
this is a per-unique-token cost, not per-commit — fine for simulation
and tests, and an explicit note for production: install ``cryptography``
there (authz.py prefers it automatically).
"""

from __future__ import annotations

import hashlib

_P = 2**255 - 19
_L = 2**252 + 27742317777372353535851937790883648493
_D = (-121665 * pow(121666, _P - 2, _P)) % _P

# Fixed ASN.1 DER prefixes for Ed25519 (RFC 8410): the whole structure is
# prefix || 32 raw key bytes, which is what makes PEM interop trivial.
_PKCS8_PREFIX = bytes.fromhex("302e020100300506032b657004220420")
_SPKI_PREFIX = bytes.fromhex("302a300506032b6570032100")


def _sha512(*parts: bytes) -> int:
    return int.from_bytes(hashlib.sha512(b"".join(parts)).digest(), "little")


# -- group ops: extended homogeneous coordinates (X, Y, Z, T) -----------------


def _add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % _P
    b = (y1 + x1) * (y2 + x2) % _P
    c = 2 * t1 * t2 * _D % _P
    d = 2 * z1 * z2 % _P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % _P, g * h % _P, f * g % _P, e * h % _P)


def _mul(s: int, p):
    q = (0, 1, 1, 0)  # neutral
    while s:
        if s & 1:
            q = _add(q, p)
        p = _add(p, p)
        s >>= 1
    return q


_BY = 4 * pow(5, _P - 2, _P) % _P
_BX = 15112221349535400772501151409588531511454012693041857206046113283949847762202
_B = (_BX, _BY, 1, _BX * _BY % _P)


def _encode(p) -> bytes:
    x, y, z, _t = p
    zi = pow(z, _P - 2, _P)
    x, y = x * zi % _P, y * zi % _P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _decode(s: bytes):
    if len(s) != 32:
        raise ValueError("bad point length")
    n = int.from_bytes(s, "little")
    y = n & ((1 << 255) - 1)
    sign = n >> 255
    if y >= _P:
        raise ValueError("y out of range")
    # x^2 = (y^2 - 1) / (d y^2 + 1); sqrt via the p = 5 (mod 8) trick.
    u = (y * y - 1) % _P
    v = (_D * y * y + 1) % _P
    x = u * v**3 % _P * pow(u * v**7 % _P, (_P - 5) // 8, _P) % _P
    if (v * x * x - u) % _P:
        x = x * pow(2, (_P - 1) // 4, _P) % _P
    if (v * x * x - u) % _P:
        raise ValueError("not a point")
    if x == 0 and sign:
        raise ValueError("bad sign bit")
    if (x & 1) != sign:
        x = _P - x
    return (x, y, 1, x * y % _P)


def _clamp(h32: bytes) -> int:
    a = int.from_bytes(h32, "little")
    return (a & ((1 << 254) - 8)) | (1 << 254)


# -- RFC 8032 sign / verify on raw 32-byte keys -------------------------------


def public_from_seed(seed: bytes) -> bytes:
    a = _clamp(hashlib.sha512(seed).digest()[:32])
    return _encode(_mul(a, _B))


def sign(seed: bytes, msg: bytes) -> bytes:
    h = hashlib.sha512(seed).digest()
    a = _clamp(h[:32])
    pub = _encode(_mul(a, _B))
    r = _sha512(h[32:], msg) % _L
    enc_r = _encode(_mul(r, _B))
    k = _sha512(enc_r, pub, msg) % _L
    s = (r + k * a) % _L
    return enc_r + s.to_bytes(32, "little")


def verify(pub: bytes, sig: bytes, msg: bytes) -> bool:
    if len(sig) != 64:
        return False
    try:
        a_pt = _decode(pub)
        r_pt = _decode(sig[:32])
    except ValueError:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= _L:
        return False
    k = _sha512(sig[:32], pub, msg) % _L
    # sB == R + kA  (compare encodings: cheaper than subgroup algebra)
    return _encode(_mul(s, _B)) == _encode(_add(r_pt, _mul(k, a_pt)))


# -- PEM interop (exact byte format cryptography emits/accepts) ---------------


def _pem(tag: str, der: bytes) -> bytes:
    import base64

    b64 = base64.b64encode(der).decode()
    lines = "\n".join(b64[i:i + 64] for i in range(0, len(b64), 64))
    return (f"-----BEGIN {tag}-----\n{lines}\n-----END {tag}-----\n").encode()


def _unpem(pem: bytes, prefix: bytes) -> bytes:
    import base64

    body = b"".join(
        line for line in pem.splitlines() if line and b"-----" not in line
    )
    der = base64.b64decode(body)
    if not der.startswith(prefix) or len(der) != len(prefix) + 32:
        raise ValueError("not an Ed25519 key of the expected form")
    return der[len(prefix):]


def generate_keypair_pem(seed: bytes | None = None) -> tuple[bytes, bytes]:
    """(private_pem, public_pem); random seed from os.urandom by default."""
    if seed is None:
        import os

        seed = os.urandom(32)
    return (
        _pem("PRIVATE KEY", _PKCS8_PREFIX + seed),
        _pem("PUBLIC KEY", _SPKI_PREFIX + public_from_seed(seed)),
    )


def seed_from_private_pem(pem: bytes) -> bytes:
    return _unpem(pem, _PKCS8_PREFIX)


def public_from_public_pem(pem: bytes) -> bytes:
    return _unpem(pem, _SPKI_PREFIX)
