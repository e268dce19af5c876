"""Authorization and tenants in the port against the JAX package
(``runtime/authz.py``, ``runtime/_ed25519.py``, ``client/tenant.py``,
``client/locality.py``, ``sim/cluster.py``'s ``authz_*`` arm).

- Every case of ``tests/test_authz.py`` but its DR case (``runtime/dr.py``
  is not ported) and every case of ``tests/test_tenant.py`` run in both
  packages as their JAX sources stand
  (``tests/test_torch_durability.jax_case``): both pass their own checks,
  and every cluster they build is equal (epochs, version chains, shard
  map, trace, ``loop.now``). ``generate_keypair`` draws its key from a seed
  in both packages (the JAX function draws a random one).
- Ed25519: the port's pure-Python RFC 8032 path against the JAX module's
  ``cryptography`` path: the same PEMs from one seed, the same signatures
  and tokens byte for byte, and each side verifies the other's tokens.
- ``TokenAuthority``'s verify cache hits as JAX's does.
- Locality on a data-distribution cluster: boundary keys, the team of a
  key and the estimated range sizes equal JAX's.
"""

import hashlib

import pytest

from tests.test_torch_cluster import PKGS, mod, norm, same
from tests.test_torch_durability import (
    case_ids,
    jax_case,
    jax_made_deterministic,  # noqa: F401  (autouse fixture)
)

AUTHZ = [q for q in case_ids("test_authz")
         if q != "test_dr_to_authz_secondary_with_admin_token"]
TENANT = case_ids("test_tenant")


@pytest.mark.parametrize("qualname", AUTHZ)
def test_authz_case_equals_jax(monkeypatch, tmp_path, qualname):
    rec = jax_case(monkeypatch, tmp_path, "test_authz", qualname)
    if qualname != "test_verify_cache_and_authority_unit":
        assert rec["clusters"]


@pytest.mark.parametrize("qualname", TENANT)
def test_tenant_case_equals_jax(monkeypatch, tmp_path, qualname):
    rec = jax_case(monkeypatch, tmp_path, "test_tenant", qualname)
    assert len(rec["clusters"]) == 1


def test_every_case_is_held():
    assert len(AUTHZ) == 13 and len(TENANT) == 5
    assert "test_data_distribution_runs_on_authz_cluster" in AUTHZ


# -- Ed25519: the pure-Python path against cryptography -----------------------


def pure_authz(monkeypatch):
    """The port's authz module on its own RFC 8032 code, as where
    ``cryptography`` is not installed."""
    A = mod(PKGS[1], "runtime.authz")
    monkeypatch.setattr(A, "_HAVE_CRYPTOGRAPHY", False)
    monkeypatch.setattr(A, "_pyed", mod(PKGS[1], "runtime._ed25519"),
                        raising=False)
    return A


def test_pure_python_ed25519_equals_cryptography(monkeypatch):
    pytest.importorskip("cryptography")
    from cryptography.hazmat.primitives import serialization as ser
    from cryptography.hazmat.primitives.asymmetric import ed25519 as ed

    J = mod(PKGS[0], "runtime.authz")
    assert J._HAVE_CRYPTOGRAPHY
    P = pure_authz(monkeypatch)
    E = mod(PKGS[1], "runtime._ed25519")
    for i in range(6):
        seed = hashlib.sha256(b"seed%d" % i).digest()
        priv_pem, pub_pem = E.generate_keypair_pem(seed)
        key = ed.Ed25519PrivateKey.from_private_bytes(seed)
        assert priv_pem == key.private_bytes(
            ser.Encoding.PEM, ser.PrivateFormat.PKCS8, ser.NoEncryption())
        assert pub_pem == key.public_key().public_bytes(
            ser.Encoding.PEM, ser.PublicFormat.SubjectPublicKeyInfo)
        for msg in (b"", b"x", bytes(range(256)) * (i + 1)):
            sig = E.sign(seed, msg)
            assert sig == key.sign(msg)
            assert E.verify(E.public_from_public_pem(pub_pem), sig, msg)
            bad = bytes([sig[0] ^ 1]) + sig[1:]
            assert not E.verify(E.public_from_public_pem(pub_pem), bad, msg)
        kw = [dict(prefixes=[b"t/"], expires_at=100.0),
              dict(prefixes=[b""], expires_at=1e12, system=True),
              dict(prefixes=[b"\x00\x01"], expires_at=5.5, tenant=b"acme")]
        for k in kw:
            tok = P.mint_token(priv_pem, **k)
            assert tok == J.mint_token(priv_pem, **k)
            want = J.TokenAuthority(pub_pem).verify(tok, now=1.0)
            assert P.TokenAuthority(pub_pem).verify(tok, now=1.0) == want
        rogue = P.mint_token(E.generate_keypair_pem(b"\x07" * 32)[0],
                             [b"t/"], expires_at=100.0)
        for A in (P, J):
            with pytest.raises(A.PermissionDenied):
                A.TokenAuthority(pub_pem).verify(rogue, now=1.0)


def test_verify_cache_hits_as_jax(monkeypatch):
    """One signature check per unique token (the port on its pure-Python
    path, JAX on ``cryptography``); expiry is checked past the cache."""
    P = pure_authz(monkeypatch)
    J = mod(PKGS[0], "runtime.authz")
    E = mod(PKGS[1], "runtime._ed25519")
    priv, pub = E.generate_keypair_pem(b"\x05" * 32)
    out = {}
    for pkg, A in ((PKGS[0], J), (PKGS[1], P)):
        checks = [0]
        real = A.TokenAuthority._verify_sig

        def counted(self, sig, payload, real=real, checks=checks):
            checks[0] += 1
            return real(self, sig, payload)

        monkeypatch.setattr(A.TokenAuthority, "_verify_sig", counted)
        auth = A.TokenAuthority(pub)
        toks = [A.mint_token(priv, [b"p%d/" % (i % 3)], expires_at=100.0)
                for i in range(9)]
        seen = [auth.verify(t, now=50.0) for t in toks * 3]
        with pytest.raises(A.PermissionDenied):
            auth.verify(toks[0], now=200.0)
        out[pkg] = (seen, len(auth._cache), checks[0])
    assert norm(out[PKGS[1]]) == norm(out[PKGS[0]])
    assert out[PKGS[1]][2] == 3  # three unique tokens, one check each


# -- locality -----------------------------------------------------------------


def _locality(pkg):
    kw = {"device": "cpu"} if pkg == PKGS[1] else {}
    c = mod(pkg, "sim.cluster").SimCluster(
        seed=41, n_storages=3, n_replicas=2, data_distribution=True,
        engine="oracle", **kw)
    db = mod(pkg, "client.ryw").open_database(c)
    L = mod(pkg, "client.locality")

    async def main():
        async def fill(tr):
            for i in range(64):
                tr.set(b"loc/%03d" % i, b"x" * 400)

        for _ in range(4):
            await db.run(fill)
        dd = c.data_distributor
        for _ in range(3):
            await dd._pass()
        await dd.move_shard(b"loc/020", b"loc/040", (2, 0))
        bounds = await L.get_boundary_keys(db, b"", b"\xff")
        tr = db.transaction()
        teams = [await L.get_addresses_for_key(tr, b"loc/%03d" % i)
                 for i in range(0, 64, 7)]
        sizes = [await L.get_estimated_range_size_bytes(tr, b, e)
                 for b, e in ((b"loc/", b"loc0"), (b"loc/020", b"loc/040"),
                              (b"", b"\xff"))]
        return {"bounds": bounds, "teams": teams, "sizes": sizes}

    return c.loop.run(main(), timeout=600)


def test_locality_equals_jax():
    got = same(_locality)
    assert len(got["bounds"]) > 1 and got["sizes"][0] > 0
