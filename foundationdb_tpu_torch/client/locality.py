"""Locality API — shard boundaries and key→server placement.

A copy of ``foundationdb_tpu/client/locality.py`` for the port, its
imports rewritten to the port's modules; names and behaviour are the JAX
module's.

Reference: fdbclient's locality surface (bindings expose it as
``fdb.locality``): ``get_boundary_keys`` walks the ``\\xff/keyServers/``
map to list shard boundaries, ``get_addresses_for_key`` returns the
storage servers owning a key. Here the same answers come from the
client's shard map (refreshed from the controller, the way the reference
reads keyServers through the proxies), so callers can partition scans by
real shard boundaries and route work near data.
"""

from __future__ import annotations

from foundationdb_tpu_torch.core.types import KeyRange


async def get_boundary_keys(db, begin: bytes, end: bytes) -> list[bytes]:
    """Shard boundary keys in [begin, end), ascending. The first boundary
    at or after `begin` starts the list (reference semantics: the split
    points of the key range, suitable for parallelising a scan)."""
    await db.refresh_client_info()
    bounds: list[bytes] = []
    for sub, _tag in db.storage_map.split_range(KeyRange(begin, end)):
        bounds.append(sub.begin)
    return [b for b in bounds if begin <= b < end]


async def get_addresses_for_key(tr, key: bytes) -> list[str]:
    """Process names of the storage team serving `key` (reference:
    Transaction::getAddressesForKey; process identity stands in for
    ip:port in the sim, and IS ip:port under the TCP runtime)."""
    db = tr.db
    await db.refresh_client_info()
    team = db.storage_map.team_for_key(key)
    out = []
    for tag in team:
        ep = db.storage_eps[tag]
        # Sim endpoints carry a `process` name; TCP RemoteEndpoints carry
        # `_addr` (their __getattr__ manufactures RPC stubs, so a plain
        # getattr for "process" would return a callable, not a name).
        addr = getattr(ep, "_addr", None)
        if addr is not None:
            out.append(f"{addr[0]}:{addr[1]}")
        else:
            proc = ep.__dict__.get("process")
            out.append(proc if isinstance(proc, str) else f"storage{tag}")
    return out


async def get_estimated_range_size_bytes(tr, begin: bytes, end: bytes) -> int:
    """Estimated bytes stored in [begin, end) (reference:
    Transaction::getEstimatedRangeSizeBytes, backed by StorageMetrics).
    Sums each covered shard's byte stats, with the same replica failover
    the read path uses (Database.first_of_team): a dead or lagging/fenced
    replica is demoted and the next team member answers, instead of the
    whole estimate failing on the primary tag alone (ADVICE.md r5)."""
    db = tr.db
    await db.refresh_client_info()
    # Estimate at the transaction's read version: shard_stats waits for
    # the storage apply loop (known-committed fence) to reach it, so the
    # caller's own committed writes are counted.
    version = await tr.get_read_version()
    token = getattr(tr, "authorization_token", None)
    total = 0
    for sub, team in db.storage_map.split_range_teams(KeyRange(begin, end)):
        stats = await db.first_of_team(
            team,
            lambda tag, sub=sub: db.storage_eps[tag].shard_stats(
                sub.begin, sub.end, version, token=token),
        )
        total += int(stats.get("bytes", 0))
    return total
