"""Tenants: named, prefix-isolated keyspaces.

A copy of ``foundationdb_tpu/client/tenant.py`` for the port, its imports
rewritten to the port's modules; names and behaviour are the JAX module's.

Reference: fdbclient/Tenant.cpp + TenantManagement.actor.cpp — a tenant
is a name mapped (via system keyspace metadata) to a short unique key
prefix; transactions opened through a Tenant see only their own keyspace,
with every key transparently prefixed on the way in and stripped on the
way out. Same design here:

- metadata: ``\\xff/tenant/map/<name>`` → 8-byte prefix, allocated from
  ``\\xff/tenant/idCounter`` (monotone counter — prefixes are never
  reused, so late writes from a deleted tenant's stale client cannot
  land in a successor's keyspace).
- ``create_tenant`` / ``delete_tenant`` (must be empty, like the
  reference) / ``list_tenants`` are ordinary transactions with
  access_system_keys.
- ``Tenant(db, name)`` hands out TenantTransactions: RYW transactions
  whose public surface maps keys through the tenant prefix. Conflict
  ranges, RYW overlay, atomic ops, watches and retry all inherit — the
  prefix mapping happens strictly at the API boundary.
"""

from __future__ import annotations

import struct

from foundationdb_tpu_torch.client.ryw import RYWTransaction
from foundationdb_tpu_torch.client.transaction import KeySelector, run_transaction_loop
from foundationdb_tpu_torch.core.errors import FdbError
from foundationdb_tpu_torch.core.mutations import MutationType
from foundationdb_tpu_torch.core.types import strinc

from foundationdb_tpu_torch.core.types import TENANT_MAP_PREFIX  # canonical home

TENANT_ID_COUNTER = b"\xff/tenant/idCounter"
# Tenant data lives under this byte BY CONVENTION, like the reference's
# optional tenant mode: plain-database clients are not fenced off from it
# (a raw client CAN read or clobber \x1e-prefixed rows, exactly as a raw
# fdb client can when the cluster does not require tenants). Cluster-wide
# enforcement (reference: tenant_mode=required) is not implemented.
DATA_PREFIX = b"\x1e"


class TenantError(FdbError):
    code = 2130  # tenant_name_required..tenant family; closest public code

    def __init__(self, message: str, code: int | None = None):
        super().__init__(message, code)


class TenantNotFound(TenantError):
    def __init__(self, name: bytes):
        super().__init__(f"tenant {name!r} not found", code=2131)


class TenantExists(TenantError):
    def __init__(self, name: bytes):
        super().__init__(f"tenant {name!r} already exists", code=2132)


class TenantNotEmpty(TenantError):
    def __init__(self, name: bytes):
        super().__init__(f"tenant {name!r} is not empty", code=2133)


def _check_name(name: bytes) -> None:
    if not name or name.startswith(b"\xff"):
        raise TenantError(f"illegal tenant name {name!r}", code=2134)


async def create_tenant(db, name: bytes, token: str | None = None) -> bytes:
    """Create `name`; returns its data prefix (reference:
    TenantAPI::createTenant). On an authz-enabled cluster `token` must
    carry the system grant (runtime/authz mint_token system=True) — the
    tenant map lives in \\xff and system writes are token-gated there."""
    _check_name(name)

    async def body(tr):
        tr.set_option("access_system_keys")
        if token:
            tr.set_option("authorization_token", token)
        if await tr.get(TENANT_MAP_PREFIX + name) is not None:
            raise TenantExists(name)
        raw = await tr.get(TENANT_ID_COUNTER)
        next_id = (struct.unpack(">Q", raw)[0] + 1) if raw else 1
        tr.set(TENANT_ID_COUNTER, struct.pack(">Q", next_id))
        prefix = DATA_PREFIX + struct.pack(">Q", next_id)
        tr.set(TENANT_MAP_PREFIX + name, prefix)
        return prefix

    return await db.run(body)


async def delete_tenant(db, name: bytes, token: str | None = None) -> None:
    """Delete `name`; fails unless its keyspace is empty (reference
    semantics — data must be cleared first). `token` as create_tenant."""

    async def body(tr):
        tr.set_option("access_system_keys")
        if token:
            tr.set_option("authorization_token", token)
        prefix = await tr.get(TENANT_MAP_PREFIX + name)
        if prefix is None:
            raise TenantNotFound(name)
        rows = await tr.get_range(prefix, strinc(prefix), limit=1)
        if rows:
            raise TenantNotEmpty(name)
        tr.clear(TENANT_MAP_PREFIX + name)

    await db.run(body)


async def list_tenants(db, token: str | None = None) -> list[bytes]:
    """`token`: any valid token on a read-authz cluster (the tenant map
    admits every tokened reader — runtime/authz.TENANT_MAP_RANGE)."""
    async def body(tr):
        tr.set_option("access_system_keys")
        if token:
            tr.set_option("authorization_token", token)
        rows = await tr.get_range(
            TENANT_MAP_PREFIX, TENANT_MAP_PREFIX + b"\xff"
        )
        return [k[len(TENANT_MAP_PREFIX):] for k, _v in rows]

    return await db.run(body)


class Tenant:
    """Handle to one tenant's keyspace (reference: fdb_database_open_tenant).

    The prefix is resolved lazily on first use and cached (reference
    clients cache the tenant map entry the same way)."""

    def __init__(self, db, name: bytes, token: str | None = None):
        """`token`: the tenant's authz token — on a read-authz cluster the
        lazy prefix resolution reads the tenant map at storage, which
        admits any VALID token (runtime/authz.TENANT_MAP_RANGE)."""
        _check_name(name)
        self.db = db
        self.name = name
        self.token = token
        self._prefix: bytes | None = None

    async def _resolve(self) -> bytes:
        if self._prefix is None:
            # Through the retry loop: a raw read here would surface
            # transient errors (killed proxy, recovery in flight) as
            # tenant failures — found by the buggify campaign.
            async def body(tr):
                tr.set_option("access_system_keys")
                if self.token:
                    tr.set_option("authorization_token", self.token)
                return await tr.get(TENANT_MAP_PREFIX + self.name)

            prefix = await self.db.run(body)
            if prefix is None:
                raise TenantNotFound(self.name)
            self._prefix = prefix
        return self._prefix

    def transaction(self) -> "TenantTransaction":
        return TenantTransaction(self)

    async def run(self, fn, max_retries: int = 50):
        """The canonical retry loop, tenant-scoped. Resolves the prefix
        up front so write-only bodies work (no dummy read needed)."""
        await self._resolve()
        return await run_transaction_loop(self.transaction(), fn, max_retries)


class TenantTransaction(RYWTransaction):
    """RYW transaction confined to one tenant's prefix.

    Every public key crossing the API is mapped through the prefix; keys
    coming back out are stripped. The underlying machinery (conflict
    ranges, overlay, commit, retry) operates on the real (prefixed) keys
    and is inherited unchanged."""

    def __init__(self, tenant: Tenant):
        super().__init__(tenant.db)
        self._tenant = tenant

    async def _p(self, key: bytes) -> bytes:
        if not isinstance(key, bytes):
            raise TypeError(f"key must be bytes, got {type(key).__name__}")
        return await self._tenant._resolve() + key

    def _strip(self, key: bytes) -> bytes:
        return key[len(self._tenant._prefix):]

    # -- reads ---------------------------------------------------------------

    async def get(self, key: bytes, snapshot: bool = False):
        return await super().get(await self._p(key), snapshot=snapshot)

    async def get_range(self, begin: bytes, end: bytes, limit: int = 0,
                        reverse: bool = False, snapshot: bool = False):
        rows = await super().get_range(
            await self._p(begin), await self._p(end),
            limit=limit, reverse=reverse, snapshot=snapshot,
        )
        return [(self._strip(k), v) for k, v in rows]

    async def get_key(self, sel: KeySelector, snapshot: bool = False) -> bytes:
        """Selector walk over RAW (prefixed) ranges, scan bounds pinned to
        the tenant's span — resolution is confined to the tenant by
        construction (reference: tenant transactions clamp to the tenant
        range). Calls the BASE get_range explicitly: the inherited
        get_key would dispatch to our overriding get_range and
        double-prefix."""
        prefix = await self._tenant._resolve()
        raw_range = RYWTransaction.get_range
        anchor = prefix + sel.key
        span_end = strinc(prefix)  # covers EVERY tenant key incl. >= \xff
        if sel.offset >= 1:
            begin = anchor + b"\x00" if sel.or_equal else anchor
            rows = await raw_range(
                self, max(begin, prefix), span_end,
                limit=sel.offset, snapshot=snapshot,
            )
            if len(rows) < sel.offset:
                return b"\xff"  # off the tenant's end
            return self._strip(rows[sel.offset - 1][0])
        back = 1 - sel.offset
        end = anchor + b"\x00" if sel.or_equal else anchor
        rows = await raw_range(
            self, prefix, max(min(end, span_end), prefix),
            limit=back, reverse=True, snapshot=snapshot,
        )
        if len(rows) < back:
            return b""  # off the tenant's front
        return self._strip(rows[back - 1][0])

    async def watch(self, key: bytes):
        # Baseline read via the BASE get (the inherited watch would
        # dispatch back to our overriding get and double-prefix).
        from foundationdb_tpu_torch.runtime.flow import Future

        real = await self._p(key)
        value = await RYWTransaction.get(self, real, snapshot=True)
        slot = Future()
        self._pending_watches.append((real, value))
        self._watch_futures.append(slot)
        return slot

    # -- writes --------------------------------------------------------------
    # Mutations are synchronous in the base API, so the prefix must be
    # resolved beforehand: Tenant.run resolves it before the retry loop;
    # a hand-built transaction must read (or await tenant._resolve())
    # before writing.

    def _pp(self, key: bytes) -> bytes:
        if self._tenant._prefix is None:
            raise TenantError(
                "tenant prefix not resolved — use Tenant.run (resolves it "
                "up front), or read/await tenant._resolve() first",
                code=2135,
            )
        if not isinstance(key, bytes):
            raise TypeError(f"key must be bytes, got {type(key).__name__}")
        return self._tenant._prefix + key

    def set(self, key: bytes, value: bytes) -> None:
        super().set(self._pp(key), value)

    def clear(self, key: bytes) -> None:
        super().clear(self._pp(key))

    def clear_range(self, begin: bytes, end: bytes) -> None:
        super().clear_range(self._pp(begin), self._pp(end))

    def atomic_op(self, op: MutationType, key: bytes, param: bytes) -> None:
        super().atomic_op(op, self._pp(key), param)

    def add_read_conflict_range(self, begin: bytes, end: bytes) -> None:
        super().add_read_conflict_range(self._pp(begin), self._pp(end))

    def add_write_conflict_range(self, begin: bytes, end: bytes) -> None:
        super().add_write_conflict_range(self._pp(begin), self._pp(end))
