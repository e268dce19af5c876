"""TimeKeeper: the version ↔ wall-clock map.

A copy of ``foundationdb_tpu/runtime/timekeeper.py`` for the port, its imports rewritten to
the port's modules; names and behaviour are the JAX module's.

Reference: the TimeKeeper actor inside ClusterController.actor.cpp —
every ~10s it writes (clock seconds → committed version) into the system
keyspace at ``\\xff\\x02/timeKeeper/map/``, bounded to a rolling window.
Tooling uses it to turn "restore to 3:14pm" into a version. Same design
here: an actor commits samples through the normal transaction path (so
the map is as durable and replicated as any other data), plus client
helpers to query it.

Clock choice: in simulation, samples key off the loop's VIRTUAL time
(deterministic). On a RealLoop (whose `now` is process-local monotonic
seconds — it restarts near zero each boot), samples key off EPOCH time
instead, so a durable cluster's map stays ordered across host reboots.
"""

from __future__ import annotations

import struct
import time

from foundationdb_tpu_torch.runtime.trace import trace

PREFIX = b"\xff\x02/timeKeeper/map/"
PREFIX_END = PREFIX + b"\xff"
DEFAULT_INTERVAL = 10.0  # reference: CLIENT_KNOBS->TIME_KEEPER_DELAY
MAX_ENTRIES = 8640  # reference keeps ~a day at 10s samples


def _key(seconds: float) -> bytes:
    # Big-endian fixed width so byte order == numeric order.
    return PREFIX + struct.pack(">Q", int(seconds))


class TimeKeeper:
    """Actor: periodically record (now → committed version)."""

    def __init__(self, loop, db, interval: float = DEFAULT_INTERVAL,
                 token: str | None = None):
        self.loop = loop
        self.db = db
        self.interval = interval
        # System-scope authz token (runtime/authz mint_token system=True):
        # required on an authz-enabled cluster, where \xff writes demand
        # an explicit system grant. None on authz-off clusters.
        self.token = token
        self._stopped = False

    def stop(self) -> None:
        self._stopped = True

    async def run(self) -> None:
        while not self._stopped:
            try:
                await self._tick()
            except Exception as e:  # noqa: BLE001 — keep ticking across recoveries
                trace(self.loop).event("TimeKeeperTickFailed",
                                       Error=type(e).__name__)
            await self.loop.sleep(self.interval)

    def _clock(self) -> float:
        # Epoch on real deployments (monotonic restarts each boot and
        # would sort new samples below a durable map's old ones); virtual
        # loop time in the sim.
        return time.time() if getattr(self.loop, "WALL_TIME", False) \
            else self.loop.now

    async def _tick(self) -> None:
        async def body(tr):
            # Clock read INSIDE the attempt: a retry that crossed a long
            # recovery must stamp the commit's actual time, or a stale
            # timestamp pairs with a much newer version and
            # version_for_time over-includes writes.
            now = self._clock()
            tr.set_option("access_system_keys")
            if self.token:
                tr.set_option("authorization_token", self.token)
            version = await tr.get_read_version()
            tr.set(_key(now), struct.pack("<q", version))
            # Trim the rolling window.
            cutoff = now - MAX_ENTRIES * self.interval
            if cutoff > 0:
                tr.clear_range(PREFIX, _key(cutoff))
            return version

        await self.db.run(body)


async def version_for_time(tr, seconds: float) -> int | None:
    """Largest recorded version at-or-before `seconds` (None if the map
    has no sample that old). Reference: versionFromTimeKeeper logic used
    by fdbbackup's --timestamp restores."""
    if seconds < 0:
        return None
    # snapshot=True: lookups need no conflict protection, and a recorded
    # conflict range here would be invalidated by every 10s tick.
    rows = await tr.get_range(PREFIX, _key(seconds) + b"\x00",
                              limit=1, reverse=True, snapshot=True)
    if not rows:
        return None
    return struct.unpack("<q", rows[0][1])[0]


async def time_for_version(tr, version: int) -> float | None:
    """Earliest recorded sample whose version is >= `version` (None if
    the map ends before it) — the inverse lookup."""
    rows = await tr.get_range(PREFIX, PREFIX_END, snapshot=True)
    for k, v in rows:
        if struct.unpack("<q", v)[0] >= version:
            return float(struct.unpack(">Q", k[len(PREFIX):])[0])
    return None
