"""YCSB-A clients over a whole simulated cluster, with role kills.

``ClusterLoad`` drives a ``SimCluster`` (``sim/cluster.py``) through the
client library (``client/ryw.py`` ``open_database``): closed-loop clients
on the cluster's loop, each taking the next transaction of a YCSB-A
stream (``loadgen/ycsb.py``: scrambled Zipf-0.99 over the keys, 2 point
reads, half the transactions writing one point) and running it through
``Database.run``: ``tr.get_multi`` of its read keys (one ``get_multi``
RPC per owning storage team, answered by the storage server's read
plane), then ``tr.set`` of its write, then the commit, retried by the
client's retry loop across conflicts and recoveries. A read-only
transaction commits in the client, as the reference's does.

Kills are placed at counts of finished transactions, never at a wall
time: ``kills`` maps a count to a role name (``"resolver0"``,
``"tlog0"``), and the process of that role in the generation current at
that moment is killed. The cluster controller's heartbeat sweep then
recovers to a new epoch, recruiting fresh resolvers (and so fresh
engines) and handing the storage servers over.

``preload`` writes rows ``0 .. n - 1`` of the key space first, in blind
transactions of a fixed number of rows through ``Database.run`` (a
durable cluster's data to restart from); ``run_ycsb(field_bytes=...)``
pads each written value to a YCSB field length.

What the run records: each transaction's attempts, the error code of
every failed attempt, and its final outcome (committed with its commit
version and batch index, or the error code ``Database.run`` gave up
with); every generation recruited (epoch, recovery version); each commit
proxy's wave schedule of every batch (a wave engine's (wave, index)
order of a version's mutations). ``outcomes_sha256`` hashes the
transactions' records and the generations: a run is a function of its
seed and its engines' verdicts, so the same run over the card engine,
over the plain versions on the CPU and over the oracle hashes the same.

Measured beside the events, and never read by them: the wall seconds of
the run, of every resolver dispatch (``sim/commit_path.time_dispatches``)
and, for each recovery, the virtual and wall time from the kill to the
new epoch's first acknowledged commit, the wall ms of the new resolvers'
first dispatch and of their longest dispatch up to that commit, and what
``probe()`` returns at that commit (the card's allocated bytes, say). The class takes any package's cluster: a test may
drive the JAX package's ``SimCluster`` with the same clients.
"""

from __future__ import annotations

import hashlib
from time import perf_counter

import numpy as np

from foundationdb_tpu_torch.loadgen.ycsb import MODES, gen_workload
from foundationdb_tpu_torch.sim.commit_path import (
    KEY_BYTES,
    time_dispatches,
    ycsb_value,
)

#: Final outcome status; any other is the fdb code of the final error.
COMMITTED = 0


def field_value(v: bytes, field_bytes: int | None) -> bytes:
    """``v`` padded with ``-`` to ``field_bytes`` (None: as it is)."""
    return v if field_bytes is None else v.ljust(field_bytes, b"-")


def preload_value(i: int) -> bytes:
    """The value row ``i`` is preloaded with."""
    return b"r%011d" % i


def cluster_key(i: int, key_bits: int) -> bytes:
    """The 12-byte user key of id ``i`` < 2^key_bits: the id in the top
    bits scaled by 255/256, so keys keep the ids' order, spread over the
    uniform maps' first-byte boundaries and never start with ``\\xff``
    (the system keyspace, which the client refuses to write)."""
    k = int(i) << (8 * KEY_BYTES - key_bits)
    return (k - (k >> 8)).to_bytes(KEY_BYTES, "big")


class ClusterLoad:
    """YCSB-A transactions over ``cluster`` through ``db`` (the cluster's
    ``open_database``), ``kills`` as {finished transactions: role}.
    ``probe`` (optional) is called at each new epoch's first commit."""

    def __init__(self, cluster, db, *, kills: dict | None = None,
                 probe=None):
        self.c, self.db = cluster, db
        self.kills = dict(kills or {})
        self.probe = probe
        self.generations: list[tuple[int, int]] = []
        self.waves: dict[int, list | None] = {}
        self.recoveries: list[dict] = []
        self.dispatch_s: list[float] = []
        # epoch -> each of its resolvers' dispatch seconds, in order
        self.gen_dispatch_s: dict[int, list[list[float]]] = {}
        g = cluster.controller.generation
        self.generations.append((g.epoch, g.recovery_version))
        self._watch_generation(cluster.commit_proxies, cluster.resolvers,
                               g.epoch)
        recruit = cluster.recruit_generation

        def recruit_and_watch(epoch, recovery_version, seed_entries):
            gen = recruit(epoch=epoch, recovery_version=recovery_version,
                          seed_entries=seed_entries)
            self.generations.append((epoch, recovery_version))
            self._watch_generation(cluster.commit_proxies,
                                   cluster.resolvers, epoch)
            return gen

        cluster.recruit_generation = recruit_and_watch

    def _watch_generation(self, proxies, resolvers, epoch: int) -> None:
        """Spy each commit proxy's resolve step for its wave schedule, and
        time every dispatch of each resolver, kept by generation."""
        for proxy in proxies:
            resolve = proxy._resolve

            async def spy_resolve(batch, prev_version, version,
                                  _resolve=resolve):
                out = await _resolve(batch, prev_version, version)
                self.waves[version] = out[3]
                return out

            proxy._resolve = spy_resolve
        mine = self.gen_dispatch_s.setdefault(epoch, [])
        for r in resolvers:
            mine.append(_Times(self.dispatch_s))
            time_dispatches(r, mine[-1])

    # -- clients --------------------------------------------------------------

    def preload(self, n_rows: int, rows_per_txn: int, n_clients: int,
                key_bits: int, field_bytes: int | None = None) -> dict:
        """Write rows ``0 .. n_rows - 1`` (``cluster_key``, each
        ``preload_value`` padded to ``field_bytes``) in transactions of
        ``rows_per_txn`` rows taken in order by ``n_clients`` closed-loop
        clients. Returns the wall seconds, the transactions and each
        one's commit version (``preload_versions``)."""
        loop = self.c.loop
        n_txns = -(-n_rows // rows_per_txn)
        self.key_bits = key_bits
        self._preload = (n_rows, rows_per_txn, field_bytes)
        self.preload_versions = np.full(n_txns, -1, np.int64)
        nxt = [0]

        async def client() -> None:
            while nxt[0] < n_txns:
                t = nxt[0]
                nxt[0] += 1
                lo, hi = t * rows_per_txn, min(n_rows, (t + 1) * rows_per_txn)
                seen: list = []

                async def body(tr, lo=lo, hi=hi, seen=seen):
                    seen[:] = [tr]
                    for i in range(lo, hi):
                        tr.set(cluster_key(i, key_bits),
                               field_value(preload_value(i), field_bytes))

                await self.db.run(body)
                self.preload_versions[t] = seen[0]._committed[0]

        t0 = perf_counter()
        for task in [loop.spawn(client(), name=f"preload.client{c}")
                     for c in range(n_clients)]:
            loop.run_until(task)
        return {"rows": n_rows, "txns": n_txns, "clients": n_clients,
                "wall_s": perf_counter() - t0}

    def run_ycsb(self, n_txns: int, n_clients: int, key_bits: int,
                 seed: int = 0, field_bytes: int | None = None) -> dict:
        """Drive ``n_txns`` YCSB-A transactions through ``n_clients``
        closed-loop clients, each write's value padded to ``field_bytes``;
        returns the run's summary. ``outcomes``
        [N, 4] int64 holds each transaction's attempts, final status
        (COMMITTED or an error code), commit version and batch index
        (-1, -1 unless committed through a proxy; a read-only
        transaction's version is its read version, index 0)."""
        loop = self.c.loop
        read_ids, write_ids, write_mask, _lag = gen_workload(
            n_txns, 1 << key_bits, seed, MODES["ycsb"])
        self.key_bits, self.field_bytes = key_bits, field_bytes
        self.read_ids, self.write_ids = read_ids, write_ids[:, 0]
        self.write_mask = write_mask
        self.outcomes = np.full((n_txns, 4), -1, np.int64)
        self.errors: list[list[int]] = [[] for _ in range(n_txns)]
        self._next = self.finished = 0
        self._kill_t: dict | None = None

        async def client() -> None:
            while self._next < n_txns:
                t = self._next
                self._next += 1
                await self._transaction(t)
                self.finished += 1
                victim = self.kills.get(self.finished)
                if victim is not None:
                    self._kill(victim)

        t0 = perf_counter()
        for task in [loop.spawn(client(), name=f"ycsb.client{c}")
                     for c in range(n_clients)]:
            loop.run_until(task)
        wall = perf_counter() - t0
        status, attempts = self.outcomes[:, 1], self.outcomes[:, 0]
        writes = status == COMMITTED
        return {
            "txns": n_txns, "clients": n_clients, "wall_s": wall,
            "virtual_s": loop.now,
            "committed": int(writes.sum()),
            "write_commits": int((writes & write_mask).sum()),
            "failed": int((~writes).sum()),
            "attempts": int(attempts.sum()),
            "retries": int(attempts.sum() - n_txns),
            "committed_share": float(writes.sum() / attempts.sum()),
            "conflicts": sum(e.count(1020) for e in self.errors),
            "error_codes": _counts(self.errors),
            "epochs": [e for e, _ in self.generations],
            "recovery_versions": [v for _, v in self.generations],
            "cluster_outcomes_sha256": self.outcomes_sha256(),
        }

    def _kill(self, role: str) -> None:
        """Kill ``role``'s process in the current generation."""
        eps = {**{f"resolver{i}": ep
                  for i, ep in enumerate(self.c.resolver_eps)},
               **{f"tlog{i}": ep for i, ep in enumerate(self.c.tlog_eps)},
               **{f"commit_proxy{i}": ep
                  for i, ep in enumerate(self.c.commit_proxy_eps)},
               **{f"grv_proxy{i}": ep
                  for i, ep in enumerate(self.c.grv_proxy_eps)},
               "master": self.c.sequencer_ep}
        proc = eps[role].process[len(self.c.process_prefix):]
        self.c.net.kill(proc)
        self._kill_t = {"victim": proc, "at_txn": self.finished,
                        "epoch": self.c.controller.generation.epoch,
                        "kill_virtual": self.c.loop.now,
                        "kill_wall": perf_counter()}

    async def _transaction(self, t: int) -> None:
        rkeys = [cluster_key(i, self.key_bits) for i in self.read_ids[t]]
        wkey = (cluster_key(self.write_ids[t], self.key_bits)
                if self.write_mask[t] else None)
        errors = self.errors[t]
        seen: list = []

        async def body(tr):
            if not seen:
                seen.append(tr)
                on_error = tr.on_error

                async def noted(e):
                    errors.append(int(getattr(e, "code", -1)))
                    return await on_error(e)

                tr.on_error = noted
            await tr.get_multi(rkeys)
            if wkey is not None:
                tr.set(wkey, field_value(ycsb_value(t), self.field_bytes))

        try:
            await self.db.run(body)
        except Exception as e:  # noqa: BLE001 - the run's final outcome
            code = getattr(e, "code", None)
            if code is None:
                raise
            self.outcomes[t] = (len(errors) + 1, int(code), -1, -1)
            return
        version, index = seen[0]._committed
        self.outcomes[t] = (len(errors) + 1, COMMITTED, version, index)
        if wkey is not None:
            self._note_commit(version)

    def _note_commit(self, version: int) -> None:
        """The first acknowledged commit of a new epoch closes the open
        recovery record."""
        k = self._kill_t
        epoch, rv = self.generations[-1]
        if k is None or epoch <= k["epoch"] or version <= rv:
            return
        self._kill_t = None
        rec = {**k, "new_epoch": epoch, "recovery_version": rv,
               "first_version": version,
               "to_first_commit_virtual_s": self.c.loop.now - k["kill_virtual"],
               "to_first_commit_wall_s": perf_counter() - k["kill_wall"],
               **self.first_dispatches_ms(epoch)}
        del rec["kill_wall"]
        if self.probe is not None:
            rec.update(self.probe())
        self.recoveries.append(rec)

    # -- after the run --------------------------------------------------------

    def outcomes_sha256(self) -> str:
        h = hashlib.sha256(np.ascontiguousarray(self.outcomes).tobytes())
        h.update(repr(self.errors).encode())
        h.update(repr(self.generations).encode())
        return h.hexdigest()

    def first_dispatches_ms(self, epoch: int) -> dict:
        """Wall ms of each of ``epoch``'s resolvers' first dispatch, and
        the longest of their dispatches so far (at the new epoch's first
        commit: the first batch with transactions is among them)."""
        times = self.gen_dispatch_s.get(epoch, [])
        return {"first_dispatch_ms": [t[0] * 1e3 if t else None
                                      for t in times],
                "longest_dispatch_ms": [max(t) * 1e3 if t else None
                                        for t in times],
                "dispatches_so_far": [len(t) for t in times]}

    def epoch_firsts(self) -> dict[int, int]:
        """For each recovered epoch, the first acknowledged write commit
        version above its recovery version (None when none)."""
        st, ver = self.outcomes[:, 1], self.outcomes[:, 2]
        acked = ver[(st == COMMITTED) & self.write_mask]
        out = {}
        for epoch, rv in self.generations[1:]:
            above = acked[acked > rv]
            out[epoch] = int(above.min()) if len(above) else None
        return out

    def replay(self, upto: int | None = None) -> dict[bytes, bytes]:
        """Every written key's value after the run (or as of version
        ``upto``), replayed on the host from the acknowledged commits: the
        preloaded rows first, then in version order, and within a version
        in batch-index order, or in (wave, index) order where the batch's
        verdicts came with a wave schedule."""
        st, ver, idx = self.outcomes[:, 1], self.outcomes[:, 2], \
            self.outcomes[:, 3]
        done = (st == COMMITTED) & self.write_mask
        if upto is not None:
            done &= ver <= upto
        rows = np.flatnonzero(done)

        def order(t):
            wave = self.waves.get(int(ver[t]))
            i = int(idx[t])
            return (int(ver[t]), max(wave[i], 0) if wave else 0, i)

        final: dict[bytes, bytes] = {}
        if hasattr(self, "_preload"):
            n_rows, per_txn, field_bytes = self._preload
            for p, v in enumerate(self.preload_versions.tolist()):
                if upto is None or v <= upto:
                    for i in range(p * per_txn, min(n_rows, (p + 1) * per_txn)):
                        final[cluster_key(i, self.key_bits)] = field_value(
                            preload_value(i), field_bytes)
        for t in sorted(rows.tolist(), key=order):
            final[cluster_key(self.write_ids[t], self.key_bits)] = \
                field_value(ycsb_value(t), self.field_bytes)
        return final

    def read_back(self, keys: list[bytes]) -> dict[bytes, bytes | None]:
        """``keys`` read in one transaction through ``tr.get_multi`` (one
        ``get_multi`` RPC per owning storage team, the read plane's
        coalesced search) at a fresh read version."""
        got: list = []

        async def body(tr):
            got[:] = await tr.get_multi(keys)

        self.c.loop.run(self.db.run(body))
        return dict(zip(keys, got))


class _Times(list):
    """A resolver's dispatch times; each also goes to ``every``."""

    def __init__(self, every: list):
        super().__init__()
        self.every = every

    def append(self, t: float) -> None:
        self.every.append(t)
        super().append(t)


def _counts(errors: list[list[int]]) -> dict[str, int]:
    out: dict[str, int] = {}
    for errs in errors:
        for e in errs:
            out[str(e)] = out.get(str(e), 0) + 1
    return dict(sorted(out.items()))
