"""Storage-side deadline coalescer for the read plane.

The port of ``foundationdb_tpu/reads/coalescer.py`` (its brain learns
a dispatch's cost on the loop's clock, not the wall's: the one difference,
see ``_dispatch``). The brain that
batches resolver dispatches (sched/coalescer.py: latency-budget deadline
coalescing and an online dispatch cost model) gathers concurrent get /
multi-get / get_range requests queued against one storage server into a
single ``TorchReadSet`` search. Requests at DIFFERENT read versions merge
into the same dispatch: the packed search is version-independent, only
the host-side value gather consults each request's version.

Observability: each dispatch ticks the read-plane sub-stages
(``read_coalesce``, the oldest queue wait; ``read_pack``, the host pack
time; ``read_dispatch``, search and gather) through the loop's span sink
when the loop carries one (``obs/span.py``'s ``span_sink``).
"""

from __future__ import annotations

from time import perf_counter

from foundationdb_tpu_torch.obs.span import span_sink
from foundationdb_tpu_torch.runtime.flow import Promise
from foundationdb_tpu_torch.sched.coalescer import AdaptiveCoalescer


class ReadBrain(AdaptiveCoalescer):
    """Deadline-only window policy for the read plane.

    The resolver brain's fill-abort branch (ship NOW when the window
    cannot fill before the deadline) minimizes verdict latency, but on
    the read plane it degenerates: the cost model only ever observes
    depth-1 dispatches, so it never learns amortization, concludes
    batching is worthless, and ships every request as a singleton — the
    exact per-key actor pattern this subsystem replaces. Reads are cheap
    and plentiful; the win IS the amortized probe. So: hold until the
    oldest request's budget is spent (or the window fills), then ship
    everything queued. The inherited cost model still prices the
    dispatch into the deadline so a slow probe ships early."""

    def decide(self, queued: int, oldest_age_ms: float) -> int:
        if queued <= 0:
            return 0
        if self.budget_ms <= 0 or queued >= self.max_window:
            return min(queued, self.max_window)
        if oldest_age_ms + self.cost.predict(queued) >= self.budget_ms:
            return min(queued, self.max_window)
        return 0


class _Req:
    __slots__ = ("kind", "args", "version", "p", "t_in")

    def __init__(self, kind, args, version, p, t_in):
        self.kind = kind  # "points" | "range"
        self.args = args
        self.version = version
        self.p = p
        self.t_in = t_in


class ReadCoalescer:
    """Queue + pump: submit_* parks the caller on a promise; the pump
    task dispatches windows per the adaptive brain's decision."""

    MIN_TICK_S = 0.0001  # pump re-decide floor (virtual s)

    def __init__(self, loop, read_set, budget_ms: float = 0.25,
                 max_window: int = 64):
        self.loop = loop
        self.read_set = read_set
        self.brain = ReadBrain(budget_ms=budget_ms, max_window=max_window)
        self._q: list[_Req] = []
        self._wake: Promise | None = None
        self._pump_task = None
        self.stats = {
            "dispatches": 0, "requests": 0, "point_reads": 0,
            "range_reads": 0, "busy_s": 0.0, "errors": 0,
        }
        self._t_first = None  # perf_counter at first dispatch (occupancy)
        self._last_pack_s = 0.0

    # -- client surface -------------------------------------------------------

    async def submit_points(self, keys, version: int):
        return await self._submit("points", list(keys), version)

    async def submit_range(self, begin, end, limit, reverse, version: int):
        return await self._submit("range", (begin, end, limit, reverse),
                                  version)

    async def _submit(self, kind, args, version):
        req = _Req(kind, args, version, Promise(), self.loop.now)
        self._q.append(req)
        self.brain.note_arrival(self.loop.now * 1000.0)
        if self._pump_task is None:
            self._pump_task = self.loop.spawn(self._pump(), name="read_pump")
        if self._wake is not None:
            w, self._wake = self._wake, None
            w.send(None)
        return await req.p.future

    # -- pump -----------------------------------------------------------------

    async def _pump(self):
        while True:
            if not self._q:
                self._wake = Promise()
                await self._wake.future
                continue
            now_ms = self.loop.now * 1000.0
            oldest_ms = now_ms - self._q[0].t_in * 1000.0
            depth = self.brain.decide(len(self._q), oldest_ms)
            if depth <= 0:
                hint = self.brain.wait_hint_ms(len(self._q), oldest_ms)
                await self.loop.sleep(max(hint / 1000.0, self.MIN_TICK_S))
                continue
            batch, self._q = self._q[:depth], self._q[depth:]
            self._dispatch(batch, oldest_ms)

    def _dispatch(self, batch: list[_Req], oldest_ms: float) -> None:
        sink = span_sink(self.loop)
        t0, t0_loop = perf_counter(), self.loop.now
        if self._t_first is None:
            self._t_first = t0
        point_reqs = [r for r in batch if r.kind == "points"]
        range_reqs = [r for r in batch if r.kind == "range"]
        try:
            flat_keys: list[bytes] = []
            flat_versions: list[int] = []
            for r in point_reqs:
                flat_keys.extend(r.args)
                flat_versions.extend([r.version] * len(r.args))
            pack_before = self.read_set.stats["pack_s"]
            values = (self.read_set.get_points(flat_keys, flat_versions)
                      if flat_keys else [])
            ranges = (self.read_set.get_ranges(
                [(*r.args, r.version) for r in range_reqs])
                if range_reqs else [])
        except BaseException as e:  # engine bug: fail the batch, not the pump
            self.stats["errors"] += 1
            for r in batch:
                r.p.fail(e)
            return
        pos = 0
        for r in point_reqs:
            k = len(r.args)
            r.p.send(values[pos:pos + k])
            pos += k
        for r, rows in zip(range_reqs, ranges):
            r.p.send(rows)
        dt = perf_counter() - t0
        self.stats["dispatches"] += 1
        self.stats["requests"] += len(batch)
        self.stats["point_reads"] += len(flat_keys)
        self.stats["range_reads"] += len(range_reqs)
        self.stats["busy_s"] += dt
        # The brain learns the dispatch's cost on the loop's clock, as the
        # resolver's queue does (sched/resolver_queue.py): none on a
        # simulated loop, whose runs stay a function of their seed. The
        # JAX module feeds it the wall time, so its simulated reads depend
        # on the host's speed.
        self.brain.observe_dispatch(len(batch),
                                    (self.loop.now - t0_loop) * 1000.0)
        if sink is not None:
            sink.stage_tick("read_coalesce", oldest_ms / 1000.0, len(batch))
            pack_s = self.read_set.stats["pack_s"] - pack_before
            sink.stage_tick("read_pack", pack_s, 1)
            sink.stage_tick("read_dispatch", dt, len(batch))

    # -- metrics --------------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return len(self._q)

    @property
    def occupancy(self) -> float:
        """Fraction of real time since the first dispatch spent inside
        dispatches (host-cost gauge; 0 before any dispatch)."""
        if self._t_first is None:
            return 0.0
        elapsed = perf_counter() - self._t_first
        return min(1.0, self.stats["busy_s"] / elapsed) if elapsed > 0 else 0.0

    @property
    def reads_per_dispatch(self) -> float:
        d = self.stats["dispatches"]
        if not d:
            return 0.0
        return (self.stats["point_reads"] + self.stats["range_reads"]) / d
