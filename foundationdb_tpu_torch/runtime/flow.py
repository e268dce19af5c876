"""Cooperative actor runtime with virtual time: the Flow analogue.

A copy of ``foundationdb_tpu/runtime/flow.py`` (pure Python), so that the
port's read plane and, later, its roles run on the same loop with the
same order of events under the same seed. The reference builds everything
on flow/: actors compiled to state machines over Future/Promise, one
single-threaded event loop (flow/Net2.actor.cpp), and a simulation mode
(flow/sim2.actor.cpp) that virtualises time under one seeded RNG so
whole-cluster runs are deterministic and replayable.

Actors are ordinary ``async def`` coroutines, Futures are awaitable
single-assignment cells, and ``Loop`` is a deterministic scheduler over
virtual time. Determinism guarantees: FIFO ready queue, timer heap
tie-broken by insertion sequence, and any randomness (network latency,
fault injection) drawn from the loop's seeded RNG.

Process semantics for fault injection: every task belongs to a named process
(inherited from the spawning task); ``Loop.kill_process`` cancels all its
tasks, so in-flight actors die mid-await exactly like a crashed fdbserver.
It cancels them in spawn order; the JAX module cancels them in the order
of a set hashed by address, which varies from run to run under one seed
(the one difference from the JAX module).
"""

from __future__ import annotations

import heapq
import random
from collections import deque
from typing import Any, Callable, Coroutine, Iterable

from foundationdb_tpu_torch.core.errors import FdbError

_PENDING = "pending"
_DONE = "done"
_ERROR = "error"


class ActorCancelled(BaseException):
    """Raised inside a coroutine when its task is cancelled (process kill).

    BaseException so ordinary ``except Exception`` recovery code in actors
    doesn't swallow a kill — mirroring flow's actor_cancelled."""


class BrokenPromise(FdbError):
    """The promise side went away without a value (reference: broken_promise,
    error 1100) — e.g. the server processing an RPC was killed."""

    code = 1100


class Future:
    """Single-assignment awaitable cell (reference: flow Future<T>)."""

    __slots__ = ("_state", "_value", "_callbacks")

    def __init__(self) -> None:
        self._state = _PENDING
        self._value: Any = None
        self._callbacks: list[Callable[[Future], None]] = []

    # -- inspection
    def done(self) -> bool:
        return self._state != _PENDING

    def is_error(self) -> bool:
        return self._state == _ERROR

    def result(self) -> Any:
        if self._state == _DONE:
            return self._value
        if self._state == _ERROR:
            raise self._value
        raise RuntimeError("future not ready")

    def exception(self) -> BaseException | None:
        return self._value if self._state == _ERROR else None

    # -- completion
    def _finish(self, state: str, value: Any) -> None:
        if self._state != _PENDING:
            return  # late completion (e.g. reply racing a kill) is dropped
        self._state = state
        self._value = value
        cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(self)

    def add_done_callback(self, cb: Callable[[Future], None]) -> None:
        if self._state != _PENDING:
            cb(self)
        else:
            self._callbacks.append(cb)

    def __await__(self):
        if not self.done():
            yield self
        return self.result()


class Promise:
    """Write end of a Future (reference: flow Promise<T>)."""

    __slots__ = ("future",)

    def __init__(self) -> None:
        self.future = Future()

    def send(self, value: Any = None) -> None:
        self.future._finish(_DONE, value)

    def fail(self, exc: BaseException) -> None:
        self.future._finish(_ERROR, exc)

    def broken(self) -> None:
        if not self.future.done():
            self.fail(BrokenPromise())


class Task(Future):
    """A running actor: a coroutine stepped by the loop, itself awaitable."""

    __slots__ = ("_coro", "_loop", "process", "name", "_awaiting")

    def __init__(self, loop: "Loop", coro: Coroutine, process: str, name: str):
        super().__init__()
        self._coro = coro
        self._loop = loop
        self.process = process
        self.name = name
        self._awaiting: Future | None = None

    def cancel(self) -> None:
        if self.done():
            return
        self._awaiting = None
        self._loop._ready.append((self, ActorCancelled()))

    def _step(self, wake: BaseException | Future | None) -> None:
        if self.done():
            return
        self._loop._current = self
        try:
            if isinstance(wake, BaseException):
                waited = self._coro.throw(wake)
            else:
                waited = self._coro.send(None)
        except StopIteration as e:
            self._finish(_DONE, e.value)
            return
        except ActorCancelled:
            self._finish(_ERROR, BrokenPromise(f"actor {self.name} cancelled"))
            return
        except BaseException as e:  # noqa: BLE001 — actor errors flow to waiters
            self._finish(_ERROR, e)
            return
        finally:
            self._loop._current = None
        assert isinstance(waited, Future), f"actors may only await Futures, got {waited!r}"
        self._awaiting = waited
        waited.add_done_callback(self._on_awaited)

    def _on_awaited(self, fut: Future) -> None:
        if self._awaiting is fut:
            self._awaiting = None
            self._loop._ready.append((self, fut.exception()))


class Loop:
    """Deterministic scheduler over virtual time (reference: flow sim2)."""

    def __init__(self, seed: int = 0, start_time: float = 0.0):
        self.rng = random.Random(seed)
        self._now = start_time
        self._ready: deque[tuple[Task, BaseException | None]] = deque()
        self._timers: list[tuple[float, int, Promise]] = []
        self._seq = 0
        self._current: Task | None = None
        # Each process's live tasks in spawn order (a dict as an ordered
        # set): a kill cancels them in that order. The JAX Loop keeps a
        # set of tasks, hashed by address, so the order in which a kill
        # wakes their waiters varies from run to run under one seed.
        self._tasks_by_process: dict[str, dict[Task, None]] = {}
        self.dead_processes: set[str] = set()
        # BUGGIFY (reference: flow/Buggify.h): OFF by default (production
        # and plain tests see zero behavior change); the sim campaign
        # enables it to fire rare timing/size perturbations inside role
        # code. Per-site activation is decided once per run from the
        # seeded RNG, so a failing seed replays identically.
        self.buggify_enabled = False
        # Aggressive mode (campaign --buggify-aggressive; TOML
        # buggifyAggressive = true): every site is ACTIVE and fires at
        # >= 50% — the maximum-perturbation schedule.
        self.buggify_aggressive = False
        self._buggify_sites: dict[str, bool] = {}

    def buggify(self, site: str, activate_p: float = 0.25,
                fire_p: float = 0.25) -> bool:
        """True when the named injection site should misbehave right now.

        Mirrors the reference's two-level scheme: a site is ACTIVATED for
        the whole run with `activate_p`, and an activated site FIRES with
        `fire_p` per evaluation. All draws come from the loop RNG —
        deterministic under the run's seed."""
        if not self.buggify_enabled:
            return False
        if self.buggify_aggressive:
            return self.rng.random() < max(fire_p, 0.5)
        active = self._buggify_sites.get(site)
        if active is None:
            active = self._buggify_sites[site] = self.rng.random() < activate_p
        return active and self.rng.random() < fire_p

    # -- time
    @property
    def now(self) -> float:
        return self._now

    @property
    def wall_now(self) -> float:
        """Epoch-seconds clock for EXTERNALLY-MEANINGFUL timestamps (token
        expiry, trace WallTime): virtual time in sim (deterministic);
        RealLoop overrides with time.time(). `now` stays monotonic-domain
        and must never be compared with operator wall-clock values."""
        return self._now

    def sleep(self, dt: float) -> Future:
        """Timer future; awaiting it parks the actor for `dt` virtual seconds."""
        p = Promise()
        self._seq += 1
        heapq.heappush(self._timers, (self._now + max(0.0, dt), self._seq, p))
        return p.future

    # -- spawning
    def spawn(self, coro: Coroutine | Future, process: str | None = None, name: str = "?") -> Task:
        if isinstance(coro, Future):  # allow spawning RPC futures directly
            coro = _await_future(coro)
        if process is None:
            process = self._current.process if self._current else "<main>"
        t = Task(self, coro, process, name)
        self._tasks_by_process.setdefault(process, {})[t] = None
        t.add_done_callback(
            lambda _f: self._tasks_by_process.get(process, {}).pop(t, None)
        )
        self._ready.append((t, None))
        return t

    def kill_process(self, process: str) -> None:
        """Cancel every task owned by `process` (simulated machine crash)."""
        self.dead_processes.add(process)
        for t in list(self._tasks_by_process.get(process, ())):
            t.cancel()

    def revive_process(self, process: str) -> None:
        self.dead_processes.discard(process)

    # -- running
    def _drain_ready(self) -> None:
        while self._ready:
            task, wake = self._ready.popleft()
            task._step(wake)

    def run_until(self, fut: Future, timeout: float = 1e9) -> Any:
        """Pump events (advancing virtual time) until `fut` resolves."""
        deadline = self._now + timeout
        while True:
            self._drain_ready()
            if fut.done():
                return fut.result()
            if not self._timers:
                raise RuntimeError(
                    "deadlock: awaited future cannot resolve (no runnable tasks"
                    " or timers)"
                )
            if self._timers[0][0] > deadline:
                raise TimeoutError(f"run_until exceeded {timeout}s virtual time")
            t, _seq, p = heapq.heappop(self._timers)
            self._now = max(self._now, t)
            p.send(None)

    def run(self, coro: Coroutine, timeout: float = 1e9) -> Any:
        return self.run_until(self.spawn(coro, process="<main>"), timeout)


async def _await_future(f: Future):
    return await f


# -- combinators (reference: flow genericactors.actor.h) ----------------------


def rpc(fn):
    """Mark a role method as remotely callable over the real transport.

    NetTransport.serve() exposes ONLY marked methods (or an explicit
    allowlist); internal helpers and administrative mutators stay private
    to the process. Defined here (not net.py) so role modules can import
    it without touching socket code or wire's struct registry.
    """
    fn._rpc_exported = True
    return fn


def ready(value: Any = None) -> Future:
    f = Future()
    f._finish(_DONE, value)
    return f


def broken(exc: BaseException | None = None) -> Future:
    f = Future()
    f._finish(_ERROR, exc or BrokenPromise())
    return f


def all_of(futures: Iterable[Future]) -> Future:
    """Resolves with a list of results once all resolve; fails fast on the
    first error (reference: waitForAll)."""
    futures = list(futures)
    out = Promise()
    remaining = [len(futures)]
    if not futures:
        out.send([])
        return out.future

    def on_done(_f: Future) -> None:
        if out.future.done():
            return
        for f in futures:
            if f.is_error():
                out.fail(f.exception())
                return
        remaining[0] -= 1
        if remaining[0] == 0:
            out.send([f.result() for f in futures])

    for f in futures:
        f.add_done_callback(on_done)
    return out.future


def any_of(futures: Iterable[Future]) -> Future:
    """Resolves with (index, result) of the first to resolve (reference:
    the `choose { when(...) }` construct)."""
    futures = list(futures)
    if not futures:
        raise ValueError("any_of of no futures can never resolve")
    out = Promise()

    def make_cb(i: int):
        def cb(f: Future) -> None:
            if out.future.done():
                return
            if f.is_error():
                out.fail(f.exception())
            else:
                out.send((i, f.result()))

        return cb

    for i, f in enumerate(futures):
        f.add_done_callback(make_cb(i))
    return out.future
