"""Double-buffered host packing for the window path.

The port of ``foundationdb_tpu/sched/packing.py``. The pack half of a
window (``TorchConflictSet.pack_wire_window``: the C wire pass and the
ranking against the dictionary mirror, numpy and ctypes only) runs on ONE
worker thread, so window N+1 packs while the card executes window N. The
dispatch half (``dispatch_window``: uploads and kernel launches) stays on
the submitting thread, in order; the worker never makes a torch call on
the card.

Packs are commit-version ordered and the single worker serializes them.
A pack mutates only host bookkeeping and defers any device rebase or full
dictionary repack into the PreparedWindow, which dispatch applies; a
deferred repack parks the worker on the mirror's gate until the window
that carries it has dispatched.

A speculative engine needs nothing of the runner: its ``dispatch_window``
routes through the engine's reconcile ring and the collector reconciles
in order, so pack N+2, speculative resolve N+1 and reconcile N overlap.
A deferred demotion parks the worker on the gate like a deferred repack.

``threaded=False`` packs inline on the submitting thread with identical
results: the mode deterministic tests use, and the parity the threaded
mode is tested against.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Callable


class PipelinedWindowRunner:
    """Pipelines pack -> dispatch -> collect over a TorchConflictSet."""

    def __init__(self, cs, threaded: bool = True, max_pending: int = 8):
        self._cs = cs
        self._threaded = threaded
        self._pending: deque[Callable] = deque()  # dispatched collectors
        self.pack_busy_s = 0.0  # host time inside pack (overlap numerator)
        self.pack_s: list[float] = []  # per window, in submit order
        self.gate_wait_s = 0.0  # packs parked behind a deferred repack
        self.windows_submitted = 0
        self.windows_collected = 0
        if threaded:
            self._req_q: queue.Queue = queue.Queue(maxsize=max_pending)
            self._ready_q: queue.Queue = queue.Queue()
            self._worker = threading.Thread(
                target=self._pack_loop, name="sched-packer", daemon=True)
            self._worker.start()
        else:
            self._ready: deque = deque()

    # -- worker --------------------------------------------------------------

    def _pack(self, wire, cvs, count):
        # A pack behind a deferred repack waits for it here, so that its
        # pack time counts host work only.
        t0 = time.perf_counter()
        if self._cs._mirror is not None:  # a non-resident engine has none
            self._cs._mirror.gate.wait()
        self.gate_wait_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        prepared = self._cs.pack_wire_window(wire, cvs, count)
        dt = time.perf_counter() - t0
        self.pack_busy_s += dt
        self.pack_s.append(dt)
        return prepared

    def _pack_loop(self) -> None:
        while True:
            req = self._req_q.get()
            if req is None:
                return
            try:
                prepared = self._pack(*req)
            except BaseException as e:  # raised again by dispatch_ready()
                prepared = e
            self._ready_q.put(prepared)

    # -- submit / dispatch / collect ------------------------------------------

    def _gate_closed(self) -> bool:
        mirror = self._cs._mirror
        return mirror is not None and not mirror.gate.is_set()

    def _put_draining(self, item) -> None:
        """Blocking put on the bounded request queue that cannot deadlock
        with a deferred repack: while the worker is parked on the mirror's
        gate the queue stops draining, so keep dispatching ready windows
        from this (the dispatch) thread, which runs the repack, reopens
        the gate and frees the worker."""
        while True:
            if self._gate_closed():
                self.dispatch_ready()
            try:
                self._req_q.put(item, timeout=0.05)
                return
            except queue.Full:
                continue

    def submit(self, wire, commit_versions, count: int) -> None:
        """Queue a window for packing (call in commit-version order)."""
        self.windows_submitted += 1
        if self._threaded:
            self._put_draining((wire, list(commit_versions), count))
            return
        # A deferred repack parks the gate until its window dispatches;
        # packing inline on this thread would wait on it forever, so
        # dispatch the ready windows first.
        if self._gate_closed():
            self.dispatch_ready()
        self._ready.append(self._pack(wire, list(commit_versions), count))

    def dispatch_ready(self, block: bool = False) -> int:
        """Move packed windows to the card (in order). Non-blocking by
        default; ``block=True`` waits for at least one pack if any window
        is still owed. Returns how many windows were dispatched."""
        n = 0
        owed = (self.windows_submitted - self.windows_collected
                - len(self._pending))
        while owed > 0:
            prepared = self._take_ready(block=block and n == 0)
            if prepared is None:
                break
            if isinstance(prepared, BaseException):
                raise prepared
            self._pending.append(self._cs.dispatch_window(prepared))
            n += 1
            owed -= 1
        return n

    def _take_ready(self, block: bool):
        if self._threaded:
            try:
                return self._ready_q.get(block=block)
            except queue.Empty:
                return None
        return self._ready.popleft() if self._ready else None

    @property
    def in_flight(self) -> int:
        """Windows dispatched to the card but not yet collected."""
        return len(self._pending)

    def spec_metrics(self) -> dict:
        """The engine's speculation counters (``spec_metrics``)."""
        return self._cs.spec_metrics()

    def collect_next(self):
        """The oldest outstanding window's verdicts (one device read).
        Dispatches it first if its pack is still in flight."""
        # Feed the card everything already packed before blocking on the
        # oldest window, so the read overlaps younger windows.
        self.dispatch_ready(block=False)
        if not self._pending:
            if not self.dispatch_ready(block=True):
                raise IndexError("no window outstanding")
        self.windows_collected += 1
        return self._pending.popleft()()

    def close(self) -> None:
        if self._threaded:
            self._put_draining(None)
            self._worker.join(timeout=5.0)
