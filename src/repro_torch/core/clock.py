"""Clocks + the discrete event loop.

The same controller/worker/scheduler code runs under either clock:
  * VirtualClock — discrete-event simulation (paper-scale experiments:
    thousands of models, millions of requests, replayed in seconds)
  * RealClock    — wall time; event callbacks execute JAX programs
    (quickstart / engine demos on the local device)

`RealtimePump` drives an EventLoop on a real clock while accepting
callbacks posted from other threads — the bridge the distributed runtime
(`repro.runtime`) needs so TCP reader threads can hand frames to the
single-threaded controller/worker event loop.
"""
from __future__ import annotations

import heapq
import itertools
import queue
import time
from typing import Callable, Optional


class VirtualClock:
    def __init__(self, start: float = 0.0):
        self._now = start

    def now(self) -> float:
        return self._now

    def advance_to(self, t: float):
        assert t >= self._now - 1e-12, (t, self._now)
        self._now = max(self._now, t)


class RealClock:
    def __init__(self):
        self._t0 = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self._t0

    def advance_to(self, t: float):
        delta = t - self.now()
        if delta > 0:
            time.sleep(delta)


class EventLoop:
    """Priority-queue event loop shared by simulation and real execution."""

    def __init__(self, clock=None):
        self.clock = clock if clock is not None else VirtualClock()
        self._heap = []
        self._seq = itertools.count()
        # throughput telemetry: events dispatched + wall time spent inside
        # run_until/run_all (virtual-clock runs: simulated events per wall s)
        self.events_total = 0
        self.wall_busy_s = 0.0

    def now(self) -> float:
        return self.clock.now()

    def schedule(self, t: float, fn: Callable[[], None]):
        heapq.heappush(self._heap, (max(t, self.now()), next(self._seq), fn))

    def schedule_in(self, dt: float, fn: Callable[[], None]):
        self.schedule(self.now() + dt, fn)

    def empty(self) -> bool:
        return not self._heap

    def peek_time(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def run_until(self, t_end: float, max_events: int = 100_000_000):
        heap = self._heap
        pop = heapq.heappop
        advance = self.clock.advance_to
        n = 0
        t0 = time.perf_counter()
        while heap and heap[0][0] <= t_end and n < max_events:
            t, _, fn = pop(heap)
            advance(t)
            fn()
            n += 1
        advance(t_end)
        self.events_total += n
        self.wall_busy_s += time.perf_counter() - t0
        return n

    def run_all(self, max_events: int = 100_000_000):
        heap = self._heap
        pop = heapq.heappop
        advance = self.clock.advance_to
        n = 0
        t0 = time.perf_counter()
        while heap and n < max_events:
            t, _, fn = pop(heap)
            advance(t)
            fn()
            n += 1
        self.events_total += n
        self.wall_busy_s += time.perf_counter() - t0
        return n

    def stats(self) -> dict:
        """Event-loop throughput gauges for telemetry reports."""
        w = self.wall_busy_s
        return {"events_total": self.events_total,
                "wall_busy_s": w,
                "events_per_wall_s": (self.events_total / w) if w > 0
                else 0.0}


class RealtimePump:
    """Single-threaded driver for an EventLoop under wall time that also
    accepts cross-thread work.

    The EventLoop itself is not thread-safe; transport reader threads must
    never touch it directly. Instead they `post(fn)` and the pump runs `fn`
    on the loop thread between event dispatches. The pump sleeps no longer
    than `max_poll` (so `stop()` is honored promptly) or until the next
    scheduled event, whichever is sooner.
    """

    def __init__(self, loop: EventLoop, max_poll: float = 0.02):
        self.loop = loop
        self.max_poll = max_poll
        self._inbox: "queue.Queue[Callable[[], None]]" = queue.Queue()
        self._stop = False

    def post(self, fn: Callable[[], None]) -> None:
        """Thread-safe: run `fn` on the pump thread as soon as possible."""
        self._inbox.put(fn)

    def stop(self) -> None:
        self._stop = True
        self._inbox.put(lambda: None)     # wake a sleeping pump

    def pump_once(self) -> None:
        """One iteration: run due events, then wait briefly for posted work
        (at most until the next scheduled event or `max_poll`)."""
        loop = self.loop
        nxt = loop.peek_time()
        now = loop.now()
        if nxt is not None and nxt <= now:
            loop.run_until(now)
            self._drain_inbox()
            return
        timeout = self.max_poll if nxt is None \
            else min(self.max_poll, max(0.0, nxt - now))
        try:
            fn = self._inbox.get(timeout=timeout)
        except queue.Empty:
            return
        fn()
        self._drain_inbox()

    def _drain_inbox(self) -> None:
        while True:
            try:
                fn = self._inbox.get_nowait()
            except queue.Empty:
                return
            fn()

    def run(self, until: Optional[Callable[[], bool]] = None,
            timeout: Optional[float] = None) -> bool:
        """Pump until `until()` is true, `timeout` seconds elapse, or
        `stop()` is called. Returns whether `until` was satisfied."""
        t_end = None if timeout is None else self.loop.now() + timeout
        while not self._stop:
            if until is not None and until():
                return True
            if t_end is not None and self.loop.now() >= t_end:
                return until() if until is not None else False
            self.pump_once()
        return until() if until is not None else False

    def run_for(self, seconds: float) -> None:
        self.run(timeout=seconds)
