"""Clock abstraction: real wall-clock and a virtual clock for hermetic tests.

The reference leans on wall-clock time everywhere (time.Now/time.Since in
scheduler.go:757-813, tickers, rate limits) and therefore can only be
exercised against a live cluster (SURVEY.md §4). Here every time read goes
through a Clock so the whole control plane — rate-limited rescheduling,
Tiresias promote/demote, trace replay — runs under simulated time.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Callable, List, Optional, Tuple


class Clock:
    """Real wall-clock.

    Timers (`call_at`/`call_later`) fire on daemon `threading.Timer`
    threads, so a callback scheduled on the real clock runs even when no
    service daemon is pumping — the scheduler uses this to re-arm a
    resched that was requested mid-pass instead of silently waiting for
    the next poll tick. Callbacks must therefore be thread-safe (every
    scheduler entry point already is). Timers are fire-and-forget and
    never cancelled; callees guard their own idempotence.
    """

    def now(self) -> float:
        return time.time()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)

    def call_at(self, when: float, fn: Callable[[], None]) -> None:
        """Run fn at wall time `when` (immediately if already past)."""
        self.call_later(when - self.now(), fn)

    def call_later(self, delay: float, fn: Callable[[], None]) -> None:
        timer = threading.Timer(max(0.0, delay), fn)
        timer.daemon = True
        # threading.Timer has no name= kwarg; the role-prefixed name
        # (doc/thread_roles.json) must be assigned before start().
        timer.name = f"voda-timer-{id(timer):x}"
        timer.start()


class VirtualClock(Clock):
    """Deterministic manually-advanced clock.

    `advance` moves time forward, firing any timers scheduled in between in
    timestamp order. This is what lets the trace-replay harness (replay/) run
    hours of cluster time in milliseconds.
    """

    def __init__(self, start: float = 0.0):
        self._now = start
        self._timers: List[Tuple[float, int, Callable[[], None]]] = []
        self._seq = itertools.count()
        self._lock = threading.RLock()

    def now(self) -> float:
        with self._lock:
            return self._now

    def sleep(self, seconds: float) -> None:
        # In simulation, a sleeper simply advances the clock.
        self.advance(seconds)

    def call_at(self, when: float, fn: Callable[[], None]) -> None:
        """Schedule fn to fire when the clock reaches `when`."""
        with self._lock:
            heapq.heappush(self._timers, (when, next(self._seq), fn))

    def call_later(self, delay: float, fn: Callable[[], None]) -> None:
        self.call_at(self.now() + delay, fn)

    def next_timer(self) -> Optional[float]:
        with self._lock:
            return self._timers[0][0] if self._timers else None

    def advance(self, seconds: float) -> None:
        """Advance by `seconds`, firing due timers in order."""
        self.advance_to(self.now() + seconds)

    def advance_to(self, target: float) -> None:
        while True:
            with self._lock:
                if not self._timers or self._timers[0][0] > target:
                    self._now = max(self._now, target)
                    return
                when, _, fn = heapq.heappop(self._timers)
                self._now = max(self._now, when)
            fn()  # fire outside the lock; fn may schedule more timers
