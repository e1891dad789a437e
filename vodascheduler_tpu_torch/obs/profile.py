"""Phase-level decide/actuate profiler: where a resched pass's
milliseconds go.

`voda_scheduler_resched_latency_seconds` tells you a pass took 40 ms;
nothing told you whether that was the allocator, the Hungarian solve, or
the booking commit — the breakdown ROADMAP item 2's vectorization work
must be judged against. A `PhaseTimer` rides each rescheduling pass:
every decide sub-stage (snapshot, allocate/algorithm, hysteresis,
placement/hungarian, diff, commit) and each actuation wave records its
wall and CPU cost, and the pass emits one closed-schema `perf_report`
record (obs/audit.py `PHASE_NAMES`) alongside its `resched_audit`.

Clock discipline: the timer reads `time.monotonic()` (wall) and
`time.process_time()` (process CPU) — never the injected Clock and never
`time.time()` — so under a VirtualClock it measures the REAL compute a
simulated pass burned, not simulated time, and replay-deterministic
audit ids are untouched (perf numbers live in their own record kind,
which bench.py's audit sink filters out).

Nesting is additive: a `hungarian` phase timed inside a `placement`
phase accrues into both (the parent's number answers "what did placement
cost end to end", the child's "how much of that was the solve").

Ambient propagation mirrors the tracer: the scheduler installs its
pass's timer with `use_timer()`, and downstream components (placement's
Hungarian bind, the allocator's algorithm stage) time themselves through
the module-level `phase()` helper, which no-ops when no pass is being
profiled (e.g. a RemoteAllocator service handling a bare HTTP call).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, Optional

from vodascheduler_tpu_torch.obs.audit import PHASE_NAMES


class PhaseTimer:
    """Per-pass phase accumulator (wall + CPU, counted).

    Thread-safe: decide phases run on the pass thread, but callers may
    time phases from wave workers too; aggregation holds a leaf lock
    (nothing is called under it).

    `cpu=False` skips the CPU clock entirely (cpu_ms reports 0.0):
    `time.process_time()` is a real syscall — microseconds on some
    kernels/containers, never vDSO-cheap like monotonic — and callers
    that drive millions of micro-passes (the exhaustive model checker)
    need wall-only profiling to stay cheap. Production and the scale
    harness keep CPU sampling on.
    """

    def __init__(self, cpu: bool = True) -> None:
        self._cpu = cpu
        self.wall_start = time.monotonic()
        self.cpu_start = time.process_time() if cpu else 0.0
        self._lock = threading.Lock()
        # name -> [wall_s, cpu_s, count]
        self._phases: Dict[str, List[float]] = {}
        self._decide_end: Optional[float] = None

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        """Time one sub-stage. `name` must be a declared PHASE_NAMES
        entry — the vocabulary is closed (vodalint checks call sites
        statically; this guard catches dynamically-built names)."""
        if name not in PHASE_NAMES:
            raise ValueError(f"phase {name!r} not in obs.audit.PHASE_NAMES")
        w0 = time.monotonic()
        c0 = time.process_time() if self._cpu else 0.0
        try:
            yield
        finally:
            dw = time.monotonic() - w0
            dc = (time.process_time() - c0) if self._cpu else 0.0
            with self._lock:
                agg = self._phases.setdefault(name, [0.0, 0.0, 0])
                agg[0] += dw
                agg[1] += dc
                agg[2] += 1

    def mark_decide_end(self) -> None:
        """Close the decide half (first call wins; the allocation-failure
        early return and the normal decide-block exit both mark)."""
        if self._decide_end is None:
            # vodarace: ignore[unguarded-shared-write] first-call-wins
            # marker on a per-pass timer owned by the decide thread
            self._decide_end = time.monotonic() - self.wall_start

    @property
    def decide_seconds(self) -> Optional[float]:
        return self._decide_end

    def total_seconds(self) -> float:
        return time.monotonic() - self.wall_start

    def cpu_seconds(self) -> float:
        return (time.process_time() - self.cpu_start) if self._cpu else 0.0

    def report(self) -> Dict[str, Dict[str, float]]:
        """{phase: {wall_ms, cpu_ms, count}} for every phase that ran."""
        with self._lock:
            snapshot = {name: list(agg) for name, agg in self._phases.items()}
        return {name: {"wall_ms": round(agg[0] * 1000.0, 3),
                       "cpu_ms": round(agg[1] * 1000.0, 3),
                       "count": int(agg[2])}
                for name, agg in snapshot.items()}


_tls = threading.local()


def current_timer() -> Optional[PhaseTimer]:
    """The pass's ambient PhaseTimer on this thread, or None."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def use_timer(timer: Optional[PhaseTimer]) -> Iterator[None]:
    """Install `timer` as this thread's ambient profiler (the scheduler
    wraps its pass body; None passes through for symmetry)."""
    if timer is None:
        yield
        return
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(timer)
    try:
        yield
    finally:
        stack.pop()


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Time `name` into the ambient PhaseTimer; no-op when no pass is
    being profiled (downstream components call this unconditionally)."""
    timer = current_timer()
    if timer is None:
        yield
        return
    with timer.phase(name):
        yield
