"""In-process tracer: spans + events with cross-process stitching.

The control plane's priced decisions (two-tier resize economics,
hysteresis bypass, own-host placement) leave no evidence beyond aggregate
counters; this tracer records *why* — one resched pass becomes a single
trace whose spans cross every boundary the system already crosses:
scheduler → allocator (in-process call or RemoteAllocator HTTP header),
scheduler → placement, scheduler → cluster backend, and backend →
training supervisor over the file-based control channel (the resize
command/ack files and the job spec carry `trace_id`/`parent_span`).

Design constraints, in order:
- **No wall-clock dependence under replay.** Span ids and timestamps come
  from the injected `common/clock` Clock — under a VirtualClock a replay
  of the same trace yields byte-identical ids, so a replay trace and a
  live trace of the same workload diff cleanly (Placeto/NEST-style
  decision-trace datasets need exactly this determinism).
- **Crash-safe, size-bounded sink.** Records append to
  `<trace_dir>/<file>` one JSON line at a time through an O_APPEND fd
  (POSIX short appends are atomic, so the supervisor's spans interleave
  with the scheduler's without tearing); when the file exceeds the byte
  bound it rotates to `<file>.1` — at most two generations ever exist.
- **Always-on ring buffer.** The newest records stay queryable in memory
  (`GET /debug/*`, `voda explain`) even with no trace_dir configured.

Thread-locality: a span entered with `with` installs itself as the
ambient (tracer, context) pair for its thread; spans started downstream —
in the allocator, placement manager, or a backend — parent onto it
automatically, whichever component created them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
from typing import Any, Dict, Iterator, List, Optional

from vodascheduler_tpu_torch.common.clock import Clock, VirtualClock

TRACE_ID_HEADER = "X-Voda-Trace-Id"
PARENT_SPAN_HEADER = "X-Voda-Parent-Span"

DEFAULT_RING_SIZE = 4096
DEFAULT_MAX_BYTES = 64 * 1024 * 1024
DEFAULT_FILENAME = "trace.jsonl"


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """The propagated half of a span: enough to parent a child anywhere."""

    trace_id: str
    span_id: str

    def to_dict(self) -> Dict[str, str]:
        return {"trace_id": self.trace_id, "parent_span": self.span_id}

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> Optional["TraceContext"]:
        if not d or not d.get("trace_id"):
            return None
        return TraceContext(trace_id=str(d["trace_id"]),
                            span_id=str(d.get("parent_span")
                                        or d.get("span_id") or ""))

    def to_headers(self) -> Dict[str, str]:
        return {TRACE_ID_HEADER: self.trace_id,
                PARENT_SPAN_HEADER: self.span_id}

    @staticmethod
    def from_headers(headers) -> Optional["TraceContext"]:
        trace_id = headers.get(TRACE_ID_HEADER)
        if not trace_id:
            return None
        return TraceContext(trace_id=str(trace_id),
                            span_id=str(headers.get(PARENT_SPAN_HEADER) or ""))


_tls = threading.local()


def _stack() -> List:
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


def current_context() -> Optional[TraceContext]:
    """The ambient trace context on this thread, or None."""
    stack = _stack()
    return stack[-1][1] if stack else None


def current_tracer() -> Optional["Tracer"]:
    """The tracer that opened the ambient span on this thread, or None —
    downstream components record into the SAME tracer as the root span
    (a replay harness's per-instance tracer, not the process global)."""
    stack = _stack()
    return stack[-1][0] if stack else None


@contextlib.contextmanager
def use_context(ctx: Optional[TraceContext],
                tracer: Optional["Tracer"] = None) -> Iterator[None]:
    """Install a remote-propagated context as ambient (e.g. from HTTP
    headers) so in-process spans under it stitch to the remote parent."""
    if ctx is None:
        yield
        return
    _stack().append((tracer, ctx))
    try:
        yield
    finally:
        _stack().pop()


class Span:
    """One timed operation. Mutate via set_attr/add_event; closed by the
    tracer (use `with tracer.span(...)` — manual end() also works)."""

    __slots__ = ("tracer", "name", "component", "trace_id", "span_id",
                 "parent_span", "start", "end_time", "attrs", "events",
                 "status", "_ended")

    def __init__(self, tracer: "Tracer", name: str, component: str,
                 trace_id: str, span_id: str, parent_span: str,
                 start: float, attrs: Optional[Dict[str, Any]] = None):
        self.tracer = tracer
        self.name = name
        self.component = component
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_span = parent_span
        self.start = start
        self.end_time = 0.0
        self.attrs: Dict[str, Any] = dict(attrs or {})
        self.events: List[Dict[str, Any]] = []
        self.status = "ok"
        self._ended = False

    @property
    def context(self) -> TraceContext:
        return TraceContext(trace_id=self.trace_id, span_id=self.span_id)

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def add_event(self, name: str, **attrs: Any) -> None:
        self.events.append({"name": name, "ts": self.tracer.clock.now(),
                            **attrs})

    def set_error(self, exc: BaseException) -> None:
        self.status = "error"
        self.attrs["error"] = f"{type(exc).__name__}: {str(exc)[:300]}"

    def end(self) -> None:
        if self._ended:
            return
        # vodarace: ignore[unguarded-shared-write] idempotence latch on a
        # per-span object; a span ends exactly once on its owning thread
        self._ended = True
        self.end_time = self.tracer.clock.now()
        self.tracer._record_span(self)

    def to_record(self) -> Dict[str, Any]:
        rec = {
            "kind": "span",
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span": self.parent_span,
            "name": self.name,
            "component": self.component,
            "start": self.start,
            "end": self.end_time,
            "duration_ms": round((self.end_time - self.start) * 1000.0, 3),
            "status": self.status,
            "attrs": self.attrs,
        }
        if self.events:
            rec["events"] = self.events
        return rec


class Tracer:
    """Span factory + record sink (ring buffer and optional JSONL file).

    `trace_dir=None` keeps records in memory only. `kinds` restricts the
    FILE sink to the given record kinds (the ring always keeps all) —
    bench.py uses it to persist only `resched_audit` records as its
    provenance artifact without megabytes of spans alongside.
    """

    def __init__(self, clock: Optional[Clock] = None,
                 trace_dir: Optional[str] = None,
                 ring_size: int = DEFAULT_RING_SIZE,
                 max_bytes: int = DEFAULT_MAX_BYTES,
                 filename: str = DEFAULT_FILENAME,
                 kinds: Optional[set] = None):
        import collections

        self.clock = clock or Clock()
        self.trace_dir = os.path.abspath(trace_dir) if trace_dir else None
        self.max_bytes = max_bytes
        self.filename = filename
        self.kinds = set(kinds) if kinds else None
        self._ring = collections.deque(maxlen=max(1, ring_size))
        self._seq = 0
        self._lock = threading.Lock()
        # Deterministic ids under replay: a VirtualClock tracer derives
        # ids purely from (virtual time, per-tracer sequence). Under the
        # real clock a pid token keeps concurrently-writing processes
        # (control plane + supervisors sharing one trace file) collision
        # free.
        self._token = ("" if isinstance(self.clock, VirtualClock)
                       else f"{os.getpid():x}.")
        if self.trace_dir:
            os.makedirs(self.trace_dir, exist_ok=True)

    # ---- ids -------------------------------------------------------------

    def _next_id(self) -> str:
        with self._lock:
            self._seq += 1
            seq = self._seq
        return f"{self._token}{int(self.clock.now() * 1000):x}.{seq:x}"

    # ---- spans -----------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, component: str = "",
             parent: Optional[TraceContext] = None,
             new_trace: bool = False,
             attrs: Optional[Dict[str, Any]] = None) -> Iterator[Span]:
        """Context-managed span. Parent resolution: explicit `parent`
        beats the thread's ambient context; `new_trace=True` forces a
        fresh trace id (the resched root does this). Exceptions mark the
        span `error` and re-raise."""
        sp = self.start_span(name, component=component, parent=parent,
                             new_trace=new_trace, attrs=attrs)
        _stack().append((self, sp.context))
        try:
            yield sp
        except BaseException as e:
            sp.set_error(e)
            raise
        finally:
            _stack().pop()
            sp.end()

    def start_span(self, name: str, component: str = "",
                   parent: Optional[TraceContext] = None,
                   new_trace: bool = False,
                   attrs: Optional[Dict[str, Any]] = None) -> Span:
        if parent is None and not new_trace:
            parent = current_context()
        span_id = self._next_id()
        if new_trace or parent is None:
            trace_id = self._next_id()
            parent_span = ""
        else:
            trace_id = parent.trace_id
            parent_span = parent.span_id
        return Span(self, name, component, trace_id, span_id, parent_span,
                    start=self.clock.now(), attrs=attrs)

    # ---- records ---------------------------------------------------------

    def emit(self, record: Dict[str, Any]) -> None:
        """Record a non-span event (resched_audit, http_access, ...).
        Stamps `ts` if absent."""
        record.setdefault("ts", self.clock.now())
        self._append(record)

    def _record_span(self, span: Span) -> None:
        self._append(span.to_record())

    def _append(self, record: Dict[str, Any]) -> None:
        with self._lock:
            self._ring.append(record)
        if self.trace_dir and (self.kinds is None
                               or record.get("kind") in self.kinds):
            self._write_line(record)

    def _write_line(self, record: Dict[str, Any]) -> None:
        path = os.path.join(self.trace_dir, self.filename)
        try:
            line = json.dumps(record, default=str) + "\n"
        except (TypeError, ValueError):
            return  # unserializable attr must never take down the caller
        with self._lock:
            try:
                try:
                    if os.path.getsize(path) + len(line) > self.max_bytes:
                        os.replace(path, path + ".1")
                except OSError:
                    pass  # no file yet
                fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                             0o644)
                try:
                    os.write(fd, line.encode())
                finally:
                    os.close(fd)
            except OSError:
                pass  # read-only volume: the ring still has the record

    # ---- queries (debug endpoints / explain) ----------------------------

    def records(self, kind: Optional[str] = None,
                trace_id: Optional[str] = None,
                limit: int = 0) -> List[Dict[str, Any]]:
        with self._lock:
            out = list(self._ring)
        if kind is not None:
            out = [r for r in out if r.get("kind") == kind]
        if trace_id is not None:
            out = [r for r in out if r.get("trace_id") == trace_id]
        if limit and len(out) > limit:
            out = out[-limit:]
        return out

    def spans_for_job(self, job: str, limit: int = 0) -> List[Dict[str, Any]]:
        """Spans whose `job` attribute names this job."""
        out = [r for r in self.records(kind="span")
               if r.get("attrs", {}).get("job") == job]
        if limit and len(out) > limit:
            out = out[-limit:]
        return out


# ---- process-global tracer ------------------------------------------------

_global_tracer: Optional[Tracer] = None
_global_lock = threading.Lock()


def get_tracer() -> Tracer:
    """The process-global tracer. First use builds it from the env knobs
    (retention: VODA_TRACE_DIR = JSONL sink directory or unset for
    memory-only; VODA_TRACE_RING = ring entries; VODA_TRACE_MAX_MB =
    rotation bound). The *ambient* tracer wins where one is installed —
    call `current_tracer() or get_tracer()` in shared components."""
    global _global_tracer
    with _global_lock:
        if _global_tracer is None:
            _global_tracer = Tracer(
                trace_dir=os.environ.get("VODA_TRACE_DIR") or None,
                ring_size=int(os.environ.get("VODA_TRACE_RING",
                                             str(DEFAULT_RING_SIZE))),
                max_bytes=int(float(os.environ.get("VODA_TRACE_MAX_MB", "64"))
                              * 1024 * 1024))
        return _global_tracer


def set_tracer(tracer: Optional[Tracer]) -> None:
    """Replace the process-global tracer (VodaApp points it at the
    workdir; tests isolate with a fresh one)."""
    global _global_tracer
    with _global_lock:
        _global_tracer = tracer


def active_tracer() -> Tracer:
    """The tracer downstream components should record into: the one that
    opened the ambient span when inside a trace, else the global."""
    return current_tracer() or get_tracer()
