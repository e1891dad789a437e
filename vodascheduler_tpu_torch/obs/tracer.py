"""Spans with cross-process stitching: the part of the JAX package's
``obs/tracer.py`` that the supervisor uses.

The scheduler stamps a trace context (``{trace_id, parent_span}``) into the
job spec and into each resize command; the supervisor's spans parent onto
it and append to the same JSONL sink under ``VODA_TRACE_DIR``, one record
per line through an O_APPEND fd, so the control plane's and the
supervisor's records interleave into one trace. Records keep the
reference's keys and id format.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Dict, Optional

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


class Span:
    """One timed operation, recorded by its tracer when it ends."""

    __slots__ = ("tracer", "name", "component", "trace_id", "span_id",
                 "parent_span", "start", "end_time", "attrs", "status",
                 "_ended")

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
        self.status = "ok"
        self._ended = False

    @property
    def context(self) -> TraceContext:
        return TraceContext(trace_id=self.trace_id, span_id=self.span_id)

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def end(self) -> None:
        if self._ended:
            return
        self._ended = True
        self.end_time = time.time()
        self.tracer._record(self.to_record())

    def to_record(self) -> Dict[str, Any]:
        return {
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


class Tracer:
    """Span factory and record sink: ended spans are appended to
    ``<trace_dir>/<filename>`` when a directory is given, rotating to
    ``<filename>.1`` past `max_bytes`."""

    def __init__(self, trace_dir: Optional[str] = None,
                 max_bytes: int = DEFAULT_MAX_BYTES,
                 filename: str = DEFAULT_FILENAME):
        self.trace_dir = os.path.abspath(trace_dir) if trace_dir else None
        self.max_bytes = max_bytes
        self.filename = filename
        self._seq = 0
        self._lock = threading.Lock()
        # The pid keeps the ids of processes sharing one trace file apart.
        self._token = f"{os.getpid():x}."
        if self.trace_dir:
            os.makedirs(self.trace_dir, exist_ok=True)

    def _next_id(self) -> str:
        with self._lock:
            self._seq += 1
            seq = self._seq
        return f"{self._token}{int(time.time() * 1000):x}.{seq:x}"

    def start_span(self, name: str, component: str = "",
                   parent: Optional[TraceContext] = None,
                   attrs: Optional[Dict[str, Any]] = None) -> Span:
        """A span under `parent`'s trace, or the root of a new trace."""
        span_id = self._next_id()
        if parent is None:
            trace_id, parent_span = self._next_id(), ""
        else:
            trace_id, parent_span = parent.trace_id, parent.span_id
        return Span(self, name, component, trace_id, span_id, parent_span,
                    start=time.time(), attrs=attrs)

    def _record(self, record: Dict[str, Any]) -> None:
        if not self.trace_dir:
            return
        path = os.path.join(self.trace_dir, self.filename)
        line = json.dumps(record, default=str) + "\n"
        with self._lock:
            try:
                try:
                    if os.path.getsize(path) + len(line) > self.max_bytes:
                        os.replace(path, path + ".1")
                except FileNotFoundError:
                    pass  # no file yet
                fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                             0o644)
                try:
                    os.write(fd, line.encode())
                finally:
                    os.close(fd)
            except OSError:
                pass  # a read-only sink must not stop the job


_global_tracer: Optional[Tracer] = None
_global_lock = threading.Lock()


def get_tracer() -> Tracer:
    """The process-global tracer, built at first use from VODA_TRACE_DIR
    (the JSONL sink's directory; unset records nothing) and
    VODA_TRACE_MAX_MB (the rotation bound)."""
    global _global_tracer
    with _global_lock:
        if _global_tracer is None:
            _global_tracer = Tracer(
                trace_dir=os.environ.get("VODA_TRACE_DIR") or None,
                max_bytes=int(float(os.environ.get("VODA_TRACE_MAX_MB", "64"))
                              * 1024 * 1024))
        return _global_tracer
