"""ClusterBackend: the interface between the scheduler and job execution.

Reference counterpart: the scheduler's k8s surface — MPIJob create/update/
delete (scheduler.go:495-612) plus the informer event stream (node and
MPIJob watchers, scheduler.go:169-242). The backend absorbs both directions:
the scheduler calls start/scale/stop, and the backend reports job and host
events back through a callback.

On TPU, "scale" is two-tiered (the elastic-resize fast path): when the
job's process group is unchanged (same hosts, single-process or
membership-stable), the backend asks the RUNNING supervisor to reshard in
place over its control channel (runtime/supervisor.py) — no checkpoint,
no process exit. Only when the process group actually changes (migration,
multihost membership change, or the supervisor nacks) does scale_job fall
back to the checkpoint-restart path. scale_job reports which tier fired
via its ResizePath return value so the scheduler can price the two very
differently (an in-place resize is not a "restart" for lease or metric
purposes).
"""

from __future__ import annotations

import abc
import dataclasses
import enum
import json
from typing import Callable, Dict, List, Optional, Tuple

from vodascheduler_tpu_torch.common.job import JobSpec
from vodascheduler_tpu_torch.obs import tracer as obs_tracer


def spec_dict_with_trace(spec: JobSpec) -> dict:
    """The spec as serialized for a training supervisor, carrying the
    ambient trace context in extra.trace_context (a JSON string — extra
    is a str->str map) so the supervisor's startup span stitches into
    the resched trace that launched it. Shared by every spawning backend
    (local/multihost/gke); a no-op copy outside a trace."""
    d = spec.to_dict()
    ctx = obs_tracer.current_context()
    if ctx is not None:
        extra = dict(d.get("extra") or {})
        extra["trace_context"] = json.dumps(ctx.to_dict())
        d["extra"] = extra
    return d


class ResizePath(str, enum.Enum):
    """Which tier a scale_job took. INPLACE = live reshard inside the
    running process(es); RESTART = checkpoint-restart (the only path when
    the process group changes). Backends that can't resize in place
    always return RESTART; a None return is treated as RESTART for
    backward compatibility."""

    INPLACE = "inplace"
    RESTART = "restart"


class ClusterEventKind(str, enum.Enum):
    JOB_COMPLETED = "job_completed"
    JOB_FAILED = "job_failed"
    HOST_ADDED = "host_added"
    HOST_REMOVED = "host_removed"


@dataclasses.dataclass
class ClusterEvent:
    kind: ClusterEventKind
    name: str                 # job or host name
    detail: str = ""
    timestamp: float = 0.0


@dataclasses.dataclass
class JobHandle:
    """Backend's view of a running job."""

    name: str
    num_workers: int
    placements: List[Tuple[str, int]] = dataclasses.field(default_factory=list)


class ClusterBackend(abc.ABC):
    """What the scheduler needs from an execution substrate."""

    # Whether this backend can ever take the Tier-A in-place path. The
    # scheduler's fast-path-aware policies (hysteresis bypass) consult
    # this so they never bypass a cost gate for a backend whose every
    # resize is a cold restart (gke, multihost today).
    supports_inplace_resize: bool = False

    @abc.abstractmethod
    def list_hosts(self) -> Dict[str, int]:
        """host name -> chip count for every live host in the pool."""

    @abc.abstractmethod
    def start_job(self, spec: JobSpec, num_workers: int,
                  placements: Optional[List[Tuple[str, int]]] = None) -> None:
        """Launch the job's workers (reference: create MPIJob :495)."""

    @abc.abstractmethod
    def scale_job(self, name: str, num_workers: int,
                  placements: Optional[List[Tuple[str, int]]] = None
                  ) -> Optional[ResizePath]:
        """Resize a running job. Tries the in-place live reshard when the
        process group is unchanged; falls back to checkpoint-restart at
        the new size (reference: update MPIJob Worker.Replicas :542).
        Returns the ResizePath taken (None == RESTART)."""

    @abc.abstractmethod
    def stop_job(self, name: str) -> None:
        """Halt the job, preserving its checkpoint (reference: delete MPIJob
        :576 — training state survives in the shared PVC)."""

    @abc.abstractmethod
    def migrate_workers(self, name: str,
                        placements: List[Tuple[str, int]]) -> None:
        """Re-place a running job's workers without changing its size
        (reference: placement manager deleting moved pods :622)."""

    @abc.abstractmethod
    def running_jobs(self) -> Dict[str, JobHandle]:
        """Live jobs as the backend sees them (crash-resume source;
        reference: listing MPIJobs on restart, scheduler.go:1019)."""

    def actuation_price_seconds(self, name: str) -> Optional[float]:
        """Modeled wall-clock cost of the most recent start/scale/stop
        call for `name`, or None when the backend has no model. Real
        backends return None — the scheduler prices actuation from the
        measured wall time of the call it just made. Simulated backends
        (FakeClusterBackend under a VirtualClock, where every call
        returns in microseconds of real time) return the overhead they
        modeled, so replay prices a pass's actuation waves at their
        critical path (per-wave max) exactly like a live run would
        measure them."""
        return None

    def set_event_callback(self, cb: Callable[[ClusterEvent], None]) -> None:
        """Register the scheduler's event sink (informer analog)."""
        self._event_cb = cb

    def emit(self, event: ClusterEvent) -> None:
        cb = getattr(self, "_event_cb", None)
        if cb is not None:
            cb(event)
