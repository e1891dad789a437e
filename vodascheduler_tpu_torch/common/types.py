"""Core enums and type aliases.

Reference counterpart: pkg/common/types/types.go:10-65. The job lifecycle and
the shape of a scheduling decision are preserved; the allocation unit is TPU
*chips* (with placement mapping counts onto ICI slice shapes) instead of GPUs.
"""

from __future__ import annotations

import enum
from typing import Dict

# A scheduling decision: job name -> number of TPU chips allocated.
# Reference: types.JobScheduleResult = map[string]int (types.go:61).
ScheduleResult = Dict[str, int]

# Sentinel "infinitely far in the future" timestamp (seconds). Used for
# FirstStartTime of never-started jobs so FIFO-by-start-time sorts them last.
# Reference: types.MaxTime (types.go:65).
MAX_TIME = float("inf")


class JobStatus(str, enum.Enum):
    """Training-job lifecycle. Reference: types.go:33-48.

    SUBMITTED -> WAITING -> RUNNING -> {COMPLETED, FAILED, CANCELED}
    with WAITING <-> RUNNING transitions on every elastic resize to/from zero.
    """

    SUBMITTED = "Submitted"  # accepted by admission service, not yet by a scheduler
    WAITING = "Waiting"      # accepted by scheduler, currently allocated zero chips
    RUNNING = "Running"      # allocated at least one chip
    COMPLETED = "Completed"
    FAILED = "Failed"
    CANCELED = "Canceled"

    @property
    def is_terminal(self) -> bool:
        return self in (JobStatus.COMPLETED, JobStatus.FAILED, JobStatus.CANCELED)


class JobKind(str, enum.Enum):
    """What runtime executes the job. Reference: types.go:52-56 (MPIJob /
    TFJob / PyTorchJob); here the native kind is an elastic JAX job."""

    JAX_JOB = "JAXJob"       # native: vodascheduler_tpu_torch.runtime elastic trainer
    EXTERNAL = "ExternalJob"  # opaque command the scheduler supervises


class EventVerb(str, enum.Enum):
    """Job-lifecycle event verbs published by the admission service and
    consumed by schedulers. Reference: rabbitmq.go Msg verbs
    (create|delete|configure)."""

    CREATE = "create"
    DELETE = "delete"
    CONFIGURE = "configure"


# Per-job config keys accepted in job specs (reference: env vars parsed from
# the MPIJob launcher container, types.go:10-29 + trainingjob.go:81-111).
JOB_NUM_PROC = "num_chips"
JOB_MIN_NUM_PROC = "min_num_chips"
JOB_MAX_NUM_PROC = "max_num_chips"
JOB_EPOCHS = "epochs"
JOB_NAME = "job_name"
JOB_PRIORITY = "priority"


# Exit-code contract between the job supervisor (runtime/supervisor.py) and
# cluster backends: a supervisor that checkpointed and exited on request
# (resize/halt/migration) is not a failure.
PREEMPTED_EXIT_CODE = 3
