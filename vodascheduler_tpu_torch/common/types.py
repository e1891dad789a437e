"""Enums and constants shared by the supervisor and the backends.

Copied from the JAX package's ``common/types.py``: the values are the wire
contract with the scheduler, so they must not drift.
"""

from __future__ import annotations

import enum


class JobKind(str, enum.Enum):
    """What runtime executes the job."""

    JAX_JOB = "JAXJob"        # the elastic trainer under runtime/supervisor.py
    EXTERNAL = "ExternalJob"  # opaque command the scheduler supervises


# Exit-code contract between the job supervisor (runtime/supervisor.py) and
# cluster backends: a supervisor that checkpointed and exited on request
# (resize/halt/migration) is not a failure.
PREEMPTED_EXIT_CODE = 3
