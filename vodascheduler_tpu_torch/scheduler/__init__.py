"""The per-pool scheduler: the rescheduling control loop.

Reference counterpart: pkg/scheduler — the heart of the system
(SURVEY.md §3.2).
"""

from vodascheduler_tpu_torch.scheduler.fleet import (  # noqa: F401
    FleetCoordinator,
    FleetRouter,
)
from vodascheduler_tpu_torch.scheduler.scheduler import Scheduler  # noqa: F401
