"""The per-pool scheduler: the rescheduling control loop.

Reference counterpart: pkg/scheduler — the heart of the system
(SURVEY.md §3.2).

The port holds the per-pool `Scheduler`; the fleet layer
(`scheduler/fleet.py`) is not ported yet.
"""

from vodascheduler_tpu_torch.scheduler.scheduler import Scheduler  # noqa: F401
