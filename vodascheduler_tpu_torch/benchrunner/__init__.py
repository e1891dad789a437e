"""Resilient benchmark orchestration plane (see orchestrator.py).

Every perf claim the repo publishes flows through this subsystem: points
run in killable subprocesses under per-point watchdogs, risk-ordered,
with a provenance-tagged cache and a crash-safe resumable journal, so the
driver can stamp a complete artifact — every registered row `measured`,
`cached_from:<ts>`, or `skipped:<reason>` — even when a compile wedges.
"""

from vodascheduler_tpu_torch.benchrunner.orchestrator import (
    BenchOrchestrator,
    PointResult,
    run_key_for,
    to_hardware_section,
    validate_summary,
)
from vodascheduler_tpu_torch.benchrunner.points import (
    BenchPoint,
    default_registry,
    ordered,
    point_from_dict,
)

__all__ = [
    "BenchOrchestrator",
    "BenchPoint",
    "PointResult",
    "default_registry",
    "ordered",
    "point_from_dict",
    "run_key_for",
    "to_hardware_section",
    "validate_summary",
]
