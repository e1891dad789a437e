"""Tiresias-L: discrete priority queues with GPU-time demotion.

Implements the Tiresias-L policy (Gu et al., "Tiresias: A GPU Cluster
Manager for Distributed Deep Learning", NSDI'19), matching the reference's
settings: 2 logical queues, 3600 s chip-time threshold for queue 0, promote
on starvation past PROMOTE_KNOB × last running time.

Reference: pkg/algorithm/tiresias.go. The promote/demote *rules* live in the
scheduler's time-metrics ticker (scheduler.go:787-802); this module provides
the allocation pass plus the priority-transition helpers the ticker calls.
"""

from __future__ import annotations

import math
from typing import Dict, List

from vodascheduler_tpu_torch.algorithms.base import SchedulerAlgorithm, validate_result
from vodascheduler_tpu_torch.common.job import TrainingJob
from vodascheduler_tpu_torch.common.types import ScheduleResult

# Settings from the original paper (reference: tiresias.go:17-36).
TIRESIAS_QUEUE_NUM = 2
TIRESIAS_THRESHOLDS_SEC: Dict[int, float] = {0: 3600.0, 1: math.inf}
TIRESIAS_PROMOTE_KNOB = 8


def tiresias_demote_priority(priority: int) -> int:
    """Reference: tiresias.go:109-115."""
    return priority + 1 if priority < TIRESIAS_QUEUE_NUM - 1 else priority


def tiresias_promote_priority(priority: int) -> int:
    """Starved jobs return to the highest-priority queue (tiresias.go:117-119)."""
    return 0


def queues_by_priority(jobs: List[TrainingJob]) -> Dict[int, List[TrainingJob]]:
    """Partition jobs into the discrete queues, each FIFO-ordered by first
    *start* time (not submit time — avoids needless preemption of jobs that
    already ran; tiresias.go:66-74)."""
    queues: Dict[int, List[TrainingJob]] = {p: [] for p in range(TIRESIAS_QUEUE_NUM)}
    for job in jobs:
        queues.setdefault(job.priority, []).append(job)
    for q in queues.values():
        q.sort(key=lambda j: j.metrics.first_start_time)
    return queues


class Tiresias(SchedulerAlgorithm):
    name = "Tiresias"

    def schedule(self, jobs: List[TrainingJob], total_chips: int) -> ScheduleResult:
        from vodascheduler_tpu_torch.algorithms import fastpath

        fast = fastpath.tiresias(jobs, total_chips)
        if fast is not None:
            return fast
        return self.schedule_reference(jobs, total_chips)

    def schedule_reference(self, jobs: List[TrainingJob],
                           total_chips: int) -> ScheduleResult:
        result: ScheduleResult = {}
        free = total_chips
        queues = queues_by_priority(jobs)
        # Allocate each job its fixed requested count, highest queue first
        # (tiresias.go:82-91): Tiresias is non-elastic.
        for priority in sorted(queues):
            for job in queues[priority]:
                result[job.name] = 0
                if free >= job.config.num_chips:
                    result[job.name] = job.config.num_chips
                    free -= job.config.num_chips
        validate_result(total_chips, result, jobs)
        return result
