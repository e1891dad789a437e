"""FIFO: non-elastic first-in-first-out.

Reference: pkg/algorithm/fifo.go:25-52 — sort by submit time; give each job
its minimum while supply lasts.
"""

from __future__ import annotations

from typing import List

from vodascheduler_tpu_torch.algorithms.base import (
    SchedulerAlgorithm,
    allocate_minimums,
    validate_result,
)
from vodascheduler_tpu_torch.common.job import TrainingJob
from vodascheduler_tpu_torch.common.types import ScheduleResult


class FIFO(SchedulerAlgorithm):
    name = "FIFO"

    def schedule(self, jobs: List[TrainingJob], total_chips: int) -> ScheduleResult:
        from vodascheduler_tpu_torch.algorithms import fastpath

        fast = fastpath.fifo(jobs, total_chips)
        if fast is not None:
            return fast
        return self.schedule_reference(jobs, total_chips)

    def schedule_reference(self, jobs: List[TrainingJob],
                           total_chips: int) -> ScheduleResult:
        result: ScheduleResult = {}
        ordered = sorted(jobs, key=lambda j: j.submit_time)
        allocate_minimums(ordered, result, total_chips)
        validate_result(total_chips, result, jobs)
        return result
