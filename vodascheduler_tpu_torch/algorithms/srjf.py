"""SRJF: non-elastic shortest-remaining-job-first.

Reference: pkg/algorithm/srjf.go:25-52 — sort by estimated remaining time
(needs job info), give each job its minimum while supply lasts.
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


def remaining_seconds(job: TrainingJob) -> float:
    return job.info.estimated_remaining_seconds if job.info else 0.0


class SRJF(SchedulerAlgorithm):
    name = "SRJF"

    def schedule(self, jobs: List[TrainingJob], total_chips: int) -> ScheduleResult:
        from vodascheduler_tpu_torch.algorithms import fastpath

        fast = fastpath.srjf(jobs, total_chips)
        if fast is not None:
            return fast
        return self.schedule_reference(jobs, total_chips)

    def schedule_reference(self, jobs: List[TrainingJob],
                           total_chips: int) -> ScheduleResult:
        result: ScheduleResult = {}
        ordered = sorted(jobs, key=remaining_seconds)
        allocate_minimums(ordered, result, total_chips)
        validate_result(total_chips, result, jobs)
        return result

    @property
    def needs_job_info(self) -> bool:
        return True
