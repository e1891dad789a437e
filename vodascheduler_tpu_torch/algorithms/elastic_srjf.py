"""ElasticSRJF: SRJF base + round-robin distribution of leftovers.

Reference: pkg/algorithm/elastic_srjf.go:25-72.
"""

from __future__ import annotations

from typing import List

from vodascheduler_tpu_torch.algorithms.base import (
    SchedulerAlgorithm,
    allocate_minimums,
    distribute_leftover,
    validate_result,
)
from vodascheduler_tpu_torch.algorithms.srjf import remaining_seconds
from vodascheduler_tpu_torch.common.job import TrainingJob
from vodascheduler_tpu_torch.common.types import ScheduleResult


class ElasticSRJF(SchedulerAlgorithm):
    name = "ElasticSRJF"
    elastic = True

    def schedule(self, jobs: List[TrainingJob], total_chips: int) -> ScheduleResult:
        from vodascheduler_tpu_torch.algorithms import fastpath

        fast = fastpath.elastic_srjf(jobs, total_chips)
        if fast is not None:
            return fast
        return self.schedule_reference(jobs, total_chips)

    def schedule_reference(self, jobs: List[TrainingJob],
                           total_chips: int) -> ScheduleResult:
        result: ScheduleResult = {}
        ordered = sorted(jobs, key=remaining_seconds)
        free = allocate_minimums(ordered, result, total_chips)
        distribute_leftover(ordered, result, free)
        validate_result(total_chips, result, jobs)
        return result

    @property
    def needs_job_info(self) -> bool:
        return True
