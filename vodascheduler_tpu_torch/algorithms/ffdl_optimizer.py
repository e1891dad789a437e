"""FfDLOptimizer: DP knapsack maximizing total cluster throughput.

Implements the elastic-scaling optimizer of Saxena et al., "Effective
Elastic Scaling of Deep Learning Workloads" (MASCOTS'20), matching the
reference (pkg/algorithm/ffdl_optimizer.go):

- FIFO-trim the queue to at most K = total_chips jobs (feasibility +
  starvation avoidance).
- DP over (jobs × chips): P[j][k] = max Σ speedup allocating k chips to the
  first j jobs, considering g in 1..max_j chips for job j; SOL[j][k] records
  job j's share. Backtrack from P[J][K].

A job may receive 0 chips (its row simply inherits P[j-1][k]) — expressed in
the reference by g starting at 1 while SOL defaults to 0.

Deliberate fix over the reference: its DP transition omits the g=0 /
"skip job j" case from P's recurrence (`P[j][k]` only ever improves from
`speedup[g] + P[j-1][k-g]` with g >= 1), relying on the -10000 init so any
assignment beats skipping; when the queue is deeper than the chips can carry
min allocations for, P[J][K] can stay negative and the reference panics
("infeasible", ffdl_optimizer.go:113-118). Here the transition includes
inheriting P[j-1][k] (allocate 0 to job j), which both removes the panic and
strictly improves the optimum. Allocations below a job's min are excluded so
results always validate (the reference trusts speedup curves to make those
unattractive rather than excluding them).
"""

from __future__ import annotations

from typing import List

from vodascheduler_tpu_torch.algorithms.base import SchedulerAlgorithm, validate_result
from vodascheduler_tpu_torch.common.job import JobInfo, TrainingJob
from vodascheduler_tpu_torch.common.types import ScheduleResult


class FfDLOptimizer(SchedulerAlgorithm):
    name = "FfDLOptimizer"
    elastic = True

    def schedule(self, jobs: List[TrainingJob], total_chips: int) -> ScheduleResult:
        from vodascheduler_tpu_torch.algorithms import fastpath

        fast = fastpath.ffdl(jobs, total_chips)
        if fast is not None:
            return fast
        return self.schedule_reference(jobs, total_chips)

    def schedule_reference(self, jobs: List[TrainingJob],
                           total_chips: int) -> ScheduleResult:
        result: ScheduleResult = {j.name: 0 for j in jobs}
        if not jobs or total_chips <= 0:
            validate_result(total_chips, result, jobs)
            return result

        ordered = sorted(jobs, key=lambda j: j.submit_time)
        K = total_chips
        feasible = ordered[:K]  # FIFO trim (ffdl_optimizer.go:53-63)
        J = len(feasible)

        native_alloc = self._native_dp(feasible, K)
        if native_alloc is not None:
            for job, g in zip(feasible, native_alloc):
                result[job.name] = g
            validate_result(total_chips, result, jobs)
            return result

        # P[j][k]: best Σ speedup giving k chips to the first j jobs.
        P = [[0.0] * (K + 1) for _ in range(J + 1)]
        SOL = [[0] * (K + 1) for _ in range(J + 1)]
        for j in range(1, J + 1):
            job = feasible[j - 1]
            info = job.info or JobInfo()
            lo, hi = job.config.min_num_chips, job.config.max_num_chips
            for k in range(0, K + 1):
                # g = 0: job j unscheduled, inherit.
                best, best_g = P[j - 1][k], 0
                for g in range(lo, min(hi, k) + 1):
                    p = info.speedup_at(g) + P[j - 1][k - g]
                    if p > best:
                        best, best_g = p, g
                P[j][k] = best
                SOL[j][k] = best_g

        k = K
        for j in range(J, 0, -1):  # backtrack (ffdl_optimizer.go:121-129)
            result[feasible[j - 1].name] = SOL[j][k]
            k -= SOL[j][k]

        validate_result(total_chips, result, jobs)
        return result

    @staticmethod
    def _native_dp(feasible: List[TrainingJob], K: int):
        """C++ DP kernel (native/voda_native.cc); None -> Python fallback."""
        from vodascheduler_tpu_torch import native

        lo = [j.config.min_num_chips for j in feasible]
        hi = [j.config.max_num_chips for j in feasible]
        speedup_rows = []
        for job in feasible:
            info = job.info or JobInfo()
            speedup_rows.append([info.speedup_at(g) for g in range(K + 1)])
        return native.ffdl_dp(K, lo, hi, speedup_rows)

    @property
    def needs_job_info(self) -> bool:
        return True
