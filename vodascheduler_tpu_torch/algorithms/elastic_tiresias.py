"""ElasticTiresias (E-Tiresias / EDL): Tiresias base + compaction + greedy
marginal-gain distribution of leftovers.

Implements the policy of Wu et al., "Elastic Deep Learning in Multi-Tenant
GPU Clusters" (TPDS'21), matching the reference semantics
(pkg/algorithm/elastic_tiresias.go):

1. Allocate each job its requested `num_chips`, highest queue first.
2. If pending jobs exceed the compaction threshold (10), shrink every
   *running* job in queues >= 1 down to its minimum, freeing chips.
3. Repeatedly give the next chip to the job with the highest marginal
   speedup gain (`speedup[n+1] - speedup[n]`); a still-pending job must
   receive its full minimum or nothing; stop when no job gains.

Chips the gain loop declines stay free deliberately: on TPU every grant is
a checkpoint-restart of the receiving job, so zero-marginal-gain growth is
pure restart cost, not "free occupancy" (a work-conserving top-up was
tried and removed for this reason).
"""

from __future__ import annotations

from typing import Dict, List

from vodascheduler_tpu_torch.algorithms.base import SchedulerAlgorithm, validate_result
from vodascheduler_tpu_torch.algorithms.tiresias import queues_by_priority
from vodascheduler_tpu_torch.common.job import JobInfo, TrainingJob
from vodascheduler_tpu_torch.common.types import JobStatus, ScheduleResult

# Reference: ElasticTiresiasCompactionThreshold (elastic_tiresias.go:21).
COMPACTION_THRESHOLD = 10

# TPU delta (no reference counterpart): minimum runtime between
# preemptions. On GPU+Horovod a preemption is a cheap ring re-form; on TPU
# it is a checkpoint-restart costing tens of seconds of the whole slice, so
# a job evicted moments after it (re)started burns two restart windows for
# almost no queue progress. A running job inside its lease window is
# guaranteed its minimum before normal queue order applies; Tiresias's
# time-slicing still happens, just at lease granularity. The default
# equals the Tiresias queue-0 threshold (tiresias.go:17-36): one lease =
# one scheduling quantum. Measured on the 64-job Philly replay
# (BENCH): restarts 319 -> ~180, steady-state utilization 0.916 -> 0.96,
# avg JCT within noise of the no-lease policy.
LEASE_SECONDS = 3600.0

# TPU delta (r4): JCT-tail "floor lift". Under saturation the
# marginal-gain loop systematically favors fresh jobs: a job with no
# learned curve carries the linear-speedup PRIOR (marginal gain exactly
# 1.0, base_job_info in common/job.py), which outbids every real learned
# curve (< 1.0) — so once a job's curve is measured it loses every
# leftover auction and sits at its minimum for hours. That is the
# diagnosed source of the r3 p95 = 11.1 ks tail: the tail jobs ran at
# 1.3-2.3x their ideal-at-max with near-zero queue WAIT (an allocation
# floor problem, not queue starvation). The guard: a job that has been
# RUNNING longer than FLOOR_LIFT_AGE_SECONDS while still allocated only
# its floor (<= min chips) gets its phase-2 gain weighted by
# FLOOR_LIFT_WEIGHT — just enough to outbid the fresh-prior's 1.0. The
# boost applies ONLY while the job sits at its floor: one granted chip
# and it competes normally again, so lifted jobs cannot hoard.
#
# Tuning evidence (8 traces: headline seed + 7 others, doc/benchmarks.md):
# age=1200 s improves or holds avg JCT on 7/8 seeds (headline -8% avg,
# -9% p95; best -22% avg) and p95 on 7/8. A more aggressive age=600
# reached -29% p95 on the headline but regressed seed 303's avg +44%
# (it taxes the fresh-job "blitz" that keeps short jobs under the
# Tiresias demotion threshold) — rejected for robustness. Weight
# magnitude barely matters (any value > 1 flips the auction); 2.0 keeps
# the intent legible.
FLOOR_LIFT_AGE_SECONDS = 1200.0
FLOOR_LIFT_WEIGHT = 2.0


def next_gain(info: JobInfo, chips: int) -> float:
    """Marginal speedup from one more chip (elastic_tiresias.go:170)."""
    return info.speedup_at(chips + 1) - info.speedup_at(chips)


class ElasticTiresias(SchedulerAlgorithm):
    name = "ElasticTiresias"
    elastic = True

    def schedule(self, jobs: List[TrainingJob], total_chips: int) -> ScheduleResult:
        from vodascheduler_tpu_torch.algorithms import fastpath

        fast = fastpath.elastic_tiresias(jobs, total_chips)
        if fast is not None:
            return fast
        return self.schedule_reference(jobs, total_chips)

    def schedule_reference(self, jobs: List[TrainingJob],
                           total_chips: int) -> ScheduleResult:
        result: ScheduleResult = {j.name: 0 for j in jobs}
        gain: Dict[str, float] = {}
        free = total_chips
        pendings = len(jobs)
        queues = queues_by_priority(jobs)

        for job in jobs:
            info = job.info or JobInfo()
            # Interpolate initial gain because min may exceed 1
            # (elastic_tiresias.go:58).
            gain[job.name] = info.speedup_at(job.config.min_num_chips) / job.config.min_num_chips

        # Phase 0 (TPU delta, see LEASE_SECONDS): running jobs inside their
        # lease keep at least their minimum, in queue order.
        leased = set()
        for priority in sorted(queues):
            for job in queues[priority]:
                if (job.status == JobStatus.RUNNING
                        and job.metrics.seconds_since_restart < LEASE_SECONDS
                        and free >= job.config.min_num_chips):
                    result[job.name] = job.config.min_num_chips
                    free -= job.config.min_num_chips
                    pendings -= 1
                    leased.add(job.name)
                    gain[job.name] = next_gain(job.info or JobInfo(),
                                               result[job.name])

        # Phase 1: fixed NumProc allocation by queue (elastic_tiresias.go:75-85).
        for priority in sorted(queues):
            for job in queues[priority]:
                if job.name in leased:
                    # Top up a leased min to the full NumProc when it fits.
                    extra = job.config.num_chips - result[job.name]
                    if 0 < extra <= free:
                        result[job.name] += extra
                        free -= extra
                        gain[job.name] = next_gain(job.info or JobInfo(),
                                                   result[job.name])
                    continue
                if free >= job.config.num_chips:
                    result[job.name] = job.config.num_chips
                    free -= job.config.num_chips
                    pendings -= 1
                    gain[job.name] = next_gain(job.info or JobInfo(), result[job.name])

        # Compaction (elastic_tiresias.go:88-103): when the pending backlog is
        # deep, shrink running low-priority jobs to their minimum.
        if pendings > COMPACTION_THRESHOLD:
            for priority in sorted(queues):
                if priority < 1:
                    continue
                for job in queues[priority]:
                    if result[job.name] != 0:
                        free += result[job.name] - job.config.min_num_chips
                        result[job.name] = job.config.min_num_chips
                        gain[job.name] = next_gain(job.info or JobInfo(), result[job.name])

        # Phase 2: greedy marginal-gain distribution (elastic_tiresias.go:106-152).
        # Deliberate fix over the reference: its candidate filter drops any
        # job with free < min (elastic_tiresias.go:109-113), wrongly
        # excluding already-RUNNING jobs that only need +1 chip and leaving
        # leftovers idle. The min threshold only gates pending (zero-alloc)
        # jobs here; the in-loop min-or-nothing rule below covers them.
        def lift_weight(j: TrainingJob) -> float:
            """Floor-lift (see FLOOR_LIFT_AGE_SECONDS above): boost only
            while the job is still stuck at its floor this pass."""
            if (result[j.name] <= j.config.min_num_chips
                    and j.metrics.running_seconds > FLOOR_LIFT_AGE_SECONDS):
                return FLOOR_LIFT_WEIGHT
            return 1.0

        candidates = [j for j in jobs
                      if result[j.name] < j.config.max_num_chips
                      and (result[j.name] > 0 or free >= j.config.min_num_chips)]
        while free > 0 and candidates:
            # Highest gain wins; ties broken by higher priority (lower value).
            # Stable sorts: priority first, then gain — matches the
            # reference's two sequential stable sorts. The floor lift only
            # reweights the auction; the raw gain still gates the <= 0
            # stop (a lifted zero is still zero).
            candidates.sort(key=lambda j: j.priority)
            candidates.sort(key=lambda j: gain[j.name] * lift_weight(j),
                            reverse=True)
            job = candidates[0]
            if gain[job.name] <= 0:
                break  # no algorithm-wide efficiency gain remains
            info = job.info or JobInfo()
            if result[job.name] == 0:
                # A pending job must get its whole minimum or nothing.
                if free >= job.config.min_num_chips:
                    result[job.name] = job.config.min_num_chips
                    free -= job.config.min_num_chips
                    gain[job.name] = next_gain(info, result[job.name])
                else:
                    candidates.remove(job)
            else:
                result[job.name] += 1
                free -= 1
                gain[job.name] = next_gain(info, result[job.name])
                if result[job.name] >= job.config.max_num_chips:
                    candidates.remove(job)

        validate_result(total_chips, result, jobs)
        return result

    @property
    def needs_job_info(self) -> bool:
        return True
