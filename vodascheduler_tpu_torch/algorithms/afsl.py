"""AFS-L: repeated one-chip auctions between pairwise-compared jobs.

Implements the AFS-L policy of Hwang et al., "Elastic Resource Sharing for
Distributed Deep Learning" (NSDI'21), matching the reference
(pkg/algorithm/afsl.go):

- Repeatedly award one chip to the "top-priority" job.
- Top priority is found by a pairwise tournament: between two unscheduled
  jobs, the one with less remaining work wins; otherwise order the pair as
  (shorter, longer) by current estimated finish length and compare the
  longer job's normalized marginal speedup against the shorter's — if the
  longer job benefits more, it wins (the paper's "allocate to the job whose
  throughput gain is larger relative to what it gives up").
- A job leaves the auction when it reaches its maximum.

Deliberate fix over the reference: the paper's model has no job minimum,
and the reference auctions strictly one GPU at a time (afsl.go:47-58), so
any min>1 job that wins fewer than min chips crashes validateResult — with
a queue of min>1 jobs it cannot produce a valid allocation at all. Here a
*pending* job that wins the auction is granted its full minimum at once
(or leaves the auction if supply can't cover it), mirroring the
min-or-nothing rule the other elastic algorithms use; running jobs still
grow one chip per win. A final sub-min revert + re-auction remains as a
safety net.
"""

from __future__ import annotations

import math
from typing import List

from vodascheduler_tpu_torch.algorithms.base import SchedulerAlgorithm, validate_result
from vodascheduler_tpu_torch.common.job import JobInfo, TrainingJob
from vodascheduler_tpu_torch.common.types import ScheduleResult


def _info(job: TrainingJob) -> JobInfo:
    return job.info or JobInfo()


def _job_length(job: TrainingJob, chips: int) -> float:
    """Estimated finish time at `chips` chips (afsl.go:94-100)."""
    if chips == 0:
        return math.inf
    speedup = _info(job).speedup_at(chips)
    if speedup <= 0:
        return math.inf
    return _info(job).estimated_remaining_seconds / speedup


def _longer_wins(short: TrainingJob, long_: TrainingJob, result: ScheduleResult) -> bool:
    """The AFS pairwise test (afsl.go:102-106): does the longer job's
    normalized marginal gain beat the shorter job's?"""
    si, li = _info(short), _info(long_)
    ls_cur = li.speedup_at(result[long_.name])
    ls_next = li.speedup_at(result[long_.name] + 1)
    ss_cur = si.speedup_at(result[short.name])
    ss_next = si.speedup_at(result[short.name] + 1)
    left = (ls_next - ls_cur) / ls_next if ls_next > 0 else 0.0
    right = (ss_next - ss_cur) / ss_cur if ss_cur > 0 else math.inf
    return left > right


class AFSL(SchedulerAlgorithm):
    name = "AFS-L"
    elastic = True

    def schedule(self, jobs: List[TrainingJob], total_chips: int) -> ScheduleResult:
        result: ScheduleResult = {j.name: 0 for j in jobs}
        auction = sorted(jobs, key=lambda j: j.submit_time)
        free = total_chips
        while free > 0 and auction:
            job = self._top_priority(auction, result)
            if result[job.name] == 0:
                # Pending winner: min-or-nothing.
                grant = job.config.min_num_chips
                if free < grant:
                    auction.remove(job)
                    continue
            else:
                grant = 1
            result[job.name] += grant
            free -= grant
            if result[job.name] >= job.config.max_num_chips:
                auction.remove(job)

        # Guard: sub-minimum partial wins revert to 0 (see module docstring),
        # and the freed chips are re-auctioned among the jobs that can still
        # absorb them rather than left idle.
        while True:
            reverted = [j for j in jobs if 0 < result[j.name] < j.config.min_num_chips]
            if not reverted:
                break
            for job in reverted:
                free += result[job.name]
                result[job.name] = 0
            auction = [j for j in auction
                       if result[j.name] > 0 and result[j.name] < j.config.max_num_chips]
            while free > 0 and auction:
                job = self._top_priority(auction, result)
                result[job.name] += 1
                free -= 1
                if result[job.name] >= job.config.max_num_chips:
                    auction.remove(job)

        validate_result(total_chips, result, jobs)
        return result

    def _top_priority(self, auction: List[TrainingJob], result: ScheduleResult) -> TrainingJob:
        """Pairwise tournament (afsl.go:72-92)."""
        winner = auction[0]
        for challenger in auction[1:]:
            if result[winner.name] == 0 and result[challenger.name] == 0:
                if (_info(winner).estimated_remaining_seconds
                        >= _info(challenger).estimated_remaining_seconds):
                    winner = challenger
            else:
                short, long_ = winner, challenger
                # NOTE: the reference compares both lengths at the *winner's*
                # chip count (afsl.go:86 `a.jobLength(jb, result[j.Name])`);
                # we use each job's own count, which is the paper's intent.
                if _job_length(short, result[short.name]) >= _job_length(long_, result[long_.name]):
                    short, long_ = long_, short
                if _longer_wins(short, long_, result):
                    winner = long_
                else:
                    winner = short
        return winner

    @property
    def needs_job_info(self) -> bool:
        return True
