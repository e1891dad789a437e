"""Algorithm interface + allocation validation.

Reference counterpart: pkg/algorithm/types.go (SchedulerAlgorithm interface)
and pkg/algorithm/utils.go (validateResult). The reference *panics* the
allocator process on an invalid allocation; here validation raises a typed
error the caller can surface, and the same checks double as test oracles.
"""

from __future__ import annotations

import abc
from typing import TYPE_CHECKING, Iterable, List, Optional

from vodascheduler_tpu_torch.common.job import TrainingJob
from vodascheduler_tpu_torch.common.types import ScheduleResult

if TYPE_CHECKING:
    from vodascheduler_tpu_torch.placement.topology import PoolTopology


class InvalidAllocationError(AssertionError):
    """An algorithm produced an allocation violating the core invariants."""


def validate_result(total_chips: int, result: ScheduleResult,
                    jobs: Iterable[TrainingJob],
                    topology: Optional["PoolTopology"] = None,
                    meta: Optional[dict] = None) -> None:
    """Invariants (reference: utils.go:18-42):
      - every allocation is >= 0
      - a nonzero allocation is within [min_num_chips, max_num_chips]
      - Σ allocations <= total_chips
      - with a topology: every allocation is slice-shape feasible (the TPU
        delta SURVEY.md §7 adds to the reference's fungible-GPU checks —
        a count with no contiguous sub-torus must never reach the backend);
        FRACTIONAL-class jobs (doc/fractional-sharing.md) admit any
        sub-host count (a static chip-partition of one host block).

    `meta` is the allocator's cached name -> (min, max, fractional) map
    (allocator._feasibility_meta); None derives bounds/classes here —
    this runs inside the decide window, so the allocator passes its
    per-pool cache instead of re-deriving a 10k-job fleet every pass.
    """
    if topology is not None:
        from vodascheduler_tpu_torch.placement.topology import FeasibleTable
        table = FeasibleTable.for_topology(topology)
        feas, ffeas, total_t = (table.feasible, table.frac_feasible,
                                table.total)
    else:
        feas = ffeas = None
        total_t = 0
    if meta is None:
        if topology is None:
            # The algorithm-internal validation path (no topology, no
            # feasibility sweep): the fractional flag is provably
            # unread, so skip the per-job class resolution entirely.
            meta = {j.name: (j.config.min_num_chips,
                             j.config.max_num_chips, False)
                    for j in jobs}
        else:
            from vodascheduler_tpu_torch.allocator.allocator import (
                _feasibility_meta,
            )
            meta = _feasibility_meta(jobs, topology)
    meta_get = meta.get
    allocated = 0
    # One fused sweep, one meta probe per grant: bounds AND (with a
    # topology) slice-shape/partition feasibility — this is the decide
    # window's runtime safety net, so it pays one pass, not two.
    for job, n in result.items():
        lo, hi, frac = meta_get(job, (0, 0, False))
        if n < 0:
            raise InvalidAllocationError(f"{job}: negative allocation {n}")
        if 0 < n < lo:
            raise InvalidAllocationError(f"{job}: allocation {n} below min {lo}")
        if n > hi:
            raise InvalidAllocationError(f"{job}: allocation {n} above max {hi}")
        allocated += n
        if n == 0 or feas is None:
            continue
        if n <= total_t and (ffeas[n] if frac else feas[n]):
            continue
        raise InvalidAllocationError(
            f"{job}: allocation {n} has no contiguous slice shape "
            f"on torus {topology.torus_dims} "
            f"(host block {topology.host_block})")
    # Capacity can transiently read negative while node deletions race a
    # resched; zero allocation is the only valid answer then, not a crash.
    if allocated > max(0, total_chips):
        raise InvalidAllocationError(
            f"total allocated {allocated} exceeds capacity {total_chips}")


def allocate_minimums(ordered: List[TrainingJob], result: ScheduleResult,
                      free: int) -> int:
    """Phase one of the FIFO/SRJF families: walk jobs in the given order and
    give each its minimum while supply lasts (fifo.go:38-45 et al.)."""
    for job in ordered:
        result[job.name] = 0
        if free >= job.config.min_num_chips:
            result[job.name] = job.config.min_num_chips
            free -= job.config.min_num_chips
    return free


class SchedulerAlgorithm(abc.ABC):
    """Reference: SchedulerAlgorithm interface (types.go:19-25)."""

    name: str = ""
    # Whether the algorithm hands out chips beyond job minimums (the
    # Elastic* family, FfDL, AFS-L). Metadata for status surfaces; the
    # feasibility post-pass itself is elasticity-agnostic because it never
    # moves a grant past its nearest feasible neighbor.
    elastic: bool = False

    def __init__(self, scheduler_id: str = ""):
        self.scheduler_id = scheduler_id

    @abc.abstractmethod
    def schedule(self, jobs: List[TrainingJob], total_chips: int) -> ScheduleResult:
        """Return {job name: chips}. Must include every job in `jobs` (0 for
        unscheduled) and satisfy validate_result."""

    def schedule_reference(self, jobs: List[TrainingJob],
                           total_chips: int) -> ScheduleResult:
        """The pure per-job reference implementation — the differential
        oracle the vectorized kernels (algorithms/fastpath.py) are
        proven bit-identical against. Algorithms with a fastpath kernel
        override this with their original body and dispatch from
        `schedule`; for the rest, `schedule` IS the reference."""
        return self.schedule(jobs, total_chips)

    @property
    def needs_job_info(self) -> bool:
        """Whether the allocator must attach JobInfo (speedup curves /
        remaining-time estimates) before calling schedule."""
        return False


def distribute_leftover(jobs: List[TrainingJob], result: ScheduleResult,
                        free: int) -> int:
    """Round-robin one chip at a time to jobs below their max, in the given
    order, until supply or demand is exhausted.

    Shared second phase of the Elastic* family (elastic_fifo.go:57-71,
    elastic_srjf.go:55-70). Jobs that got nothing in phase one stay at zero.

    Deliberate fix over the reference: its sweep condition
    `result < max || !satisfied` also increments zero-allocated jobs (marked
    satisfied because min didn't fit), which can leave 0 < alloc < min and
    panic validateResult — e.g. total=3, A(min1,max10) then B(min3,max3):
    phase 1 gives A=1 free=2, B=0; the sweep then sets B=1 and crashes.
    Excluding zero-allocated jobs preserves the intended semantics
    ("leftovers never lift a job from 0 below its min") without the crash.
    """
    eligible = [j for j in jobs if result[j.name] > 0
                and result[j.name] < j.config.max_num_chips]
    while free > 0 and eligible:
        for job in list(eligible):
            result[job.name] += 1
            free -= 1
            if result[job.name] == job.config.max_num_chips:
                eligible.remove(job)
            if free == 0:
                break
    return free
