"""The resource allocator.

Reference counterpart: pkg/allocator/allocator/resource_allocator.go —
`allocateResource` (:76) builds the algorithm from the factory, fetches
job_info docs from Mongo when `NeedJobInfo()` (:115, getJobsInfo), runs
`Schedule`, and returns the {job: count} map.

Info-attachment policy (getJobsInfo semantics + the admission service's
category seeding, handlers.go:180-206): exact job doc if present, else the
newest doc of the job's category (repeat workloads inherit learned curves),
else the linear-speedup base prior.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

from vodascheduler_tpu_torch.algorithms import new_algorithm
from vodascheduler_tpu_torch.algorithms.base import validate_result
from vodascheduler_tpu_torch.common.job import JobInfo, TrainingJob, base_job_info
from vodascheduler_tpu_torch.common.metrics import Registry
from vodascheduler_tpu_torch.common.store import JobStore
from vodascheduler_tpu_torch.common.types import ScheduleResult
from vodascheduler_tpu_torch.obs import profile as obs_profile
from vodascheduler_tpu_torch.obs import tracer as obs_tracer
from vodascheduler_tpu_torch.placement.topology import (
    PoolTopology,
    is_feasible_count,
    next_feasible_above,
    round_to_feasible,
)


@dataclasses.dataclass
class AllocationRequest:
    """Reference: AllocationRequest (pkg/allocator/allocator/types.go:5-10).

    TPU delta: the optional `topology` turns chip counts into slice-shape
    commitments — the allocator's grants are rounded to counts that admit
    a contiguous sub-torus (SURVEY.md §7 "allocation unit" delta; the
    reference's GPUs are fungible so utils.go:18-42 never needed this).
    `fractional_sharing` (doc/fractional-sharing.md) is the sub-host
    co-tenancy knob: on (default), FRACTIONAL-class jobs round within a
    host block and share hosts; off — the whole-host-minimum baseline —
    every grant's capacity cost rounds up to whole host blocks, so the
    A/B can measure what sharing recovers.
    """

    scheduler_id: str
    num_chips: int
    algorithm: str
    ready_jobs: List[TrainingJob]
    topology: Optional[PoolTopology] = None
    fractional_sharing: bool = True


def _is_frac_job(j: TrainingJob, cph: int) -> bool:
    """Whether one job's resolved resource class is fractional — the
    ONE resolution rule (common/job.py resolve_resource_class), shared
    by every derivation below so the cached meta, the reference
    oracle, and the validator can never disagree on a job's class."""
    from vodascheduler_tpu_torch.common.job import (
        RESOURCE_CLASS_FRACTIONAL,
        resolve_resource_class,
    )

    return resolve_resource_class(
        getattr(j.spec, "resource_class", "auto"),
        j.config.max_num_chips, cph) == RESOURCE_CLASS_FRACTIONAL


def _job_classes(jobs: List[TrainingJob],
                 topology: PoolTopology) -> dict:
    """name -> True iff the job's resolved resource class is fractional
    on this pool."""
    cph = topology.chips_per_host
    return {j.name: _is_frac_job(j, cph) for j in jobs}


def _feasibility_meta(jobs: List[TrainingJob],
                      topology: PoolTopology) -> dict:
    """name -> (min, max, fractional) for the feasibility post-pass and
    its validator — ONE derivation shared by both (and cached per pool
    by the allocator: bounds and class are spec-static, so a
    steady-state 10k-job pass pays one dict probe per job instead of
    re-deriving the fleet every pass)."""
    cph = topology.chips_per_host
    return {j.name: (j.config.min_num_chips, j.config.max_num_chips,
                     _is_frac_job(j, cph))
            for j in jobs}


def _footprint_fit_pass(out: ScheduleResult, total_chips: int,
                        cph: int) -> ScheduleResult:
    """The sharing-OFF budget pass (doc/fractional-sharing.md "The
    whole-host baseline"): every grant physically occupies whole host
    blocks, so its capacity cost is ceil(n / chips_per_host) x
    chips_per_host. Walk grants in result order (the allocator's
    priority order) and zero any grant whose footprint no longer fits —
    min-or-nothing, like allocate_minimums. Grant VALUES are untouched
    (a 2-chip job still runs 2 chips; the other 2 chips of its host are
    the stranded capacity the A/B measures)."""
    fitted: ScheduleResult = {}
    budget = max(0, total_chips)
    for job, n in out.items():
        if n <= 0:
            fitted[job] = 0
            continue
        footprint = ((n + cph - 1) // cph) * cph
        if footprint <= budget:
            fitted[job] = n
            budget -= footprint
        else:
            fitted[job] = 0
    return fitted


def enforce_feasibility(result: ScheduleResult, jobs: List[TrainingJob],
                        total_chips: int, topology: PoolTopology,
                        fractional_sharing: bool = True,
                        meta: Optional[dict] = None) -> ScheduleResult:
    """Round every grant to the slice-shape-feasible count *nearest* it.

    Algorithms reason in fungible chip counts (their speedup curves are
    keyed by count); this post-pass maps each grant onto the pool's torus
    with minimal distortion: an infeasible grant moves down to the largest
    feasible count below it, or — when capacity allows and the rounded
    count would violate the job's min — up to the smallest feasible count
    above it. A grant is never moved past its nearest feasible neighbors:
    chips an algorithm deliberately left free (e.g. ElasticTiresias's
    zero-marginal-gain stop) stay free, because every grant change is a
    checkpoint-restart of the receiving job. Jobs whose min cannot be met
    feasibly within spare capacity are zeroed (min-or-nothing, as in
    allocate_minimums). Never exceeds capacity or a job's max.

    Fractional resource class (doc/fractional-sharing.md): a job whose
    resolved class is fractional rounds sub-host grants WITHIN a host
    block (any 1..chips_per_host-1 count is a valid static
    chip-partition) instead of against the sub-torus shape catalog;
    whole-host jobs are unchanged. With `fractional_sharing` off — the
    whole-host-minimum A/B baseline — a trailing footprint pass charges
    every grant whole host blocks against capacity.

    `meta` is the _feasibility_meta map (the allocator passes its
    per-pool cache); None derives it here. This runs inside the decide
    window at fleet queue sizes, so the common case — every grant
    already feasible and within bounds, capacity respected — returns
    the input identically after one array-lookup scan (proven
    bit-identical to the scan-based enforce_feasibility_reference by
    feasibility_self_check)."""
    if meta is None:
        meta = _feasibility_meta(jobs, topology)
    from vodascheduler_tpu_torch.placement.topology import FeasibleTable
    table = FeasibleTable.for_topology(topology)
    feas, ffeas = table.feasible, table.frac_feasible
    rdown, frdown = table.round_down, table.frac_round_down
    total_t = table.total
    cph = table.chips_per_host
    meta_get = meta.get

    # Identity fast scan: nothing to round, nothing over capacity,
    # nothing the sharing-off footprint pass would zero — the steady
    # state of a pool whose algorithms already emit feasible counts.
    clean = True
    granted = 0
    footprint = 0
    for job, n in result.items():
        if n == 0:
            continue
        lo, _hi, frac = meta_get(job, (0, n, False))
        if (n < 0 or n > total_t or n < lo
                or not (ffeas[n] if frac else feas[n])):
            clean = False
            break
        granted += n
        if not fractional_sharing:
            footprint += ((n + cph - 1) // cph) * cph
    if clean and granted <= max(0, total_chips) and (
            fractional_sharing or footprint <= max(0, total_chips)):
        return result

    out: ScheduleResult = {}
    for job, n in result.items():
        lo, _hi, frac = meta_get(job, (0, n, False))
        if n <= 0:
            out[job] = 0
            continue
        k = n if n <= total_t else total_t
        f = frdown[k] if frac else rdown[k]
        out[job] = f if f >= (lo if lo > 1 else 1) else 0
    free = max(0, total_chips) - sum(out.values())

    # Second pass, largest rounding loss first: move each distorted grant
    # up to its ceiling — the smallest feasible count >= the original
    # grant — when spare capacity covers the difference. This both rescues
    # min-violating roundings (grant 6, min 5 -> 8) and recovers chips the
    # rounding stranded (7 -> 4 becomes 7 -> 8 when free), while a grant
    # that was already feasible is its own ceiling and never inflates.
    # Restricting to distorted grants BEFORE the sort is order-preserving
    # (the comparator is per-element, and undistorted grants were no-ops
    # in the oracle's loop).
    by_loss = [(job, n) for job, n in result.items()
               if n > 0 and out[job] != n]
    by_loss.sort(key=lambda kv: kv[1] - out[kv[0]], reverse=True)
    for job, n in by_loss:
        lo, hi, frac = meta_get(job, (0, n, False))
        ceiling = n if is_feasible_count(n, topology, fractional=frac) \
            else next_feasible_above(n, topology, fractional=frac)
        if ceiling is None or ceiling > hi:
            continue
        cost = ceiling - out[job]
        if 0 < cost <= free:
            out[job] = ceiling
            free -= cost
    if not fractional_sharing:
        out = _footprint_fit_pass(out, total_chips, cph)
    return out


def enforce_feasibility_reference(result: ScheduleResult,
                                  jobs: List[TrainingJob], total_chips: int,
                                  topology: PoolTopology,
                                  fractional_sharing: bool = True
                                  ) -> ScheduleResult:
    """Differential oracle for enforce_feasibility: the identical
    rounding policy on the pre-table scan primitives (topology.py
    `_*_scan`), so tests can prove the FeasibleTable-backed path makes
    the same per-grant decisions the O(scan) implementation made —
    including the fractional-class axis and the sharing-off footprint
    pass."""
    from vodascheduler_tpu_torch.placement.topology import (
        _is_feasible_scan,
        _next_feasible_above_scan,
        _round_to_feasible_scan,
    )

    bounds = {j.name: (j.config.min_num_chips, j.config.max_num_chips)
              for j in jobs}
    frac = _job_classes(jobs, topology)
    out: ScheduleResult = {}
    for job, n in result.items():
        lo, _hi = bounds.get(job, (0, n))
        f = _round_to_feasible_scan(n, topology, frac.get(job, False))
        out[job] = f if f >= max(lo, 1) else 0
    free = max(0, total_chips) - sum(out.values())
    by_loss = sorted(result.items(),
                     key=lambda kv: kv[1] - out.get(kv[0], 0), reverse=True)
    for job, n in by_loss:
        if n <= 0 or out[job] == n:
            continue
        lo, hi = bounds.get(job, (0, n))
        fractional = frac.get(job, False)
        ceiling = n if _is_feasible_scan(n, topology, fractional) else \
            _next_feasible_above_scan(n, topology, fractional)
        if ceiling is None or ceiling > hi:
            continue
        cost = ceiling - out[job]
        if 0 < cost <= free:
            out[job] = ceiling
            free -= cost
    if not fractional_sharing:
        out = _footprint_fit_pass(out, total_chips,
                                  topology.chips_per_host)
    return out


def feasibility_self_check(n_pools: int = 100,
                           seed: int = 20260804) -> List[str]:
    """Differential oracle sweep for the feasibility post-pass
    (doc/fractional-sharing.md): seeded random pools of mixed
    whole-host/sub-host jobs (auto, explicit fractional, explicit
    whole_host), random grants, both sharing modes — the
    FeasibleTable-backed enforce_feasibility must match the scan-based
    enforce_feasibility_reference exactly, values AND dict insertion
    order. Returns human-readable mismatches (empty = equivalent).
    Wired into `make modelcheck-selftest` beside fastpath.self_check."""
    import random

    from vodascheduler_tpu_torch.common.job import JobConfig, JobSpec, TrainingJob

    problems: List[str] = []
    rng = random.Random(seed)
    topologies = (
        PoolTopology(torus_dims=(4, 4, 4), host_block=(2, 2, 1)),
        PoolTopology(torus_dims=(4, 2, 2), host_block=(2, 2, 1)),
        PoolTopology(torus_dims=(8, 4, 4), host_block=(2, 2, 2)),
        PoolTopology(torus_dims=(32,), host_block=(8,)),
    )
    for p in range(n_pools):
        topology = topologies[p % len(topologies)]
        n = rng.randint(1, 24)
        jobs = []
        grants = {}
        for i in range(n):
            lo = rng.choice((1, 1, 2, 3, 4, 5))
            hi = max(lo, rng.choice((1, 2, 3, 4, 6, 8, 12, 16)))
            rc = rng.choice(("auto", "auto", "fractional", "whole_host"))
            spec = JobSpec(name=f"fz-{i:03d}", resource_class=rc,
                           config=JobConfig(min_num_chips=lo,
                                            max_num_chips=hi))
            jobs.append(TrainingJob.from_spec(spec, submit_time=float(i)))
            grants[spec.name] = rng.randint(0, hi)
        total = rng.choice((0, 4, topology.total_chips // 2,
                            topology.total_chips))
        for sharing in (True, False):
            fast = enforce_feasibility(dict(grants), jobs, total, topology,
                                       fractional_sharing=sharing)
            oracle = enforce_feasibility_reference(
                dict(grants), jobs, total, topology,
                fractional_sharing=sharing)
            if fast != oracle or list(fast) != list(oracle):
                problems.append(
                    f"pool {p} ({n} jobs, {total} chips, "
                    f"sharing={sharing}, {topology}): table != scan: "
                    f"{ {k: (oracle.get(k), fast.get(k)) for k in set(oracle) | set(fast) if oracle.get(k) != fast.get(k)} }")
    return problems


# The linear-speedup prior's curves are identical for every fresh job
# (speedup[n] = n, efficiency[n] = 1). One shared, effectively-immutable
# pair of dicts instead of ~500 fresh entries per job keeps a 10k-job
# fill from minting millions of heap objects whose eventual gen-2 GC
# pause lands inside a later pass's decide window. Nothing in the tree
# mutates an ATTACHED info's curves in place (the collector builds its
# own docs and upserts them), and serialization deep-copies.
_BASE_CURVES = base_job_info("", "", "")


def _base_prior(name: str, category: str, pool: str) -> JobInfo:
    return JobInfo(name=name, category=category, pool=pool,
                   estimated_remaining_seconds=0.0,
                   speedup=_BASE_CURVES.speedup,
                   efficiency=_BASE_CURVES.efficiency)


class ResourceAllocator:
    def __init__(self, store: JobStore, registry: Optional[Registry] = None):
        self.store = store
        # Per-job linear-speedup priors, reused across passes: a fresh
        # job with no learned doc gets the same base prior every pass,
        # and building one is ~500 dict entries — at 10k fresh jobs that
        # was most of the job-info fetch cost. Scoped PER SCHEDULER
        # (request.scheduler_id): one allocator serves every pool of a
        # fleet, and a single shared dict bounded by "this pass's queue"
        # saw 10 pools' entries, tripped its bound on EVERY pass, and
        # re-minted each pool's priors while evicting the other nine's —
        # an O(fleet) rebuild inside every decide window (the 100k-fleet
        # p95 regression the fleet perf point caught). Per-pool maps keep
        # each bound honest: once a doc exists in the store the prior is
        # never consulted for that job again, and each pool's cache is
        # bounded by its own ready queue.
        self._base_infos_by_pool: dict = {}
        # Per-pool feasibility meta cache: name -> (min, max,
        # fractional-class) for the feasibility post-pass + validator
        # (_feasibility_meta). Bounds and resource class are
        # spec-static, so a steady-state pass pays one probe per job;
        # bounded by the live queue like the prior cache above.
        self._feas_meta_by_pool: dict = {}
        registry = registry or Registry()
        # Reference metric names: pkg/allocator/allocator/metrics.go.
        self.m_requests = registry.counter(
            "voda_allocator_allocation_requests_total",
            "Total allocation requests served", ("algorithm",))
        self.m_algo_seconds = registry.summary(
            "voda_allocator_algorithm_duration_seconds",
            "Scheduling algorithm run time", ("algorithm",))
        self.m_info_seconds = registry.summary(
            "voda_allocator_jobinfo_fetch_duration_seconds",
            "Job info fetch time", ("algorithm",))
        # Bucketed view of the pure algorithm runtime: the summary above
        # gives the mean; the histogram answers "does SRJF on a 200-job
        # queue still finish under 50 ms" (the scheduler holds its lock
        # across this call, so the tail IS the control-plane stall tail).
        self.h_algo_runtime = registry.histogram(
            "voda_allocator_algorithm_runtime_seconds",
            "Scheduling algorithm runtime (bucketed)", ("algorithm",),
            buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5,
                     1.0, 5.0))

    def allocate(self, request: AllocationRequest) -> ScheduleResult:
        algo = new_algorithm(request.algorithm, request.scheduler_id)
        self.m_requests.inc(algorithm=algo.name)
        # The span parents onto the caller's ambient context: the resched
        # root for the in-process call, or the remote scheduler's context
        # installed from the RemoteAllocator HTTP headers (service/rest.py)
        # — one stitched trace either way.
        tracer = obs_tracer.active_tracer()
        with tracer.span("allocator.allocate", component="allocator",
                         attrs={"algorithm": algo.name,
                                "num_chips": request.num_chips,
                                "num_jobs": len(request.ready_jobs)}) as sp:
            if algo.needs_job_info:
                t0 = time.monotonic()
                attached = self._attach_job_info(request.ready_jobs,
                                                 request.scheduler_id)
                self.m_info_seconds.observe(time.monotonic() - t0,
                                            algorithm=algo.name)
                sp.set_attr("jobinfo", attached)
            t0 = time.monotonic()
            # The pure decision stage, profiled separately from the
            # job-info fetch above (obs/profile.py; the ambient pass
            # timer no-ops on a bare RemoteAllocator HTTP call): this is
            # the number ROADMAP item 2's algorithm vectorization moves.
            with obs_profile.phase("algorithm"):
                result = algo.schedule(request.ready_jobs, request.num_chips)
                if request.topology is not None:
                    meta = self._feasibility_meta_cached(
                        request.scheduler_id, request.ready_jobs,
                        request.topology)
                    result = enforce_feasibility(
                        result, request.ready_jobs, request.num_chips,
                        request.topology,
                        fractional_sharing=request.fractional_sharing,
                        meta=meta)
                    validate_result(request.num_chips, result,
                                    request.ready_jobs,
                                    topology=request.topology, meta=meta)
            took = time.monotonic() - t0
            self.m_algo_seconds.observe(took, algorithm=algo.name)
            self.h_algo_runtime.observe(took, algorithm=algo.name)
            sp.set_attr("granted_chips", sum(result.values()))
        return result

    def _feasibility_meta_cached(self, scheduler_id: str,
                                 jobs: List[TrainingJob],
                                 topology: PoolTopology) -> dict:
        """The pool's name -> (min, max, fractional) map, extended with
        only the names this pass hasn't seen (spec bounds and resource
        class never change post-admission) and bounded by the live
        queue — same cache policy as the base-prior cache."""
        cache = self._feas_meta_by_pool.setdefault(scheduler_id, {})
        cph = topology.chips_per_host
        for j in jobs:
            if j.name in cache:
                continue
            cfg = j.config
            cache[j.name] = (cfg.min_num_chips, cfg.max_num_chips,
                             _is_frac_job(j, cph))
        if len(cache) > 2 * len(jobs) + 64:
            keep = {j.name for j in jobs}
            cache = {k: v for k, v in cache.items() if k in keep}
            self._feas_meta_by_pool[scheduler_id] = cache
        return cache

    def _attach_job_info(self, jobs: List[TrainingJob],
                         scheduler_id: str = "") -> int:
        """Attach each job's info doc for this pass and return how many
        were served from LEARNED docs (exact or category fallback) —
        the allocate span's `jobinfo` attr; the remainder to `num_jobs`
        ran on the linear-speedup prior, so the pair reads as curve
        coverage of the queue.

        Batched: ONE store scan per pass (store.job_infos_for — single
        lock acquisition, O(1) name-index probes, category-fallback doc
        memoized per distinct category) instead of N point lookups +
        N category scans while the scheduler holds its lock. Jobs with
        neither a doc nor a category fallback get the linear-speedup
        base prior, cached per job name — semantics per job are
        unchanged (exact doc, else newest category doc, else prior)."""
        infos = self.store.job_infos_for(jobs)
        base_cache = self._base_infos_by_pool.setdefault(scheduler_id, {})
        learned = 0
        for job in jobs:
            info = infos.get(job.name)
            if info is None:
                info = base_cache.get(job.name)
                if info is None:
                    info = base_cache[job.name] = _base_prior(
                        job.name, job.category, job.pool)
            else:
                learned += 1
            job.info = info
        # Bound each pool's prior cache by ITS live queue: names no
        # longer in the ready set (completed/deleted jobs) drop out.
        if len(base_cache) > 2 * len(jobs) + 64:
            keep = {job.name for job in jobs}
            self._base_infos_by_pool[scheduler_id] = {
                k: v for k, v in base_cache.items() if k in keep}
        return learned
