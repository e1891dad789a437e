"""What-if shadow planner (doc/learned-models.md "What-if planner").

`voda explain --whatif <job>` answers "what would happen if this job
ran at a different size?" by scoring candidate allocations on the SAME
placement-sensitive step-time model the replay simulator and the
placement objective share (rate = speedup(n)^(1 - f*spread)), under
both the learned model (fitted curves + confidence-blended fractions)
and the prior model (linear speedup + assumed family tables) — so the
report doubles as a live view of what learning has changed.

Discipline (the decide path must never notice the planner exists):

- snapshot-in: ONE brief scheduler-lock hold copies the job records,
  bookings, and live placements; everything after runs lock-free on
  cloned records;
- read-only: the shadow allocator call runs under a dedicated
  `<pool>::whatif` scheduler id, so its caches never collide with the
  live pass's, and cloned jobs take the info attachment — live records
  are never touched;
- bounded: the scheduler runs plans on one lazily-created worker with
  a small in-flight cap (Scheduler.whatif), off the decide critical
  path by construction (the perf_scale `learned` section pins that a
  hammering planner does not inflate live decide p95).

The emitted `whatif_report` is a closed-schema record (obs/audit.py):
the allocator's would-be grant plus a candidate table of feasible chip
counts with modeled spread penalty and remaining time under learned vs
prior models.
"""

from __future__ import annotations

import copy
import dataclasses
import time as _walltime
from typing import Dict, List, Optional, Tuple

from vodascheduler_tpu_torch.obs import audit as obs_audit

# Bound on the candidate table: feasible counts are sparse, but a
# 256-chip fractional range could enumerate hundreds — the report is a
# human surface, and the planner's cost must stay bounded. Never a
# silent cap: the record carries `candidates_total`.
MAX_CANDIDATES = 24


@dataclasses.dataclass
class _Snapshot:
    pool: str
    algorithm: str
    total_chips: int
    job: object                     # cloned TrainingJob of the target
    jobs: List[object]              # cloned ready queue
    booked: Dict[str, int]
    live_pairs: List[Tuple[str, int]]
    topology: object
    fractional: bool
    learned_models: bool
    learned_fraction: Optional[Tuple[float, float]]


def snapshot(sched, job_name: str) -> _Snapshot:
    """Copy everything the planner needs. The scheduler lock is held
    only for the REFERENCE grabs (list of job records, ledger snapshot,
    placement pairs) — cloning a 10k-job queue under the lock would
    itself stall the decide path the planner promises not to touch.
    The per-record clones happen lock-free afterwards: a pass mutating
    a record mid-clone can tear individual fields, which is acceptable
    for an advisory shadow plan (the report is a model of "about now",
    not a linearizable read)."""
    with sched._lock:
        tj = sched.ready_jobs.get(job_name)
        if tj is None:
            raise KeyError(f"unknown or finished job {job_name!r}")
        refs = list(sched.ready_jobs.values())
        booked = sched.job_num_chips.snapshot()
        pm = sched.placement_manager
        pairs: List[Tuple[str, int]] = []
        if pm is not None:
            placement = pm.job_placements.get(job_name)
            if placement is not None:
                pairs = [(hs.host, hs.num_slots)
                         for hs in placement.host_slots if hs.num_slots > 0]
        lf = sched._learned_fraction.get(job_name)
        fractional = sched._is_fractional(job_name)
    # copy.copy, not dataclasses.replace: replace() re-runs __init__
    # per record (~4x the cost), and at 10k jobs the difference is real
    # GIL time stolen from a concurrent decide.
    jobs = [copy.copy(j) for j in refs]
    clone = next(j for j in jobs if j.name == job_name)
    return _Snapshot(
        pool=sched.pool_id,
        algorithm=sched.algorithm,
        total_chips=sched.total_chips,
        job=clone,
        jobs=jobs,
        booked=booked,
        live_pairs=pairs,
        topology=pm.topology if pm is not None else None,
        fractional=fractional,
        learned_models=sched.learned_models,
        learned_fraction=lf,
    )


def _compact_spread(topology, n: int,
                    coords_cache: Dict[int, float]) -> float:
    """Optimistic spread of an n-chip grant placed compactly: the
    spread of the first ceil(n/chips_per_host) host coords in torus
    order — deterministic, and the best case the placement objective
    steers toward. 0.0 for sub-host grants (and without a topology)."""
    if topology is None or n <= 0:
        return 0.0
    hosts = -(-n // topology.chips_per_host)
    if hosts <= 1:
        return 0.0
    got = coords_cache.get(hosts)
    if got is None:
        coords = topology.host_coords()[:hosts]
        got = coords_cache[hosts] = topology.spread(coords)
    return got


def _live_spread(topology, pairs: List[Tuple[str, int]]) -> float:
    if topology is None or not pairs:
        return 0.0
    names = {topology.host_name(c): c for c in topology.host_coords()}
    coords = [names[h] for h, n in pairs if n > 0 and h in names]
    return topology.spread(coords) if coords else 0.0


def _candidate_counts(snap: _Snapshot) -> Tuple[List[int], int]:
    """Feasible chip counts in the job's [min, max], capped (with the
    uncapped total reported). Without a topology every count in range
    is a candidate — chips are fungible there."""
    cfg = snap.job.config
    lo, hi = cfg.min_num_chips, cfg.max_num_chips
    if snap.topology is None:
        counts = list(range(max(1, lo), hi + 1))
    else:
        from vodascheduler_tpu_torch.placement.topology import FeasibleTable
        table = FeasibleTable.for_topology(snap.topology)
        feas = table.frac_feasible if snap.fractional else table.feasible
        counts = [n for n in range(max(1, lo), min(hi, table.total) + 1)
                  if feas[n]]
    total = len(counts)
    if total > MAX_CANDIDATES:
        # Keep the ends and an even stride through the middle — the
        # extremes are what an operator asks about.
        stride = (total - 1) / float(MAX_CANDIDATES - 1)
        keep = sorted({counts[int(round(i * stride))]
                       for i in range(MAX_CANDIDATES)})
        counts = keep
    return counts, total


def _yield_to_passes(sched, timeout_s: float = 2.0,
                     pending_timeout_s: float = 0.25) -> None:
    """Wait out decide activity before a GIL-heavy planner stage: the
    shadow decide is advisory (freshness of one pass is irrelevant),
    and a 10k-job clone+allocate running concurrently with a live
    decide would steal roughly half its cycles — the inflation the
    perf gate's planner-overhead column forbids. An IN-FLIGHT pass is
    waited out up to `timeout_s`; a merely PENDING pass only up to
    `pending_timeout_s` (under a real clock a pass can stay pending a
    whole rate-limit window, and an operator's --whatif must not stall
    behind it)."""
    deadline = _walltime.monotonic() + timeout_s
    pending_deadline = _walltime.monotonic() + pending_timeout_s
    while _walltime.monotonic() < deadline:
        with sched._lock:
            in_flight = sched._in_resched
            pending = sched._resched_pending
        if not in_flight and (not pending
                              or _walltime.monotonic() > pending_deadline):
            return
        # vodalint: ignore[clock-discipline] deliberately WALL-clock:
        # the sleep exists to yield the GIL to a live decide thread;
        # a VirtualClock sleep would advance simulated time (and fire
        # timers) from a planner that must be invisible to the replay
        _walltime.sleep(0.002)


def run_whatif(sched, job_name: str) -> dict:
    """Build one whatif_report for `job_name` (see module doc). Runs on
    the scheduler's bounded planner worker; raises KeyError for an
    unknown job."""
    from vodascheduler_tpu_torch.allocator import AllocationRequest
    from vodascheduler_tpu_torch.metricscollector import learned as learned_mod
    from vodascheduler_tpu_torch.placement import comms as comms_mod

    t0 = _walltime.monotonic()
    _yield_to_passes(sched)
    snap = snapshot(sched, job_name)
    tj = snap.job
    info = sched.store.get_job_info(job_name)
    category = tj.category
    profile = comms_mod.profile_for_job(tj.spec.collectives, category)
    f_prior = 0.0 if profile is None else profile.comms_fraction
    fi_prior = comms_mod.interference_fraction_for_category(category)
    if snap.learned_fraction is not None:
        f_learned, _fi_learned = snap.learned_fraction
    elif info is not None:
        f_learned = learned_mod.blend(f_prior, info.comms_fraction_est,
                                      info.comms_fraction_weight)
    else:
        f_learned = f_prior
    fit = (learned_mod.fit_serial_seconds(info.epoch_seconds)
           if info is not None else None)
    remaining_serial = (info.estimated_remaining_seconds
                        if info is not None else 0.0)
    # Prior-model serial time: the linear prior has no time scale of
    # its own, so the measured serial estimate anchors both models —
    # the columns differ in how they SCALE it, which is what the
    # learned-vs-prior comparison is about.
    current = snap.booked.get(job_name, 0)

    def _rate(n: int, fraction: float, learned_curve: bool) -> float:
        if n <= 0:
            return 0.0
        if learned_curve and fit is not None:
            s = learned_mod.modeled_speedup(n, fit, info.epoch_seconds)
        else:
            s = float(n)  # the linear prior
        spread = _compact_spread(snap.topology, n, coords_cache)
        if s > 1.0 and fraction > 0.0 and spread > 0.0:
            s = s ** (1.0 - fraction * spread)
        return s

    coords_cache: Dict[int, float] = {}
    counts, counts_total = _candidate_counts(snap)
    candidates = []
    for n in counts:
        spread = _compact_spread(snap.topology, n, coords_cache)
        rate_l = _rate(n, f_learned, learned_curve=True)
        rate_p = _rate(n, f_prior, learned_curve=False)
        s_contig = (learned_mod.modeled_speedup(n, fit, info.epoch_seconds)
                    if fit is not None else float(n))
        candidates.append({
            "chips": n,
            "spread": round(spread, 4),
            # Placement penalty factor at this size: modeled step time
            # vs the contiguous ideal (1.0 = no spread cost).
            "modeled_step_ratio": round(s_contig / rate_l, 4)
            if rate_l > 0 else 0.0,
            "modeled_remaining_s": round(remaining_serial / rate_l, 1)
            if rate_l > 0 else 0.0,
            "prior_remaining_s": round(remaining_serial / rate_p, 1)
            if rate_p > 0 else 0.0,
        })

    # Shadow decide: what the allocator would grant RIGHT NOW, on the
    # cloned queue, under the live algorithm — read-only (dedicated
    # scheduler id keeps the allocator's per-pool caches disjoint from
    # the live pass's).
    would_grant = current
    shadow_error = None
    try:
        _yield_to_passes(sched)
        result = sched.allocator.allocate(AllocationRequest(
            scheduler_id=f"{snap.pool}::whatif",
            num_chips=snap.total_chips,
            algorithm=snap.algorithm,
            ready_jobs=snap.jobs,
            topology=snap.topology,
            fractional_sharing=sched.fractional_sharing,
        ))
        would_grant = result.get(job_name, 0)
    except Exception as e:  # noqa: BLE001 - the planner must degrade, not wedge
        shadow_error = str(e)

    rec = {
        "kind": "whatif_report",
        "schema": obs_audit.SCHEMA_VERSION,
        "ts": sched.clock.now(),
        "pool": snap.pool,
        "job": job_name,
        "algorithm": snap.algorithm,
        "current_chips": current,
        "current_spread": round(_live_spread(snap.topology,
                                             snap.live_pairs), 4),
        "would_grant": would_grant,
        "model": "learned" if snap.learned_models else "prior",
        "comms_fraction_learned": round(f_learned, 4),
        "comms_fraction_prior": round(f_prior, 4),
        "interference_fraction_prior": round(fi_prior, 4),
        "drift_ratio": round(info.model_drift_ratio, 4)
        if info is not None else 1.0,
        "candidates": candidates,
        "candidates_total": counts_total,
        "duration_ms": round((_walltime.monotonic() - t0) * 1000.0, 3),
    }
    if shadow_error is not None:
        rec["shadow_error"] = shadow_error
    problems = obs_audit.validate_record(rec)
    if problems:  # the closed schema is a contract, not a suggestion
        raise ValueError(f"invalid whatif_report: {problems}")
    sched.tracer.emit(dict(rec))
    return rec
