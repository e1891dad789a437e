"""The replay harness: a full control plane + simulated cluster, fed a
trace, measured on JCT and chip utilization.

Fills SURVEY.md §7 stage 8. The whole stack is real — admission, event bus,
allocator, scheduler, placement, metrics collector — only the cluster and
the clock are simulated, so replay results exercise exactly the code paths
production runs.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import List, Optional, Sequence

from vodascheduler_tpu_torch import config
from vodascheduler_tpu_torch.allocator import ResourceAllocator
from vodascheduler_tpu_torch.cluster.fake import FakeClusterBackend
from vodascheduler_tpu_torch.common.clock import VirtualClock
from vodascheduler_tpu_torch.common.events import EventBus
from vodascheduler_tpu_torch.common.store import JobStore
from vodascheduler_tpu_torch.metricscollector import BackendRowSource, MetricsCollector
from vodascheduler_tpu_torch.obs import tracer as obs_tracer
from vodascheduler_tpu_torch.placement import PlacementManager, PoolTopology
from vodascheduler_tpu_torch.replay.trace import TraceJob
from vodascheduler_tpu_torch.scheduler import Scheduler
from vodascheduler_tpu_torch.service import AdmissionService


@dataclasses.dataclass
class ReplayReport:
    algorithm: str
    num_jobs: int
    completed: int
    failed: int
    makespan_seconds: float
    avg_jct_seconds: float
    p50_jct_seconds: float
    p95_jct_seconds: float
    avg_wait_seconds: float
    chip_utilization: float      # productive chip-seconds / capacity window
    # productive chip-seconds / attainable capacity, where attainable at any
    # instant is min(fleet capacity, Σ ready jobs' max chips) — the honest
    # denominator when the trace's ramp-up and drain-down tails cannot
    # physically fill the fleet
    attainable_utilization: float
    # raw utilization restricted to the demand-saturated windows (Σ ready
    # max >= capacity): in steady state the denominator IS the full fleet,
    # so this is the un-caveated number the BASELINE north star asks for.
    steady_state_utilization: float
    steady_state_seconds: float
    total_chips: int
    restarts_total: int
    rescheds_total: float
    # Resize-path mix (doc/elastic-resize.md): Tier-A live reshards vs
    # cold checkpoint-restart resizes (the latter are also in
    # restarts_total; in-place ones never are).
    resizes_inplace_total: int = 0
    cold_resizes_total: int = 0
    # Actuation pricing (the concurrent actuation plane): scheduler-busy
    # seconds spent actuating passes at the parallel engine's cost (sum
    # over passes of per-wave critical paths) vs what the pre-wave
    # serial engine would have paid (sum of every backend call). The
    # ratio is the modeled resched-latency win; the critical-path figure
    # is also priced into the replay itself (each pass delays the next
    # rate-limit window by its critical path — see Scheduler
    # price_actuation).
    actuation_critical_path_seconds: float = 0.0
    actuation_serial_sum_seconds: float = 0.0
    # Placement-sensitive step-time model (doc/placement.md): the
    # busy-weighted mean fraction of throughput lost to placement
    # spread (0 = every job ran contiguously), and whether the
    # comms-aware placement objective was on for this run — the A/B
    # axis the bench's topology-sensitive mix reports.
    comms_penalty_mean: float = 0.0
    placement_comms: bool = True
    # Fractional sub-host sharing (doc/fractional-sharing.md): whether
    # the sharing plane was on for this run (off = the whole-host-
    # minimum baseline arm), and the busy-weighted mean fraction of
    # throughput lost to co-tenant interference — the honest price of
    # the stranded capacity sharing recovers.
    fractional_sharing: bool = True
    interference_penalty_mean: float = 0.0
    # Learned-model plane (doc/learned-models.md): whether online
    # refinement + consumption was on for this run (off = the
    # prior-only learned_models_ab baseline arm), and how many drift
    # episodes fired an audited model_drift_detected resched.
    learned_models: bool = True
    drift_rescheds_total: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class PreemptionEvent:
    """Spot-style fleet change at a trace offset: removes `host`, or adds
    it with `chips` capacity when `add=True`."""

    at_seconds: float
    host: str
    add: bool = False
    chips: int = 0


def config5_preemptions(topology) -> list:
    """BASELINE config 5's spot-preemption schedule: two hosts reclaimed
    mid-trace, returned later. The single definition shared by bench.py,
    replay/compare.py, and the replay tests — tune it here and every
    consumer moves together."""
    names = [topology.host_name(c) for c in topology.host_coords()]
    return [
        PreemptionEvent(at_seconds=4000.0, host=names[3]),
        PreemptionEvent(at_seconds=4600.0, host=names[7]),
        PreemptionEvent(at_seconds=9000.0, host=names[3], add=True,
                        chips=topology.chips_per_host),
        PreemptionEvent(at_seconds=12000.0, host=names[7], add=True,
                        chips=topology.chips_per_host),
    ]


class ReplayHarness:
    def __init__(
        self,
        trace: Sequence[TraceJob],
        algorithm: str = "ElasticTiresias",
        topology: Optional[PoolTopology] = None,
        pool: str = "replay-pool",
        # None: the family-weighted mean from replay.restart_costs (the
        # backend fallback for jobs without a per-job profile cost —
        # trace jobs all carry their family's measured/assumed value).
        restart_overhead_seconds: Optional[float] = None,
        # Tier-A in-place resize cost fallback; None mirrors the above
        # via restart_costs.default_inplace_seconds.
        inplace_overhead_seconds: Optional[float] = None,
        rate_limit_seconds: float = config.RATE_LIMIT_SECONDS,
        # None -> the production defaults (config.SCALE_OUT_HYSTERESIS /
        # RESIZE_COOLDOWN_SECONDS, the r5 sweep knee): replay evidence
        # and deployed policy must not drift. 1.0 restores reference
        # apply-every-diff semantics.
        scale_out_hysteresis: Optional[float] = None,
        resize_cooldown_seconds: Optional[float] = None,
        collector_interval_seconds: float = 60.0,
        preemptions: Sequence[PreemptionEvent] = (),
        start_epoch: float = 1753760000.0,
        tracer: Optional[obs_tracer.Tracer] = None,
        # Comms-aware placement objective (doc/placement.md): None =
        # the environment default (VODA_PLACEMENT_COMMS, on unless 0);
        # False forces the count-only reference placement — the A/B
        # baseline the bench's topology mix runs. The SIMULATOR's
        # placement-sensitive step-time model stays on either way
        # (physics is not a policy knob), so both arms are judged
        # under the same cost model.
        placement_comms: Optional[bool] = None,
        # Scheduler defragmentation threshold (full repack + Hungarian
        # bind once this many jobs span hosts; 0 = off, the production
        # default). The topology mix enables it so the A/B also prices
        # consolidation migrations: the aware arm payback-gates them,
        # the count-only arm fires every re-binding.
        defrag_cross_host_threshold: int = 0,
        # Fractional sub-host sharing (doc/fractional-sharing.md):
        # None = the environment default (VODA_FRACTIONAL_SHARING, on
        # unless 0); False forces the whole-host-minimum baseline —
        # the fractional_sharing_ab A/B arm. The SIMULATOR's
        # interference-sensitive step-time model stays on either way
        # (physics is not a policy knob; the baseline arm's exclusive
        # hosts simply have no co-tenants to interfere with), so both
        # arms are judged under the same cost model.
        fractional_sharing: Optional[bool] = None,
        # Learned-model plane (doc/learned-models.md): None = the
        # environment default (VODA_LEARNED_MODELS, on unless 0);
        # False forces the prior-only reference path — the
        # learned_models_ab A/B arm: no fraction estimation, no drift
        # rescheds, and the scheduler's placement weights / payback
        # gate read the assumed family tables. The SIMULATOR's physics
        # stays identical either way (physics is not a policy knob).
        learned_models: Optional[bool] = None,
    ):
        self.trace = list(trace)
        self.algorithm = algorithm
        self.pool = pool
        self.clock = VirtualClock(start=start_epoch)
        self.store = JobStore()
        self.bus = EventBus()
        # Decision-audit tracing under simulated time: ids and timestamps
        # derive from the VirtualClock (obs/tracer.py), so the same trace
        # replayed twice emits byte-identical records — directly diffable
        # against a live run's trace of the same workload. Default keeps
        # records in the ring only; pass a Tracer with trace_dir (bench.py
        # does) to persist the audit JSONL as a provenance artifact.
        self.tracer = tracer or obs_tracer.Tracer(clock=self.clock)
        if restart_overhead_seconds is None:
            from vodascheduler_tpu_torch.replay.restart_costs import (
                default_restart_seconds,
            )
            restart_overhead_seconds = default_restart_seconds()
        if inplace_overhead_seconds is None:
            from vodascheduler_tpu_torch.replay.restart_costs import (
                default_inplace_seconds,
            )
            inplace_overhead_seconds = default_inplace_seconds()
        self.backend = FakeClusterBackend(
            self.clock, restart_overhead_seconds=restart_overhead_seconds,
            inplace_overhead_seconds=inplace_overhead_seconds)

        self.topology = topology or PoolTopology(torus_dims=(4, 4, 4),
                                                 host_block=(2, 2, 1))
        pm = PlacementManager(pool, topology=self.topology,
                              comms_enabled=placement_comms)
        self.placement_comms = pm.comms_enabled
        pm.add_hosts_from_topology(self.topology)
        # Placement-sensitive physics: the backend degrades each job's
        # speedup by its comms fraction x host-set spread, so placement
        # quality moves modeled step time (and the placements the
        # scheduler hands to start/scale are no longer cosmetic).
        self.backend.set_topology(self.topology)
        for coord in self.topology.host_coords():
            self.backend.add_host(self.topology.host_name(coord),
                                  self.topology.chips_per_host, announce=False)

        self.scheduler = Scheduler(
            pool, self.backend, self.store, ResourceAllocator(self.store),
            self.clock, bus=self.bus, placement_manager=pm,
            algorithm=algorithm, rate_limit_seconds=rate_limit_seconds,
            scale_out_hysteresis=(
                config.SCALE_OUT_HYSTERESIS if scale_out_hysteresis is None
                else scale_out_hysteresis),
            resize_cooldown_seconds=(
                config.RESIZE_COOLDOWN_SECONDS
                if resize_cooldown_seconds is None
                else resize_cooldown_seconds),
            defrag_cross_host_threshold=defrag_cross_host_threshold,
            fractional_sharing=fractional_sharing,
            learned_models=learned_models,
            tracer=self.tracer,
            # A live pass occupies real time while its actuation waves
            # run; under the VirtualClock it would occupy none, letting
            # replay reschedule infinitely fast. price_actuation charges
            # each pass its critical-path actuation seconds (per-wave
            # max — what the parallel engine pays; the pre-wave serial
            # engine paid the sum) against the next rate-limit window.
            price_actuation=True)
        self.admission = AdmissionService(self.store, self.bus, self.clock)
        # The collector inherits the scheduler's learned-models arm and
        # fires the audited drift trigger at it (doc/learned-models.md)
        # — one knob decides the whole A/B arm.
        self.collector = MetricsCollector(
            self.store, BackendRowSource(self.backend), self.clock,
            interval_seconds=collector_interval_seconds,
            learned=self.scheduler.learned_models,
            drift_trigger=lambda job: self.scheduler.trigger_resched(
                "model_drift_detected"))
        self.collector.start()

        self._submitted: List[str] = []
        self._first_submit_at: Optional[float] = None
        self._attainable_chip_seconds = 0.0
        self._attainable_last_t: Optional[float] = None
        self._attainable_current = 0.0
        self._sat_capacity_cs = 0.0   # ∫ capacity over saturated windows
        self._sat_busy_cs = 0.0       # busy chip-seconds within them
        self._sat_seconds = 0.0
        self._busy_at_last_accrue = 0.0

        # Event-exact attainable-capacity integration: demand changes only
        # on submission and on cluster events (completion/failure/host
        # churn), so accruing the piecewise-constant value right before the
        # scheduler processes each event — and re-reading it right after —
        # integrates min(capacity, Σ ready max) exactly, with no sampling
        # grid. (The scheduler registered its callback in its ctor; wrap it.)
        scheduler_cb = self.backend._event_cb

        def _instrumented(event):
            self._accrue_attainable()
            scheduler_cb(event)
            self._refresh_attainable()

        self.backend.set_event_callback(_instrumented)

        for tj in self.trace:
            self.clock.call_later(tj.submit_offset_seconds,
                                  lambda tj=tj: self._submit(tj))
        for ev in preemptions:
            self.clock.call_later(ev.at_seconds,
                                  lambda ev=ev: self._apply_preemption(ev))

    def _accrue_attainable(self) -> None:
        """Close the window since the last demand/capacity change at the
        value that held throughout it (and classify it as steady-state if
        demand saturated the fleet for its whole span)."""
        now = self.clock.now()
        self.backend.sync_accounting()
        busy = self.backend.busy_chip_seconds
        if (self._attainable_last_t is not None
                and self._first_submit_at is not None):
            dt = now - self._attainable_last_t
            self._attainable_chip_seconds += dt * self._attainable_current
            capacity = self.backend.total_chips()
            if dt > 0 and capacity > 0 and self._attainable_current >= capacity:
                self._sat_capacity_cs += dt * capacity
                self._sat_busy_cs += busy - self._busy_at_last_accrue
                self._sat_seconds += dt
        self._busy_at_last_accrue = busy
        self._attainable_last_t = now

    def _refresh_attainable(self) -> None:
        demand = sum(j.config.max_num_chips
                     for j in self.scheduler.ready_jobs.values())
        self._attainable_current = min(self.backend.total_chips(), demand)

    def _apply_preemption(self, ev: PreemptionEvent) -> None:
        # Close the accounting window before capacity changes (the event
        # the backend emits would close it after, mis-pricing the window).
        self._accrue_attainable()
        if ev.add:
            self.backend.add_host(ev.host, ev.chips)
        else:
            self.backend.remove_host(ev.host)
        self._refresh_attainable()

    def _submit(self, tj: TraceJob) -> None:
        self._accrue_attainable()
        # Profile registration rides the pre-publish hook: the CREATE
        # event can synchronously start the job, and a sim started before
        # its profile lands would be priced at the backend default
        # (exactly what happened to 37/287 restarts before r5 — restart
        # costs silently fell back to the 30 s default). Exact-name
        # registration keeps per-job fault injection from leaking to
        # other jobs of the same family.
        name = self.admission.create_training_job(
            tj.job_spec(self.pool),
            on_admitted=lambda n: self.backend.register_profile(
                n, tj.profile()))
        self._submitted.append(name)
        if self._first_submit_at is None:
            self._first_submit_at = self.clock.now()
            self._attainable_last_t = self.clock.now()
        self._refresh_attainable()

    # ---- run -------------------------------------------------------------

    def run(self, max_sim_seconds: float = 90 * 24 * 3600.0,
            stall_horizon_seconds: float = 48 * 3600.0) -> ReplayReport:
        deadline = self.clock.now() + max_sim_seconds
        last_progress_at = self.clock.now()
        last_done = -1
        while not self._all_done():
            nxt = self.clock.next_timer()
            if nxt is None or nxt > deadline:
                break
            self.clock.advance_to(nxt)
            done = len(self.backend.completed) + len(self.backend.failed)
            if done != last_done:
                last_done = done
                last_progress_at = self.clock.now()
            elif (not self.backend.running_jobs()
                    and len(self._submitted) == len(self.trace)
                    and self.clock.now() - last_progress_at > stall_horizon_seconds):
                # Livelock: jobs queued, nothing running, nothing scheduled.
                # A correct algorithm never reaches this; break rather than
                # simulating an idle eternity.
                break
        return self._report()

    def _all_done(self) -> bool:
        if len(self._submitted) < len(self.trace):
            return False
        done = set(self.backend.completed) | set(self.backend.failed)
        return all(name in done for name in self._submitted)

    # ---- metrics ---------------------------------------------------------

    def _report(self) -> ReplayReport:
        jcts: List[float] = []
        waits: List[float] = []
        for name in self._submitted:
            job = self.store.get_job(name)
            if job is None or job.finish_time >= 1e300:
                continue
            jcts.append(job.finish_time - job.submit_time)
            waits.append(job.metrics.waiting_seconds)

        start = self._first_submit_at or self.clock.now()
        end = max((self.store.get_job(n).finish_time for n in self._submitted
                   if self.store.get_job(n) and self.store.get_job(n).finish_time < 1e300),
                  default=self.clock.now())
        makespan = max(1e-9, end - start)
        # Close the final accounting window FIRST (syncs lazy per-job busy
        # accrual too) so raw, attainable, and steady-state utilization
        # all read the same busy total.
        self._accrue_attainable()
        # Capacity integrates fleet changes (spot preemption shrinks the
        # denominator for exactly the window the chips were gone).
        capacity = self.backend.capacity_chip_seconds(start, end)
        util = self.backend.busy_chip_seconds / capacity if capacity > 0 else 0.0
        attainable = self._attainable_chip_seconds
        attainable_util = (self.backend.busy_chip_seconds / attainable
                           if attainable > 0 else 0.0)

        return ReplayReport(
            algorithm=self.algorithm,
            num_jobs=len(self.trace),
            completed=len(self.backend.completed),
            failed=len(self.backend.failed),
            makespan_seconds=makespan,
            avg_jct_seconds=statistics.mean(jcts) if jcts else 0.0,
            p50_jct_seconds=statistics.median(jcts) if jcts else 0.0,
            p95_jct_seconds=(statistics.quantiles(jcts, n=20)[18]
                             if len(jcts) >= 20 else (max(jcts) if jcts else 0.0)),
            avg_wait_seconds=statistics.mean(waits) if waits else 0.0,
            chip_utilization=util,
            attainable_utilization=min(1.0, attainable_util),
            steady_state_utilization=(self._sat_busy_cs / self._sat_capacity_cs
                                      if self._sat_capacity_cs > 0 else 0.0),
            steady_state_seconds=self._sat_seconds,
            total_chips=self.backend.total_chips(),
            restarts_total=self.backend.restarts_total,
            rescheds_total=self.scheduler.m_resched_total.value(),
            resizes_inplace_total=self.backend.resizes_inplace_total,
            cold_resizes_total=self.backend.cold_resizes_total,
            actuation_critical_path_seconds=round(
                self.scheduler.actuation_critical_path_seconds_total, 1),
            actuation_serial_sum_seconds=round(
                self.scheduler.actuation_serial_sum_seconds_total, 1),
            comms_penalty_mean=round(
                self.backend.comms_penalty_chip_seconds
                / self.backend.busy_chip_seconds, 4)
            if self.backend.busy_chip_seconds > 0 else 0.0,
            placement_comms=self.placement_comms,
            fractional_sharing=self.scheduler.fractional_sharing,
            interference_penalty_mean=round(
                self.backend.interference_penalty_chip_seconds
                / self.backend.busy_chip_seconds, 4)
            if self.backend.busy_chip_seconds > 0 else 0.0,
            learned_models=self.scheduler.learned_models,
            drift_rescheds_total=self.collector.drift_fired_total,
        )
