"""The per-pool scheduler event loop.

Reference counterpart: pkg/scheduler/scheduler/scheduler.go (1183 LoC Go).
One scheduler owns one TPU pool (the reference runs one per GPU type): job
state maps, rate-limited coalescing rescheduling, allocation diffing, time
accounting with Tiresias priority transitions, host churn handling, and
crash resume.

Event-driven design: every timed behavior (rate-limit window, the
time-metrics ticker, retry-after-failure) is a Clock timer, so the same
scheduler runs in real time (service layer pumps a thread) or simulated
time (trace replay advances a VirtualClock) with identical semantics —
the property the reference's goroutine+wall-clock design lacked
(SURVEY.md §4).

The resize path is TPU-native: "scale" asks the backend to
checkpoint-restart the job at the new size, and the placement pass may add
migrations, which use the same restart mechanism (SURVEY.md §7).
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Tuple

from vodascheduler_tpu_torch.algorithms.tiresias import (
    TIRESIAS_PROMOTE_KNOB,
    TIRESIAS_THRESHOLDS_SEC,
    tiresias_demote_priority,
    tiresias_promote_priority,
)
from vodascheduler_tpu_torch import config
from vodascheduler_tpu_torch.allocator import AllocationRequest, ResourceAllocator
from vodascheduler_tpu_torch.cluster.backend import (
    ClusterBackend,
    ClusterEvent,
    ClusterEventKind,
    ResizePath,
)
from vodascheduler_tpu_torch.common.clock import Clock, VirtualClock
from vodascheduler_tpu_torch.common.events import EventBus, JobEvent
from vodascheduler_tpu_torch.common.job import TrainingJob
from vodascheduler_tpu_torch.common import lifecycle
from vodascheduler_tpu_torch.common.lifecycle import BookingLedger
from vodascheduler_tpu_torch.common.metrics import Registry
from vodascheduler_tpu_torch.common.store import JobStore
from vodascheduler_tpu_torch.durability.journal import FencedOut
from vodascheduler_tpu_torch.common.types import (
    EventVerb,
    JobStatus,
    ScheduleResult,
)
from vodascheduler_tpu_torch.obs import audit as obs_audit
from vodascheduler_tpu_torch.obs import profile as obs_profile
from vodascheduler_tpu_torch.obs import tracer as obs_tracer
from vodascheduler_tpu_torch.placement import PlacementManager

log = logging.getLogger(__name__)

# How many decision-audit records each scheduler retains in memory for
# GET /debug/resched and `voda explain` (the JSONL sink keeps the long
# tail; this bounds the hot queryable window).
AUDIT_RING_SIZE = 256

# Bound on the per-record queue snapshot (oldest-submitted first). A
# 10k-job pool was minting 10k row dicts per pass — 2.5M retained
# across the ring, whose allocation churn landed gen-2 GC pauses
# inside later decide windows (the fractional 10k p95 spike) — for a
# debugging surface nobody reads past the first page. Never a silent
# cap: a truncated record carries the full count in `queue_total`.
AUDIT_QUEUE_MAX = 512

# Reference default is 30 s (scheduler.go:212); under two-tier resize
# pricing the r6 sweep pick is 15 s (cheap in-place resizes reward a
# scheduler that acts more often — config.py), so the shipped value
# comes from config (one source of truth, env-overridable).
DEFAULT_RATE_LIMIT_SECONDS = config.RATE_LIMIT_SECONDS
DEFAULT_TICKER_SECONDS = 5.0        # reference: rateLimitTimeMetricsSeconds
# TPU-delta knobs at the r6 sweep pick (re-derived under two-tier
# resize pricing — config.py narrative). Values live in config (one
# source of truth, env-overridable); the replay guards
# (tests/test_replay.py) pin the same values.
DEFAULT_SCALE_OUT_HYSTERESIS = config.SCALE_OUT_HYSTERESIS
DEFAULT_RESIZE_COOLDOWN_SECONDS = config.RESIZE_COOLDOWN_SECONDS


class _OwnedRLock:
    """RLock that knows whether the calling thread owns it.

    The concurrent actuation engine needs this introspection: a resched
    pass launched from a frame that already holds the scheduler lock
    (a VirtualClock event handler running the pass inline) must actuate
    on its own thread — parallel workers would deadlock waiting for a
    lock the pass thread's outer frames hold until the pass returns.
    `held_by_me()` is what lets `_run_wave` pick safely.
    """

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._owner: Optional[int] = None
        self._count = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self._owner = threading.get_ident()
            self._count += 1
        return ok

    def release(self) -> None:
        self._count -= 1
        if self._count == 0:
            self._owner = None
        self._lock.release()

    def __enter__(self) -> "_OwnedRLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def held_by_me(self) -> bool:
        # Benign race: a stale read of another thread's ident can never
        # equal ours, and our own writes happen on this thread.
        return self._owner == threading.get_ident() and self._count > 0


class Scheduler:
    def __init__(
        self,
        pool_id: str,
        backend: ClusterBackend,
        store: JobStore,
        allocator: ResourceAllocator,
        clock: Clock,
        bus: Optional[EventBus] = None,
        placement_manager: Optional[PlacementManager] = None,
        algorithm: str = "ElasticFIFO",
        rate_limit_seconds: float = DEFAULT_RATE_LIMIT_SECONDS,
        ticker_seconds: float = DEFAULT_TICKER_SECONDS,
        resume: bool = False,
        registry: Optional[Registry] = None,
        scale_out_hysteresis: float = DEFAULT_SCALE_OUT_HYSTERESIS,
        resize_cooldown_seconds: float = DEFAULT_RESIZE_COOLDOWN_SECONDS,
        defrag_cross_host_threshold: int = 0,
        fractional_sharing: Optional[bool] = None,
        learned_models: Optional[bool] = None,
        journal=None,
        recovered_state=None,
        tracer: Optional[obs_tracer.Tracer] = None,
        actuation_workers: Optional[int] = None,
        actuation_parallel: Optional[bool] = None,
        price_actuation: bool = False,
        profile_cpu: bool = True,
    ):
        self.pool_id = pool_id
        self.backend = backend
        self.store = store
        self.allocator = allocator
        self.clock = clock
        self.bus = bus
        self.algorithm = algorithm
        self.rate_limit_seconds = rate_limit_seconds
        self.ticker_seconds = ticker_seconds
        # TPU-specific: a scale-out is a checkpoint-restart, not a free ring
        # rebuild, so small growth doesn't pay for the restart pause. Small
        # growth (new < ceil(old * hysteresis)) is suppressed only within
        # resize_cooldown_seconds of the job's last resize — suppression
        # must delay a restart, never permanently strand idle chips. Set
        # hysteresis to 1.0 to disable (reference semantics — it applies
        # every diff, scheduler.go:448-480, because Horovod resizes are
        # cheap).
        self.scale_out_hysteresis = scale_out_hysteresis
        self.resize_cooldown_seconds = resize_cooldown_seconds
        # Incremental placement fragments over time; when more than this
        # many jobs span hosts, the next pass runs the full repack +
        # Hungarian consolidation (placement.defragment) and pays its
        # migrations. 0 disables defragmentation.
        self.defrag_cross_host_threshold = defrag_cross_host_threshold
        self._last_cross_host = 0
        # Bandwidth-aware placement (ROADMAP item 3, doc/placement.md):
        # per-job integer comms weights (memoized by name — weights are
        # category-static) handed to the placement manager each pass,
        # and the last pass's fleet placement totals for the perf
        # record / `voda top`. Migration payback gating prices a pure
        # re-binding against the family's resharding cost over this
        # window; per-category cost memo below.
        self.migration_payback_seconds = config.MIGRATION_PAYBACK_SECONDS
        # Fractional sub-host sharing (doc/fractional-sharing.md): on,
        # FRACTIONAL-class jobs share host blocks (co-tenancy priced by
        # interference weights below); off — the whole-host-minimum A/B
        # baseline — every grant's capacity cost AND placement request
        # round up to whole host blocks (_footprint), so sub-host jobs
        # occupy exclusive hosts and the stranded chips are measurable.
        self.fractional_sharing = (config.FRACTIONAL_SHARING
                                   if fractional_sharing is None
                                   else bool(fractional_sharing))
        # name -> resolved-fractional memo (class is spec-static) and
        # the last placed pass's fleet fractional stats (perf record /
        # `voda top`).
        self._fractional_class: Dict[str, bool] = {}
        self._interference_weight: Dict[str, int] = {}
        self._last_fractional_stats: Dict[str, int] = {}
        self._comms_weight: Dict[str, int] = {}
        # Learned-model consumption (doc/learned-models.md): on, the
        # placement comms weights, the interference pricing, and the
        # migration payback gate read the collector's confidence-
        # blended fraction estimates instead of the static family
        # tables. VODA_LEARNED_MODELS=0 is the prior-only A/B
        # reference path.
        self.learned_models = (config.LEARNED_MODELS
                               if learned_models is None
                               else bool(learned_models))
        # job -> (blended comms fraction, blended interference
        # fraction), refreshed in ONE batched store read per model-
        # version bump (a steady-state pass pays one int compare; a
        # collector pass that moved a model costs one store scan on the
        # NEXT pass, off the per-job hot loop).
        self._learned_fraction: Dict[str, Tuple[float, float]] = {}
        self._learned_seen_version = -1
        # Model bumps consumed from the store's change feed while their
        # job was NOT in ready_jobs yet (e.g. mid-recovery): stashed
        # here and applied once the job shows up — advancing the seen
        # version must never silently drop a bump.
        self._learned_pending: set = set()
        # Persistent per-pass weight OUTPUT maps (what the placement
        # manager consumes), maintained by DELTA: request-set arrivals/
        # departures plus the dirty set below. Rebuilding two 2.5k-entry
        # dicts from a 10k-probe sweep every placed pass measurably ate
        # the decide budget (the perf_scale `learned` column).
        self._weights_out: Dict[str, int] = {}
        self._iweights_out: Dict[str, int] = {}
        self._weight_request_names: set = set()
        self._weight_dirty: set = set()
        # What-if shadow planner (doc/learned-models.md): one bounded
        # worker per scheduler, created lazily — the planner runs
        # snapshot-in/read-only and NEVER on the decide critical path.
        self._whatif_pool = None
        self._whatif_inflight = 0
        self._last_contiguity_cost = 0
        self._last_comms_score = 0
        self._migration_cost_cache: Dict[str, float] = {}
        self._last_resize_at: Dict[str, float] = {}
        # Jobs needing re-placement after host churn even if their chip
        # count is unchanged (e.g. their host died).
        self._placement_dirty = False

        # Job state (reference: ReadyJobsMap / DoneJobsMap / JobNumGPU,
        # scheduler.go:81-93). Chip bookings live in the ledger
        # (common/lifecycle.py): reads behave like the plain dict this
        # used to be; writes go through commit/release/commit_pass so
        # the booking discipline is auditable (vodacheck's
        # booking-release rule).
        self.ready_jobs: Dict[str, TrainingJob] = {}
        self.done_jobs: Dict[str, TrainingJob] = {}
        # Durability plane (doc/durability.md): the write-ahead journal
        # every transition(), ledger mutation, placement delta and
        # resize-clock re-arm flows through (vodalint's `journal-seam`
        # rule pins the call sites). None = ephemeral scheduler (tests,
        # replay, model worlds without the crash profile).
        self.journal = journal
        self.job_num_chips: BookingLedger = BookingLedger(journal=journal)
        # Last journaled placement intent per job — jplace records are
        # deltas against this (a steady-state pass appends only moves).
        self._journaled_placements: Dict[str, tuple] = {}
        # The last crash recovery's audited report (recovery_report
        # record) and as-rebuilt tables (before the resume pass),
        # for /debug/journal and the model checker.
        self._last_recovery_report: Optional[dict] = None
        self._recovered_tables: Optional[tuple] = None
        # Hot-standby takeover stamp (takeover_report fields, set by
        # durability/standby.finish_takeover) — the /debug/standby
        # surface on a leader that was born from a warm standby.
        self._last_takeover: Optional[dict] = None

        # Host capacity (reference: TotalGpus via node informer).
        self.total_chips = 0

        self.placement_manager = placement_manager
        self._init_hosts()

        # Resched rate limiting (reference: lastResched/reschedBlockedUntil).
        self.last_resched = -1.0
        self.resched_blocked_until = -float("inf")
        self._resched_pending = False
        self._in_resched = False
        # Failure-recovery introspection: retries armed as clock timers
        # (VirtualClock mode arms a timer WITHOUT setting
        # _resched_pending, so pending alone under-reports). The model
        # checker keys its double-booking invariant on this: a backend
        # overlap is legal exactly while the scheduler still owns a
        # recovery step for it, and a strand with no recovery pending
        # is the bug.
        self._retries_armed = 0
        self._stopped = False
        # --- concurrent actuation plane (doc/observability.md,
        # "Scheduler concurrency model") ---
        # Bound on in-flight backend calls per wave.
        self.actuation_workers = max(1, int(
            config.ACTUATION_WORKERS if actuation_workers is None
            else actuation_workers))
        # Whether waves may fan out on a thread pool. Default: parallel on
        # the wall clock (production), serial under a VirtualClock —
        # replay determinism requires span/record creation in a fixed
        # order, and simulated backend calls return instantly anyway.
        # Either way a pass whose thread already holds the scheduler lock
        # (inline VirtualClock trigger under an event handler) actuates
        # serially — see _OwnedRLock.
        self.actuation_parallel = (
            not isinstance(clock, VirtualClock)
            if actuation_parallel is None else bool(actuation_parallel))
        # Replay-mode pricing: treat each pass's critical-path actuation
        # seconds as scheduler-busy time when opening the next rate-limit
        # window. Under a VirtualClock the pass consumes zero simulated
        # time, which would let replay schedule infinitely fast compared
        # to a live control plane; the harness sets this so replay prices
        # a pass at max-per-wave (what the parallel engine pays), not the
        # serial sum (what the pre-wave engine paid) nor zero.
        self.price_actuation = price_actuation
        # Monotonic pass counter. The actuation window below carries the
        # running pass's generation (0 = no pass actuating): job/cluster
        # events arriving while it is set are queued and replayed at the
        # commit point instead of interleaving with half-applied state,
        # and a commit may only close the window IT opened — a stale
        # commit frame can never clear a newer pass's deferral window.
        self._pass_generation = 0
        self._actuating_gen = 0
        self._deferred_events: List[tuple] = []
        # Backend stops queued by a delete while the lock was held; every
        # mutator entry point drains them outside the lock, before its
        # triggers (see _drain_pending_stops). While a stop is draining
        # (checkpoint flush, up to stop_grace_seconds), the dying job's
        # chips stay RESERVED via _stops_in_flight — a pass triggered by
        # an unrelated event mid-drain must not grant chips the backend
        # still holds (the old engine got this by holding the lock
        # across the stop; the reservation keeps the invariant without
        # re-freezing readers).
        self._pending_stops: List[Tuple[str, int]] = []
        self._stops_in_flight: Dict[str, int] = {}
        # Per-pass priced actuation (sum of per-wave critical paths) and
        # the cumulative totals the replay report exposes.
        self._last_pass_priced_seconds = 0.0
        self.actuation_critical_path_seconds_total = 0.0
        self.actuation_serial_sum_seconds_total = 0.0
        self._pass_wave_stats: List[dict] = []
        # Decision-audit plane (doc/observability.md): every resched pass
        # emits one machine-readable record (trigger, queue snapshot,
        # per-job delta reasons) through the tracer, retained here for
        # /debug/resched and `voda explain`.
        self.tracer = tracer or obs_tracer.get_tracer()
        import collections
        self.audit_ring = collections.deque(maxlen=AUDIT_RING_SIZE)
        self._audit_seq = 0
        # Performance observatory (doc/observability.md): every pass
        # also emits a phase-level perf_report (obs/profile.py),
        # retained here for GET /debug/profile and `voda top`.
        # profile_cpu=False drops per-phase CPU sampling (wall stays):
        # process_time is a real syscall, and drivers running millions
        # of micro-passes (the model checker) opt out.
        self.profile_cpu = bool(profile_cpu)
        self.profile_ring = collections.deque(maxlen=AUDIT_RING_SIZE)
        # Triggers coalesce like the rescheds they request: every reason
        # arriving inside one rate-limit window lands in the same pass's
        # record.
        self._pending_triggers: List[str] = []
        # Per-pass scratch: job -> reason codes, job -> resize seconds.
        self._pass_reasons: Dict[str, List[str]] = {}
        self._pass_resize_seconds: Dict[str, float] = {}
        # Serializes state mutation (reference: SchedulerLock,
        # scheduler.go:88-89) — but NOT backend calls: a pass decides
        # under the lock, releases it for the actuation waves, and
        # re-acquires it per bookkeeping step, so REST reads, job events,
        # and metric updates never wait out a slow backend. Reentrant
        # (handlers nest), with owner introspection for the wave engine's
        # serial fallback.
        self._lock = _OwnedRLock()

        # Read-path snapshot cache (doc/observability.md "Ingestion
        # plane"): status_table()/GET /training serve from a
        # state-version-stamped cached (rows, json) pair. The version
        # bumps under the lock at every mutation a reader could observe;
        # the cache ref itself is swapped atomically and read LOCK-FREE,
        # so a scrape arriving while a pass holds the lock serves the
        # last committed snapshot instead of waiting out the decide
        # phase.
        self._state_version = 0
        self._status_cache: Optional[Tuple[int, List[Dict[str, object]],
                                           bytes]] = None

        self._init_metrics(registry or Registry())

        backend.set_event_callback(self._on_cluster_event)
        if bus is not None:
            # Batch mode: a burst drained off the queue arrives as ONE
            # _on_job_events call — one lock acquisition and one
            # coalesced trigger set for N events, instead of N
            # serialized callbacks contending for the scheduler lock.
            bus.subscribe(pool_id, self._on_job_events, batch=True)

        if resume:
            if self.journal is not None and (
                    recovered_state is not None
                    or self.journal.has_state()):
                # Journal-backed recovery (doc/durability.md): replay
                # the committed prefix, reconcile against the backend's
                # live view, audit every corrective step. A hot-standby
                # takeover passes its applier's pre-materialized state
                # (recovered_state) so recovery skips the replay and
                # pays only the reconcile + first pass.
                from vodascheduler_tpu_torch.durability.recover import (
                    recover_scheduler,
                )
                recover_scheduler(self, state=recovered_state)
            else:
                self._construct_status_on_restart()

        self._start_ticker()

    # ---- setup -----------------------------------------------------------

    def _init_hosts(self) -> None:
        hosts = self.backend.list_hosts()
        self.total_chips = sum(hosts.values())
        if self.placement_manager is not None and not self.placement_manager.host_states:
            for name, chips in hosts.items():
                self.placement_manager.add_host(name, chips)

    def _init_metrics(self, registry: Registry) -> None:
        """Reference series: pkg/scheduler/scheduler/metrics.go:12-196."""
        self.registry = registry
        # pool const-label: N pools share one registry/exposition without
        # colliding series (reference: one scheduler process per GPU type).
        pool_l = {"pool": self.pool_id}
        self.m_resched_total = registry.counter(
            "voda_scheduler_resched_total", "Reschedulings executed",
            const_labels=pool_l)
        self.m_resched_seconds = registry.summary(
            "voda_scheduler_resched_duration_seconds", "Rescheduling latency",
            const_labels=pool_l)
        self.m_alloc_seconds = registry.summary(
            "voda_scheduler_resched_allocation_duration_seconds",
            "Allocator call latency", const_labels=pool_l)
        self.m_jobs_completed = registry.counter(
            "voda_scheduler_jobs_completed_total", "Jobs completed",
            const_labels=pool_l)
        self.m_jobs_failed = registry.counter(
            "voda_scheduler_jobs_failed_total", "Jobs failed",
            const_labels=pool_l)
        self.m_jobs_created = registry.counter(
            "voda_scheduler_jobs_created_total", "Jobs accepted",
            const_labels=pool_l)
        self.m_jobs_deleted = registry.counter(
            "voda_scheduler_jobs_deleted_total", "Jobs deleted by user",
            const_labels=pool_l)
        self.m_job_restarts = registry.counter(
            "voda_scheduler_job_restarts_total",
            "Checkpoint-restart incarnations (start/cold scale/migration)",
            const_labels=pool_l)
        # The resize-path split (doc/elastic-resize.md): an in-place live
        # reshard never stopped the process, so it is NOT a restart — it
        # gets its own series and leaves the restart counter (and the
        # preemption lease) alone.
        self.m_job_resizes_inplace = registry.counter(
            "voda_scheduler_job_resizes_inplace_total",
            "Elastic resizes taken in-place (live reshard, no restart)",
            const_labels=pool_l)
        # Histograms (the summaries above keep their reference-parity
        # names; the bucketed views answer tail questions the sums can't).
        # Split by pass half (the decide/actuate lock split, PR 4): the
        # decide series is the under-lock decision latency ROADMAP item
        # 2 targets (~50 ms at 10k jobs); the actuate series is the wave
        # execution the lock split already took off the critical path.
        # One blob histogram could not distinguish a slow allocator from
        # a slow backend.
        self.h_resched_latency = registry.histogram(
            "voda_scheduler_resched_latency_seconds",
            "Rescheduling pass latency by half (phase=decide: the "
            "under-lock decision; phase=actuate: the wave execution)",
            labels=("phase",),
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0,
                     60.0),
            const_labels=pool_l)
        # Per sub-stage wall time, one observation per pass per phase
        # that ran (obs/profile.py PHASE_NAMES) — the live counterpart of
        # doc/perf_baseline.json's latency-vs-N curves.
        self.h_phase_seconds = registry.histogram(
            "voda_scheduler_phase_seconds",
            "Wall time of one decide/actuate sub-stage per resched pass "
            "(phase from obs.audit.PHASE_NAMES)",
            labels=("phase",),
            buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5,
                     1.0, 5.0, 15.0, 60.0),
            const_labels=pool_l)
        # Fast-vs-cold resize duration: the measured wall time of each
        # backend scale_job call, labeled by the ResizePath it took —
        # the live counterpart of doc/resize_measured.json.
        self.h_resize_duration = registry.histogram(
            "voda_scheduler_resize_duration_seconds",
            "Backend scale_job wall time by resize path (fast = in-place "
            "live reshard, cold = checkpoint-restart)",
            labels=("path",),
            buckets=(0.01, 0.1, 0.5, 1.0, 5.0, 15.0, 30.0, 60.0, 120.0,
                     300.0, 600.0),
            const_labels=pool_l)
        # One observation per non-empty actuation wave: the wave's wall
        # time — with parallel actuation this is the critical path (the
        # slowest member), not the per-job sum. wave="release" covers
        # halts + scale-ins; wave="claim" covers starts + scale-outs +
        # migrations.
        self.h_actuation = registry.histogram(
            "voda_scheduler_actuation_seconds",
            "Wall time of one actuation wave (release = halts+scale-ins, "
            "claim = starts+scale-outs+migrations); parallel waves make "
            "this the critical path, not the sum",
            labels=("wave",),
            buckets=(0.001, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0,
                     120.0, 300.0, 600.0),
            const_labels=pool_l)
        registry.gauge("voda_scheduler_ready_jobs",
                       "Jobs in the ready queue",
                       fn=lambda: float(len(self.ready_jobs)),
                       const_labels=pool_l)
        registry.gauge("voda_scheduler_running_jobs", "Jobs allocated chips",
                       fn=lambda: float(sum(1 for n in self.job_num_chips.values() if n > 0)),
                       const_labels=pool_l)
        registry.gauge("voda_scheduler_waiting_jobs", "Ready jobs with zero chips",
                       fn=lambda: float(sum(1 for n in self.job_num_chips.values() if n == 0)),
                       const_labels=pool_l)
        registry.gauge("voda_scheduler_total_chips", "Pool chip capacity",
                       fn=lambda: float(self.total_chips),
                       const_labels=pool_l)
        registry.gauge("voda_scheduler_allocated_chips", "Chips allocated",
                       fn=lambda: float(sum(self.job_num_chips.values())),
                       const_labels=pool_l)
        # Fractional sub-host sharing (doc/fractional-sharing.md): how
        # many ready jobs resolve to the fractional resource class on
        # this pool's topology — the long tail sharing exists for.
        registry.gauge("voda_scheduler_fractional_jobs",
                       "Ready jobs whose resolved resource class is "
                       "fractional (sub-host static chip-partition)",
                       fn=lambda: float(sum(
                           1 for name in list(self.ready_jobs)
                           if self._is_fractional(name))),
                       const_labels=pool_l)
        # Durability plane (doc/durability.md): journal size + the last
        # crash recovery's wall time. Registered only for journaled
        # schedulers — a disabled journal must not export 0 bytes as if
        # a healthy journal were empty.
        self.m_recovery_seconds = None
        if self.journal is not None:
            registry.gauge(
                "voda_scheduler_journal_bytes",
                "Active write-ahead journal segment size (compaction "
                "folds it into the snapshot past the bound)",
                fn=lambda: float(self.journal.size_bytes()),
                const_labels=pool_l)
            self.m_recovery_seconds = registry.gauge(
                "voda_scheduler_recovery_seconds",
                "Wall time of the last journal-backed crash recovery "
                "(replay + backend reconciliation)",
                const_labels=pool_l)

    def _start_ticker(self) -> None:
        def tick() -> None:
            if self._stopped:
                return
            self.update_time_metrics()
            self.clock.call_later(self.ticker_seconds, tick)

        if isinstance(self.clock, VirtualClock):
            self.clock.call_later(self.ticker_seconds, tick)
        # Real-time mode: the service layer runs update_time_metrics from
        # its own thread loop (service/daemon.py).

    def stop(self) -> None:
        self._stopped = True

    # ---- event intake ----------------------------------------------------
    #
    # The decide/actuate split's intake contract: every handler mutates
    # state under the lock but fires trigger_resched AFTER releasing it
    # (an inline VirtualClock pass launched while an outer frame holds
    # the lock would force the wave engine's serial fallback), and any
    # event arriving while a pass is mid-actuation is deferred to the
    # pass's commit point — the alternative is a JOB_COMPLETED popping
    # bookkeeping that a wave worker is concurrently writing.

    def _journal_fenced(self) -> bool:
        """Whether this scheduler has been deposed: its journal's
        fencing epoch moved past it (a standby took the lease). A
        deposed scheduler stops itself — its in-memory state past the
        fence is unjournalable by construction (append-before-apply),
        and the new leader owns the journal's committed prefix."""
        j = self.journal
        if j is not None and j.fenced:
            # vodarace: ignore[guarded-read-unguarded-write] monotonic
            # stop latch: a one-way False->True store, read lock-free by
            # design (deposed-leader fencing)
            self._stopped = True
            return True
        return False

    def _probe_leadership(self) -> bool:
        """Actively probe the lease (one small read) at pass start: the
        append-time fence alone cannot stop a deposed leader whose pass
        decides a no-op booking delta — delta-encoded journaling
        appends nothing, so nothing raises, and the pass would actuate
        its (stale) migration wave against the shared backend. The
        probe closes that window at the pass boundary; a deposition
        landing MID-pass still fences at the first append, as before."""
        j = self.journal
        if j is not None and j.probe_fence():
            # vodarace: ignore[guarded-read-unguarded-write] monotonic
            # stop latch: a one-way False->True store, read lock-free by
            # design (deposed-leader fencing)
            self._stopped = True
            return True
        return False

    def _locked_or_deferred(self, fn, *args) -> List[str]:
        """Run a _*_locked mutator under the lock, unless an actuation is
        in flight — then defer it (with its args) to the commit point.
        Returns the trigger reasons to fire once the lock is released."""
        if self._journal_fenced():
            return []
        with self._lock:
            if self._actuating_gen:
                self._deferred_events.append((fn, args))
                return []
            reasons = fn(*args)
        # Side effects the mutator queued for after the lock (a deleted
        # job's backend stop) run before its triggers fire.
        self._drain_pending_stops()
        return reasons

    def _fire(self, reasons: List[str]) -> None:
        for reason in reasons:
            self.trigger_resched(reason)

    def _on_job_event(self, event: JobEvent) -> None:
        """Reference: readMsgs goroutine (scheduler.go:829-843).
        Single-event shim over the batch path below."""
        self._on_job_events([event])

    def _on_job_events(self, events: List[JobEvent]) -> None:
        """Batch-mode bus subscriber (doc/observability.md "Ingestion
        plane"): the whole drained burst is applied under ONE lock
        acquisition and its trigger reasons are deduplicated, so a
        1k-event storm costs one mutation window and a bounded number of
        resched passes — not 1k serialized lock round-trips."""
        self._fire(self._locked_or_deferred(self._handle_job_events_locked,
                                            list(events)))

    def _handle_job_events_locked(self, events: List[JobEvent]) -> List[str]:
        reasons: List[str] = []
        for event in events:
            try:
                if event.verb == EventVerb.CREATE:
                    out = self._create_job_locked(event.job_name)
                elif event.verb == EventVerb.DELETE:
                    out = self._delete_job_locked(event.job_name)
                else:
                    out = []
            except Exception:
                # Per-event isolation: one malformed event (a
                # re-delivered create for a finished job raising in
                # transition()) must not drop the rest of the burst —
                # same posture as the deferred-event replay loop.
                log.exception("job event %s failed; continuing with the "
                              "rest of the batch", event)
                continue
            for reason in out:
                if reason not in reasons:
                    reasons.append(reason)
        return reasons

    def _on_cluster_event(self, event: ClusterEvent) -> None:
        """Reference: MPIJob + node informer handlers (scheduler.go:592-747)."""
        if event.kind == ClusterEventKind.JOB_COMPLETED:
            self.handle_job_completed(event.name)
        elif event.kind == ClusterEventKind.JOB_FAILED:
            self.handle_job_failed(event.name)
        elif event.kind == ClusterEventKind.HOST_ADDED:
            self._fire(self._locked_or_deferred(self._on_host_added, event.name))
        elif event.kind == ClusterEventKind.HOST_REMOVED:
            self._fire(self._locked_or_deferred(self._on_host_removed,
                                                event.name))

    # ---- job lifecycle ---------------------------------------------------

    def _require_leadership(self) -> None:
        """User-facing mutations on a DEPOSED scheduler must fail
        loudly (the REST layer surfaces the error and the client
        retries against the new leader) — an ack-and-drop would tell
        the user their delete happened while the new leader keeps the
        job running. Internal event paths keep the silent drop
        (_locked_or_deferred): a deposed leader's backend events are
        meaningless and the raise would only wedge monitor threads."""
        if self._journal_fenced():
            raise FencedOut(
                f"pool {self.pool_id}: this scheduler was deposed (a "
                f"newer leader holds the journal lease) — retry "
                f"against the current leader")

    def create_training_job(self, name: str) -> None:
        """Accept a job announced by the admission service
        (reference: scheduler.go:845-890)."""
        self._require_leadership()
        self._fire(self._locked_or_deferred(self._create_job_locked, name))

    def _create_job_locked(self, name: str) -> List[str]:
        job = self.store.get_job(name)
        if job is None:
            log.error("create event for unknown job %s", name)
            return []
        if name in self.ready_jobs or name in self.done_jobs:
            # Duplicate create announcement (a re-delivered bus event):
            # the job is already accepted — or already finished its
            # whole lifecycle. Re-accepting would be an undeclared
            # edge (Waiting/terminal -> Waiting) and a double-count.
            return []
        lifecycle.transition(job, JobStatus.WAITING, reason="accepted",
                             chips=0, tracer=self.tracer,
                             pool=self.pool_id, journal=self.journal)
        job.metrics.last_update_time = self.clock.now()
        self.store.update_job(job)
        self.ready_jobs[name] = job
        self.job_num_chips.commit(name, 0)
        self.m_jobs_created.inc()
        self._bump_state_version()
        return ["job_created"]

    def delete_training_job(self, name: str) -> None:
        """User-initiated cancel (reference: scheduler.go:916-1000)."""
        self._require_leadership()
        self._fire(self._locked_or_deferred(self._delete_job_locked, name))

    def _delete_job_locked(self, name: str) -> List[str]:
        job = self.ready_jobs.pop(name, None)
        if job is None:
            return []
        # Tombstone BEFORE the booking release: the CANCELED edge and
        # the jretire record must hit the journal ahead of the jbook
        # release, or a crash between them replays to "RUNNING with no
        # booking" and recovery re-adopts the deleted job from the
        # backend's live view — resurrection (doc/durability.md
        # "Tombstones"). Recovery best-effort stops a retired job the
        # backend still runs.
        lifecycle.transition(job, JobStatus.CANCELED, reason="user_delete",
                             tracer=self.tracer, pool=self.pool_id,
                             journal=self.journal)
        if self.journal is not None:
            self.journal.append("jretire", {"job": name,
                                            "status": job.status.value})
        chips = self.job_num_chips.release(name)
        job.finish_time = self.clock.now()
        self.store.update_job(job)
        self.done_jobs[name] = job
        self.m_jobs_deleted.inc()
        if chips > 0:
            # The backend stop can block for a full checkpoint drain
            # (stop_grace_seconds) — it must NOT run under the scheduler
            # lock this method holds. Queue it with the dying size;
            # every caller drains the queue right after releasing the
            # lock and BEFORE firing the resched trigger
            # (_drain_pending_stops). The reservation is registered HERE,
            # under the same lock hold that released the booking — were
            # it registered at drain time, a pass sneaking between the
            # lock release and the drain would see the chips as free.
            self._pending_stops.append((name, chips))
            self._stops_in_flight[name] = chips
            # The next pass must release the dead slots in the
            # placement manager even if the freed chips change no
            # allocation — otherwise the grow gates (and co-tenancy
            # stats) read the stale occupancy until something else
            # moves (doc/fractional-sharing.md).
            self._placement_dirty = True
        self._bump_state_version()
        return ["job_deleted"]

    def _drain_pending_stops(self) -> None:
        """Execute backend stops queued by _delete_job_locked — outside
        the scheduler lock (they can block for a checkpoint drain), but
        before the delete's trigger fires, so the freed chips are truly
        free by the time a pass re-grants them. Passes triggered by
        UNRELATED events while a drain is blocking see the dying jobs in
        _stops_in_flight: their chips stay off the allocator's budget
        and their host slots stay held (see _resched_pass) until the
        backend actually released them."""
        with self._lock:
            stops, self._pending_stops = self._pending_stops, []
        for name, _chips in stops:
            try:
                self.backend.stop_job(name)
            except Exception:
                # Best-effort: the backend monitor reaps stragglers, and
                # the job is already CANCELED in every table.
                log.exception("stop of deleted job %r failed", name)
            finally:
                with self._lock:
                    self._stops_in_flight.pop(name, None)

    def handle_job_completed(self, name: str) -> None:
        """Reference: handleJobCompleted (scheduler.go:630-650)."""
        self._fire(self._locked_or_deferred(self._job_terminal_locked, name,
                                            JobStatus.COMPLETED))

    def handle_job_failed(self, name: str) -> None:
        """Reference: handleJobFailed (scheduler.go:652-671)."""
        self._fire(self._locked_or_deferred(self._job_terminal_locked, name,
                                            JobStatus.FAILED))

    def _job_terminal_locked(self, name: str,
                             status: JobStatus) -> List[str]:
        job = self.ready_jobs.get(name)
        if job is None:
            # Duplicate terminal event: the first one already moved the
            # job to done_jobs under this same lock, so there is no
            # silent same-status overwrite to guard against here — an
            # actual terminal self-loop would raise in transition()
            # (the self-loop policy is declared, not an `==` accident).
            return []
        reasons = []
        # Final accounting before the terminal state; a Tiresias flip
        # here rides the same pass as the completion.
        if self._update_time_metrics_locked():
            reasons.append("priority_change")
        if status == JobStatus.COMPLETED:
            lifecycle.transition(job, JobStatus.COMPLETED,
                                 reason="completed", tracer=self.tracer,
                                 pool=self.pool_id, journal=self.journal)
            self._job_done(job)
            self.m_jobs_completed.inc()
            reasons.append("job_completed")
        else:
            lifecycle.transition(job, JobStatus.FAILED, reason="failed",
                                 tracer=self.tracer, pool=self.pool_id,
                                 journal=self.journal)
            self._job_done(job)
            self.m_jobs_failed.inc()
            reasons.append("job_failed")
        self._bump_state_version()
        return reasons

    def _job_done(self, job: TrainingJob) -> None:
        """Reference: handleJobDoneInternal (scheduler.go:673-686)."""
        if self.journal is not None:
            # Durable tombstone (doc/durability.md): a completed/failed
            # job survives crash-recover-compact-crash-recover as
            # retired, never resurrected into the ready queue.
            self.journal.append("jretire", {"job": job.name,
                                            "status": job.status.value})
        job.finish_time = self.clock.now()
        self.store.update_job(job)
        self.done_jobs[job.name] = job
        self.ready_jobs.pop(job.name, None)
        if self.job_num_chips.release(job.name) > 0:
            # Even when the freed chips change no allocation, the next
            # pass must release the dead slots in the placement manager
            # (see _delete_job_locked).
            self._placement_dirty = True

    # ---- host churn (reference: addNode/updateNode/deleteNode :689-747) --

    def _on_host_added(self, name: str) -> List[str]:
        # Recompute rather than increment: a re-announced host (capacity
        # update) must not double-count.
        self.total_chips = sum(self.backend.list_hosts().values())
        if self.placement_manager is not None:
            chips = self.backend.list_hosts().get(name, 0)
            self.placement_manager.add_host(name, chips)
        return ["host_added"]

    def _on_host_removed(self, name: str) -> List[str]:
        # The backend no longer lists the host; recompute capacity.
        self.total_chips = sum(self.backend.list_hosts().values())
        if self.placement_manager is not None:
            self.placement_manager.remove_host(name)
            # Jobs that lost workers need re-placement even if the next
            # allocation leaves their chip count unchanged.
            self._placement_dirty = True
        return ["host_removed"]

    # ---- rescheduling (reference: Run select loop + resched :271-434) ----

    def trigger_resched(self, reason: str = "manual") -> None:
        """Request a resched; coalesces and honors the rate limit
        (reference: TriggerResched + the Run loop's drop-and-block logic,
        scheduler.go:297-316). `reason` (an obs.audit.TRIGGERS code) is
        recorded in the pass's decision-audit record; reasons arriving
        while a resched is already pending coalesce into that pass.

        A due trigger runs the pass inline on the calling thread; a
        rate-limited one arms a clock timer for the window's opening —
        on BOTH clock types (the real clock grew timers for exactly
        this), so a blocked trigger never silently waits out a daemon
        poll tick. The service daemon's pump() remains as a belt-and-
        braces driver; _run_resched_now is idempotent under the race."""
        run_now = False
        with self._lock:
            if reason not in self._pending_triggers:
                self._pending_triggers.append(reason)
            if self._resched_pending or self._stopped:
                return
            self._resched_pending = True
            if self._in_resched:
                return  # the pass's commit point re-arms
            now = self.clock.now()
            at = max(now, self.resched_blocked_until)
            if at <= now:
                run_now = True
            else:
                self.clock.call_at(at, self._run_when_window_opens)
        if run_now:
            # Outside the trigger's own lock hold: the pass manages its
            # own locking (decide under, actuate outside).
            self._run_resched_now()

    def _run_when_window_opens(self) -> None:
        """Timer target for a pending pass: run it if the rate-limit
        window is open, else re-arm for the window's (possibly moved)
        opening. The window can shift AFTER a timer was armed — a pass
        commit rewrites resched_blocked_until from the time actuation
        finished, and a retry extends it — so firing _run_resched_now
        directly would run inside the closed window the limit exists to
        protect (apiserver churn bounds)."""
        with self._lock:
            if (not self._resched_pending or self._stopped
                    or self._in_resched):
                return  # commit re-arms if still pending
            rearm_at = (self.resched_blocked_until
                        if self.clock.now() < self.resched_blocked_until
                        else None)
        if rearm_at is not None:
            self.clock.call_at(rearm_at, self._run_when_window_opens)
            return
        self._run_resched_now()

    @property
    def resched_pending(self) -> bool:
        return self._resched_pending

    @property
    def recovery_pending(self) -> bool:
        """Whether the scheduler still owns a corrective step: a pass
        pending/running, or a failure retry armed on a clock timer.
        While this holds, bookkeeping and backend truth may legally
        diverge (the failure-isolation contract re-converges them);
        once it clears, any divergence is a real strand — the exact
        line the model checker draws."""
        with self._lock:
            return (self._resched_pending or self._in_resched
                    or self._retries_armed > 0)

    def _fire_retry(self) -> None:
        """VirtualClock retry-timer target: trigger FIRST, disarm the
        introspection counter after (in a finally, so a raising pass
        can't wedge the counter high) — recovery_pending never drops
        while the corrective pass is still unrequested."""
        try:
            self.trigger_resched("retry")
        finally:
            with self._lock:
                self._retries_armed = max(0, self._retries_armed - 1)

    def pump(self) -> None:
        """Real-time driver hook (service/daemon.py): run a pending resched
        once the rate-limit window opens. Under a VirtualClock the clock's
        timers do this; under the wall clock a daemon thread calls pump().
        """
        with self._lock:
            due = (self._resched_pending and not self._in_resched
                   and self.clock.now() >= self.resched_blocked_until)
        if due:
            self._run_resched_now()

    def set_algorithm(self, name: str) -> None:
        """Switch the scheduling algorithm at runtime and reschedule
        (reference: PUT /algorithm, scheduler.go:1127-1155)."""
        from vodascheduler_tpu_torch.algorithms import new_algorithm
        new_algorithm(name, self.pool_id)  # validate; raises on unknown
        with self._lock:
            self.algorithm = name
        self.trigger_resched("algorithm_changed")

    def set_rate_limit(self, seconds: float) -> None:
        """Adjust the resched rate limit (reference: PUT /ratelimit,
        scheduler.go:1157-1183)."""
        if seconds < 0:
            raise ValueError("rate limit must be >= 0")
        with self._lock:
            self.rate_limit_seconds = seconds

    def _run_resched_now(self) -> None:
        if self._journal_fenced() or self._probe_leadership():
            return
        with self._lock:
            if (not self._resched_pending or self._stopped
                    or self._in_resched):
                return
            self._resched_pending = False
            self._in_resched = True
            self._pass_generation += 1
            gen = self._pass_generation
            self._actuating_gen = gen
        try:
            self.resched()
        except FencedOut:
            # Deposed mid-pass: the journal rejected a write-ahead
            # append, so nothing past the fence was applied (append-
            # before-apply). Stop; the new leader recovers from the
            # journal's committed prefix.
            log.warning("pool %s: journal fenced mid-pass — deposed "
                        "leader stopping", self.pool_id)
            # vodarace: ignore[guarded-read-unguarded-write] monotonic
            # stop latch: a one-way False->True store, read lock-free by
            # design (deposed-leader fencing)
            self._stopped = True
        finally:
            with self._lock:
                if self._actuating_gen == gen:
                    self._actuating_gen = 0
                self._in_resched = False
                now = self.clock.now()
                self.last_resched = now
                # Replay pricing: the pass occupied its critical-path
                # actuation seconds of scheduler time (zero simulated
                # time passed while it ran), so the rate-limit window
                # opens that much later — see price_actuation.
                priced = (self._last_pass_priced_seconds
                          if self.price_actuation else 0.0)
                self.resched_blocked_until = (now + priced
                                              + self.rate_limit_seconds)
                rearm_at = (self.resched_blocked_until
                            if self._resched_pending else None)
                deferred, self._deferred_events = self._deferred_events, []
            # Commit point: replay events that arrived mid-actuation, in
            # arrival order, against the now-consistent state. Their
            # triggers land inside the just-opened rate-limit window and
            # coalesce into the next pass.
            for fn, args in deferred:
                # Each replayed event is isolated: since transition()
                # raises on undeclared edges, one malformed deferred
                # event (a re-delivered create for a finished job) must
                # not drop the rest of the queue or skip the re-arm
                # below — same posture as the EventBus dispatcher.
                try:
                    with self._lock:
                        reasons = fn(*args)
                    self._drain_pending_stops()
                    self._fire(reasons)
                except Exception:
                    log.exception("deferred event %s%r failed; "
                                  "continuing with the rest",
                                  getattr(fn, "__name__", fn), args)
            if self.journal is not None and not self._stopped:
                # Compaction rides the pass commit point, off the
                # decide path: fold the journal into a snapshot once
                # the active segment outgrows its bound
                # (doc/durability.md "Compaction").
                try:
                    self.journal.maybe_compact()
                except FencedOut:
                    # vodarace: ignore[guarded-read-unguarded-write] a
                    # monotonic stop latch (see _check_fence)
                    self._stopped = True
                except OSError:
                    log.exception("journal compaction failed; the "
                                  "active segment keeps growing")
            if rearm_at is not None:
                # Re-triggered mid-pass (a Tiresias priority flip, a
                # wave worker's retry): run again once the window opens —
                # on either clock (the real-clock timer is what closes
                # the old wait-for-the-next-poll-tick gap).
                self.clock.call_at(rearm_at, self._run_when_window_opens)

    def resched(self) -> None:
        """One rescheduling pass (reference: resched, scheduler.go:326-364),
        wrapped in the decision-audit plane (doc/observability.md): a root
        span per pass — every downstream boundary (allocator, placement,
        backend, supervisor control channel) parents onto it via the
        ambient context — plus one schema-validated audit record capturing
        the trigger set, the queue snapshot, and a reason code for every
        per-job chip delta.

        Concurrency model (doc/observability.md "Scheduler concurrency
        model"): the pass DECIDES under the scheduler lock — allocation,
        hysteresis, diff, placement, and the booking commit of
        job_num_chips — then releases the lock and ACTUATES the decision
        in two bounded-parallel waves (release, then barrier, then
        claim), re-acquiring the lock only for per-job bookkeeping. The
        pass therefore costs the slowest wave member (the critical
        path), not the sum of K backend calls, and readers
        (status_table, REST, metric ticks) never wait out a backend."""
        import time as _walltime

        with self._lock:
            triggers = [t for t in self._pending_triggers
                        if t in obs_audit.TRIGGERS] or ["manual"]
            self._pending_triggers = []
            self._pass_reasons = {}
            self._pass_resize_seconds = {}
            self._last_pass_priced_seconds = 0.0
            self._pass_wave_stats = []
        # Phase-level profiler (obs/profile.py): t_start is the timer's
        # own wall origin, so the pass duration, the decide/actuate
        # split, and the per-phase numbers all share one zero.
        prof = obs_profile.PhaseTimer(cpu=self.profile_cpu)
        t_start = prof.wall_start
        self.update_time_metrics()
        with self._lock:
            old = self.job_num_chips.snapshot()
        outcome = "error"
        with self.tracer.span(
                "resched", component="scheduler", new_trace=True,
                attrs={"pool": self.pool_id, "algorithm": self.algorithm,
                       "triggers": triggers}) as sp:
            try:
                # Ambient install: downstream stages on this thread
                # (placement's Hungarian bind, the allocator's algorithm
                # stage) time themselves into the same pass profile.
                with obs_profile.use_timer(prof):
                    outcome = self._resched_pass(t_start, old, prof)
            finally:
                duration = _walltime.monotonic() - t_start
                decide_s = (prof.decide_seconds
                            if prof.decide_seconds is not None else duration)
                actuate_s = max(0.0, duration - decide_s)
                sp.set_attr("outcome", outcome)
                sp.set_attr("actuation_mode",
                            "parallel" if self.actuation_parallel
                            else "serial")
                sp.set_attr("actuation_workers", self.actuation_workers)
                sp.set_attr("actuation_critical_path_s",
                            round(self._last_pass_priced_seconds, 4))
                sp.set_attr("decide_ms", round(decide_s * 1000.0, 3))
                sp.set_attr("actuate_ms", round(actuate_s * 1000.0, 3))
                self.h_resched_latency.observe(decide_s, phase="decide")
                self.h_resched_latency.observe(actuate_s, phase="actuate")
                self._emit_audit(sp, triggers, old, duration, outcome)
                self._emit_perf(sp, triggers, prof, duration, decide_s,
                                actuate_s, outcome)

    def _resched_pass(self, t_start: float, old: ScheduleResult,
                      prof: obs_profile.PhaseTimer) -> str:
        """The pass body; returns the audit outcome tag ('applied',
        'allocation_failed', or 'reverted_release_failure'). `prof` is
        the pass's phase profiler; every decide sub-stage and actuation
        wave below accrues into it (doc/observability.md "Performance
        observatory")."""
        import time as _walltime

        # ---- decide (under the lock) ---------------------------------
        with self._lock:
            with prof.phase("snapshot"):
                jobs = list(self.ready_jobs.values())
                # Chips of deleted jobs whose checkpoint drain is still
                # blocking in _drain_pending_stops: physically occupied,
                # so off this pass's budget (and their host slots stay
                # held below). The drain's own trigger re-runs
                # allocation once the backend has truly released them.
                reserved = dict(self._stops_in_flight)
            t_alloc = _walltime.monotonic()
            try:
                with prof.phase("allocate"):
                    new = self.allocator.allocate(AllocationRequest(
                        scheduler_id=self.pool_id,
                        # Reserved (draining) chips come off the budget
                        # at their physical FOOTPRINT — whole hosts
                        # under the sharing-off baseline.
                        num_chips=max(0, self.total_chips
                                      - sum(self._footprint(v)
                                            for v in reserved.values())),
                        algorithm=self.algorithm,
                        ready_jobs=jobs,
                        # Slice-shape feasibility: with a modeled torus,
                        # grants are rounded to counts that admit a
                        # contiguous sub-slice (SURVEY.md §7); the
                        # fractional resource class rounds within a
                        # host block (doc/fractional-sharing.md).
                        topology=(self.placement_manager.topology
                                  if self.placement_manager is not None
                                  else None),
                        fractional_sharing=self.fractional_sharing,
                    ))
            except Exception:
                log.exception("allocation failed; retrying after rate limit")
                prof.mark_decide_end()
                self._schedule_retry()
                return "allocation_failed"
            self.m_alloc_seconds.observe(_walltime.monotonic() - t_alloc)

            if self.scale_out_hysteresis > 1.0:
                with prof.phase("hysteresis"):
                    self._apply_hysteresis(old, new)
            # Decide-phase booking commit: the pass's whole allocation
            # lands in the ledger atomically; the waves below actuate
            # it, and every failure edge re-books through the ledger
            # (the booking-release contract vodacheck enforces).
            with prof.phase("commit"):
                self.job_num_chips.commit_pass(new)
                self._bump_state_version()
            with prof.phase("diff"):
                halts, scale_ins, scale_outs, starts = \
                    self.compare_results(old)
                changed = bool(halts or scale_ins or scale_outs or starts)
                for job in starts:
                    self._add_reason(job, "started")
                for job in halts:
                    self._add_reason(job, "halted")
                for job in scale_ins:
                    self._add_reason(job, "scale_in")
                for job in scale_outs:
                    self._add_reason(job, "scale_out")
                # Per-job shrink targets, snapshotted now: the wave-1
                # barrier compares bookkeeping against these to detect
                # shrinks the backend didn't realize.
                scale_in_targets = {j: self.job_num_chips.get(j, 0)
                                    for j in scale_ins}

            # Unlike the reference (which places *after* the MPI-Operator
            # creates pods, steering them via tolerations and deleting
            # movers, §3.3), we own the runtime: compute host bindings
            # first and hand them to the backend with each start/scale.
            placements: Dict[str, List[Tuple[str, int]]] = {}
            placed = False
            if ((changed or self._placement_dirty)
                    and self.placement_manager is not None):
                # Placement requests are physical FOOTPRINTS: the grant
                # itself under fractional sharing, whole host blocks
                # under the sharing-off baseline — which is what makes
                # a 2-chip job's exclusive host real in the slot
                # accounting (and its stranded chips measurable).
                requests = {j: self._footprint(n)
                            for j, n in self.job_num_chips.items()
                            if n > 0}
                # Draining deletions keep their host slots until the
                # backend released them (phantom same-size requests:
                # _release_slots leaves an unchanged request alone).
                requests.update({j: self._footprint(n)
                                 for j, n in reserved.items()})
                with prof.phase("comms"):
                    # Per-job comms weights for the bandwidth-aware
                    # objective (memoized; a steady-state pass costs
                    # its NEW jobs, not the fleet).
                    self._refresh_comms_weights(requests)
                with prof.phase("placement"):
                    if (self.defrag_cross_host_threshold > 0
                            and self._last_cross_host
                            >= self.defrag_cross_host_threshold):
                        decision = self.placement_manager.defragment(
                            requests)
                    else:
                        decision = self.placement_manager.place(requests)
                    self._last_cross_host = decision.num_jobs_cross_host
                    self._last_contiguity_cost = \
                        decision.total_contiguity_cost
                    self._last_comms_score = decision.total_comms_score
                    self._last_fractional_stats = \
                        self.placement_manager.fractional_fleet_stats()
                    placements = decision.placements
                    placed = True
                    self._placement_dirty = False
                    self._journal_placements(placements)
            prof.mark_decide_end()

        # ---- actuate (lock released; re-acquired per bookkeeping) ----
        # Wave 1 — release: halts and scale-ins free chips concurrently.
        # Each apply is isolated: a backend failure (API storm during pod
        # creation) must not abort the rest of the pass, and — critically
        # — must not leave job_num_chips claiming an allocation the
        # backend never realized, or the diff would never emit the start
        # again and the job would strand as phantom-running (found live
        # in r5: a single 503 during start_job stranded the job
        # permanently). Failures are gathered at the wave barrier and
        # feed the release-failure revert below.
        halt_failures: List[str] = []

        def _halt_task(job: str) -> None:
            try:
                self._halt_job(job)
            except Exception:
                log.exception("halt of %r failed; keeping its allocation "
                              "booked so the halt is retried", job)
                with self._lock:
                    self._add_reason(job, "halt_failed")
                    self.job_num_chips.commit(job, old.get(job, 0))
                    halt_failures.append(job)
                    self._bump_state_version()

        wave1 = ([(job, (lambda j=job: _halt_task(j))) for job in halts]
                 + [(job, (lambda j=job: self._apply_scale(
                     j, placements.get(j), old.get(j, 0))))
                    for job in scale_ins])
        with prof.phase("actuate_release"):
            self._run_wave("release", wave1)

        with self._lock:
            release_failed = bool(halt_failures) or any(
                self.job_num_chips.get(j, 0) > target
                for j, target in scale_in_targets.items())
        if release_failed:
            # The rest of this pass was computed assuming the released
            # chips are free — applying it would double-book their hosts
            # (starts pinned onto still-occupied nodes). Revert every
            # UNAPPLIED booking (wave-1 members already book backend
            # truth through their failure isolation) and leave the pass
            # to the retry, which recomputes from consistent state.
            with self._lock:
                for job in scale_outs + starts:
                    self.job_num_chips.commit(job, old.get(job, 0))
                    self._add_reason(job, "reverted_release_failure")
                self._placement_dirty = True
                self._bump_state_version()
            self._schedule_retry()
            self.store.flush()
            self.m_resched_total.inc()
            self.m_resched_seconds.observe(_walltime.monotonic() - t_start)
            return "reverted_release_failure"

        # Wave 2 — claim: starts and scale-outs run concurrently; then
        # migrations as a trailing sub-wave (concurrent among
        # themselves), because candidates are diffed against the
        # backend's live view and that view must already include this
        # pass's starts and scales. The job sets are disjoint (a
        # migration candidate is by construction untouched by the diff),
        # so per-job isolation carries over from the serial engine
        # unchanged.
        wave2 = ([(job, (lambda j=job: self._apply_start(
            j, placements.get(j)))) for job in starts]
            + [(job, (lambda j=job: self._apply_scale(
                j, placements.get(j), old.get(j, 0))))
               for job in scale_outs])
        with prof.phase("actuate_claim"):
            self._run_wave("claim", wave2)
        if placed:
            # Reserved (draining) jobs are never migration candidates —
            # they are mid-teardown, not mis-placed.
            touched = (set(halts) | set(starts) | set(scale_ins)
                       | set(scale_outs) | set(reserved))
            with prof.phase("actuate_migrate"):
                self._run_wave("migrate",
                               self._migration_tasks(placements, touched))

        self.store.flush()  # batch boundary for autoflush=False stores
        self.m_resched_total.inc()
        self.m_resched_seconds.observe(_walltime.monotonic() - t_start)
        return "applied"

    def _run_wave(self, label: str, tasks: List[Tuple[str, object]]) -> None:
        """Run one actuation wave: every task is a backend-facing apply
        for a distinct job. Parallel on a bounded ThreadPoolExecutor when
        allowed (see actuation_parallel), serial otherwise — including
        whenever the calling thread still holds the scheduler lock from
        an outer frame, where parallel workers would deadlock on their
        bookkeeping acquisitions.

        The wave barrier is the `with` executor join: the pass never
        proceeds with a wave still in flight. Tracer context is
        propagated explicitly into workers (the ambient context is
        thread-local; without this, job.*/backend.* spans would orphan).

        Pricing: each task is priced at the backend's modeled cost when
        it offers one (FakeClusterBackend under replay, where wall time
        is meaningless) else its measured wall time; the wave contributes
        its MAX (critical path) to the pass price and its SUM to the
        serial-equivalent counter, so replay and metrics can report the
        speedup honestly."""
        import time as _walltime

        if not tasks:
            return
        parent = obs_tracer.current_context()

        def _run_one(job: str, fn) -> Tuple[str, float]:
            t0 = _walltime.monotonic()
            with obs_tracer.use_context(parent, self.tracer):
                fn()
            measured = _walltime.monotonic() - t0
            price = None
            try:
                price = self.backend.actuation_price_seconds(job)
            except Exception:  # noqa: BLE001 - a hint, never load-bearing
                price = None
            return job, (measured if price is None else price)

        t0 = _walltime.monotonic()
        priced: Dict[str, float] = {}
        parallel = (self.actuation_parallel and len(tasks) > 1
                    and self.actuation_workers > 1
                    and not self._lock.held_by_me())
        if parallel:
            from concurrent.futures import ThreadPoolExecutor

            workers = min(self.actuation_workers, len(tasks))
            with ThreadPoolExecutor(
                    max_workers=workers,
                    thread_name_prefix=f"voda-actuate-{label}") as pool:
                futures = [pool.submit(_run_one, job, fn)
                           for job, fn in tasks]
                for fut in futures:
                    job, seconds = fut.result()
                    priced[job] = seconds
        else:
            for job, fn in tasks:
                job, seconds = _run_one(job, fn)
                priced[job] = seconds
        wall = _walltime.monotonic() - t0
        self.h_actuation.observe(wall, wave=label)
        critical_path = self._wave_critical_path(list(priced.values()))
        serial_sum = sum(priced.values())
        with self._lock:
            self._last_pass_priced_seconds += critical_path
            self.actuation_critical_path_seconds_total += critical_path
            self.actuation_serial_sum_seconds_total += serial_sum
            self._pass_wave_stats.append({
                "wave": label, "jobs": len(tasks),
                "parallel": parallel,
                "wall_s": round(wall, 4),
                "critical_path_s": round(critical_path, 4),
                "serial_sum_s": round(serial_sum, 4),
            })

    def _wave_critical_path(self, costs: List[float]) -> float:
        """The wave's priced duration under the BOUNDED pool: a greedy
        longest-first schedule of the per-task costs onto
        actuation_workers bins — a wave of K tasks over W workers costs
        ~ceil(K/W) rounds, not max(costs). (max() would understate any
        wave wider than the pool; the plain sum is what the pre-wave
        serial engine paid.)"""
        if not costs:
            return 0.0
        bins = [0.0] * min(self.actuation_workers, len(costs))
        for cost in sorted(costs, reverse=True):
            index = min(range(len(bins)), key=bins.__getitem__)
            bins[index] += cost
        return max(bins)

    def _journal_placements(self, placements: Dict[str, List[Tuple[str, int]]]
                            ) -> None:
        """Append this pass's placement-intent delta (`jplace`) — only
        bindings that CHANGED since the last journaled intent, so a
        steady-state fleet pass appends its moves, not its whole map
        (doc/durability.md "Record catalog").

        Decide-window fast: the placement manager's persistent view
        keeps the SAME list object for an untouched job across passes
        (touched jobs get fresh lists), so an identity probe skips the
        normalize+compare for the untouched 10k-job bulk — the delta
        computation costs the pass's touched set, not the fleet."""
        if self.journal is None:
            return
        journaled = self._journaled_placements
        pre_len = len(journaled)
        changed: Dict[str, List[List[object]]] = {}
        new_key = False
        for job, pairs in placements.items():
            entry = journaled.get(job)
            if entry is not None and entry[0] is pairs:
                continue  # untouched: same persistent-view object
            key = tuple(sorted((h, int(n)) for h, n in pairs))
            if entry is not None and entry[1] == key:
                entry[0] = pairs  # rebuilt but identical binding
                continue
            if entry is None:
                new_key = True
            journaled[job] = [pairs, key]
            changed[job] = [list(p) for p in key]
        # A removal implies the maps' sizes diverged or a key was added
        # this pass (net-zero swap) — only then pay the O(n) sweep.
        removed: List[str] = []
        if new_key or pre_len != len(placements):
            removed = [j for j in journaled if j not in placements]
            for job in removed:
                del journaled[job]
        if changed or removed:
            self.journal.append("jplace", {"set": changed, "del": removed})

    def _arm_resize_clock(self, name: str) -> None:
        """Re-arm the job's hysteresis/cooldown clock — write-ahead
        journaled (`jclock`) so recovery restores the exact suppression
        windows the pre-crash scheduler was honoring."""
        at = self.clock.now()
        if self.journal is not None:
            self.journal.append("jclock", {"job": name, "at": at})
        self._last_resize_at[name] = at

    def journal_stats(self) -> Dict[str, object]:
        """GET /debug/journal (doc/durability.md): journal size, last
        seq, epoch, snapshot age, torn-tail count — plus the last crash
        recovery's audited report when this process recovered."""
        if self.journal is None:
            return {"enabled": False}
        stats = self.journal.stats()
        if self._last_recovery_report is not None:
            stats["last_recovery"] = dict(self._last_recovery_report)
        return stats

    def _is_fractional(self, name: str) -> bool:
        """Whether `name`'s resolved resource class is fractional on
        this pool (common/job.py resolve_resource_class). Memoized —
        the class is spec-static. False without a modeled topology (no
        host-block notion to be fractional against)."""
        pm = self.placement_manager
        if pm is None or pm.topology is None:
            return False
        got = self._fractional_class.get(name)
        if got is None:
            from vodascheduler_tpu_torch.common.job import (
                RESOURCE_CLASS_FRACTIONAL,
                resolve_resource_class,
            )
            job = self.ready_jobs.get(name)
            if job is None:
                return False  # unknown here; don't cache a guess
            # vodarace: ignore[guarded-read-unguarded-write] idempotent
            # memo: recomputation stores the identical value, and a dict
            # item store is atomic under the GIL
            got = self._fractional_class[name] = (
                resolve_resource_class(
                    getattr(job.spec, "resource_class", "auto"),
                    job.config.max_num_chips,
                    pm.topology.chips_per_host)
                == RESOURCE_CLASS_FRACTIONAL)
        return got

    def _footprint(self, n: int) -> int:
        """Chips a grant of n occupies physically: n itself under
        fractional sharing; whole host blocks under the sharing-off
        baseline (doc/fractional-sharing.md "The whole-host
        baseline")."""
        pm = self.placement_manager
        if (self.fractional_sharing or n <= 0 or pm is None
                or pm.topology is None):
            return max(0, n)
        return pm.topology.host_footprint(n)

    def _refresh_comms_weights(self, requests: ScheduleResult) -> None:
        """Install this pass's per-job comms weights on the placement
        manager (placement/comms.py): category-derived, memoized by job
        name so a steady-state pass pays one dict probe per job and a
        lookup only for jobs it has never seen. No-op when placement is
        absent or the comms objective is disabled
        (VODA_PLACEMENT_COMMS=0 — the count-only reference path).

        Also installs the fractional plane's interference weights
        (doc/fractional-sharing.md): FRACTIONAL-class jobs get their
        category's co-tenant interference weight so _pick_host prices
        co-tenancy; whole-host jobs never carry one. Skipped entirely
        with sharing off — exclusive hosts have no co-tenants to
        price."""
        pm = self.placement_manager
        if pm is None:
            return
        from vodascheduler_tpu_torch.placement import comms as comms_mod

        self._refresh_learned_models(requests)
        do_interference = (self.fractional_sharing
                           and pm.topology is not None)
        comms_enabled = pm.comms_enabled
        if not do_interference and not comms_enabled:
            return
        # DELTA maintenance of the persistent output maps: only names
        # that arrived, departed, or were invalidated since the last
        # pass are re-derived — a steady-state 10k churn pass pays one
        # set build + a handful of derivations, not a 20k-probe sweep
        # (the perf_scale `learned` column's budget).
        learned = self._learned_fraction
        learned_get = learned.get
        icache = self._interference_weight
        cache = self._comms_weight
        iweights = self._iweights_out
        weights = self._weights_out
        ready = self.ready_jobs
        ready_get = ready.get
        cur = set(requests)
        prev_names = self._weight_request_names
        dirty = self._weight_dirty
        todo = cur - prev_names if prev_names else cur
        if dirty:
            todo |= dirty & cur
            dirty.clear()
        for job in prev_names - cur:
            iweights.pop(job, None)
            weights.pop(job, None)
        self._weight_request_names = cur
        for job in todo:
            if do_interference:
                w = icache.get(job)
                if w is None:
                    if not self._is_fractional(job):
                        w = 0
                    else:
                        lf = learned_get(job)
                        if lf is not None:
                            # Blended learned interference fraction
                            # (doc/learned-models.md): measured
                            # co-tenant behavior wins over the family
                            # table once confident.
                            w = comms_mod.interference_weight_from_fraction(
                                lf[1])
                        else:
                            from vodascheduler_tpu_torch.common.job import (
                                category_of,
                            )
                            w = comms_mod.interference_weight_for_category(
                                category_of(job))
                    icache[job] = w
                if w:
                    iweights[job] = w
                else:
                    iweights.pop(job, None)
            if comms_enabled:
                w = cache.get(job)
                if w is None:
                    tj = ready_get(job)
                    if tj is None:
                        w = 0
                    else:
                        # Spec descriptor wins over the family default
                        # (doc/placement.md "Collective profiles").
                        profile = comms_mod.profile_for_job(
                            tj.spec.collectives, tj.category)
                        lf = learned_get(job)
                        if lf is not None:
                            # Blended learned comms fraction rescales
                            # the family byte profile (doc/learned-
                            # models.md): a job measured chattier than
                            # its table gets a proportionally stronger
                            # contiguity pull.
                            w = comms_mod.learned_weight(profile, lf[0])
                        else:
                            w = 0 if profile is None else profile.weight()
                    cache[job] = w
                if w:
                    weights[job] = w
                else:
                    weights.pop(job, None)
        # Bound the memos by the live request set (completed/deleted
        # jobs drop out), same policy as the allocator's prior cache.
        if len(icache) > 2 * len(requests) + 64:
            self._interference_weight = {
                k: v for k, v in icache.items() if k in cur}
            self._fractional_class = {
                k: v for k, v in self._fractional_class.items()
                if k in cur}
        if len(cache) > 2 * len(requests) + 64:
            self._comms_weight = {k: v for k, v in cache.items()
                                  if k in cur}
        if do_interference:
            pm.set_interference_weights(iweights)
        if comms_enabled:
            pm.set_comms_weights(weights)

    def _refresh_learned_models(self, requests: ScheduleResult) -> None:
        """Re-read the learned-model fractions (doc/learned-models.md)
        when — and only when — the store's model version moved since
        the last pass, and then only for the names whose models
        actually changed (the store's per-name stamps): ONE batched
        info fetch for the changed slice, blended against the family
        priors through the confidence curve, with the derived weight
        memos invalidated for every job whose blend moved. No-op with
        learned models off (the prior-only A/B path) and in the steady
        state (one int compare); a consumer behind the store's prune
        floor falls back to one full-working-set refresh."""
        if not self.learned_models:
            return
        version = self.store.model_version
        seen = self._learned_seen_version
        if version == seen:
            return
        changed = self.store.model_changes_since(seen) if seen >= 0 \
            else None
        self._learned_seen_version = version
        ready = self.ready_jobs
        # Membership and pruning are against the READY set, not the
        # granted request set: a preempted job keeps its blended entry
        # (a version bump consumed while it waited would otherwise be
        # lost, silently reverting it to the family tables when
        # re-granted), and entries die only with the job.
        pending = self._learned_pending
        if changed is None:
            names = list(ready)
            pending.clear()
        else:
            pending.update(changed)
            names = [n for n in pending if n in ready]
            pending.difference_update(names)
            # Bound: pending bumps for jobs that will never be ready
            # here (completed elsewhere, deleted) must not accrete.
            if len(pending) > 2 * len(ready) + 64:
                pending.intersection_update(ready)
        if len(self._learned_fraction) > 2 * len(ready) + 64:
            self._learned_fraction = {
                k: v for k, v in self._learned_fraction.items()
                if k in ready}
        if not names:
            return
        from vodascheduler_tpu_torch.metricscollector import learned as learned_mod
        from vodascheduler_tpu_torch.placement import comms as comms_mod

        jobs = [ready[n] for n in names]
        infos = self.store.job_infos_for(jobs)
        table = self._learned_fraction
        for tj in jobs:
            info = infos.get(tj.name)
            prev = table.get(tj.name)
            pair = None
            if info is not None:
                cw = getattr(info, "comms_fraction_weight", 0.0)
                iw = getattr(info, "interference_fraction_weight", 0.0)
                if cw > 0.0 or iw > 0.0:
                    profile = comms_mod.profile_for_job(
                        tj.spec.collectives, tj.category)
                    f_prior = (0.0 if profile is None
                               else profile.comms_fraction)
                    fi_prior = comms_mod.interference_fraction_for_category(
                        tj.category)
                    pair = (
                        learned_mod.blend(f_prior,
                                          info.comms_fraction_est, cw),
                        learned_mod.blend(
                            fi_prior, info.interference_fraction_est, iw))
            if pair is None:
                if prev is not None:
                    del table[tj.name]
                    self._comms_weight.pop(tj.name, None)
                    self._interference_weight.pop(tj.name, None)
                    self._weight_dirty.add(tj.name)
                continue
            # Invalidate the derived INTEGER weights only when the
            # blend moved enough to plausibly flip a bucket (the units
            # are 0.02 of fraction): a converged collector nudges the
            # blend by epsilon every pass, and re-deriving 10k weights
            # for sub-bucket noise measurably ate the decide budget. A
            # boundary-hugging fraction may serve a one-bucket-stale
            # weight until its next real move — advisory pricing, not
            # a booking.
            if (prev is None or abs(prev[0] - pair[0]) > 0.005
                    or abs(prev[1] - pair[1]) > 0.005):
                table[tj.name] = pair
                self._comms_weight.pop(tj.name, None)
                self._interference_weight.pop(tj.name, None)
                self._weight_dirty.add(tj.name)

    def _migration_cost_seconds(self, job_name: str) -> float:
        """Priced resharding cost of migrating `job_name`: a migration
        is a checkpoint-restart, so the family's measured/assumed cold
        restart cost (replay/restart_costs.py) is the honest price —
        the same number the replay's two-tier pricing charges. Memoized
        per category."""
        from vodascheduler_tpu_torch.common.job import category_of

        category = category_of(job_name)
        cost = self._migration_cost_cache.get(category)
        if cost is None:
            from vodascheduler_tpu_torch.replay.restart_costs import (
                default_restart_seconds,
                family_restart_costs,
            )
            try:
                costs = family_restart_costs()
                cost = (costs[category].restart_s if category in costs
                        else default_restart_seconds())
            except Exception:  # noqa: BLE001 - pricing must never wedge a pass
                cost = 30.0
            # vodarace: ignore[unguarded-shared-write] idempotent memo:
            # recomputation stores the identical value, and a dict item
            # store is atomic under the GIL
            self._migration_cost_cache[category] = cost
        return cost

    def _migration_unpaid(self, job_name: str, handle,
                          target: List[Tuple[str, int]]) -> bool:
        """Whether an OPTIMIZATION migration (pure re-binding: same
        size, every current host alive) fails its payback test: the
        modeled step-time win — the job's comms fraction times the
        spread the move recovers — earned over the payback window must
        repay the priced resharding cost (doc/placement.md "Priced
        migrations"). Forced migrations (size mismatch, workers on a
        dead host) are never gated; with the comms objective disabled
        every mismatch migrates, the pre-comms behavior.

        Deliberate consequence (lazy consolidation): a job whose
        profile models no comms win (fraction 0 — unknown category, no
        descriptor) NEVER pays back, so its defragment re-bindings
        defer until the chips it squats on are actually claimed — at
        which point the promised-elsewhere check below flips the move
        to forced. Consolidation happens when the space is needed,
        not speculatively at a restart's price."""
        pm = self.placement_manager
        if (pm is None or not pm.comms_enabled or pm.topology is None):
            return False
        live_pairs = list(handle.placements)
        if sum(n for _, n in live_pairs) != sum(n for _, n in target):
            return False  # size drifted: reconcile unconditionally
        hosts = pm.host_states
        if any(h not in hosts for h, n in live_pairs if n > 0):
            return False  # workers on a dead/removed host: forced
        # Deferring keeps the job running on its OLD chips while the
        # placement manager books its NEW ones; that is only safe while
        # the old chips are still free in the manager's view (nothing
        # else has been promised them). The job's OWN new booking on an
        # overlapping host is credited back — those chips are promised
        # to nobody else, and without the credit every partial-overlap
        # re-binding on a tight host would read as forced and bypass
        # the gate. The moment another job claims the old chips, this
        # check fails and the migration fires as forced — the deferral
        # can never turn into a cross-job chip conflict.
        if any(n > 0
               and (hosts[h].free_slots
                    + hosts[h].job_num_workers.get(job_name, 0)) < n
               for h, n in live_pairs):
            return False
        from vodascheduler_tpu_torch.placement import comms as comms_mod
        from vodascheduler_tpu_torch.common.job import category_of

        tj = self.ready_jobs.get(job_name)
        profile = comms_mod.profile_for_job(
            tj.spec.collectives if tj is not None else None,
            category_of(job_name))
        # The payback gate prices the move at the LEARNED fraction when
        # one is blended in (doc/learned-models.md): a job measured
        # chattier than its family table repays consolidation sooner;
        # one measured quieter defers moves the table would have fired.
        lf = (self._learned_fraction.get(job_name)
              if self.learned_models else None)
        if lf is not None:
            fraction = lf[0]
        else:
            fraction = 0.0 if profile is None else profile.comms_fraction
        spread_old = pm.spread_of_pairs(live_pairs)
        spread_new = pm.spread_of_pairs(target)
        win_rate = max(0.0, spread_old - spread_new) * fraction
        return (win_rate * self.migration_payback_seconds
                <= self._migration_cost_seconds(job_name))

    def _migration_tasks(self, placements: Dict[str, List[Tuple[str, int]]],
                         already_restarted: set) -> List[Tuple[str, object]]:
        """Wave-2 tasks for same-size jobs whose host binding no longer
        matches what the backend is running — including jobs whose
        workers died with a removed host (those produce no index-level
        move in the placement diff, so the backend's live view is the
        ground truth to compare). Optimization re-bindings are payback-
        gated (_migration_unpaid): a migration is a checkpoint-restart,
        and one that cannot repay its resharding cost in modeled
        step-time win within the payback window is deferred (audited as
        migration_deferred_unpaid; re-priced every placed pass)."""
        live = self.backend.running_jobs()
        tasks: List[Tuple[str, object]] = []
        for job_name, target in placements.items():
            if job_name in already_restarted:
                continue
            handle = live.get(job_name)
            if handle is None:
                continue
            if sorted(handle.placements) == sorted(target):
                continue
            if self._migration_unpaid(job_name, handle, target):
                self._add_reason(job_name, "migration_deferred_unpaid")
                continue
            tasks.append((job_name,
                          (lambda j=job_name, t=target:
                           self._migrate_job(j, t))))
        return tasks

    def _migrate_job(self, job_name: str,
                     target: List[Tuple[str, int]]) -> None:
        try:
            with self.tracer.span(
                    "job.migrate", component="scheduler",
                    attrs={"job": job_name,
                           "target": [list(t) for t in target]}):
                self.backend.migrate_workers(job_name, target)
        except Exception:
            log.exception("migration of %r failed; re-booking from "
                          "backend state and retrying", job_name)
            try:
                still_live = job_name in self.backend.running_jobs()
            except Exception:  # noqa: BLE001 - storm still on
                still_live = True  # keep the booking; retry decides
            with self._lock:
                self._add_reason(job_name, "migrate_failed")
                if not still_live:
                    self._revert_to_waiting(job_name)
                # The retry only recomputes placements when dirty —
                # without this, an unchanged allocation would never
                # re-check the mismatched binding.
                self._placement_dirty = True
            self._schedule_retry()
            return
        # Priced resharding cost of the move, surfaced as the delta's
        # resize_seconds (`voda explain`): the backend's modeled price
        # when it offers one, else the family cold-restart price the
        # payback gate used.
        try:
            price = self.backend.actuation_price_seconds(job_name)
        except Exception:  # noqa: BLE001 - a hint, never load-bearing
            price = None
        if not price:
            price = self._migration_cost_seconds(job_name)
        with self._lock:
            self._add_reason(job_name, "migrated")
            self._pass_resize_seconds[job_name] = price
            self._arm_resize_clock(job_name)

    def _apply_hysteresis(self, old: ScheduleResult, new: ScheduleResult) -> None:
        """Suppress small scale-outs of recently-resized running jobs (see
        ctor comment) — a cold TPU resize is a checkpoint-restart, so a
        +1/-1 oscillation burns two restart windows for negligible speedup.

        Fast-path pricing (doc/elastic-resize.md): a grow that fits the
        job's CURRENT host set keeps the process group stable, so the
        backend can apply it as a Tier-A in-place reshard at a fraction
        of the restart cost — the premise behind suppression doesn't
        hold, and suppressing would strand cheap speedup. Those grows
        pass through; only growth that must add hosts (a cold restart
        for certain) is hysteresis-gated.

        Keeping the old (smaller) allocation only shrinks the total, so
        the result stays valid; the cooldown guarantees the growth
        eventually applies instead of stranding chips forever. (Symmetric
        scale-in suppression was tried and removed: holding a job at its
        larger size delays the inevitable shrink-restart without saving
        it, and measured neutral-to-negative on trace replay.)"""
        import math as _math

        now = self.clock.now()
        for job, n_new in new.items():
            n_old = old.get(job, 0)
            if not (n_old > 0 and n_new > n_old
                    and n_new < _math.ceil(n_old * self.scale_out_hysteresis)
                    and now - self._last_resize_at.get(job, -float("inf"))
                    < self.resize_cooldown_seconds):
                continue
            # Small growth inside the cooldown window: the gate fires, and
            # which way it goes is an audited decision either way.
            if self._grow_fits_current_hosts(job, n_new):
                self._add_reason(job, "hysteresis_bypassed_grow_fits_host")
            elif self._fractional_grow_fits(job, n_new):
                # The PR 2 prefer_own idiom at chip granularity
                # (doc/fractional-sharing.md): a sub-host tenant growing
                # WITHIN its current partition's host block never adds a
                # host — the resize is a cheap intra-host repartition,
                # so the restart-amortization premise behind hysteresis
                # doesn't hold even on backends without a Tier-A
                # in-place path.
                self._add_reason(job, "hysteresis_bypassed_fractional_fit")
            else:
                new[job] = n_old
                self._add_reason(job, "hysteresis_suppressed")

    def _grow_fits_current_hosts(self, job: str, n_new: int) -> bool:
        """Whether growing `job` to n_new chips can plausibly be applied
        as a Tier-A in-place reshard: the backend must support the fast
        path at all, the job must occupy exactly ONE host (the real
        feasibility gate is a single unchanged process — any multi-host
        resize is a membership change, always cold), and that host's own
        + FREE slots must cover the target. Slots held by other jobs
        don't count — growing into them would force a foreign host (a
        cold restart), exactly what the hysteresis this gates exists to
        suppress. The bound reads pre-placement free_slots, so it can
        err in both directions within one pass (a same-pass shrink
        frees more; a same-pass start can claim the slot first). A
        wrong wave-through costs one mispriced cold resize and the
        cooldown gates the next — bounded, and on the measured headline
        this branch fires rarely (the hysteresis window itself binds
        only a couple of times per replay)."""
        if (self.placement_manager is None
                or not getattr(self.backend, "supports_inplace_resize",
                               False)):
            return False
        placement = self.placement_manager.job_placements.get(job)
        if placement is None:
            return False
        hosts = self.placement_manager.host_states
        occupied = {hs.host for hs in placement.host_slots
                    if hs.num_slots > 0 and hs.host in hosts}
        if len(occupied) != 1:
            return False
        own = sum(hs.num_slots for hs in placement.host_slots
                  if hs.num_slots > 0 and hs.host in hosts)
        free = max(0, hosts[next(iter(occupied))].free_slots)
        return 0 < n_new <= own + free

    def _fractional_grow_fits(self, job: str, n_new: int) -> bool:
        """Whether a FRACTIONAL-class job's grow to n_new stays a
        sub-host partition of the ONE host it already occupies — own
        slots + that host's free chips cover the target. Unlike
        _grow_fits_current_hosts this needs no backend in-place
        support: the grow never changes the host set, so it can't be
        the foreign-host cold restart hysteresis exists to suppress.
        Sharing-off mode never takes it (exclusive hosts make
        _grow_fits_current_hosts the honest gate)."""
        if (not self.fractional_sharing or self.placement_manager is None
                or not self._is_fractional(job)):
            return False
        placement = self.placement_manager.job_placements.get(job)
        if placement is None:
            return False
        hosts = self.placement_manager.host_states
        occupied = {hs.host for hs in placement.host_slots
                    if hs.num_slots > 0 and hs.host in hosts}
        if len(occupied) != 1:
            return False
        host = hosts[next(iter(occupied))]
        own = sum(hs.num_slots for hs in placement.host_slots
                  if hs.num_slots > 0 and hs.host in hosts)
        return 0 < n_new <= min(host.total_slots,
                                own + max(0, host.free_slots))

    def _schedule_retry(self) -> None:
        """Reference: TriggerReschedAtTime after allocator failure
        (scheduler.go:344-349). Thread-safe: wave workers call this from
        their failure isolation."""
        delay = self.rate_limit_seconds + 1.0
        if isinstance(self.clock, VirtualClock):
            with self._lock:
                self._retries_armed += 1
            self.clock.call_later(delay, self._fire_retry)
        else:
            # Real-time mode: keep the request pending (the service
            # daemon's pump retries once the window opens) AND arm a
            # real-clock timer so the retry fires even with no daemon.
            with self._lock:
                self._resched_pending = True
                if "retry" not in self._pending_triggers:
                    self._pending_triggers.append("retry")
                self.resched_blocked_until = self.clock.now() + delay
                at = self.resched_blocked_until
            self.clock.call_at(at, self._run_when_window_opens)

    def compare_results(self, old: ScheduleResult) -> Tuple[
            List[str], List[str], List[str], List[str]]:
        """Diff old vs new allocations into (halts, scale_ins, scale_outs,
        starts). Reference: compareResults (scheduler.go:448-480)."""
        halts: List[str] = []
        scale_ins: List[str] = []
        scale_outs: List[str] = []
        starts: List[str] = []
        # One ledger snapshot for the whole diff: the per-job .get()
        # takes the ledger lock each call, which at 10k jobs is pure
        # overhead inside the decide window (behavior identical — the
        # pass thread is the only booking writer here).
        booked = self.job_num_chips.snapshot()
        booked_get = booked.get
        for job, n_old in old.items():
            n_new = booked_get(job, 0)
            if n_old > n_new:
                if n_new == 0:
                    status = self._job_status(job)
                    # don't halt a job that already finished
                    if status is not None and not status.is_terminal:
                        halts.append(job)
                else:
                    scale_ins.append(job)
            elif n_old < n_new:
                if n_old == 0:
                    starts.append(job)
                else:
                    scale_outs.append(job)
        # jobs that appear only in the new result
        for job, n_new in booked.items():
            if job not in old and n_new > 0:
                starts.append(job)
        return halts, scale_ins, scale_outs, starts

    def _apply_start(self, name: str,
                     placements: Optional[List[Tuple[str, int]]] = None
                     ) -> None:
        """_start_job with failure isolation: on a backend raise the
        bookkeeping reverts to 'not running' (backends guarantee a
        raising start leaves nothing running — gke cleans partial pods,
        multihost kills partial spawns) and a retry is scheduled."""
        try:
            self._start_job(name, placements)
        except Exception:
            log.exception("start of %r failed; reverting allocation and "
                          "retrying after the rate limit", name)
            with self._lock:
                self._add_reason(name, "start_failed")
                self._revert_to_waiting(name)
            self._schedule_retry()

    def _apply_scale(self, name: str,
                     placements: Optional[List[Tuple[str, int]]] = None,
                     old_chips: int = 0) -> None:
        """_scale_job with failure isolation. If the backend still runs
        the old incarnation, book its live size (the resize simply didn't
        happen); if the backend dropped the job (gke's cleaned partial
        resize), revert to waiting — the checkpoint makes the later
        restart a resume, not lost work. If the backend can't even be
        ASKED (the storm also broke running_jobs), keep the old booking:
        assuming not-running while pods still hold chips would double-
        book hosts and livelock retried starts against 'already
        running'."""
        try:
            self._scale_job(name, placements)
        except Exception:
            log.exception("resize of %r failed; re-booking from backend "
                          "state and retrying", name)
            try:
                live = self.backend.running_jobs()
            except Exception:  # noqa: BLE001 - storm may still be on
                with self._lock:
                    self._add_reason(name, "scale_failed")
                    self.job_num_chips.commit(name, old_chips)
                    self._bump_state_version()
                self._schedule_retry()
                return
            with self._lock:
                self._add_reason(name, "scale_failed")
                if name in live:
                    self.job_num_chips.commit(name, live[name].num_workers)
                    self._bump_state_version()
                else:
                    self._revert_to_waiting(name)
            self._schedule_retry()

    def _revert_to_waiting(self, name: str) -> None:
        with self._lock:
            self.job_num_chips.commit(name, 0)
            self._bump_state_version()
            job = self.ready_jobs.get(name)
            if job is not None and job.status == JobStatus.RUNNING:
                lifecycle.transition(job, JobStatus.WAITING,
                                     reason="backend_lost", chips=0,
                                     tracer=self.tracer,
                                     pool=self.pool_id,
                                     journal=self.journal)
                job.metrics.last_waiting_seconds = 0.0
                self.store.update_job(job)

    def _start_job(self, name: str,
                   placements: Optional[List[Tuple[str, int]]] = None) -> None:
        """Reference: startTrainingJob (scheduler.go:495-519). Runs on a
        wave worker: the backend call happens without the scheduler lock;
        bookkeeping re-acquires it."""
        with self._lock:
            job = self.ready_jobs.get(name)
            chips = self.job_num_chips.get(name, 0)
        if job is None:
            return
        with self.tracer.span("job.start", component="scheduler",
                              attrs={"job": name, "chips": chips}):
            self.backend.start_job(job.spec, chips, placements)
        with self._lock:
            self.m_job_restarts.inc()
            lifecycle.transition(job, JobStatus.RUNNING, reason="scheduled",
                                 chips=self.job_num_chips.get(name, 0),
                                 tracer=self.tracer, pool=self.pool_id,
                                 journal=self.journal)
            job.metrics.last_chip_seconds = 0.0
            job.metrics.last_running_seconds = 0.0
            job.metrics.seconds_since_restart = 0.0
            # Also consume the waiting window (the reference leaves it,
            # scheduler.go:505-514, letting a freshly-started job
            # immediately satisfy the Tiresias promote test and bounce
            # back to queue 0).
            job.metrics.last_waiting_seconds = 0.0
            self._arm_resize_clock(name)
            if job.metrics.running_seconds == 0:
                job.metrics.first_start_time = self.clock.now()
            self.store.update_job(job)
            self._bump_state_version()

    def _scale_job(self, name: str,
                   placements: Optional[List[Tuple[str, int]]] = None) -> None:
        """Reference: scaleTrainingJob (scheduler.go:542-574), priced by
        the path the backend actually took (doc/elastic-resize.md).
        Backend call outside the scheduler lock; bookkeeping inside."""
        import time as _walltime

        with self._lock:
            chips = self.job_num_chips.get(name, 0)
        t0 = _walltime.monotonic()
        with self.tracer.span("job.scale", component="scheduler",
                              attrs={"job": name, "chips": chips}) as sp:
            path = self.backend.scale_job(name, chips, placements)
            took = _walltime.monotonic() - t0
            path_label = "fast" if path == ResizePath.INPLACE else "cold"
            sp.set_attr("path", path_label)
            sp.set_attr("resize_seconds", round(took, 4))
        # The resize-duration histogram + audit pricing: the measured wall
        # time of the backend call, labeled by the tier it took.
        self.h_resize_duration.observe(took, path=path_label)
        with self._lock:
            self._bump_state_version()
            self._pass_resize_seconds[name] = took
            self._add_reason(name,
                             "resize_inplace" if path == ResizePath.INPLACE
                             else "resize_cold")
            self._arm_resize_clock(name)
            if path == ResizePath.INPLACE:
                # The job never stopped: no restart counted, and the
                # preemption lease (seconds_since_restart) keeps running
                # — re-arming it here would shield a live-resized job
                # from eviction it never earned (and skew restart
                # metrics).
                self.m_job_resizes_inplace.inc()
                return
            self.m_job_restarts.inc()
            job = self.ready_jobs.get(name)
            if job is not None:
                # A cold resize is a checkpoint-restart: re-arm the
                # preemption lease so the just-restarted job isn't
                # evicted back-to-back.
                job.metrics.seconds_since_restart = 0.0
                self.store.update_job(job)

    def _halt_job(self, name: str) -> None:
        """Reference: haltTrainingJob (scheduler.go:576-590)."""
        with self._lock:
            job = self.ready_jobs.get(name)
        with self.tracer.span("job.halt", component="scheduler",
                              attrs={"job": name}):
            self.backend.stop_job(name)
        if job is not None:
            with self._lock:
                lifecycle.transition(job, JobStatus.WAITING,
                                     reason="preempted",
                                     chips=self.job_num_chips.get(name, 0),
                                     tracer=self.tracer,
                                     pool=self.pool_id,
                                     journal=self.journal)
                job.metrics.last_waiting_seconds = 0.0
                self.store.update_job(job)
                self._bump_state_version()

    def _job_status(self, name: str) -> Optional[JobStatus]:
        job = self.ready_jobs.get(name) or self.done_jobs.get(name)
        return job.status if job else None

    # ---- decision audit (doc/observability.md) ---------------------------

    def _add_reason(self, job: str, code: str) -> None:
        """Tag this pass's delta for `job` with a REASON_CODES entry.
        Lock-guarded: wave workers tag concurrently."""
        with self._lock:
            reasons = self._pass_reasons.setdefault(job, [])
            if code not in reasons:
                reasons.append(code)

    def _emit_audit(self, span, triggers: List[str], old: ScheduleResult,
                    duration_s: float, outcome: str) -> None:
        """Build + emit the pass's decision-audit record: the trigger set,
        the queue snapshot, and one delta (with reason codes) per job whose
        chip count changed or about which a decision was recorded."""
        with self._lock:
            self._audit_seq += 1
            ready = sorted(self.ready_jobs.values(),
                           key=lambda j: j.submit_time)
            queue = [{"name": j.name, "status": j.status.value,
                      "priority": j.priority,
                      "chips_before": old.get(j.name, 0)}
                     for j in ready[:AUDIT_QUEUE_MAX]]
            deltas = []
            for job in sorted(set(old) | set(self.job_num_chips)
                              | set(self._pass_reasons)):
                before = old.get(job, 0)
                after = self.job_num_chips.get(job, 0)
                reasons = list(self._pass_reasons.get(job, []))
                if before == after and not reasons:
                    continue
                if not reasons:
                    # Changed with no recorded action: the only silent
                    # path is a job that left the allocation by reaching
                    # a terminal state (completed/failed/canceled before
                    # this pass).
                    reasons = ["released_terminal"]
                delta = {"job": job, "before": before, "after": after,
                         "reasons": reasons}
                if job in self._pass_resize_seconds:
                    delta["resize_seconds"] = round(
                        self._pass_resize_seconds[job], 4)
                if self.placement_manager is not None:
                    # Placement columns (doc/placement.md): the job's
                    # comms weight x contiguity score, rendered by
                    # `voda explain`. Only for jobs that still hold a
                    # placement and only when nonzero — count-only
                    # pools emit the pre-comms record shape.
                    stats = self.placement_manager.job_comms_stats(job)
                    if stats is not None and (stats[0] or stats[1]):
                        delta["comms"] = {"weight": stats[0],
                                          "contiguity": stats[1],
                                          "score": stats[2]}
                    # Fractional delta block (doc/fractional-sharing.md,
                    # closed keys validated by obs/audit.py): partition
                    # size, the host(s) it partitions, co-tenants, and
                    # the current interference price. Only for placed
                    # fractional tenants — whole-host jobs emit the
                    # classic record shape.
                    frac = self.placement_manager.job_fractional_stats(job)
                    if frac is not None:
                        delta["fractional"] = frac
                deltas.append(delta)
            rec = {
                "kind": "resched_audit",
                "schema": obs_audit.SCHEMA_VERSION,
                "ts": self.clock.now(),
                "pool": self.pool_id,
                "seq": self._audit_seq,
                "trace_id": span.trace_id,
                "triggers": triggers,
                "algorithm": self.algorithm,
                "total_chips": self.total_chips,
                "queue": queue,
                "queue_total": len(ready),
                "deltas": deltas,
                "duration_ms": round(duration_s * 1000.0, 3),
                "outcome": outcome,
            }
            if self._pass_wave_stats:
                # Optional actuation block (schema: additive, validated
                # as free-form): per-wave size, execution mode, wall
                # time, and the critical-path vs serial-sum pricing.
                rec["actuation"] = {
                    "waves": list(self._pass_wave_stats),
                    "critical_path_s": round(
                        self._last_pass_priced_seconds, 4),
                }
            self.audit_ring.append(rec)
        self.tracer.emit(dict(rec))

    def audit_records(self, n: int = 20) -> List[dict]:
        """The last n decision-audit records (GET /debug/resched)."""
        with self._lock:
            records = list(self.audit_ring)
        return records[-max(0, int(n)):] if n else records

    def _emit_perf(self, span, triggers: List[str],
                   prof: obs_profile.PhaseTimer, duration_s: float,
                   decide_s: float, actuate_s: float, outcome: str) -> None:
        """Emit the pass's phase-level perf_report (the performance
        observatory, doc/observability.md): the same seq/trace_id as the
        pass's resched_audit, plus where the milliseconds went. Feeds
        the profile ring (GET /debug/profile, `voda top`) and the
        per-phase histogram."""
        phases = prof.report()
        with self._lock:
            rec = {
                "kind": "perf_report",
                "schema": obs_audit.SCHEMA_VERSION,
                "ts": self.clock.now(),
                "pool": self.pool_id,
                "seq": self._audit_seq,
                "trace_id": span.trace_id,
                "triggers": list(triggers),
                "outcome": outcome,
                "algorithm": self.algorithm,
                "num_jobs": len(self.ready_jobs),
                # The jobs this pass acted on (reason-tagged deltas):
                # what `voda top` shows as the pass's triggering jobs.
                "jobs": sorted(self._pass_reasons),
                "duration_ms": round(duration_s * 1000.0, 3),
                "cpu_ms": round(prof.cpu_seconds() * 1000.0, 3),
                "decide_ms": round(decide_s * 1000.0, 3),
                "actuate_ms": round(actuate_s * 1000.0, 3),
                "phases": phases,
            }
            if self.placement_manager is not None:
                # Fleet placement totals after the last placed pass
                # (additive field; `voda top` renders the line).
                rec["placement"] = {
                    "jobs_cross_host": self._last_cross_host,
                    "contiguity_cost": self._last_contiguity_cost,
                    "comms_score": self._last_comms_score,
                }
                if self._last_fractional_stats:
                    # Fractional-sharing totals (doc/fractional-
                    # sharing.md; `voda top` renders the line).
                    rec["placement"]["fractional"] = dict(
                        self._last_fractional_stats)
            self.profile_ring.append(rec)
        for name, stats in phases.items():
            self.h_phase_seconds.observe(stats["wall_ms"] / 1000.0,
                                         phase=name)
        self.tracer.emit(dict(rec))

    def profile_records(self, n: int = 20) -> List[dict]:
        """The last n perf_report records (GET /debug/profile)."""
        with self._lock:
            records = list(self.profile_ring)
        return records[-max(0, int(n)):] if n else records

    def explain_profile(self, job: str) -> Optional[dict]:
        """The newest perf_report whose pass acted on `job` — where the
        time went the last time the scheduler touched it (`voda explain`
        renders the job's per-pass share)."""
        with self._lock:
            records = list(self.profile_ring)
        for rec in reversed(records):
            if job in rec.get("jobs", ()):
                return rec
        return None

    def explain_job(self, job: str, n: int = 50) -> List[dict]:
        """Audit records whose deltas touch `job`, oldest first
        (GET /debug/trace/<job> and `voda explain <job>`)."""
        with self._lock:
            records = list(self.audit_ring)
        hits = [r for r in records
                if any(d.get("job") == job for d in r.get("deltas", ()))]
        return hits[-max(0, int(n)):] if n else hits

    def whatif(self, job: str) -> dict:
        """What-if shadow plan for one job (doc/learned-models.md
        "What-if planner", replay/whatif.py): snapshot-in under one
        brief lock hold, then scored entirely OFF the decide critical
        path on this scheduler's single bounded planner worker — the
        planner never holds the scheduler lock while it computes, and
        a small in-flight cap sheds pile-ups instead of queueing them.
        Backs GET /debug/whatif/<job> and `voda explain --whatif`."""
        from concurrent.futures import ThreadPoolExecutor

        from vodascheduler_tpu_torch.replay import whatif as whatif_mod

        with self._lock:
            if self._whatif_inflight >= 4:
                raise RuntimeError(
                    "what-if planner busy (in-flight cap reached; "
                    "retry shortly)")
            self._whatif_inflight += 1
            if self._whatif_pool is None:
                self._whatif_pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="voda-whatif")
            pool = self._whatif_pool
        parent = obs_tracer.current_context()

        def _run() -> dict:
            try:
                with obs_tracer.use_context(parent, self.tracer):
                    return whatif_mod.run_whatif(self, job)
            finally:
                with self._lock:
                    self._whatif_inflight -= 1

        return pool.submit(_run).result(timeout=60.0)

    # ---- time accounting + Tiresias transitions (reference :757-813) -----

    def update_time_metrics(self) -> None:
        with self._lock:
            priority_changed = self._update_time_metrics_locked()
        # Trigger outside the lock hold (an inline VirtualClock pass
        # must not inherit this frame's lock — see trigger_resched).
        if priority_changed:
            self.trigger_resched("priority_change")

    def _update_time_metrics_locked(self) -> bool:
        """Returns whether a Tiresias priority flipped (the caller fires
        the resched trigger once it has released the lock).

        This runs inside every pass's decide window (resched() ticks it
        before deciding), so the loop body is hoisted for the 10k-job
        queue: one booking snapshot instead of a locked get per job, and
        the per-job enum/algorithm tests reduced to locals (ROADMAP
        item 2; behavior identical to the unhoisted form)."""
        now = self.clock.now()
        priority_changed = False
        is_tiresias = self.algorithm in ("Tiresias", "ElasticTiresias")
        booked = self.job_num_chips.snapshot()
        booked_get = booked.get
        RUNNING, WAITING = JobStatus.RUNNING, JobStatus.WAITING
        for job in self.ready_jobs.values():
            m = job.metrics
            elapsed = now - m.last_update_time
            if elapsed < 0:
                elapsed = 0.0
            status = job.status
            if status is RUNNING:
                chip_elapsed = elapsed * booked_get(job.name, 0)
                m.running_seconds += elapsed
                m.chip_seconds += chip_elapsed
                m.total_seconds += elapsed
                m.last_running_seconds += elapsed
                m.last_chip_seconds += chip_elapsed
                m.seconds_since_restart += elapsed
            elif status is WAITING:
                m.waiting_seconds += elapsed
                m.total_seconds += elapsed
                m.last_waiting_seconds += elapsed
            m.last_update_time = now

            if (is_tiresias
                    and job.status in (JobStatus.RUNNING, JobStatus.WAITING)):
                # Deliberate fix over the reference (scheduler.go:787-802),
                # which never resets the last_* windows on a transition: a
                # preempted-then-starved job would oscillate promote/demote
                # every tick, thrashing allocations. Consuming the window
                # that caused each transition (per the Tiresias paper's
                # window semantics) makes transitions one-shot.
                threshold = TIRESIAS_THRESHOLDS_SEC.get(job.priority, float("inf"))
                if m.last_chip_seconds > threshold:
                    job.priority = tiresias_demote_priority(job.priority)
                    m.last_chip_seconds = 0.0
                    priority_changed = True
                elif (m.last_waiting_seconds >= m.last_running_seconds * TIRESIAS_PROMOTE_KNOB
                        and job.priority > 0):
                    job.priority = tiresias_promote_priority(job.priority)
                    m.last_waiting_seconds = 0.0
                    priority_changed = True
        if self.ready_jobs:
            # An idle pool's tick mutates no row — keep the status
            # snapshot cache valid so steady-state scrapes stay free.
            self._bump_state_version()
        return priority_changed

    # ---- crash resume (reference: constructStatusOnRestart :1009-1072) ---

    def _construct_status_on_restart(self) -> None:
        """Rebuild in-memory state from the store and the backend's live
        view. Jobs recorded as non-terminal return to the ready queue; their
        current allocation comes from the backend (like reading live MPIJob
        Worker.Replicas)."""
        running = self.backend.running_jobs()
        for job in self.store.list_jobs(pool=self.pool_id):
            if job.status.is_terminal:
                self.done_jobs[job.name] = job
                continue
            handle = running.get(job.name)
            n = handle.num_workers if handle else 0
            # Re-assert status from store + backend truth. Same-status
            # re-assertions are DECLARED self-loops and emit their audit
            # record (the resume trail used to be silent).
            lifecycle.transition(
                job,
                JobStatus.RUNNING if n > 0 else JobStatus.WAITING,
                reason="resume", chips=n, tracer=self.tracer,
                pool=self.pool_id, journal=self.journal)
            job.metrics.last_update_time = self.clock.now()
            self.ready_jobs[job.name] = job
            self.job_num_chips.commit(job.name, n)
        self._bump_state_version()
        if self.placement_manager is not None:
            self.placement_manager.restore(
                {name: h.placements for name, h in running.items()
                 if h.placements})
        self.trigger_resched("resume")

    # ---- introspection (reference: GET /training table :968-998) ---------

    def _bump_state_version(self) -> None:
        """Invalidate the read-path snapshot cache. Called under the
        scheduler lock by every mutation a status_table() reader could
        observe (status, chips, priority, time accounting)."""
        # vodarace: ignore[unguarded-shared-write] generation token:
        # every steady-state caller holds the scheduler lock (docstring
        # contract); the one unlocked path is single-threaded recovery,
        # before the pool serves. Readers are lock-free by design.
        self._state_version += 1

    @property
    def state_version(self) -> int:
        """The read-path mutation stamp, read lock-free (int loads are
        atomic) — cache keys for fleet-wide aggregations (the router's
        load cache); a racing bump just forces the caller's next
        rebuild."""
        return self._state_version

    def _snapshot(self) -> Tuple[List[Dict[str, object]], bytes]:
        """The (rows, json-bytes) status snapshot, version-stamped.

        Fast path is LOCK-FREE: the cache ref is swapped atomically, so
        a fleet under scrape load pays one dict compare per request. A
        stale cache rebuilds under the lock — but a reader arriving
        while a pass (or another rebuild) holds the lock serves the last
        committed snapshot instead of blocking, so REST reads stay live
        through an in-flight resched (snapshot isolation: the reader
        sees the consistent pre-pass state). Rows are shared across
        callers — treat them as read-only."""
        cache = self._status_cache
        if cache is not None and cache[0] == self._state_version:
            return cache[1], cache[2]
        if not self._lock.acquire(blocking=False):
            if cache is not None:
                return cache[1], cache[2]
            # No snapshot built yet: the one time a reader must wait.
            self._lock.acquire()
        try:
            version = self._state_version
            rows = self._status_table_locked()
        finally:
            self._lock.release()
        import json as _json
        data = (_json.dumps(rows) + "\n").encode()
        self._status_cache = (version, rows, data)
        return rows, data

    def status_table(self) -> List[Dict[str, object]]:
        """Status rows, served from the snapshot cache. The returned
        list is the caller's to reorder, but the row dicts are SHARED
        with every concurrent reader (and with the cached JSON) — treat
        them as read-only."""
        return list(self._snapshot()[0])

    def status_table_json(self) -> bytes:
        """Pre-serialized status table for the REST layer: the cached
        bytes are written straight to the socket (no per-request
        re-serialization of a 10k-row fleet)."""
        return self._snapshot()[1]

    def _status_table_locked(self) -> List[Dict[str, object]]:
        rows = []
        for job in sorted(self.ready_jobs.values(), key=lambda j: j.submit_time):
            rows.append({
                "name": job.name,
                "status": job.status.value,
                "chips": self.job_num_chips.get(job.name, 0),
                "priority": job.priority,
                "running_seconds": round(job.metrics.running_seconds, 1),
                "waiting_seconds": round(job.metrics.waiting_seconds, 1),
                "chip_seconds": round(job.metrics.chip_seconds, 1),
            })
        for job in sorted(self.done_jobs.values(), key=lambda j: j.submit_time):
            rows.append({
                "name": job.name,
                "status": job.status.value,
                "chips": 0,
                "priority": job.priority,
                "running_seconds": round(job.metrics.running_seconds, 1),
                "waiting_seconds": round(job.metrics.waiting_seconds, 1),
                "chip_seconds": round(job.metrics.chip_seconds, 1),
            })
        return rows
