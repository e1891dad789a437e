"""Job admission: create/delete with persistence and event publication.

Reference counterpart: pkg/service/service/handlers.go —
`CreateTrainingJob` (:60): parse spec, timestamp the name (:85-88), create
or inherit base job info (:77, getOrCreateBaseJobInfo), insert into Mongo,
publish `create` to the GPU-type queue with rollback on publish failure
(:119-134). `DeleteTrainingJob` (:255) mirrors it.

Ingestion plane (doc/observability.md "Ingestion plane"): the single
create path is a batch of one. `create_training_jobs` admits a whole
burst atomically — validate every spec, commit them all with ONE store
lock acquisition and ONE flush (`JobStore.insert_jobs`), publish via
`EventBus.publish_many_multi` (all pools' queues loaded under one bus
lock hold — atomic even across pools), and on hook/publish failure
compensating-delete the entire batch (the reference's rollback idiom,
scaled up). A batch
with any invalid spec admits NOTHING (zero residue in store or bus) and
returns per-item error bodies. When the pool's event queue is past its
shed watermark, admission refuses with `AdmissionShed` → the REST layer
answers 429 + Retry-After and counts `voda_admission_shed_total`.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import threading
import time as _walltime
from typing import Dict, List, Optional

from vodascheduler_tpu_torch import config
from vodascheduler_tpu_torch.common.clock import Clock
from vodascheduler_tpu_torch.common.events import EventBus, EventQueueFull, JobEvent
from vodascheduler_tpu_torch.common.job import (
    JobInfo,
    JobSpec,
    TrainingJob,
    category_of,
    shared_base_job_info,
    timestamped_name,
)
from vodascheduler_tpu_torch.common.metrics import Registry, timed
from vodascheduler_tpu_torch.common.store import JobStore
from vodascheduler_tpu_torch.common.types import EventVerb
from vodascheduler_tpu_torch.obs import tracer as obs_tracer

log = logging.getLogger(__name__)

# The per-item error every VALID spec in a rejected batch carries: bulk
# admission is all-or-nothing (zero residue on partial failure), so a
# good spec's outcome still names why it wasn't admitted.
BATCH_SIBLING_REJECTED = "batch rejected: sibling spec invalid (nothing admitted)"


class AdmissionError(Exception):
    pass


class AdmissionShed(AdmissionError):
    """Backpressure: the pool's event queue is past its shed watermark —
    the caller should retry after the scheduler has drained some backlog
    (REST maps this to 429 + Retry-After)."""

    def __init__(self, pool: str, retry_after: float):
        super().__init__(
            f"pool {pool!r} ingestion backlogged past the shed watermark; "
            f"retry after {retry_after:g}s")
        self.pool = pool
        self.retry_after = retry_after


class NotLeader(AdmissionError):
    """This control plane was deposed: a standby holds the leadership
    lease (doc/durability.md). Admissions must refuse LOUDLY — the
    store commit + bus publish would otherwise ack a mutation the
    fenced scheduler then silently drops. REST maps this to 503 so the
    client retries against the current leader."""


class AdmissionService:
    def __init__(self, store: JobStore, bus: EventBus, clock: Clock,
                 registry: Optional[Registry] = None,
                 valid_pools: Optional[set] = None,
                 tracer: Optional[obs_tracer.Tracer] = None,
                 router=None, deposed=None):
        self.store = store
        self.bus = bus
        self.clock = clock
        self.tracer = tracer
        # Leadership probe (doc/durability.md): a zero-arg callable
        # returning True when this process no longer holds the lease.
        # Checked at every admission entry point; None = standalone
        # deployment with no leadership plane.
        self.deposed = deposed
        # Cross-pool admission router (scheduler/fleet.py FleetRouter,
        # doc/observability.md "Fleet decide"): specs naming no pool are
        # placed by fleet-wide score BEFORE the shed pre-check below —
        # the routed pool is the queue whose backpressure applies. None
        # = the static reference path (explicit pools only).
        self.router = router
        # When set, jobs naming a pool outside it are rejected at
        # admission: the bus queues events for unsubscribed topics
        # silently, so an unvalidated typo'd (or defaulted) pool would be
        # accepted 200 and then sit Submitted forever with no scheduler
        # ever seeing it.
        self.valid_pools = valid_pools
        registry = registry or Registry()
        # Reference series: pkg/service/service/metrics.go.
        self.m_created = registry.counter(
            "voda_service_jobs_created_total", "Jobs admitted")
        self.m_deleted = registry.counter(
            "voda_service_jobs_deleted_total", "Jobs deleted")
        self.m_errors = registry.counter(
            "voda_service_errors_total", "Admission errors")
        self.m_shed = registry.counter(
            "voda_admission_shed_total",
            "Admissions refused with 429 (event-queue backpressure)")
        self.m_create_duration = registry.summary(
            "voda_service_create_duration_seconds",
            "Job admission handler duration")
        self.m_bulk_duration = registry.summary(
            "voda_service_bulk_create_duration_seconds",
            "Bulk admission handler duration (POST /training/batch)")
        self.m_delete_duration = registry.summary(
            "voda_service_delete_duration_seconds",
            "Job deletion handler duration")
        # Ingestion stats for /debug/ingest and `voda top`: recent
        # single-request admission latencies (per-request p50/p99) and
        # the last bulk burst's shape.
        self._stats_lock = threading.Lock()
        self._recent_admit_ms: collections.deque = collections.deque(
            maxlen=2048)
        self._last_burst: Optional[Dict[str, float]] = None
        # Serializes the name-pick → store-insert window across
        # concurrent admissions (see _admit_batch).
        self._name_claim_lock = threading.Lock()

    def create_training_job(self, spec: JobSpec,
                            on_admitted=None) -> str:
        """Admit a job; returns its timestamped name.

        `on_admitted(name)`, when given, runs after the store write but
        BEFORE the scheduler hears the CREATE event — the only window
        where per-job metadata (e.g. the replay's workload profiles) can
        be attached race-free, since publish may synchronously trigger a
        reschedule that starts the job.

        Internally a batch of one (the bulk path below is the only
        admission engine); per-request wall time feeds the ingestion
        stats ring."""
        with timed(self.m_create_duration):
            t0 = _walltime.monotonic()
            results = self._admit_batch([spec], on_admitted)
            with self._stats_lock:
                self._recent_admit_ms.append(
                    (_walltime.monotonic() - t0) * 1000.0)
        if "error" in results[0]:
            self.m_errors.inc()
            raise AdmissionError(results[0]["error"])
        return results[0]["name"]

    def create_training_jobs(self, specs: List[JobSpec],
                             on_admitted=None) -> List[Dict[str, str]]:
        """Bulk admission (POST /training/batch): admit a burst of specs
        atomically. Returns one result per spec, in order — `{"name":
        <timestamped>}` on success, `{"name": <requested>, "error": ...}`
        otherwise. All-or-nothing: any invalid spec rejects the whole
        batch with zero residue in the store or on the bus; a hook or
        publish failure compensating-deletes every inserted job and
        re-raises."""
        with timed(self.m_bulk_duration):
            t0 = _walltime.monotonic()
            results = self._admit_batch(list(specs), on_admitted)
            admitted = sum(1 for r in results if "error" not in r)
            # Count the specs that were actually invalid — not their
            # BATCH_SIBLING_REJECTED siblings, which would inflate the
            # error rate by the batch size on one typo.
            invalid = sum(1 for r in results
                          if r.get("error") not in (None,
                                                    BATCH_SIBLING_REJECTED))
            if invalid:
                self.m_errors.inc(invalid)
            with self._stats_lock:
                total_ms = (_walltime.monotonic() - t0) * 1000.0
                self._last_burst = {
                    "size": len(results),
                    "admitted": admitted,
                    "total_ms": round(total_ms, 3),
                    "per_item_ms": round(total_ms / max(1, len(results)), 4),
                    "ts": self.clock.now(),
                }
        return results

    def _require_leadership(self) -> None:
        if self.deposed is not None and self.deposed():
            self.m_errors.inc()
            raise NotLeader(
                "this control plane was deposed (a standby holds the "
                "leadership lease); retry against the current leader")

    def _admit_batch(self, specs: List[JobSpec],
                     on_admitted=None) -> List[Dict[str, str]]:
        if not specs:
            return []
        self._require_leadership()
        # Cross-pool routing first: a spec that names no pool gets its
        # fleet-wide placement here, so the shed pre-check and the
        # validation below see the pool the job will actually land in.
        # Routing is per-spec and isolated — a router error becomes that
        # spec's admission error (the batch's all-or-nothing semantics
        # then reject the siblings), never a 500 for the whole burst.
        # Decisions stay PENDING until the batch's outcome is known:
        # committed (stats + fleet_route audit records) only once the
        # jobs are truly handed off, aborted (in-flight reservations
        # released, audit silent) on every shed/rejection/rollback path
        # — so the audit trail never asserts placements that didn't
        # happen, and a retried 429 burst can't accrete phantom backlog
        # in the router's in-flight correction.
        route_errors: Dict[int, str] = {}
        pending_routes: List[dict] = []
        if self.router is not None:
            routed: List[JobSpec] = []
            for i, spec in enumerate(specs):
                if self.router.needs_route(spec.pool):
                    try:
                        pending = self.router.route_pending(spec)
                        pending_routes.append(pending)
                        spec = dataclasses.replace(spec,
                                                   pool=pending["pool"])
                    except Exception as e:  # noqa: BLE001 - per-item outcome
                        route_errors[i] = str(e)
                routed.append(spec)
            specs = routed
        if route_errors:
            self._abort_routes(pending_routes)
            return [{"name": s.name,
                     "error": route_errors.get(i, BATCH_SIBLING_REJECTED)}
                    for i, s in enumerate(specs)]
        # Backpressure first: a backlogged pool sheds the whole burst
        # before any validation/store work is spent on it — at the
        # watermark, or when this burst cannot fit WHOLE under the queue
        # bound (a partially-queued burst would strand committed jobs
        # the scheduler never hears about).
        per_pool = collections.Counter(s.pool for s in specs)
        for pool in sorted(per_pool):
            if (self.bus.saturated(pool)
                    or self.bus.free_slots(pool) < per_pool[pool]):
                self.m_shed.inc()
                self._abort_routes(pending_routes)
                raise AdmissionShed(
                    pool, retry_after=config.ADMISSION_RETRY_AFTER_SECONDS)

        # Validate every spec before touching the store (atomicity: one
        # bad spec must leave zero residue).
        from vodascheduler_tpu_torch.common.job import RESOURCE_CLASSES
        errors: Dict[int, str] = {}
        for i, spec in enumerate(specs):
            if self.valid_pools is not None and spec.pool not in self.valid_pools:
                errors[i] = (f"unknown pool {spec.pool!r}; configured "
                             f"pools: {sorted(self.valid_pools)}")
            elif spec.resource_class not in RESOURCE_CLASSES:
                # A typo'd class would silently resolve as AUTO
                # downstream (doc/fractional-sharing.md) — reject it
                # here where the submitter can see it.
                errors[i] = (f"unknown resource_class "
                             f"{spec.resource_class!r}; valid: "
                             f"{list(RESOURCE_CLASSES)}")
        if errors:
            self._abort_routes(pending_routes)
            return [{"name": s.name,
                     "error": errors.get(i, BATCH_SIBLING_REJECTED)}
                    for i, s in enumerate(specs)]

        now = self.clock.now()
        jobs: List[TrainingJob] = []
        infos: List[JobInfo] = []
        names: List[str] = []
        taken: set = set()
        # Category-fallback memo: every job in the burst seeds from the
        # PRE-batch curve state (one sorted lookup per distinct
        # category, not per job) — batch siblings don't see each other's
        # just-created base priors, which carry no learned curves anyway.
        fallback: Dict[str, Optional[JobInfo]] = {}
        # The name-pick → insert window must be atomic against concurrent
        # admissions: two same-second requests for the same spec.name
        # would otherwise both pass the uniqueness probe, pick the same
        # timestamped name, and the later insert would silently overwrite
        # the earlier job. Serializing admissions here is cheap — the
        # measured per-burst cost is sub-ms/job — and publish/rollback
        # stay outside the region.
        with self._name_claim_lock:
            for spec in specs:
                # Second-resolution timestamps collide when jobs arrive
                # in the same second (guaranteed inside a burst); bump
                # until unique against both the store and this batch.
                stamp = now
                name = timestamped_name(spec.name, now=stamp)
                while self.store.get_job(name) is not None or name in taken:
                    stamp += 1.0
                    name = timestamped_name(spec.name, now=stamp)
                taken.add(name)
                spec = dataclasses.replace(spec, name=name)
                category = category_of(name)

                # Seed job info: inherit the category's learned curves
                # if a past run of the same workload exists, else the
                # linear prior (reference: getOrCreateBaseJobInfo,
                # handlers.go:180-206).
                if category not in fallback:
                    fallback[category] = self.store.find_category_info(
                        category)
                past = fallback[category]
                if past is not None:
                    info = dataclasses.replace(
                        past, name=name,
                        speedup=dict(past.speedup),
                        efficiency=dict(past.efficiency),
                        epoch_seconds=dict(past.epoch_seconds),
                        step_seconds=dict(past.step_seconds))
                    # A fresh submission restarts from epoch 0:
                    # remaining time is the full run re-estimated from
                    # the learned epoch time.
                    if 1 in info.epoch_seconds:
                        info.estimated_remaining_seconds = (
                            info.epoch_seconds[1] * spec.config.epochs)
                    info.current_epoch = -1
                    info.remaining_epochs = spec.config.epochs
                else:
                    # Shared immutable prior curves: a 100k-job fleet
                    # admission must not mint 100k ~500-entry dicts
                    # whose gen-2 GC pause lands inside a later decide
                    # window (the collector copy-on-writes before its
                    # first curve mutation, so sharing is safe).
                    info = shared_base_job_info(name, category, spec.pool)

                jobs.append(TrainingJob.from_spec(spec, submit_time=now))
                infos.append(info)
                names.append(name)

            # The whole batch commits as one store write (one lock
            # acquisition, one flush — insert_jobs).
            self.store.insert_jobs(jobs, infos)

        try:
            if on_admitted is not None:
                for name in names:
                    on_admitted(name)
            by_pool: Dict[str, List[JobEvent]] = {}
            for job, name in zip(jobs, names):
                by_pool.setdefault(job.pool, []).append(
                    JobEvent(EventVerb.CREATE, name))
            # All-or-nothing hand-off: a burst racing other publishers
            # past the capacity pre-check above must fail LOUDLY with
            # nothing queued on ANY pool — the bus checks and loads
            # every pool's queue under one lock hold, because with
            # sequential per-pool publishes a later pool's overflow
            # would roll back jobs an earlier pool's scheduler had
            # already consumed.
            span = (self.tracer.span("admission.batch",
                                     component="service",
                                     attrs={"jobs": len(names),
                                            "pools": sorted(by_pool)})
                    if len(specs) > 1 and self.tracer is not None
                    else contextlib.nullcontext())
            with span:
                self.bus.publish_many_multi(by_pool)
        except EventQueueFull as e:
            # Rollback, then shed: the queue filled between the
            # pre-check and the publish — to the client this is the
            # same backpressure (429 + Retry-After), just detected one
            # step later.
            self.store.delete_jobs(names, with_infos=True)
            self._abort_routes(pending_routes)
            self.m_shed.inc()
            raise AdmissionShed(
                e.topic,
                retry_after=config.ADMISSION_RETRY_AFTER_SECONDS) from e
        except Exception:
            # Rollback like the reference (handlers.go:124-131), batch
            # wide: jobs the scheduler never hears about must not linger
            # in the store (one compensating bulk delete).
            self.store.delete_jobs(names, with_infos=True)
            self._abort_routes(pending_routes)
            self.m_errors.inc()
            raise
        if self.router is not None and pending_routes:
            self.router.commit_routes(pending_routes)
        self.m_created.inc(len(names))
        return [{"name": name} for name in names]

    def _abort_routes(self, pending_routes: List[dict]) -> None:
        """Release pending router reservations on a failed batch —
        best-effort: the admission outcome (shed/rejection/rollback)
        must propagate even if the router bookkeeping hiccups."""
        if self.router is None or not pending_routes:
            return
        try:
            self.router.abort_routes(pending_routes)
        except Exception:  # noqa: BLE001 - never mask the admission outcome
            log.exception("router abort_routes failed")

    def delete_training_job(self, name: str) -> None:
        self._require_leadership()
        with timed(self.m_delete_duration):
            job = self.store.get_job(name)
            if job is None:
                self.m_errors.inc()
                raise AdmissionError(f"job {name} not found")
            try:
                # All-or-nothing: a DELETE silently dropped at the bound
                # would answer 200 while the scheduler keeps the job
                # running forever. Nothing to roll back — the scheduler
                # owns the store mutation when it handles the event.
                self.bus.publish_many(job.pool,
                                      (JobEvent(EventVerb.DELETE, name),),
                                      all_or_nothing=True)
            except EventQueueFull as e:
                self.m_shed.inc()
                raise AdmissionShed(
                    job.pool,
                    retry_after=config.ADMISSION_RETRY_AFTER_SECONDS) from e
            self.m_deleted.inc()

    def get_job(self, name: str) -> Optional[TrainingJob]:
        return self.store.get_job(name)

    # ---- ingestion stats (/debug/ingest, `voda top`) ---------------------

    def ingest_stats(self) -> Dict[str, object]:
        """Operator view of the ingestion plane: shed/drop counters, live
        per-topic queue depth, recent single-request admission p50/p99,
        and the last bulk burst's shape — how a human sees backpressure
        engage (doc/observability.md "Ingestion plane")."""
        from vodascheduler_tpu_torch.common.metrics import nearest_rank_percentile

        with self._stats_lock:
            recent = list(self._recent_admit_ms)
            burst = dict(self._last_burst) if self._last_burst else None

        def pct(q: float) -> float:
            return round(nearest_rank_percentile(recent, q), 4)

        return {
            "admitted_total": self.m_created.value(),
            "shed_total": self.m_shed.value(),
            "events_dropped_total": self.bus.dropped(),
            "queue_depth": {t: self.bus.pending(t)
                            for t in self.bus.topics()},
            "recent_admit_ms": {"count": len(recent), "p50": pct(0.50),
                                "p99": pct(0.99)},
            "last_burst": burst,
        }
