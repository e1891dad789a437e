"""The metrics collector: telemetry rows -> job_info curve updates.

Reference counterpart: python/metrics_collector/metrics_collector.py
(parse_csv_and_update_db :52-129 and the _update_* math :131-167):

  - epoch/step time per worker count = mean over that count's rows
  - speedup[n] = epoch_time[1] / epoch_time[n]
  - efficiency[n] = speedup[n] / n
  - estimated remaining = epoch_time[1] × remaining_epochs (serial time —
    SRJF/AFS-L divide by the current speedup themselves)
  - skip a job whose newest epoch was already ingested

Deliberate fixes over the reference:

- it indexes epoch_time['1'] blindly and crashes for jobs that never ran
  at exactly 1 worker (an elastic job with min>1 never does). Here the
  1-chip epoch time is inferred from the measured counts: authoritative
  when a real 1-chip row exists, a power-law fit over the measured
  counts when two or more distinct counts were observed (so a min>1
  job's sub-host partition counts — 3, 5, 6 chips — participate in the
  curve fit, learned.fit_serial_seconds), and the linear anchor only as
  the single-count fallback.
- the learned-model plane (doc/learned-models.md): rows carry the
  placement spread and co-tenancy they ran under, and the collector
  refines each job's effective comms/interference fraction online by
  inverting the step-time cost model over burden VARIATION — plus a
  measured-vs-modeled drift ratio whose band crossing fires one audited
  `model_drift_detected` resched per episode. Learned state is
  journaled (`jmodel`) ahead of the store write so it survives
  crash-recovery, and `VODA_LEARNED_MODELS=0` keeps the prior-only
  reference behavior.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Protocol

from vodascheduler_tpu_torch import config
from vodascheduler_tpu_torch.cluster.fake import FakeClusterBackend, MetricsRow
from vodascheduler_tpu_torch.common.clock import Clock, VirtualClock
from vodascheduler_tpu_torch.common.job import JobInfo, base_job_info, category_of
from vodascheduler_tpu_torch.common.store import JobStore
from vodascheduler_tpu_torch.metricscollector import learned as learned_mod
from vodascheduler_tpu_torch.metricscollector.csv_logger import read_epoch_csv

DEFAULT_INTERVAL_SECONDS = 60.0  # reference CronJob: every 1 minute


class RowSource(Protocol):
    """Where epoch telemetry comes from."""

    def job_names(self) -> List[str]: ...

    def rows(self, job: str) -> List[MetricsRow]: ...


class BackendRowSource:
    """Reads the fake backend's in-memory rows (simulation mode)."""

    def __init__(self, backend: FakeClusterBackend):
        self.backend = backend

    def job_names(self) -> List[str]:
        return list(self.backend.metrics_rows.keys())

    def rows(self, job: str) -> List[MetricsRow]:
        return self.backend.metrics_rows.get(job, [])


class CsvDirRowSource:
    """Reads `<dir>/<job>.csv` files written by training jobs (real mode —
    the reference's shared /metrics PVC)."""

    def __init__(self, metrics_dir: str):
        self.metrics_dir = metrics_dir

    def job_names(self) -> List[str]:
        if not os.path.isdir(self.metrics_dir):
            return []
        return [f[:-4] for f in os.listdir(self.metrics_dir)
                if f.endswith(".csv")]

    def rows(self, job: str) -> List[MetricsRow]:
        out = []
        for r in read_epoch_csv(os.path.join(self.metrics_dir, f"{job}.csv")):
            out.append(MetricsRow(
                job=job,
                epoch=int(r["epoch"]),
                epoch_time_sec=float(r["epoch_time_sec"]),
                workers=int(r["workers"]),
                timestamp=0.0,
                step_time_sec=float(r.get("step_time_sec") or 0.0),
                # Trainer-side loggers that report their placement
                # context feed the learned plane; absent columns mean
                # contiguous/exclusive (the estimators stay silent).
                spread=float(r.get("spread") or 0.0),
                cotenancy=float(r.get("cotenancy") or 0.0),
            ))
        return out


class MetricsCollector:
    def __init__(self, store: JobStore, source: RowSource,
                 clock: Optional[Clock] = None,
                 interval_seconds: float = DEFAULT_INTERVAL_SECONDS,
                 registry=None, pool: str = "",
                 learned: Optional[bool] = None,
                 drift_trigger: Optional[Callable[[str], None]] = None,
                 journal=None):
        self.store = store
        self.source = source
        self.clock = clock
        self.interval_seconds = interval_seconds
        self._stopped = False
        # Learned-model plane (doc/learned-models.md): on, each pass
        # refines effective comms/interference fractions and the drift
        # ratio from the rows' placement context; off
        # (VODA_LEARNED_MODELS=0) keeps the prior-only reference
        # behavior (curves still learn from epoch means — that is the
        # reference's own feedback loop, shared by both A/B arms).
        self.learned = config.LEARNED_MODELS if learned is None else learned
        # Fired once per job per drift episode: the wired callback
        # requests a `model_drift_detected` resched; the scheduler's
        # trigger coalescing dedups N drifting jobs in one rate-limit
        # window into one pass.
        self.drift_trigger = drift_trigger
        self._drift_fired: Dict[str, bool] = {}
        self.drift_fired_total = 0
        # Write-ahead journal (doc/durability.md `jmodel`): learned
        # state is appended BEFORE the store upsert, so crash recovery
        # replays the models the pre-crash scheduler was consuming.
        self.journal = journal
        # Supervisor-reported step times, bucketed (doc/observability.md).
        # The control plane is the only process with a /metrics endpoint,
        # so training-side step latency surfaces here at ingestion time —
        # one observation per newly-collected epoch row, labeled by the
        # job's category (family) so repeat submissions aggregate. The
        # pool const-label keeps N per-pool collectors on one shared
        # registry from emitting duplicate identical-labelset series
        # (same pattern as every per-pool scheduler instrument).
        self.h_step_time = None
        self.g_drift = None
        if registry is not None:
            self.h_step_time = registry.histogram(
                "voda_job_step_time_seconds",
                "Trainer-reported mean step time per ingested epoch row",
                ("category",),
                buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0,
                         30.0),
                const_labels={"pool": pool} if pool else None)
            # Per-job modeled-vs-measured divergence (doc/learned-
            # models.md): the recency-weighted mean of measured step
            # time / modeled step time — scrapeable BEFORE it trips the
            # drift band and forces a resched. 1.0 = the model predicts
            # the job perfectly.
            self.g_drift = registry.gauge(
                "voda_job_model_drift_ratio",
                "Recency-weighted measured/modeled step-time ratio per "
                "job (1.0 = model matches; leaving the drift band "
                "fires a model_drift_detected resched)",
                labels=("job",),
                const_labels={"pool": pool} if pool else None)
        # Highest epoch already observed into the histogram per job (the
        # job-info current_epoch can't serve: a job whose info update is
        # skipped must still not re-observe old rows next pass).
        self._observed_epoch: Dict[str, int] = {}
        # Highest epoch the learned plane has folded into the drift
        # ratio (drift judges NEW rows against the model as it stood
        # BEFORE they arrived — re-judging old rows against a model
        # that has since absorbed them would read as zero drift).
        self._drift_epoch: Dict[str, int] = {}
        # Jobs with an exported per-job drift series: reaped (series
        # removed, per-job state dropped) once the job is terminal —
        # a per-job gauge left forever is a cardinality leak on a
        # 100k-job fleet, and these dicts would grow with it.
        self._drift_series: set = set()

    def start(self) -> None:
        """Register the periodic collection timer (simulation mode)."""
        if not isinstance(self.clock, VirtualClock):
            return

        def tick() -> None:
            if self._stopped:
                return
            self.collect_all()
            self.clock.call_later(self.interval_seconds, tick)

        self.clock.call_later(self.interval_seconds, tick)

    def stop(self) -> None:
        self._stopped = True

    def _now(self) -> float:
        return self.clock.now() if self.clock is not None else 0.0

    # ---- one collection pass (reference: update_info_all) ----------------

    def collect_all(self) -> int:
        updated = 0
        for job in self.source.job_names():
            if self.update_job_info(job):
                updated += 1
        self._reap_terminal()
        return updated

    def _reap_terminal(self) -> None:
        """Drop per-job drift series + tracking state for jobs that
        reached a terminal status (or vanished from the store): the
        learned DOCS stay — curves outlive the run by design — but a
        per-job gauge series and the episode/epoch maps must not
        accrete one entry per job ever seen. Sweeps the union of ALL
        per-job tracking maps (not just the exported-series set — a
        registry-less collector, e.g. replay's, tracks epochs too)."""
        tracked = (set(self._observed_epoch) | set(self._drift_epoch)
                   | set(self._drift_fired) | self._drift_series)
        for name in tracked:
            job = self.store.get_job(name)
            if job is not None and not job.status.is_terminal:
                continue
            self._drift_series.discard(name)
            self._drift_fired.pop(name, None)
            self._drift_epoch.pop(name, None)
            # The histogram watermark is only safe to drop once the
            # job's record is GONE (deleted): a terminal job's rows
            # still flow past _observe_step_times every pass (it runs
            # before the same-epoch skip), and a dropped watermark
            # would re-observe the whole history each time.
            if job is None:
                self._observed_epoch.pop(name, None)
            if self.g_drift is not None:
                self.g_drift.remove(job=name)

    def update_job_info(self, job_name: str) -> bool:
        rows = self.source.rows(job_name)
        if not rows:
            return False
        self._observe_step_times(job_name, rows)
        info = self.store.get_job_info(job_name)
        if info is None:
            # The record must exist before we update it (reference
            # :81-84) — admission creates it; tolerate stragglers.
            job = self.store.get_job(job_name)
            pool = job.pool if job else ""
            info = base_job_info(job_name, category_of(job_name), pool)

        newest_epoch = rows[-1].epoch
        if info.current_epoch == newest_epoch:
            return False  # same epoch, skip (reference :86-88)

        # Drift BEFORE the curve update (doc/learned-models.md): the
        # new rows are judged against the model the scheduler was
        # actually consuming — the pre-update curves and blended
        # fractions. Updating first would absorb the surprise and read
        # every drift as zero.
        drift_changed = self._update_drift(job_name, info, rows) \
            if self.learned else False

        # Mean epoch AND step time per observed worker count (reference
        # :131-141 ingests both columns). Step time comes from the CSV's
        # `step_time_sec` when the trainer reports it; the curves can
        # legitimately diverge — epoch time carries per-epoch fixed costs
        # (eval, checkpointing, input-pipeline restarts) that step time
        # excludes, so step speedup is the honest compute-scaling signal.
        # Rows without a step measurement (step_time_sec == 0) fall back
        # to the epoch-derived value for that count.
        #
        # Per count, CONTIGUOUS-and-exclusive rows are preferred when
        # any exist (doc/learned-models.md): an epoch run spread across
        # the torus or sharing its hosts measures placement, not
        # scaling, and folding it into the speedup curve conflates the
        # two. Counts observed only under burden keep the all-rows mean
        # (the pre-learned behavior — better a burdened measurement
        # than a prior).
        by_workers: Dict[int, List[float]] = {}
        by_workers_clean: Dict[int, List[float]] = {}
        by_workers_step: Dict[int, List[float]] = {}
        for r in rows:
            if r.workers <= 0:
                continue
            by_workers.setdefault(r.workers, []).append(r.epoch_time_sec)
            if (getattr(r, "spread", 0.0) < learned_mod.MIN_DELTA
                    and getattr(r, "cotenancy", 0.0)
                    < learned_mod.MIN_DELTA):
                by_workers_clean.setdefault(r.workers, []).append(
                    r.epoch_time_sec)
            step = getattr(r, "step_time_sec", 0.0)
            if step and step > 0:
                by_workers_step.setdefault(r.workers, []).append(step)
        # Copy-on-write, assembled on LOCALS and rebound in one shot at
        # the end: fresh jobs are seeded with SHARED immutable prior
        # dicts (shared_base_job_info), so the old dicts are never
        # written through — and concurrent readers (the what-if
        # planner's worker iterates live info docs) must only ever see
        # a COMPLETE curve dict. A reference swap is atomic; mutating a
        # published dict can raise mid-iteration in a reader.
        epoch_seconds = dict(info.epoch_seconds)
        step_seconds = dict(info.step_seconds)
        speedup = dict(info.speedup)
        efficiency = dict(info.efficiency)
        for n, times in by_workers.items():
            clean = by_workers_clean.get(n)
            epoch_seconds[n] = (sum(clean) / len(clean) if clean
                                else sum(times) / len(times))
            steps = by_workers_step.get(n)
            if steps:
                step_seconds[n] = sum(steps) / len(steps)
            else:
                step_seconds[n] = epoch_seconds[n]

        fit = learned_mod.fit_serial_seconds(epoch_seconds)
        curve = epoch_seconds
        refs = None
        if self.learned and fit is not None:
            # Burden deflation (doc/learned-models.md): a job that only
            # ever ran spread/co-tenant measures placement, not scaling
            # — and the burden GROWS with count (more chips = more
            # hosts = more spread), biasing a raw fit's exponent low.
            # Deflate each count's least-burdened mean by its modeled
            # burden (blended fractions) and refit: the curve then
            # approximates CONTIGUOUS scaling, the same semantics the
            # simulator's base speedup curve carries.
            refs = self._reference_buckets(rows)
            fit, curve = self._deflated_fit(job_name, info, fit,
                                            epoch_seconds, refs)
        epoch1 = fit[0] if fit is not None else None
        if epoch1 is not None:
            # speedup + efficiency for measured counts (reference :143-167).
            for n in by_workers:
                if curve.get(n, 0.0) > 0:
                    speedup[n] = epoch1 / curve[n]
                    efficiency[n] = speedup[n] / n
            distinct = len({n for n, t in curve.items()
                            if n > 0 and t > 0})
            if self.learned and distinct >= 2:
                # Learned curve EXTRAPOLATION (doc/learned-models.md):
                # with two+ measured counts the fitted power law covers
                # the whole curve, so the allocator's marginal-gain
                # lookups at counts the job never ran read the measured
                # scaling instead of the linear prior (a job measured at
                # exponent 0.6 stops looking like free speedup at 2x the
                # chips). Confidence-damped by count coverage (a 2-count
                # fit moves halfway off the prior; more counts converge
                # on the fit); measured counts stay exact. The
                # prior-only reference path (VODA_LEARNED_MODELS=0)
                # keeps the measured-counts-only patching.
                w = float(distinct - 1)
                for n in speedup:
                    if n <= 0 or n in curve:
                        continue
                    fitted = learned_mod.modeled_speedup(n, fit, curve)
                    speedup[n] = learned_mod.blend(
                        float(n), fitted, w, confidence_k=1.0)
                    efficiency[n] = speedup[n] / n

        # Atomic rebind of the assembled curves (see the comment at the
        # locals above).
        info.epoch_seconds = epoch_seconds
        info.step_seconds = step_seconds
        info.speedup = speedup
        info.efficiency = efficiency

        job = self.store.get_job(job_name)
        total_epochs = job.config.epochs if job else rows[-1].epoch + 1
        info.current_epoch = newest_epoch
        info.remaining_epochs = max(0, total_epochs - newest_epoch - 1)
        if epoch1 is not None:
            info.estimated_remaining_seconds = epoch1 * info.remaining_epochs

        changed = False
        if self.learned and fit is not None:
            if refs is None:
                refs = self._reference_buckets(rows)
            changed = self._refine_fractions(job_name, info, rows, fit,
                                             curve, refs)
        if changed or drift_changed:
            # One jmodel append per update that moved ANY learned state
            # — fraction estimates or the drift fold (the drift episode
            # the pre-crash scheduler was accumulating must survive
            # recovery too, not just the fractions). Append-before-
            # apply, like every durability seam. Consumers' derived
            # caches only depend on the fractions, so only those bump
            # the store's model version.
            info.model_version += 1
            if self.journal is not None:
                self.journal.append("jmodel", self._model_payload(info))
            if changed:
                self.store.bump_model_version(job_name)

        self.store.upsert_job_info(info)
        return True

    # ---- learned-model refinement (doc/learned-models.md) ----------------

    @staticmethod
    def _row_weight(r, now: float) -> float:
        """One row's recency weight. Rows without a timestamp (the CSV
        source stamps 0.0) count as FRESH — decaying unknown-age rows
        to zero would silently disable learning on the real-CSV path."""
        ts = getattr(r, "timestamp", 0.0)
        if ts <= 0.0:
            return 1.0
        return learned_mod.decayed_weight(now - ts)

    @staticmethod
    def _reference_buckets(rows) -> Dict[int, tuple]:
        """Per worker count, the least-burdened observation bucket:
        (spread_ref, cot_ref, mean epoch time over that bucket). Rows
        bucket on a MIN_DELTA grid so float jitter doesn't split one
        physical placement into many buckets."""
        grid = learned_mod.MIN_DELTA
        buckets: Dict[int, Dict[tuple, List[float]]] = {}
        for r in rows:
            if r.workers <= 0 or r.epoch_time_sec <= 0:
                continue
            key = (round(getattr(r, "spread", 0.0) / grid),
                   round(getattr(r, "cotenancy", 0.0) / grid))
            buckets.setdefault(r.workers, {}).setdefault(key, []).append(
                r.epoch_time_sec)
        out: Dict[int, tuple] = {}
        for n, per_bucket in buckets.items():
            key = min(per_bucket, key=lambda k: (k[0] + k[1], k))
            times = per_bucket[key]
            out[n] = (key[0] * grid, key[1] * grid,
                      sum(times) / len(times))
        return out

    def _blended_fractions(self, job_name: str, info: JobInfo) -> tuple:
        """(blended comms fraction, blended interference fraction) —
        the prior pulled toward the stored estimates through the
        confidence curve, resolved EXACTLY the way the scheduler
        resolves it (profile_for_job: a spec collectives descriptor
        wins over the family table) — drift must judge measurements
        against the model the scheduler actually consumed, not a
        table the spec overrode."""
        from vodascheduler_tpu_torch.placement import comms as comms_mod
        category = category_of(job_name)
        job = self.store.get_job(job_name)
        profile = comms_mod.profile_for_job(
            job.spec.collectives if job is not None else None, category)
        f_prior = 0.0 if profile is None else profile.comms_fraction
        fi_prior = comms_mod.interference_fraction_for_category(category)
        return (learned_mod.blend(f_prior, info.comms_fraction_est,
                                  info.comms_fraction_weight),
                learned_mod.blend(fi_prior,
                                  info.interference_fraction_est,
                                  info.interference_fraction_weight))

    def _deflated_fit(self, job_name: str, info: JobInfo, fit,
                      measured: Dict[int, float], refs: Dict[int, tuple]):
        """(refitted serial fit, cleaned per-count map): each count's
        LEAST-burdened observed mean deflated by its modeled burden at
        the blended fractions — t_clean = t_ref * s^(-f*spread_ref) *
        (1 - fi*cot_ref) — then refit. `measured` is the caller's
        freshly-assembled per-count map (never the live info dicts — a
        concurrent reader may be iterating those). The deflation reads
        only the previous pass's stored estimates (which derive from
        raw data), so no value ever feeds back into its own derivation
        within a pass. `refs` is the caller's reference-bucket map
        (computed once per update, shared with _refine_fractions)."""
        if not refs:
            return fit, measured
        f_b, fi_b = self._blended_fractions(job_name, info)
        cleaned: Dict[int, float] = {}
        for n, (s_ref, c_ref, t_ref) in refs.items():
            t = t_ref
            s = learned_mod.modeled_speedup(n, fit, measured)
            if s > 1.0 and f_b > 0.0 and s_ref > 0.0:
                t *= s ** (-f_b * s_ref)
            if fi_b > 0.0 and c_ref > 0.0:
                t *= max(1e-9, 1.0 - fi_b * c_ref)
            cleaned[n] = t
        fit2 = learned_mod.fit_serial_seconds(cleaned)
        if fit2 is None:
            return fit, measured
        return fit2, cleaned

    def _refine_fractions(self, job_name: str, info: JobInfo, rows,
                          fit, curve=None, refs=None) -> bool:
        """Recompute the effective comms/interference fraction estimates
        from the full row history (closed-form, recency-weighted — see
        learned.py) and write them onto `info` when they moved. Returns
        whether anything changed — the caller owns the jmodel append
        and the store's model-version bump (one per update, shared with
        the drift fold)."""
        if refs is None:
            refs = self._reference_buckets(rows)
        now = self._now()
        cf_num = cf_den = 0.0
        fi_num = fi_den = 0.0
        for r in rows:
            n = r.workers
            if n <= 0 or r.epoch_time_sec <= 0 or n not in refs:
                continue
            s_ref, c_ref, t_ref = refs[n]
            spread = getattr(r, "spread", 0.0)
            cot = getattr(r, "cotenancy", 0.0)
            w = self._row_weight(r, now)
            if cot <= c_ref + learned_mod.MIN_DELTA:
                speedup = learned_mod.modeled_speedup(
                    n, fit, curve if curve is not None
                    else info.epoch_seconds)
                f = learned_mod.estimate_comms_fraction(
                    r.epoch_time_sec, t_ref, speedup, spread - s_ref)
                if f is not None:
                    cf_num += w * f
                    cf_den += w
            if spread <= s_ref + learned_mod.MIN_DELTA:
                fi = learned_mod.estimate_interference_fraction(
                    r.epoch_time_sec, t_ref, cot, c_ref)
                if fi is not None:
                    fi_num += w * fi
                    fi_den += w
        changed = False
        if cf_den > 0:
            est = cf_num / cf_den
            if (abs(est - info.comms_fraction_est) > 1e-9
                    or abs(cf_den - info.comms_fraction_weight) > 1e-9):
                info.comms_fraction_est = est
                info.comms_fraction_weight = cf_den
                changed = True
        if fi_den > 0:
            est = fi_num / fi_den
            if (abs(est - info.interference_fraction_est) > 1e-9
                    or abs(fi_den - info.interference_fraction_weight)
                    > 1e-9):
                info.interference_fraction_est = est
                info.interference_fraction_weight = fi_den
                changed = True
        if changed:
            info.model_stamp = now
        return changed

    @staticmethod
    def _model_payload(info: JobInfo) -> dict:
        """The `jmodel` journal record: the learned fields plus the
        measured-count curves (NOT the full 256-entry prior — recovery
        re-seeds priors itself; what a crash must not lose is what was
        measured)."""
        measured = {str(n): t for n, t in info.epoch_seconds.items()}
        return {
            "job": info.name,
            "category": info.category,
            "pool": info.pool,
            "cf_est": info.comms_fraction_est,
            "cf_w": info.comms_fraction_weight,
            "if_est": info.interference_fraction_est,
            "if_w": info.interference_fraction_weight,
            "drift": info.model_drift_ratio,
            "drift_w": info.model_drift_weight,
            "stamp": info.model_stamp,
            "version": info.model_version,
            "epoch_seconds": measured,
            "step_seconds": {str(n): t
                             for n, t in info.step_seconds.items()},
            "current_epoch": info.current_epoch,
        }

    def _update_drift(self, job_name: str, info: JobInfo, rows) -> bool:
        """Fold rows newer than the last drift pass into the
        measured-vs-modeled ratio, judged against the PRE-update model
        (curves + blended fractions as the scheduler consumed them).
        Crossing the band fires ONE `model_drift_detected` resched per
        episode; returning inside the band re-arms. Returns whether
        anything was folded (the caller journals it)."""
        fit = learned_mod.fit_serial_seconds(info.epoch_seconds)
        seen = self._drift_epoch.get(job_name, -1)
        newest = seen
        if fit is None:
            # No model yet (first ingestion): nothing to diverge from.
            self._drift_epoch[job_name] = max(seen, rows[-1].epoch)
            return False
        f_b, fi_b = self._blended_fractions(job_name, info)
        now = self._now()
        t1 = fit[0]
        num = den = 0.0
        for r in rows:
            if r.epoch <= seen or r.workers <= 0 or r.epoch_time_sec <= 0:
                continue
            newest = max(newest, r.epoch)
            s = learned_mod.modeled_speedup(r.workers, fit,
                                            info.epoch_seconds)
            if s <= 0:
                continue
            spread = getattr(r, "spread", 0.0)
            cot = getattr(r, "cotenancy", 0.0)
            rate = s ** (1.0 - f_b * spread) if s > 1.0 else s
            rate *= max(1e-9, 1.0 - fi_b * cot)
            t_model = t1 / rate
            if t_model <= 0:
                continue
            w = self._row_weight(r, now)
            num += w * (r.epoch_time_sec / t_model)
            den += w
        self._drift_epoch[job_name] = newest
        if den <= 0:
            return False
        # Decay the accumulated weight against the LAST FOLD's stamp —
        # which this fold must then advance: model_stamp used to move
        # only when a fraction estimate changed, so a converged job's
        # drift weight decayed against an ever-older stamp and could
        # never reach the band's minimum — the exact converged-model-
        # then-workload-shifts scenario the band exists for.
        w_old = info.model_drift_weight * learned_mod.decayed_weight(
            now - info.model_stamp)
        ratio = ((w_old * info.model_drift_ratio + num)
                 / (w_old + den))
        info.model_drift_ratio = ratio
        info.model_drift_weight = w_old + den
        info.model_stamp = now
        if self.g_drift is not None:
            self.g_drift.set(ratio, job=job_name)
            self._drift_series.add(job_name)
        if learned_mod.drift_exceeds_band(ratio, info.model_drift_weight):
            if not self._drift_fired.get(job_name):
                self._drift_fired[job_name] = True
                self.drift_fired_total += 1
                if self.drift_trigger is not None:
                    self.drift_trigger(job_name)
        else:
            self._drift_fired.pop(job_name, None)
        return True

    def _observe_step_times(self, job_name: str, rows) -> None:
        """Feed newly-seen rows' step times into the histogram (no-op
        without a registry). Rows without a trainer-reported step time
        fall back to epoch_time/steps-per-epoch? No — they are skipped:
        a derived value would blur the series' meaning (the summary of
        epoch time already lives in the job info)."""
        if self.h_step_time is None:
            return
        seen = self._observed_epoch.get(job_name, -1)
        newest = seen
        category = category_of(job_name)
        for r in rows:
            if r.epoch <= seen:
                continue
            newest = max(newest, r.epoch)
            step = getattr(r, "step_time_sec", 0.0)
            if step and step > 0:
                self.h_step_time.observe(step, category=category)
        self._observed_epoch[job_name] = newest
