"""Persistent job store: metadata + learned job-info curves.

Reference counterpart: pkg/common/mongo/mongo.go — MongoDB db `job_metadata`
(TrainingJob docs, scheduler.go:49-51) and db `job_info` with one collection
per job *category* holding speedup curves (resource_allocator.go:22,
handlers.go:175-186).

TPU-native redesign: a single-process framework doesn't need an external
database for crash consistency — a JSON-file-backed store with atomic
renames gives the same durability the scheduler's `constructStatusOnRestart`
path needs (scheduler.go:1009-1072), and an in-memory store serves tests and
trace replay. Both implement the same interface so the scheduler is agnostic.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import threading
from typing import Dict, List, Optional

from vodascheduler_tpu_torch.common.job import JobInfo, JobSpec, TrainingJob, category_of
from vodascheduler_tpu_torch.common.types import JobKind, JobStatus


class JobStore:
    """In-memory job store. Base class for persistent variants."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._jobs: Dict[str, TrainingJob] = {}       # by job name
        self._infos: Dict[str, Dict[str, JobInfo]] = {}  # category -> job name -> info
        # Monotonic mutation stamp: bumped by _dirty() on every write.
        # Read-path caches (the service's GET /training snapshot) compare
        # against it to serve unchanged fleets without a rebuild.
        self._version = 0
        # Flat name -> info index for the allocator's batched per-pass
        # lookup. Only docs whose stored category matches
        # category_of(name) are indexed, so a hit here is exactly what
        # get_job_info(name) would have returned (a doc filed under a
        # foreign category is invisible to get_job_info's bucket walk
        # and must stay invisible to the batch path too).
        self._info_by_name: Dict[str, JobInfo] = {}
        # Learned-model mutation stamp (doc/learned-models.md): bumped
        # by the metrics collector whenever a job's LEARNED fields
        # (fraction estimates, drift state) change — separate from
        # `_version` so the scheduler's per-pass weight caches refresh
        # only when a model actually moved, not on every metadata
        # write. A steady-state 10k-job decide pays one int compare,
        # and a pass after a collector update pays the CHANGED names
        # (per-name stamps below), not a full-fleet rescan.
        self._model_version = 0
        self._model_name_versions: Dict[str, int] = {}
        # Names pruned below this version are gone from the per-name
        # map; a consumer whose last-seen version predates the floor
        # must do a full refresh of its own working set.
        self._model_floor = 0

    # -- job metadata (reference: job_metadata collection) -------------------

    def insert_job(self, job: TrainingJob) -> None:
        with self._lock:
            self._jobs[job.name] = job
            self._dirty()

    def update_job(self, job: TrainingJob) -> None:
        self.insert_job(job)

    def get_job(self, name: str) -> Optional[TrainingJob]:
        with self._lock:
            return self._jobs.get(name)

    def delete_job(self, name: str) -> None:
        with self._lock:
            self._jobs.pop(name, None)
            self._dirty()

    def insert_jobs(self, jobs: List[TrainingJob],
                    infos: List[JobInfo] = ()) -> None:
        """Bulk insert for batch admission: the whole batch commits under
        ONE lock acquisition and ONE persistence write (`_dirty` fires
        once — on a FileJobStore that is one atomic file rewrite instead
        of N), the `autoflush=False` batch-boundary idiom applied to the
        always-flushing default store."""
        with self._lock:
            for info in infos:
                self._infos.setdefault(info.category, {})[info.name] = info
                if category_of(info.name) == info.category:
                    self._info_by_name[info.name] = info
            for job in jobs:
                self._jobs[job.name] = job
            self._dirty()

    def delete_jobs(self, names: List[str],
                    with_infos: bool = False) -> None:
        """Bulk delete — the batch path's compensating rollback (one lock
        acquisition, one write), mirroring the reference's
        publish-failure delete (handlers.go:124-131). With
        `with_infos=True` the jobs' JobInfo docs go too: a rolled-back
        job never ran, so its seeded info is a phantom — left behind it
        would feed `find_category_info()` and grow the store by N docs
        per failed batch. Normal deletes keep infos (learned curves
        outlive the run by design)."""
        with self._lock:
            for name in names:
                self._jobs.pop(name, None)
                if with_infos:
                    self._info_by_name.pop(name, None)
                    category = category_of(name)
                    docs = self._infos.get(category)
                    if docs is not None:
                        docs.pop(name, None)
                        if not docs:
                            self._infos.pop(category, None)
            self._dirty()

    def list_jobs(self, pool: Optional[str] = None) -> List[TrainingJob]:
        with self._lock:
            jobs = list(self._jobs.values())
        if pool is not None:
            jobs = [j for j in jobs if j.pool == pool]
        return jobs

    # -- job info / speedup curves (reference: job_info db) ------------------

    def upsert_job_info(self, info: JobInfo) -> None:
        with self._lock:
            self._infos.setdefault(info.category, {})[info.name] = info
            if category_of(info.name) == info.category:
                self._info_by_name[info.name] = info
            self._dirty()

    def get_job_info(self, name: str) -> Optional[JobInfo]:
        with self._lock:
            return self._infos.get(category_of(name), {}).get(name)

    def find_category_info(self, category: str) -> Optional[JobInfo]:
        """Any historical info doc in the category — used to seed a new job's
        curves from past runs of the same workload (handlers.go:180-206)."""
        with self._lock:
            return self._find_category_info_locked(category)

    def _find_category_info_locked(self, category: str) -> Optional[JobInfo]:
        docs = self._infos.get(category)
        if not docs:
            return None
        # newest job name sorts last (timestamp suffix)
        return docs[sorted(docs.keys())[-1]]

    def job_infos_for(self, jobs: List[TrainingJob]) -> Dict[str, Optional[JobInfo]]:
        """Batched per-pass info lookup for the allocator: one lock
        acquisition and one O(1) name-index probe per job instead of N
        point lookups (each paying the category_of regex + a lock
        round-trip), with the category-fallback doc memoized per
        distinct category instead of re-sorted per job. Returns
        {job name: info-or-None}; semantics per job are exactly
        `get_job_info(name) or find_category_info(job.category)`."""
        out: Dict[str, Optional[JobInfo]] = {}
        with self._lock:
            by_name = self._info_by_name
            fallback: Dict[str, Optional[JobInfo]] = {}
            for job in jobs:
                info = by_name.get(job.name)
                if info is None:
                    cat = job.category
                    if cat in fallback:
                        info = fallback[cat]
                    else:
                        info = fallback[cat] = \
                            self._find_category_info_locked(cat)
                out[job.name] = info
        return out

    @property
    def version(self) -> int:
        """The current mutation stamp (see __init__); reading it is
        lock-free (int loads are atomic) — a racing write just makes the
        caller's cache comparison fail and rebuild."""
        return self._version

    @property
    def model_version(self) -> int:
        """The learned-model mutation stamp (see __init__), read
        lock-free like `version` — the scheduler compares it per pass
        and batch-refreshes its placement-weight caches only when a
        collector pass actually moved a model."""
        return self._model_version

    @property
    def model_floor(self) -> int:
        """Versions below this were pruned from the per-name map (see
        bump_model_version); consumers behind it must full-refresh."""
        return self._model_floor

    def bump_model_version(self, name: Optional[str] = None) -> None:
        """Collector hook: `name`'s learned-model fields changed —
        invalidate consumers' derived caches for it. The per-name
        stamp lets a consumer refresh only what moved; the map is
        bounded (a clear raises the floor, forcing stragglers into one
        full refresh instead of growing forever with retired jobs)."""
        with self._lock:
            self._model_version += 1
            if name is not None:
                self._model_name_versions[name] = self._model_version
                if len(self._model_name_versions) > 100_000:
                    self._model_name_versions.clear()
                    self._model_floor = self._model_version
            else:
                # No name: everything may have moved (recovery's bulk
                # restore) — raise the floor so consumers full-refresh.
                self._model_name_versions.clear()
                self._model_floor = self._model_version

    def model_changes_since(self, version: int) -> Optional[List[str]]:
        """Names whose learned model moved after `version`, or None
        when `version` predates the prune floor (caller must
        full-refresh its working set). One locked scan of the per-name
        int map — ~µs per thousand tracked names."""
        with self._lock:
            if version < self._model_floor:
                return None
            return [n for n, v in self._model_name_versions.items()
                    if v > version]

    def _dirty(self) -> None:  # persistence hook (subclasses extend)
        self._version += 1

    def flush(self) -> None:  # persistence hook
        pass


def _job_to_dict(job: TrainingJob) -> dict:
    d = dataclasses.asdict(job)
    d["kind"] = job.kind.value
    d["status"] = job.status.value
    d["spec"]["kind"] = job.spec.kind.value
    # inf (MAX_TIME sentinels) would serialize as bare `Infinity`, which is
    # not valid JSON; clamp to a representable sentinel instead.
    for key in ("finish_time", "submit_time"):
        d[key] = _clamp_inf(d[key])
    m = d["metrics"]
    for key in ("first_start_time", "last_update_time"):
        m[key] = _clamp_inf(m[key])
    return d


_INF_SENTINEL = 1e308


def _clamp_inf(v: float) -> float:
    return _INF_SENTINEL if v == float("inf") else v


def _job_from_dict(d: dict) -> TrainingJob:
    from vodascheduler_tpu_torch.common.job import JobConfig, JobMetrics

    spec = JobSpec.from_dict(d["spec"])
    info = None
    if d.get("info") is not None:
        info = _info_from_dict(d["info"])
    return TrainingJob(
        name=d["name"], category=d["category"], spec=spec, pool=d["pool"],
        kind=JobKind(d["kind"]), user=d["user"], priority=d["priority"],
        status=JobStatus(d["status"]), submit_time=d["submit_time"],
        finish_time=d["finish_time"], config=JobConfig(**d["config"]),
        metrics=JobMetrics(**d["metrics"]), info=info,
    )


def _info_to_dict(info: JobInfo) -> dict:
    d = dataclasses.asdict(info)
    # JSON keys are strings; mark int-keyed curve dicts for round-trip
    for k in ("speedup", "efficiency", "epoch_seconds", "step_seconds"):
        d[k] = {str(n): v for n, v in d[k].items()}
    return d


def _info_from_dict(d: dict) -> JobInfo:
    d = dict(d)
    for k in ("speedup", "efficiency", "epoch_seconds", "step_seconds"):
        d[k] = {int(n): v for n, v in d.get(k, {}).items()}
    return JobInfo(**d)


class FileJobStore(JobStore):
    """JSON-file-backed store with atomic writes; survives scheduler crashes
    so `resume=True` can reconstruct state (SURVEY.md §3.6).

    autoflush=True (default) rewrites the file on every mutation — maximum
    durability, O(total jobs) per write. Trace replay and other bulk
    writers pass autoflush=False and call flush() at their own batch
    boundaries (the scheduler flushes after each resched pass)."""

    def __init__(self, path: str, autoflush: bool = True):
        super().__init__()
        self._path = path
        self._loading = False
        self.autoflush = autoflush
        self._pending = False
        if os.path.exists(path):
            self._load()

    def _load(self) -> None:
        with open(self._path) as f:
            raw = json.load(f)
        self._loading = True
        try:
            for jd in raw.get("jobs", []):
                job = _job_from_dict(jd)
                self._jobs[job.name] = job
            for idoc in raw.get("infos", []):
                info = _info_from_dict(idoc)
                self._infos.setdefault(info.category, {})[info.name] = info
                if category_of(info.name) == info.category:
                    self._info_by_name[info.name] = info
        finally:
            self._loading = False

    def _dirty(self) -> None:
        super()._dirty()
        if self._loading:
            return
        if not self.autoflush:
            self._pending = True
            return
        self._write()

    def flush(self) -> None:
        if self._pending:
            self._pending = False
            self._write()

    def _write(self) -> None:
        raw = {
            "jobs": [_job_to_dict(j) for j in self._jobs.values()],
            "infos": [_info_to_dict(i) for docs in self._infos.values()
                      for i in docs.values()],
        }
        payload = json.dumps(raw, allow_nan=False)
        d = os.path.dirname(self._path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".store-")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(payload)
            os.replace(tmp, self._path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise


# Public serialization aliases (REST allocator wire format, rest.py).
job_to_dict = _job_to_dict
job_from_dict = _job_from_dict
