"""Training-job model: config, time metrics, speedup info, and the job record.

Reference counterpart: pkg/common/trainingjob/trainingjob.go. Differences are
deliberate TPU-first redesigns:

- Speedup/efficiency curves are keyed by *int* chip count (the reference keys
  Mongo maps by strings, trainingjob.go:167-187; the string keying was a BSON
  artifact, not a design choice).
- The job spec is a native `JobSpec` dataclass (model name, dataset, chip
  bounds, epochs, priority) rather than a full Kubernetes MPIJob manifest
  parsed for env vars (trainingjob.go:81-149).
- Durations are floats in seconds against an injected Clock, so the whole
  model works under simulated time.
"""

from __future__ import annotations

import dataclasses
import re
import time as _time
from typing import Dict, Optional

from vodascheduler_tpu_torch.common.types import MAX_TIME, JobKind, JobStatus

# Speedup prior extends to this many chips. Reference: maxNumGpu = 32
# (trainingjob.go:13); TPU pods are bigger, so default higher.
MAX_NUM_CHIPS = 256

_TIMESTAMP_RE = re.compile(r"-\d{8}-\d{6}$")

# Resource classes (doc/fractional-sharing.md): how a job's grant maps
# onto host hardware. A WHOLE_HOST job schedules at the pool's classic
# slice-shape granularity; a FRACTIONAL job is a sub-host tenant — its
# grant is a static chip-partition of ONE host block, co-resident with
# other fractional tenants. AUTO resolves from the job's ceiling: a job
# that can never fill a host (max_num_chips < chips_per_host) is the
# eval/debug/fine-tune long tail fractional sharing exists for.
RESOURCE_CLASS_AUTO = "auto"
RESOURCE_CLASS_FRACTIONAL = "fractional"
RESOURCE_CLASS_WHOLE_HOST = "whole_host"
RESOURCE_CLASSES = (RESOURCE_CLASS_AUTO, RESOURCE_CLASS_FRACTIONAL,
                    RESOURCE_CLASS_WHOLE_HOST)


def resolve_resource_class(spec_class: str, max_chips: int,
                           chips_per_host: int) -> str:
    """The job's effective resource class on a pool with
    `chips_per_host`-chip host blocks: an explicit spec class wins;
    AUTO (or anything unknown — admission validates, but old stored
    specs predate the field) derives from whether the job's ceiling
    fits under one host block."""
    if spec_class == RESOURCE_CLASS_FRACTIONAL:
        return RESOURCE_CLASS_FRACTIONAL
    if spec_class == RESOURCE_CLASS_WHOLE_HOST:
        return RESOURCE_CLASS_WHOLE_HOST
    return (RESOURCE_CLASS_FRACTIONAL
            if 0 < max_chips < chips_per_host
            else RESOURCE_CLASS_WHOLE_HOST)


def category_of(job_name: str) -> str:
    """Job 'category' = name minus the submission timestamp suffix.

    Repeat submissions of the same workload share learned speedup curves via
    their category. Reference: metrics_collector.py:66-68 and
    service/handlers.go:74-76.
    """
    return _TIMESTAMP_RE.sub("", job_name)


def timestamped_name(base: str, now: Optional[float] = None) -> str:
    """`<base>-YYYYMMDD-HHMMSS`, as the admission service names jobs.

    Reference: service/handlers.go:85-88.
    """
    t = _time.localtime(now if now is not None else _time.time())
    return f"{base}-{_time.strftime('%Y%m%d-%H%M%S', t)}"


@dataclasses.dataclass(slots=True)
class JobConfig:
    """User-requested elasticity bounds. Reference: JobConfig
    (trainingjob.go:34-40); num/min/max procs become chip counts."""

    num_chips: int = 0       # requested; 0 = unset, defaults to min_num_chips
    min_num_chips: int = 1   # floor for elastic allocation
    max_num_chips: int = 1   # ceiling for elastic allocation
    epochs: int = 1

    def __post_init__(self) -> None:
        if self.num_chips == 0:
            self.num_chips = self.min_num_chips
        if not (0 < self.min_num_chips <= self.max_num_chips):
            raise ValueError(
                f"invalid chip bounds: min={self.min_num_chips} max={self.max_num_chips}"
            )
        if not (self.min_num_chips <= self.num_chips <= self.max_num_chips):
            raise ValueError(
                f"num_chips={self.num_chips} outside [{self.min_num_chips}, {self.max_num_chips}]"
            )


@dataclasses.dataclass(slots=True)
class JobMetrics:
    """Cumulative + windowed time accounting driving Tiresias promote/demote
    and the status tables. Reference: JobMetrics (trainingjob.go:43-58).

    The `last_*` windows reset when the job's allocation flips between zero
    and nonzero; `last_chip_seconds` crossing the Tiresias queue threshold
    demotes, `last_waiting >= promote_knob * last_running` promotes
    (scheduler.go:787-802).
    """

    running_seconds: float = 0.0
    waiting_seconds: float = 0.0
    chip_seconds: float = 0.0    # Σ (seconds × allocated chips); "GPU time" in reference
    total_seconds: float = 0.0

    last_running_seconds: float = 0.0
    last_waiting_seconds: float = 0.0
    last_chip_seconds: float = 0.0

    # Running time since the last checkpoint-restart of ANY kind — start
    # AND resize reset it (unlike last_running_seconds, which only resets
    # on zero<->nonzero flips). Drives the ElasticTiresias preemption
    # lease: "restarted recently" must include restarted-by-resize, or a
    # just-resized job could be evicted back-to-back.
    seconds_since_restart: float = 0.0

    first_start_time: float = MAX_TIME
    last_update_time: float = 0.0


@dataclasses.dataclass(slots=True)
class JobInfo:
    """Learned performance profile consumed by info-needing algorithms
    (SRJF, ElasticSRJF, ElasticTiresias, FfDLOptimizer, AFS-L).

    Reference: JobInfo (trainingjob.go:61-68) + the Mongo job_info document
    (mongo.go:22-35). Curves are keyed by chip count.
    """

    name: str = ""
    category: str = ""
    pool: str = ""  # reference: GpuType; here the TPU pool/slice-type name
    estimated_remaining_seconds: float = 0.0
    speedup: Dict[int, float] = dataclasses.field(default_factory=dict)
    efficiency: Dict[int, float] = dataclasses.field(default_factory=dict)
    # Raw learned timings (metrics collector writes these; mongo.go:27-30)
    epoch_seconds: Dict[int, float] = dataclasses.field(default_factory=dict)
    step_seconds: Dict[int, float] = dataclasses.field(default_factory=dict)
    current_epoch: int = -1
    remaining_epochs: int = 0
    # --- learned-model plane (doc/learned-models.md) ---------------------
    # Online-estimated effective comms/interference fractions with their
    # recency-decayed observation weights (metricscollector/learned.py):
    # raw EWMA estimates — consumers blend them against the family prior
    # through the confidence curve (learned.blend), so a single noisy
    # epoch can't flip placement policy. weight 0.0 = never observed.
    comms_fraction_est: float = 0.0
    comms_fraction_weight: float = 0.0
    interference_fraction_est: float = 0.0
    interference_fraction_weight: float = 0.0
    # EWMA measured/modeled step-time ratio (1.0 = the model predicts
    # the job perfectly) and its observation weight — what the
    # voda_job_model_drift_ratio gauge exports and the drift band
    # judges.
    model_drift_ratio: float = 1.0
    model_drift_weight: float = 0.0
    # Clock timestamp of the last learned-model update (recency decay
    # anchors here) and a monotonic per-doc stamp consumers use to
    # invalidate derived caches (the scheduler's weight memos).
    model_stamp: float = 0.0
    model_version: int = 0

    def speedup_at(self, n: int) -> float:
        return self.speedup.get(n, 0.0)


def base_job_info(name: str, category: str, pool: str,
                  max_chips: int = MAX_NUM_CHIPS) -> JobInfo:
    """Linear-speedup prior for jobs with no history yet.

    Reference: NewBaseJobInfo (trainingjob.go:167-187): speedup[n]=n,
    efficiency[n]=1 for n in 1..max+1, speedup[0]=0.
    """
    speedup = {0: 0.0}
    efficiency = {0: 0.0}
    for n in range(1, max_chips + 2):
        speedup[n] = float(n)
        efficiency[n] = 1.0
    return JobInfo(name=name, category=category, pool=pool,
                   estimated_remaining_seconds=0.0,
                   speedup=speedup, efficiency=efficiency)


# The linear prior's curves are identical for every fresh job; these
# shared, treat-as-immutable dicts back `shared_base_job_info` so a
# 100k-job fleet admission seeds two dict REFERENCES per job instead of
# two ~500-entry dicts per job (whose eventual gen-2 GC pause lands
# inside a later decide window — the PR 8 finding, recurring at fleet
# scale through the admission seeding path). The metrics collector — the
# one in-place curve mutator in the tree — rebinds fresh copies before
# its first write (copy-on-write), so sharing can never cross-contaminate
# jobs.
_SHARED_PRIOR = base_job_info("", "", "")


def shared_base_job_info(name: str, category: str, pool: str) -> JobInfo:
    """A fresh job's linear-speedup prior with SHARED curve dicts (see
    _SHARED_PRIOR). Use for bulk seeding; callers that intend to mutate
    curves in place must copy them first."""
    return JobInfo(name=name, category=category, pool=pool,
                   estimated_remaining_seconds=0.0,
                   speedup=_SHARED_PRIOR.speedup,
                   efficiency=_SHARED_PRIOR.efficiency)


@dataclasses.dataclass
class JobSpec:
    """Native job specification submitted by the user (YAML/JSON/dataclass).

    Replaces the reference's Kubernetes MPIJob manifest: instead of a pod
    template with `horovodrun` args and config env vars, the user names a
    model/workload and elasticity bounds; the runtime owns process launch.
    """

    name: str                      # base name; admission appends a timestamp
    pool: str = "default"          # TPU pool (reference: GPU type nodeSelector)
    kind: JobKind = JobKind.JAX_JOB
    config: JobConfig = dataclasses.field(default_factory=JobConfig)
    priority: int = 0
    user: str = ""
    # Workload description for the native runtime:
    model: str = "mnist_mlp"       # key into models.registry
    dataset: str = "synthetic"
    global_batch_size: int = 128
    steps_per_epoch: int = 100
    workdir: str = ""              # checkpoints + metrics CSVs live here
    # Optional collective-traffic descriptor (doc/placement.md): keys
    # from placement/comms.py CollectiveProfile (ring_bytes_per_chip,
    # p2p_bytes_per_chip, allreduce_bytes_per_chip, comms_fraction).
    # None = derive from the job's category's model family. Drives the
    # bandwidth-aware placement objective and migration pricing.
    collectives: Optional[Dict[str, float]] = None
    # Resource class (doc/fractional-sharing.md): "auto" (default —
    # fractional iff max_num_chips < the pool's chips_per_host),
    # "fractional" (sub-host static chip-partition, co-tenant with
    # other fractional jobs), or "whole_host" (classic slice-shape
    # granularity). Resolved per pool by resolve_resource_class.
    resource_class: str = RESOURCE_CLASS_AUTO
    extra: Dict[str, str] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["kind"] = self.kind.value
        return d

    @staticmethod
    def from_dict(d: dict) -> "JobSpec":
        d = dict(d)
        if "kind" in d:
            d["kind"] = JobKind(d["kind"])
        if "config" in d and isinstance(d["config"], dict):
            d["config"] = JobConfig(**d["config"])
        return JobSpec(**d)


@dataclasses.dataclass
class TrainingJob:
    """The central job record owned by the scheduler and persisted in the
    store. Reference: TrainingJob (trainingjob.go:17-31)."""

    name: str
    category: str
    spec: JobSpec
    pool: str = "default"
    kind: JobKind = JobKind.JAX_JOB
    user: str = ""
    priority: int = 0
    status: JobStatus = JobStatus.SUBMITTED
    submit_time: float = 0.0
    finish_time: float = MAX_TIME
    config: JobConfig = dataclasses.field(default_factory=JobConfig)
    metrics: JobMetrics = dataclasses.field(default_factory=JobMetrics)
    # Filled by the resource allocator during rescheduling when the active
    # algorithm needs it (reference: Info nil until allocator loads it).
    info: Optional[JobInfo] = None

    @staticmethod
    def from_spec(spec: JobSpec, submit_time: float, name: Optional[str] = None) -> "TrainingJob":
        """Build the job record from a (timestamp-named) spec.

        Reference: NewTrainingJob (trainingjob.go:69-149), minus the env-var
        excavation — the spec is already structured.
        """
        jobname = name or spec.name
        return TrainingJob(
            name=jobname,
            category=category_of(jobname),
            spec=spec,
            pool=spec.pool,
            kind=spec.kind,
            user=spec.user,
            priority=spec.priority,
            status=JobStatus.SUBMITTED,
            submit_time=submit_time,
            finish_time=MAX_TIME,
            config=dataclasses.replace(spec.config),
            metrics=JobMetrics(last_update_time=submit_time),
            info=None,
        )
