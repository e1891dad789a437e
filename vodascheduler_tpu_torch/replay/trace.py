"""Workload traces: synthetic Philly-like generation + JSON round-trip.

The generator reproduces the well-known statistical shape of the Microsoft
Philly cluster traces (Jeon et al., ATC'19) that the Tiresias and AFS
papers evaluate against: heavy-tailed job durations (most jobs are short,
a few are enormous), small-chip-count mode with occasional large jobs, and
Poisson arrivals. Model categories map to the baseline configs' families
(ResNet/BERT/ViT/Llama/Mixtral; BASELINE.md configs 3-5).
"""

from __future__ import annotations

import dataclasses
import json
import math
import random
from typing import Dict, List, Optional, Sequence

from vodascheduler_tpu_torch.cluster.fake import WorkloadProfile
from vodascheduler_tpu_torch.common.job import JobConfig, JobSpec


@dataclasses.dataclass
class TraceJob:
    """One submission in a trace."""

    submit_offset_seconds: float
    model: str                 # category / model family
    min_chips: int
    max_chips: int
    epochs: int
    epoch_seconds_at_1: float  # ground-truth serial epoch time
    speedup_exponent: float = 0.9
    priority: int = 0
    fail_at_epoch: Optional[int] = None
    restart_overhead_seconds: Optional[float] = None
    # Tier-A (in-place) resize cost for this job; None falls back to the
    # backend default (restart_costs.default_inplace_seconds in replay).
    inplace_overhead_seconds: Optional[float] = None
    # Share of a contiguously-placed step spent on ICI collectives
    # (placement/comms.py FAMILY_COLLECTIVES): the simulator degrades
    # the speedup exponent by this x the job's placement spread, so
    # WHERE the job lands moves its modeled step time. 0.0 keeps the
    # job placement-insensitive (old traces load unchanged).
    comms_fraction: float = 0.0
    # Throughput share lost at full co-tenancy (placement/comms.py
    # FAMILY_INTERFERENCE): the simulator scales the rate by
    # (1 - interference_fraction x cotenancy), so WHO shares the job's
    # hosts moves its modeled step time (doc/fractional-sharing.md).
    # 0.0 keeps the job interference-insensitive (old traces load
    # unchanged).
    interference_fraction: float = 0.0

    def job_spec(self, pool: str) -> JobSpec:
        return JobSpec(
            name=self.model, pool=pool, priority=self.priority,
            model=self.model,
            config=JobConfig(min_num_chips=self.min_chips,
                             max_num_chips=self.max_chips,
                             epochs=self.epochs))

    def profile(self) -> WorkloadProfile:
        return WorkloadProfile(
            epoch_seconds_at_1=self.epoch_seconds_at_1,
            speedup_exponent=self.speedup_exponent,
            comms_fraction=self.comms_fraction,
            interference_fraction=self.interference_fraction,
            fail_at_epoch=self.fail_at_epoch,
            restart_overhead_seconds=self.restart_overhead_seconds,
            inplace_overhead_seconds=self.inplace_overhead_seconds)


# Model families with serial epoch times loosely shaped like the baseline
# configs (BASELINE.md): vision models are epoch-dominated and modest-sized;
# LLMs have huge serial work, wide elastic chip ranges (FSDP scales), and
# near-linear speedup at these scales. chip_k = (min, max) exponent range of
# the job's *maximum* chips (2^k), sampled uniformly. Restart costs are NOT
# here: they come from replay.restart_costs (measured on-chip when
# doc/resize_measured.json exists, assumed-with-provenance otherwise).
MODEL_FAMILIES: Dict[str, Dict[str, object]] = {
    "resnet50": {"epoch_seconds": 240.0, "exponent": 0.92, "weight": 0.30,
                 "chip_k": (1, 4), "epochs_base": 30},
    "bert":     {"epoch_seconds": 480.0, "exponent": 0.90, "weight": 0.25,
                 "chip_k": (2, 4), "epochs_base": 20},
    "vitl":     {"epoch_seconds": 900.0, "exponent": 0.90, "weight": 0.20,
                 "chip_k": (2, 5), "epochs_base": 15},
    "llama8b":  {"epoch_seconds": 3600.0, "exponent": 0.95, "weight": 0.15,
                 "chip_k": (4, 6), "epochs_base": 8},
    "mixtral":  {"epoch_seconds": 5400.0, "exponent": 0.93, "weight": 0.10,
                 "chip_k": (4, 6), "epochs_base": 6},
}


def philly_like_trace(
    num_jobs: int = 64,
    seed: int = 20260729,
    arrival_rate_per_hour: float = 48.0,
    max_job_chips: int = 64,
    failure_fraction: float = 0.0,
) -> List[TraceJob]:
    """Synthesize a Philly-shaped trace.

    - arrivals: Poisson process (exponential inter-arrival)
    - chip demand: family-dependent 2^k maxima with min = max/4 elastic
      range (Philly mode is small jobs; LLM families claim large slices)
    - duration: log-normal heavy tail on epoch count
    """
    from vodascheduler_tpu_torch.placement.comms import (
        fraction_for_category,
        interference_fraction_for_category,
    )
    from vodascheduler_tpu_torch.replay.restart_costs import family_restart_costs

    rng = random.Random(seed)
    # Failure marks ride their OWN stream: failure_fraction must compose
    # with the base trace (same arrivals/families/sizes, only fail_at
    # added) so a failure-injection run is comparable to the headline
    # run on the same seed — drawing from `rng` would shift every
    # subsequent sample and generate a different workload.
    fail_rng = random.Random(f"{seed}-fail")  # str-seeded: deterministic
    # across processes (tuple seeds hash with the salted str hash)
    names = list(MODEL_FAMILIES)
    weights = [float(MODEL_FAMILIES[m]["weight"]) for m in names]
    restart_costs = family_restart_costs()

    jobs: List[TraceJob] = []
    t = 0.0
    for _ in range(num_jobs):
        t += rng.expovariate(arrival_rate_per_hour / 3600.0)
        model = rng.choices(names, weights=weights)[0]
        fam = MODEL_FAMILIES[model]

        k_lo, k_hi = fam["chip_k"]  # type: ignore[misc]
        k_hi = min(k_hi, int(math.log2(max_job_chips)))
        k = rng.randint(k_lo, max(k_lo, k_hi))
        max_chips = 2 ** k
        min_chips = max(1, max_chips // 4)

        # heavy-tailed epoch count around the family base
        duration_scale = rng.lognormvariate(0.0, 0.8)
        epochs = max(1, int(round(float(fam["epochs_base"]) * duration_scale)))

        fail_at = None
        if failure_fraction > 0 and fail_rng.random() < failure_fraction:
            fail_at = max(1, epochs // 2)

        jobs.append(TraceJob(
            submit_offset_seconds=t,
            model=model,
            min_chips=min_chips,
            max_chips=max_chips,
            epochs=epochs,
            epoch_seconds_at_1=float(fam["epoch_seconds"]),
            speedup_exponent=float(fam["exponent"]),
            fail_at_epoch=fail_at,
            restart_overhead_seconds=restart_costs[model].restart_s,
            inplace_overhead_seconds=restart_costs[model].inplace_s,
            comms_fraction=fraction_for_category(model),
            interference_fraction=interference_fraction_for_category(model),
        ))
    return jobs


def topology_mix_trace(
    num_jobs: int = 48,
    seed: int = 20260803,
    arrival_rate_per_hour: float = 40.0,
    heavy_fraction: float = 0.4,
) -> List[TraceJob]:
    """The topology-sensitive workload mix (doc/placement.md): a bimodal
    stream where placement quality — not just host count — moves JCT.

    Two populations interleave:
      - filler: small short resnet50 jobs (1-2 chips, comms-light) that
        churn through the pool, punching free-slot fragments into the
        torus as they complete;
      - heavy: wide elastic llama8b/mixtral jobs (8-32 chips,
        comms_fraction 0.18-0.25) whose collectives pay for every hop
        between their hosts.

    On a fragmented torus the count-only best-fit sends a heavy job's
    growth to the TIGHTEST fragment wherever it sits; the comms-aware
    objective trades that packing tightness for contiguity in proportion
    to the job's per-step traffic. Replaying this mix with the objective
    on vs off (ReplayHarness placement_comms) under the SAME
    placement-sensitive step-time model is the bench's A/B proof row.
    """
    from vodascheduler_tpu_torch.placement.comms import (
        fraction_for_category,
        interference_fraction_for_category,
    )
    from vodascheduler_tpu_torch.replay.restart_costs import family_restart_costs

    rng = random.Random(f"{seed}-topomix")
    restart_costs = family_restart_costs()
    jobs: List[TraceJob] = []
    t = 0.0
    for _ in range(num_jobs):
        t += rng.expovariate(arrival_rate_per_hour / 3600.0)
        if rng.random() < heavy_fraction:
            model = rng.choice(("llama8b", "mixtral"))
            max_chips = rng.choice((16, 32))
            min_chips = max(8, max_chips // 4)
            epochs = rng.randint(4, 8)
        else:
            model = "resnet50"
            max_chips = rng.choice((1, 2, 2))
            min_chips = 1
            epochs = rng.randint(4, 12)
        fam = MODEL_FAMILIES[model]
        jobs.append(TraceJob(
            submit_offset_seconds=t,
            model=model,
            min_chips=min_chips,
            max_chips=max_chips,
            epochs=epochs,
            epoch_seconds_at_1=float(fam["epoch_seconds"]),
            speedup_exponent=float(fam["exponent"]),
            restart_overhead_seconds=restart_costs[model].restart_s,
            inplace_overhead_seconds=restart_costs[model].inplace_s,
            comms_fraction=fraction_for_category(model),
            interference_fraction=interference_fraction_for_category(model),
        ))
    return jobs


def mismatched_prior_trace(
    num_jobs: int = 48,
    seed: int = 20260804,
    arrival_rate_per_hour: float = 40.0,
    heavy_fraction: float = 0.4,
    heavy_comms_fraction: float = 0.5,
    filler_interference_fraction: float = 0.35,
    heavy_speedup_exponent: float = 0.65,
) -> List[TraceJob]:
    """The learned-models proof trace (doc/learned-models.md): the
    bimodal topology mix, but with the jobs' TRUE placement physics
    deliberately mis-matching the assumed family tables the prior-only
    scheduler plans with.

    - heavy llama8b/mixtral jobs really spend `heavy_comms_fraction`
      (0.5) of a contiguous step on collectives — the family tables
      assume 0.18/0.25, so the prior-only arm under-weights contiguity
      and under-prices consolidation migrations (its payback gate keeps
      deferring moves that would in fact repay);
    - filler resnet50 jobs really lose `filler_interference_fraction`
      (0.35) of throughput at full co-tenancy — the table assumes 0.08,
      so the prior-only arm packs them onto shared hosts far too
      cheaply.

    Replaying this mix with learned models ON vs OFF (ReplayHarness
    `learned_models`) under the SAME physics is the learned_models_ab
    bench row: the learned arm measures the real fractions from the
    step times it observes, re-weights placement, re-prices paybacks,
    and drift-rescheds onto the corrected model.
    """
    from vodascheduler_tpu_torch.replay.restart_costs import family_restart_costs

    rng = random.Random(f"{seed}-mismatch")
    restart_costs = family_restart_costs()
    jobs: List[TraceJob] = []
    t = 0.0
    for _ in range(num_jobs):
        t += rng.expovariate(arrival_rate_per_hour / 3600.0)
        if rng.random() < heavy_fraction:
            model = rng.choice(("llama8b", "mixtral"))
            max_chips = rng.choice((16, 32))
            min_chips = max(8, max_chips // 4)
            epochs = rng.randint(4, 8)
            comms = heavy_comms_fraction
            interference = 0.0
            exponent = heavy_speedup_exponent
        else:
            model = "resnet50"
            max_chips = rng.choice((1, 2, 2))
            min_chips = 1
            epochs = rng.randint(4, 12)
            comms = 0.0
            interference = filler_interference_fraction
            exponent = float(MODEL_FAMILIES[model]["exponent"])
        fam = MODEL_FAMILIES[model]
        jobs.append(TraceJob(
            submit_offset_seconds=t,
            model=model,
            min_chips=min_chips,
            max_chips=max_chips,
            epochs=epochs,
            epoch_seconds_at_1=float(fam["epoch_seconds"]),
            speedup_exponent=exponent,
            restart_overhead_seconds=restart_costs[model].restart_s,
            inplace_overhead_seconds=restart_costs[model].inplace_s,
            comms_fraction=comms,
            interference_fraction=interference,
        ))
    return jobs


def save_trace(jobs: Sequence[TraceJob], path: str) -> None:
    with open(path, "w") as f:
        json.dump([dataclasses.asdict(j) for j in jobs], f, indent=1)


def load_trace(path: str) -> List[TraceJob]:
    with open(path) as f:
        return [TraceJob(**d) for d in json.load(f)]
