"""Per-algorithm replay comparison: MEASURED gains, not inherited claims.

The reference README credits its algorithms with gains inherited from the
papers it cites (Tiresias, EDL, FfDL, AFS — BASELINE.md "per-algorithm
gains" row: "not reproduced in repo"). This module reproduces the
comparison for THIS framework: every registered algorithm replays the
same trace on the same simulated pool with the same knobs, through the
production scheduler/allocator/placement/collector code path, and the
table lands in doc/benchmarks.md.

Run:  python -m vodascheduler_tpu_torch.replay.compare [num_jobs] [seed]
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

from vodascheduler_tpu_torch import config
from vodascheduler_tpu_torch.algorithms import ALGORITHM_NAMES
from vodascheduler_tpu_torch.placement import PoolTopology
from vodascheduler_tpu_torch.replay.simulator import (
    PreemptionEvent,
    ReplayHarness,
    ReplayReport,
    config5_preemptions,
)
from vodascheduler_tpu_torch.replay.trace import (
    mismatched_prior_trace,
    philly_like_trace,
    topology_mix_trace,
)


def compare_algorithms(
    num_jobs: int = 64,
    seed: int = 20260729,
    algorithms: Optional[Sequence[str]] = None,
    rate_limit_seconds: float = config.RATE_LIMIT_SECONDS,
    # None -> the production defaults (config, the r5 sweep knee) via
    # ReplayHarness's own resolution — one source of truth.
    scale_out_hysteresis: Optional[float] = None,
    resize_cooldown_seconds: Optional[float] = None,
    preemptions: bool = False,
) -> List[ReplayReport]:
    """One ReplayReport per algorithm, same trace/pool/knobs for all.

    Defaults mirror bench.py's headline configuration (minus spot
    preemption, so rigid algorithms aren't additionally penalized by
    capacity dips they cannot react to — pass preemptions=True for the
    full config-5 scenario).
    """
    reports = []
    for name in (algorithms or ALGORITHM_NAMES):
        trace = philly_like_trace(num_jobs=num_jobs, seed=seed)
        topology = PoolTopology(torus_dims=(4, 4, 4), host_block=(2, 2, 1))
        events: Sequence[PreemptionEvent] = (
            config5_preemptions(topology) if preemptions else ())
        harness = ReplayHarness(
            trace, algorithm=name, topology=topology,
            rate_limit_seconds=rate_limit_seconds,
            scale_out_hysteresis=scale_out_hysteresis,
            resize_cooldown_seconds=resize_cooldown_seconds,
            preemptions=events)
        reports.append(harness.run())
    return reports


def placement_comms_ab(
    num_jobs: int = 48,
    seed: int = 20260803,
    algorithm: str = "ElasticTiresias",
    torus_dims: tuple = (4, 4, 4),
    defrag_cross_host_threshold: int = 3,
) -> Dict[str, Dict[str, object]]:
    """The topology-sensitive A/B (doc/placement.md "Proof"): replay the
    bimodal topology mix twice — comms-aware placement objective ON vs
    the count-only baseline (VODA_PLACEMENT_COMMS=0 semantics) — under
    the SAME placement-sensitive step-time model, same trace, same pool,
    same knobs. Defragmentation is on in both arms (threshold 3), so
    the run also prices consolidation migrations: the aware arm
    payback-gates each re-binding against its resharding cost and binds
    with the comms-weighted Hungarian; the count-only arm fires every
    re-binding and binds on stay-put overlap alone. Returns
    {"aware": row, "count_only": row, "win": ...}; bench.py attaches it
    as detail.placement_comms and the tier-1 guard pins that aware
    beats count-only on modeled step-time penalty AND avg JCT."""
    rows: Dict[str, Dict[str, object]] = {}
    for label, enabled in (("aware", True), ("count_only", False)):
        trace = topology_mix_trace(num_jobs=num_jobs, seed=seed)
        topology = PoolTopology(torus_dims=torus_dims, host_block=(2, 2, 1))
        harness = ReplayHarness(
            trace, algorithm=algorithm, topology=topology,
            placement_comms=enabled,
            defrag_cross_host_threshold=defrag_cross_host_threshold)
        r = harness.run()
        rows[label] = {
            "avg_jct_s": round(r.avg_jct_seconds, 1),
            "p95_jct_s": round(r.p95_jct_seconds, 1),
            "comms_penalty_mean": r.comms_penalty_mean,
            "steady_state_util": round(r.steady_state_utilization, 4),
            "completed": r.completed,
            "failed": r.failed,
            "restarts": r.restarts_total,
        }
    aware, count = rows["aware"], rows["count_only"]
    rows["win"] = {
        "jct_ratio": round(aware["avg_jct_s"] / count["avg_jct_s"], 4)
        if count["avg_jct_s"] else 1.0,
        "penalty_delta": round(count["comms_penalty_mean"]
                               - aware["comms_penalty_mean"], 4),
    }
    return rows


def fractional_sharing_ab(
    num_jobs: int = 48,
    seed: int = 20260803,
    algorithm: str = "ElasticTiresias",
    torus_dims: tuple = (4, 4, 4),
    defrag_cross_host_threshold: int = 3,
) -> Dict[str, Dict[str, object]]:
    """The fractional-sharing A/B (doc/fractional-sharing.md "Proof"):
    replay the bimodal topology mix twice — fractional sub-host sharing
    ON (the default: small jobs co-tenant host blocks, interference
    priced into placement and the step-time model) vs the whole-host-
    minimum baseline (VODA_FRACTIONAL_SHARING=0 semantics: every
    grant's capacity cost and placement footprint round up to whole
    host blocks, so sub-host jobs hold exclusive hosts) — same trace,
    same pool, same knobs, same interference-sensitive physics.

    The mix's filler class (1-2 chip resnet50 jobs) IS the eval/debug/
    fine-tune long tail: under the baseline each filler strands 2-3 of
    its host's 4 chips. Rows carry raw utilization (the stranded-
    capacity metric), the large-job (>= 8 max chips) and small-job JCT
    split, and the modeled interference price sharing pays. bench.py
    attaches this as detail.fractional_sharing; the tier-1 guard pins
    sharing >= +3 raw-utilization points at large-job JCT no worse
    than 2%."""
    rows: Dict[str, Dict[str, object]] = {}
    for label, sharing in (("sharing", True), ("whole_host", False)):
        trace = topology_mix_trace(num_jobs=num_jobs, seed=seed)
        topology = PoolTopology(torus_dims=torus_dims, host_block=(2, 2, 1))
        harness = ReplayHarness(
            trace, algorithm=algorithm, topology=topology,
            fractional_sharing=sharing,
            defrag_cross_host_threshold=defrag_cross_host_threshold)
        r = harness.run()
        large: List[float] = []
        small: List[float] = []
        for tj, name in zip(harness.trace, harness._submitted):
            job = harness.store.get_job(name)
            if job is None or job.finish_time >= 1e300:
                continue
            jct = job.finish_time - job.submit_time
            (large if tj.max_chips >= 8 else small).append(jct)
        rows[label] = {
            "raw_util": round(r.chip_utilization, 4),
            "steady_state_util": round(r.steady_state_utilization, 4),
            "avg_jct_s": round(r.avg_jct_seconds, 1),
            "large_avg_jct_s": round(sum(large) / len(large), 1)
            if large else 0.0,
            "small_avg_jct_s": round(sum(small) / len(small), 1)
            if small else 0.0,
            "interference_penalty_mean": r.interference_penalty_mean,
            "comms_penalty_mean": r.comms_penalty_mean,
            "completed": r.completed,
            "failed": r.failed,
            "restarts": r.restarts_total,
        }
    sharing, base = rows["sharing"], rows["whole_host"]
    rows["win"] = {
        # Raw-utilization points recovered from the stranded sub-host
        # remainder (the acceptance pin: >= +3 points).
        "raw_util_delta": round(sharing["raw_util"] - base["raw_util"], 4),
        # Large jobs must not pay for the tail's sharing (<= 1.02).
        "large_jct_ratio": round(
            sharing["large_avg_jct_s"] / base["large_avg_jct_s"], 4)
        if base["large_avg_jct_s"] else 1.0,
        "small_jct_ratio": round(
            sharing["small_avg_jct_s"] / base["small_avg_jct_s"], 4)
        if base["small_avg_jct_s"] else 1.0,
    }
    return rows


def learned_models_ab(
    num_jobs: int = 48,
    seed: int = 20260804,
    algorithm: str = "ElasticTiresias",
    torus_dims: tuple = (4, 4, 4),
    defrag_cross_host_threshold: int = 3,
) -> Dict[str, Dict[str, object]]:
    """The learned-models A/B (doc/learned-models.md "Proof"): replay
    the mismatched-prior mix twice — online-learned speedup & comms
    models ON (the default: the collector measures each job's real
    comms/interference fractions from observed step times, the
    scheduler's placement weights and migration payback gate consume
    the blended estimates, drift rescheds re-plan on the corrected
    model) vs the prior-only baseline (VODA_LEARNED_MODELS=0
    semantics: assumed family tables, no drift) — same trace, same
    pool, same knobs, same physics. The trace's families deliberately
    mis-match their priors (heavies twice as comms-bound as their
    table, fillers 4x as interference-bound), so the arms differ in
    exactly one thing: whether the scheduler's cost model is measured
    or assumed. bench.py attaches this as detail.learned_models; the
    tier-1 guard pins learned beating prior-only on avg JCT."""
    rows: Dict[str, Dict[str, object]] = {}
    for label, enabled in (("learned", True), ("prior_only", False)):
        trace = mismatched_prior_trace(num_jobs=num_jobs, seed=seed)
        topology = PoolTopology(torus_dims=torus_dims, host_block=(2, 2, 1))
        harness = ReplayHarness(
            trace, algorithm=algorithm, topology=topology,
            learned_models=enabled,
            defrag_cross_host_threshold=defrag_cross_host_threshold)
        r = harness.run()
        rows[label] = {
            "avg_jct_s": round(r.avg_jct_seconds, 1),
            "p95_jct_s": round(r.p95_jct_seconds, 1),
            "comms_penalty_mean": r.comms_penalty_mean,
            "interference_penalty_mean": r.interference_penalty_mean,
            "steady_state_util": round(r.steady_state_utilization, 4),
            "drift_rescheds": r.drift_rescheds_total,
            "completed": r.completed,
            "failed": r.failed,
            "restarts": r.restarts_total,
        }
    learned, prior = rows["learned"], rows["prior_only"]
    rows["win"] = {
        "jct_ratio": round(learned["avg_jct_s"] / prior["avg_jct_s"], 4)
        if prior["avg_jct_s"] else 1.0,
        "penalty_delta": round(
            (prior["comms_penalty_mean"] + prior["interference_penalty_mean"])
            - (learned["comms_penalty_mean"]
               + learned["interference_penalty_mean"]), 4),
    }
    return rows


def as_rows(reports: Sequence[ReplayReport]) -> List[Dict[str, object]]:
    return [{
        "algorithm": r.algorithm,
        "avg_jct_s": round(r.avg_jct_seconds, 1),
        "p95_jct_s": round(r.p95_jct_seconds, 1),
        "steady_state_util": round(r.steady_state_utilization, 4),
        "makespan_s": round(r.makespan_seconds, 1),
        "completed": r.completed,
        "failed": r.failed,
        "restarts": r.restarts_total,
    } for r in reports]


if __name__ == "__main__":
    import sys
    num_jobs = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 20260729
    for row in as_rows(compare_algorithms(num_jobs=num_jobs, seed=seed)):
        print(json.dumps(row), flush=True)
