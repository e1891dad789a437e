"""Learned-model math: online refinement of speedup and comms models
(doc/learned-models.md).

Every model the scheduler optimizes against started as a prior: speedup
curves default to the shared linear prior, comms/interference profiles
are assumed per-family tables (placement/comms.py). Placeto and NEST
(PAPERS.md) both show measured cost models beat static ones for
placement decisions; this module holds the estimation math the metrics
collector applies to the step times the system already observes — at
each (size, placement-spread, co-tenancy) a job actually ran.

All estimators are closed-form over measurements, recomputed from the
full row history each collection pass — no estimate ever feeds back
into itself across passes (the anchor-spiral class the collector's
docstring warns about cannot occur), and a collector restart rebuilds
the same state from the same rows.

- `fit_serial_seconds`: the inferred 1-chip epoch time. With one
  measured count the linear anchor stands (t1 ~= t[m] * m); with two
  or more DISTINCT counts a log-log least-squares power-law fit
  (speedup(n) ~= n^e, e clamped to [0, 1]) anchors through the
  measured scaling instead — the sub-host fix: a min>1 job whose
  counts are non-power-of-2 partitions refines its serial estimate
  from exactly the counts it ran, where the old linear anchor stayed
  prior-biased until a real 1-chip row arrived (which a min>1 job
  never produces).

- `estimate_comms_fraction` / `estimate_interference_fraction`:
  identification comes from VARIATION, not from an assumed contiguous
  baseline (a min-8-chip job on 4-chip hosts never runs contiguous, so
  a baseline-dependent estimator would never engage). Each count's
  least-burdened observation bucket is the reference; an observation
  at higher spread (or co-tenancy) then identifies the fraction by
  inverting the cost model the placement objective and the step-time
  simulator share:

      t(sigma) / t(ref) = speedup(n) ** (f * (sigma - sigma_ref))
      t(c)     / t(ref) = (1 - fi*c_ref) / (1 - fi*c)

Estimates accumulate as recency-weighted means (`decayed_weight`):
each observation's weight halves per `MODEL_HALF_LIFE_SECONDS`, so a
workload whose behavior shifted re-learns instead of averaging against
stale history forever. Consumers never read the raw estimate: `blend`
pulls it toward the family prior through the confidence curve
w = weight / (weight + MODEL_CONFIDENCE_K), so a single noisy epoch
cannot flip placement policy.

Drift: `drift_exceeds_band` judges the recency-weighted
measured/modeled ratio against [1/band, band]; the collector fires one
audited `model_drift_detected` resched per drift episode when it
trips.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from vodascheduler_tpu_torch import config

# Minimum spread / co-tenancy DELTA vs the reference bucket before an
# observation identifies a fraction: the estimators divide by it, and a
# tiny denominator amplifies noise into garbage fractions.
MIN_DELTA = 0.05

# Estimated fractions are clamped to the CollectiveProfile bound: the
# placement objective and the step-time model both treat 0.9 as the
# physical ceiling (a step cannot be >90% collectives and still step).
MAX_FRACTION = 0.9

# Minimum effective samples before the drift band may fire: the first
# ingestion after a resize legitimately mispredicts once.
DRIFT_MIN_WEIGHT = 3.0


def decayed_weight(age_seconds: float,
                   half_life: Optional[float] = None) -> float:
    """One observation's recency weight: 1.0 fresh, halving per
    half-life. Negative ages (clock skew) count as fresh."""
    hl = config.MODEL_HALF_LIFE_SECONDS if half_life is None else half_life
    if age_seconds <= 0.0 or hl <= 0.0:
        return 1.0
    return 0.5 ** (age_seconds / hl)


def blend(prior: float, estimate: float, weight: float,
          confidence_k: Optional[float] = None) -> float:
    """Confidence-blended value: prior until observed, estimate once
    confident — prior + w/(w+K) * (estimate - prior)."""
    if weight <= 0.0:
        return prior
    k = config.MODEL_CONFIDENCE_K if confidence_k is None else confidence_k
    return prior + (weight / (weight + k)) * (estimate - prior)


def fit_serial_seconds(epoch_seconds: Dict[int, float]
                       ) -> Optional[Tuple[float, float]]:
    """(inferred 1-chip epoch time, fitted exponent) from the measured
    per-count means, or None with no usable measurements.

    - a real 1-chip measurement is authoritative (exponent still
      fitted for model extrapolation);
    - one distinct count: linear anchor (t1 = t[m] * m, e = 1) — the
      pre-fit behavior, still exact for the linear prior;
    - two+ distinct counts: least-squares fit of ln t = ln t1 - e ln n
      with e clamped to [0, 1] (TPU scaling is sublinear; a clamped
      fit stays sane under noise), then t1 from the fitted intercept.
    """
    measured = [(n, t) for n, t in epoch_seconds.items() if n > 0 and t > 0]
    if not measured:
        return None
    if len({n for n, _ in measured}) == 1:
        m, t = min(measured)
        return (t if m == 1 else t * float(m)), 1.0
    xs = [math.log(float(n)) for n, _ in measured]
    ys = [math.log(t) for _, t in measured]
    k = float(len(measured))
    mean_x = sum(xs) / k
    mean_y = sum(ys) / k
    var_x = sum((x - mean_x) ** 2 for x in xs)
    slope = sum((x - mean_x) * (y - mean_y)
                for x, y in zip(xs, ys)) / var_x
    e = min(1.0, max(0.0, -slope))
    # Intercept re-derived at the CLAMPED exponent (the unclamped
    # intercept would pair with a slope we refused to use), and a real
    # 1-chip measurement overrides the extrapolation.
    t1 = math.exp(mean_y + e * mean_x)
    if epoch_seconds.get(1, 0.0) > 0:
        t1 = epoch_seconds[1]
    return t1, e


def modeled_speedup(n: int, serial_fit: Tuple[float, float],
                    measured: Dict[int, float]) -> float:
    """Modeled speedup at n chips relative to the fitted serial time:
    the measured per-count mean when this count was observed
    (t1 / t[n]), else the fitted power law n^e. 0 for n <= 0."""
    if n <= 0:
        return 0.0
    t1, e = serial_fit
    t = measured.get(n, 0.0)
    if t > 0:
        return t1 / t
    return float(n) ** e


def estimate_comms_fraction(t_obs: float, t_ref: float, speedup: float,
                            dspread: float) -> Optional[float]:
    """Effective comms fraction from one observation at `dspread` more
    placement spread than its count's reference bucket (see module
    doc); None when unestimable (delta/speedup too small, or the
    observation implies super-ideal throughput)."""
    if dspread < MIN_DELTA or speedup <= 1.02 or t_obs <= 0 or t_ref <= 0:
        return None
    f = math.log(t_obs / t_ref) / (math.log(speedup) * dspread)
    return min(MAX_FRACTION, max(0.0, f))


def estimate_interference_fraction(t_obs: float, t_ref: float,
                                   cotenancy: float, cot_ref: float
                                   ) -> Optional[float]:
    """Effective interference fraction from one observation at higher
    co-tenancy than its count's reference bucket (see module doc);
    None when unestimable."""
    if cotenancy - cot_ref < MIN_DELTA or t_obs <= 0 or t_ref <= 0:
        return None
    big_r = t_obs / t_ref
    denom = big_r * cotenancy - cot_ref
    if denom <= 0:
        return None
    fi = (big_r - 1.0) / denom
    return min(MAX_FRACTION, max(0.0, fi))


def drift_exceeds_band(ratio: float, weight: float,
                       band: Optional[float] = None) -> bool:
    """Whether the recency-weighted measured/modeled ratio has left the
    drift band [1/band, band] with enough effective samples to trust
    it."""
    if weight < DRIFT_MIN_WEIGHT or ratio <= 0.0:
        return False
    b = config.MODEL_DRIFT_BAND if band is None else band
    if b <= 1.0:
        return False
    return ratio > b or ratio < 1.0 / b
