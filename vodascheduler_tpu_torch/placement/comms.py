"""Communication-cost model: what a job's collectives pay for its placement.

ROADMAP item 3 (Placeto / NEST, PAPERS.md): placement quality on a TPU
torus is not "how many hosts" but "how far apart" — a job's step time
carries its per-step collective traffic over ICI links whose hop count
depends on which hosts it landed on. The training plane already knows
its collective shapes (parallel/ring_attention.py streams K/V around the
`sp` ring with one ppermute per block; parallel/pipeline.py rotates
stage activations with a CollectivePermute per tick; data/FSDP axes
all-reduce gradients every step); this module turns those shapes into a
priced, placement-sensitive cost the scheduler can optimize and the
replay simulator can charge.

Three layers, mirroring replay/restart_costs.py (measured, not assumed,
wherever a chip session has run):

- `CollectiveProfile`: per-step ICI traffic of one workload — ring
  ppermute bytes (sequence-parallel K/V streaming), pipeline p2p bytes
  (stage activation rotation), and data-parallel all-reduce bytes, all
  per chip — plus `comms_fraction`, the share of a *contiguously
  placed* step spent on ICI collectives (what spreading the job out
  multiplies; the replay model degrades the speedup exponent by
  `comms_fraction * spread`, see cluster/fake.py).
- `FAMILY_COLLECTIVES`: assumed per-family defaults for the trace
  families (same table discipline as restart_costs: a family added to
  trace.MODEL_FAMILIES without an entry here fails fast).
- `doc/ici_measured.json`: the hwbench ICI microbench artifact
  (runtime/hwbench.py `bench_ici_point`: ppermute / all-gather bytes
  per second vs ring size, captured on real hardware). When present,
  `link_gbps()` derives the effective per-hop ICI bandwidth from it;
  absent, the vendor-sheet assumption keeps the model deterministic
  with provenance="assumed".

The *placement objective* consumes none of the float pricing directly:
`weight_for_category` buckets a profile's total per-chip traffic into a
small integer weight, and the placement manager scores host sets by
`weight x contiguity_cost` — integer arithmetic, so PR 8's Hungarian
canonical-extraction and warm-start theorems keep holding (see
placement/hungarian.py module docstring: tightness is tested with ==,
exact for integer scores).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

ICI_MEASURED_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "doc", "ici_measured.json")

# Per-hop ICI link bandwidth assumption (GB/s, one direction) when no
# measured artifact exists: the v4/v5p ICI link class is ~50-100 GB/s
# per direction per link; 45 GB/s is the conservative end once protocol
# and fan-in effects are folded in. Superseded by doc/ici_measured.json
# (pooled ppermute bytes-per-second) whenever a chip session captured it.
ASSUMED_LINK_GBPS = 45.0

# One integer placement-weight unit per this much per-step-per-chip ICI
# traffic. The bucketing keeps the objective integer-scaled (the
# Hungarian theorems) and bounded (a runaway profile cannot make one
# job's comms term dwarf every consolidation term in the pool).
WEIGHT_UNIT_BYTES = 0.5e9
MAX_COMMS_WEIGHT = 16


@dataclasses.dataclass(frozen=True)
class CollectiveProfile:
    """Per-step ICI traffic of one workload, per chip.

    ring_bytes_per_chip:      sequence-parallel ring streaming (ring
                              attention ppermutes each K/V block to its
                              neighbor once per block step).
    p2p_bytes_per_chip:       pipeline stage-to-stage activation
                              rotation (spmd_pipeline's per-tick
                              CollectivePermute).
    allreduce_bytes_per_chip: data-parallel / FSDP gradient reduction
                              (a ring all-reduce moves ~2x the payload
                              past each chip).
    comms_fraction:           share of a contiguously-placed step spent
                              on ICI collectives — what spreading the
                              job across the torus multiplies. Bounded
                              [0, 0.9] on construction.
    """

    ring_bytes_per_chip: float = 0.0
    p2p_bytes_per_chip: float = 0.0
    allreduce_bytes_per_chip: float = 0.0
    comms_fraction: float = 0.0
    provenance: str = "assumed"

    def __post_init__(self) -> None:
        if not (0.0 <= self.comms_fraction <= 0.9):
            raise ValueError(
                f"comms_fraction {self.comms_fraction} outside [0, 0.9]")

    @property
    def bytes_per_chip(self) -> float:
        """Total per-step ICI bytes past one chip: the ring all-reduce
        term counts double (reduce-scatter + all-gather phases each move
        the payload once)."""
        return (self.ring_bytes_per_chip + self.p2p_bytes_per_chip
                + 2.0 * self.allreduce_bytes_per_chip)

    def weight(self) -> int:
        """Integer placement weight (0..MAX_COMMS_WEIGHT): how many
        contiguity units one hop of spread costs this job."""
        return min(MAX_COMMS_WEIGHT,
                   int(round(self.bytes_per_chip / WEIGHT_UNIT_BYTES)))


# Assumed per-family collective shapes for the trace families
# (trace.MODEL_FAMILIES). Bytes are per step per chip at the family's
# typical allocation; fractions are the comms share of a contiguous
# step. Vision families are gradient-all-reduce-dominated and small;
# the LLM families add FSDP all-gather traffic (folded into the
# allreduce term — same ring pattern) and, for the long-context
# variants, ring-attention K/V streaming; mixtral adds expert-parallel
# all-to-all (priced as p2p — neighbor-dominated under GSPMD's
# expert-sharded dispatch).
FAMILY_COLLECTIVES: Dict[str, CollectiveProfile] = {
    "resnet50": CollectiveProfile(allreduce_bytes_per_chip=0.05e9,
                                  comms_fraction=0.04),
    "bert":     CollectiveProfile(allreduce_bytes_per_chip=0.20e9,
                                  comms_fraction=0.06),
    "vitl":     CollectiveProfile(allreduce_bytes_per_chip=0.30e9,
                                  comms_fraction=0.08),
    "llama8b":  CollectiveProfile(ring_bytes_per_chip=0.50e9,
                                  allreduce_bytes_per_chip=2.00e9,
                                  comms_fraction=0.18),
    "mixtral":  CollectiveProfile(ring_bytes_per_chip=0.50e9,
                                  p2p_bytes_per_chip=1.00e9,
                                  allreduce_bytes_per_chip=2.50e9,
                                  comms_fraction=0.25),
}


# Assumed per-family co-tenant interference fractions
# (doc/fractional-sharing.md): the throughput share a job loses when
# its hosts are FULLY co-tenant (shared HBM bandwidth, host CPU input
# pipelines, intra-host ICI hops through a partitioned block). Small
# vision jobs — the fractional long tail — are input-pipeline- and
# HBM-bound, so they interfere hardest per chip; the LLM families are
# compute-dominated on their own whole hosts and barely notice a
# neighbor. Same table-sync discipline as FAMILY_COLLECTIVES: a family
# added to trace.MODEL_FAMILIES without an entry here fails
# sanity_check_families().
FAMILY_INTERFERENCE: Dict[str, float] = {
    "resnet50": 0.08,
    "bert":     0.06,
    "vitl":     0.05,
    "llama8b":  0.03,
    "mixtral":  0.03,
}

# One integer interference-weight unit per this much interference
# fraction, capped — the same integer-bucketing posture as the comms
# weight (keeps the _pick_host pricing integer and bounded).
INTERFERENCE_WEIGHT_UNIT = 0.02
MAX_INTERFERENCE_WEIGHT = 8


# Learned-fraction weight unit (doc/learned-models.md): for a job with
# NO family byte profile, one integer placement-weight unit per this
# much learned comms fraction. Calibrated against the family tables
# (llama8b: 9 byte-units at fraction 0.18 ~= 0.02/unit), so a learned
# weight and a byte-derived weight price a hop comparably.
LEARNED_FRACTION_WEIGHT_UNIT = 0.02


def learned_weight(profile: Optional["CollectiveProfile"],
                   fraction: float) -> int:
    """Integer placement weight under a LEARNED effective comms
    fraction (doc/learned-models.md): the family's byte-derived weight
    rescaled by measured/assumed fraction when a byte profile exists
    (the bytes are the best traffic shape we have; the fraction is what
    measurement corrects), else derived from the fraction alone at the
    calibrated unit. Same cap as the static path — the Hungarian
    integer-score theorems (PR 8) hold unchanged, learned weights are
    just different integers."""
    if fraction <= 0.0:
        return 0
    if profile is not None and profile.comms_fraction > 0.0:
        # Rescale the RAW bytes, then bucket: rescaling the already-
        # rounded integer weight would pin a light family (byte weight
        # 0) at 0 no matter how chatty the job measured.
        scaled_bytes = (profile.bytes_per_chip * fraction
                        / profile.comms_fraction)
        return min(MAX_COMMS_WEIGHT,
                   int(round(scaled_bytes / WEIGHT_UNIT_BYTES)))
    return min(MAX_COMMS_WEIGHT,
               int(round(fraction / LEARNED_FRACTION_WEIGHT_UNIT)))


def interference_weight_from_fraction(fraction: float) -> int:
    """Integer interference weight from a (learned or assumed)
    interference fraction — the one bucketing rule, shared by the
    static table path and the learned path."""
    return min(MAX_INTERFERENCE_WEIGHT,
               int(round(max(0.0, fraction) / INTERFERENCE_WEIGHT_UNIT)))


def interference_fraction_for_category(category: str) -> float:
    """The co-tenant interference fraction of a job category; 0.0 when
    unknown (interference-free, the pre-fractional physics)."""
    return FAMILY_INTERFERENCE.get(category, 0.0)


def interference_weight_for_category(category: str) -> int:
    """Integer placement interference weight (0..MAX_INTERFERENCE_WEIGHT):
    how much one foreign chip on a shared host costs this job in the
    _pick_host pricing (placement/manager.py)."""
    return interference_weight_from_fraction(
        interference_fraction_for_category(category))


def profile_for_category(category: str) -> Optional[CollectiveProfile]:
    """The collective profile of a job category (name minus timestamp),
    or None for workloads with no declared/known shape (their placement
    weight is 0 — count-only semantics, exactly the old behavior)."""
    return FAMILY_COLLECTIVES.get(category)


_DESCRIPTOR_FIELDS = ("ring_bytes_per_chip", "p2p_bytes_per_chip",
                      "allreduce_bytes_per_chip", "comms_fraction")


def profile_from_descriptor(descriptor: Dict[str, Any]
                            ) -> CollectiveProfile:
    """Build a profile from a job spec's `collectives` descriptor
    (common/job.py JobSpec): known fields only, everything else
    ignored; CollectiveProfile's own validation bounds the fraction.
    Raises on non-numeric values — admission-time garbage should fail
    loudly, not place as weight 0."""
    kwargs = {k: float(descriptor[k]) for k in _DESCRIPTOR_FIELDS
              if k in descriptor}
    return CollectiveProfile(provenance="spec", **kwargs)


def profile_for_job(spec_collectives: Optional[Dict[str, Any]],
                    category: str) -> Optional[CollectiveProfile]:
    """Per-job profile resolution (doc/placement.md): an explicit spec
    descriptor wins; otherwise the category's model family; otherwise
    None (count-only). A malformed descriptor falls back to the family
    default rather than wedging a scheduling pass."""
    if spec_collectives:
        try:
            return profile_from_descriptor(spec_collectives)
        except (TypeError, ValueError, KeyError):
            pass
    return profile_for_category(category)


def weight_for_category(category: str) -> int:
    """Integer placement weight for a category; 0 when unknown."""
    profile = profile_for_category(category)
    return 0 if profile is None else profile.weight()


def weights_for_categories(categories: Sequence[str]) -> List[int]:
    """Vectorized-shape batch weight lookup: one memo per distinct
    category, so a 10k-job fleet costs its distinct-category count, not
    its job count (the perf_scale placement-scoring column times this)."""
    memo: Dict[str, int] = {}
    out: List[int] = []
    for cat in categories:
        w = memo.get(cat)
        if w is None:
            w = memo[cat] = weight_for_category(cat)
        out.append(w)
    return out


def fraction_for_category(category: str) -> float:
    profile = profile_for_category(category)
    return 0.0 if profile is None else profile.comms_fraction


# ---- measured ICI bandwidth (the hwbench derivation idiom) -----------------


def load_ici_measured(path: Optional[str] = None
                      ) -> Optional[List[Dict[str, Any]]]:
    """The checked-in ICI microbench artifact, or None when not yet
    captured. Points come from runtime/hwbench.py `bench_ici_point`
    (captured via the benchrunner like every other hardware row)."""
    p = path or ICI_MEASURED_PATH
    if not os.path.exists(p):
        return None
    with open(p) as f:
        doc = json.load(f)
    points = [r for r in doc.get("points", [])
              if r.get("ppermute_gbps") and r.get("ring_size")]
    return points or None


def derive_link_gbps(points: List[Dict[str, Any]]) -> float:
    """Effective per-hop ICI bandwidth from measured ppermute points:
    the ring-size-weighted mean of per-point bytes/second (bigger rings
    sample more links, so they weigh more) — one pooled number, same
    posture as restart_costs' pooled io_rate."""
    num = den = 0.0
    for p in points:
        w = float(p["ring_size"])
        num += w * float(p["ppermute_gbps"])
        den += w
    if den <= 0:
        raise ValueError("no usable ICI points")
    return num / den


def link_gbps(path: Optional[str] = None) -> Tuple[float, str]:
    """(per-hop ICI GB/s, provenance): measured-derived when the
    artifact exists, else the vendor-sheet assumption."""
    points = load_ici_measured(path)
    if points:
        devices = ",".join(dict.fromkeys(
            str(p.get("device_kind", "?")) for p in points))
        return derive_link_gbps(points), f"measured:{devices}"
    return ASSUMED_LINK_GBPS, "assumed"


def comms_seconds_per_step(topology, coords: Sequence[Tuple[int, ...]],
                           profile: CollectiveProfile,
                           gbps: Optional[float] = None) -> float:
    """Modeled per-step ICI seconds for a job occupying `coords` on
    `topology`: the profile's per-chip traffic carried over the job's
    mean inter-host hop distance at the per-hop link bandwidth. A
    single-host job pays only intra-host ICI (hop distance 0 at host
    granularity) — the model prices the *placement-sensitive* part,
    which is exactly what the objective minimizes."""
    spread_hops = topology.mean_hop_distance(coords)
    if spread_hops <= 0.0:
        return 0.0
    if gbps is None:
        gbps = link_gbps()[0]
    return profile.bytes_per_chip * spread_hops / (gbps * 1e9)


def sanity_check_families() -> None:
    """FAMILY_COLLECTIVES must cover exactly the trace families — the
    restart_costs table-sync discipline (a new family needs entries in
    every pricing table or every replay KeyErrors)."""
    from vodascheduler_tpu_torch.replay.trace import MODEL_FAMILIES

    if set(MODEL_FAMILIES) != set(FAMILY_COLLECTIVES):
        raise ValueError(
            "comms families out of sync: trace.MODEL_FAMILIES vs "
            "comms.FAMILY_COLLECTIVES — a new family needs a collective "
            "profile (placement/comms.py)")
    if set(MODEL_FAMILIES) != set(FAMILY_INTERFERENCE):
        raise ValueError(
            "interference families out of sync: trace.MODEL_FAMILIES vs "
            "comms.FAMILY_INTERFERENCE — a new family needs a co-tenant "
            "interference fraction (placement/comms.py, "
            "doc/fractional-sharing.md)")
