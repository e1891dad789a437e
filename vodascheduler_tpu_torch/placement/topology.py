"""TPU pool topology: hosts, chips, and ICI slice shapes.

The reference models capacity as fungible GPUs per node
(`nvidia.com/gpu` capacity, placement/utils.go:20-54). TPU capacity is not
fungible the same way: chips sit on an ICI torus, hosts own fixed sub-blocks
of it (e.g. a v4/v5p host = 2x2x1 = 4 chips), and a job's collective
performance depends on whether its chips form a contiguous sub-torus.

This module gives the framework a first-class topology vocabulary:

- `SliceShape`: an axis-shape tuple (e.g. (2, 2, 1)) with chip count.
- feasible_shapes(n, topology): the contiguous sub-torus shapes of n chips
  available inside a given pool torus — what the allocator's chip counts
  must map onto.
- `PoolTopology`: the pool's torus dims, host block size, and host grid,
  with distance/contiguity scoring used by the placement manager.

Generalizes across TPU generations: v4/v5p are 3D tori with 4-chip hosts;
v5e/v6e are 2D meshes with 1/4/8-chip hosts. The defaults model a v5p-like
3D torus.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class SliceShape:
    """A contiguous sub-torus, e.g. (4, 4, 4) = 64 chips on a 3D torus."""

    dims: Tuple[int, ...]

    @property
    def num_chips(self) -> int:
        return math.prod(self.dims)

    def __str__(self) -> str:
        return "x".join(str(d) for d in self.dims)

    @staticmethod
    def parse(s: str) -> "SliceShape":
        return SliceShape(tuple(int(d) for d in s.split("x")))


def _divisor_shapes(n: int, max_dims: Sequence[int]) -> List[Tuple[int, ...]]:
    """All factorizations of n into len(max_dims) factors with factor i
    bounded by max_dims[i]."""
    ndim = len(max_dims)
    results = []

    def rec(prefix: Tuple[int, ...], remaining: int) -> None:
        axis = len(prefix)
        if axis == ndim - 1:
            if remaining <= max_dims[axis]:
                results.append(prefix + (remaining,))
            return
        for d in range(1, min(remaining, max_dims[axis]) + 1):
            if remaining % d == 0:
                rec(prefix + (d,), remaining // d)

    rec((), n)
    return results


def feasible_shapes(num_chips: int, torus_dims: Sequence[int]) -> List[SliceShape]:
    """Contiguous sub-torus shapes for `num_chips` inside `torus_dims`,
    best (most compact) first.

    Compactness = lower surface-to-volume; compact slices keep collective
    hops short on ICI. Power-of-two chip counts on power-of-two tori always
    have a feasible shape; other counts may not (the allocation path rounds
    chip counts to feasible ones via round_to_feasible)."""
    shapes = [SliceShape(t) for t in _divisor_shapes(num_chips, torus_dims)]
    # Sort by perimeter (sum of dims): the most cube-like first.
    shapes.sort(key=lambda s: (sum(s.dims), max(s.dims)))
    # Dedup up to permutation order preserved (a 2x1x1 and 1x2x1 both kept:
    # orientation matters when packing a real torus).
    return shapes


class FeasibleTable:
    """Precomputed feasibility of every chip count 0..total_chips for
    one (torus_dims, host_block) pool shape — the decide-path kernel
    behind round_to_feasible / next_feasible_above / is_feasible_count.

    The scan-based primitives below (`_is_feasible_scan` et al.) pay a
    factorization enumeration per probe and, for the rounding helpers,
    a probe per candidate count; under `enforce_feasibility` that ran
    on every grant of every pass while the scheduler lock was held.
    A pool shape's feasibility is static, so one upfront sweep turns
    all three into array lookups. Tables are cached per shape
    (`FeasibleTable.for_topology`); the scan primitives remain the
    differential-test oracles (tests/test_fastpath_oracle.py).
    """

    __slots__ = ("total", "feasible", "round_down", "next_at",
                 "chips_per_host", "frac_feasible", "frac_round_down",
                 "frac_next_at")

    def __init__(self, torus_dims: Tuple[int, ...],
                 host_block: Tuple[int, ...]) -> None:
        total = math.prod(torus_dims)
        cph = math.prod(host_block)
        host_grid = tuple(t // h for t, h in zip(torus_dims, host_block))
        feasible = [False] * (total + 1)
        feasible[0] = True
        for n in range(1, total + 1):
            if n < cph:
                feasible[n] = bool(_divisor_shapes(n, host_block))
            else:
                feasible[n] = (n % cph == 0
                               and bool(_divisor_shapes(n // cph, host_grid)))
        # Fractional twin (doc/fractional-sharing.md): a FRACTIONAL job's
        # sub-host grant is a static chip-partition of one host block,
        # not a contiguous sub-torus — every chip of a host block is at
        # most one intra-host ICI hop from every other, so ANY count
        # 1..chips_per_host-1 partitions cleanly (a 3-chip partition of a
        # 2x2 block is fine; only multi-host slices need torus shapes).
        # At or above one host the classic whole-host table applies
        # unchanged.
        frac_feasible = [n < cph or feasible[n]
                         for n in range(total + 1)]
        round_down = [0] * (total + 1)
        frac_round_down = [0] * (total + 1)
        best = frac_best = 0
        for n in range(1, total + 1):
            if feasible[n]:
                best = n
            if frac_feasible[n]:
                frac_best = n
            round_down[n] = best
            frac_round_down[n] = frac_best
        # next_at[k] = smallest feasible count >= k (k in 0..total);
        # None past the pool's largest feasible count.
        next_at: List[Optional[int]] = [None] * (total + 1)
        frac_next_at: List[Optional[int]] = [None] * (total + 1)
        nxt: Optional[int] = None
        frac_nxt: Optional[int] = None
        for n in range(total, -1, -1):
            if feasible[n]:
                nxt = n
            if frac_feasible[n]:
                frac_nxt = n
            next_at[n] = nxt
            frac_next_at[n] = frac_nxt
        self.total = total
        self.chips_per_host = cph
        self.feasible = feasible
        self.round_down = round_down
        self.next_at = next_at
        self.frac_feasible = frac_feasible
        self.frac_round_down = frac_round_down
        self.frac_next_at = frac_next_at

    _cache: Dict[Tuple[Tuple[int, ...], Tuple[int, ...]], "FeasibleTable"] = {}

    @classmethod
    def for_topology(cls, topology: "PoolTopology") -> "FeasibleTable":
        key = (topology.torus_dims, topology.host_block)
        table = cls._cache.get(key)
        if table is None:
            table = cls._cache[key] = cls(*key)
        return table


def round_to_feasible(n: int, topology: "PoolTopology",
                      fractional: bool = False) -> int:
    """Largest feasible chip count <= n on this pool.

    Feasible = a contiguous sub-block of one host (sub-host jobs share a
    host's chips like the reference's fractional-node GPU jobs), or a
    whole-host-granular contiguous sub-torus (multi-host jobs own whole
    hosts — the unit that runs one runtime process). This is the TPU
    shape-feasibility check SURVEY.md §7 derives from `map[job]int`
    becoming `map[job]sliceShape` (reference invariant enforcement:
    pkg/algorithm/utils.go:18-42 has no such notion — GPUs are fungible).

    `fractional` (doc/fractional-sharing.md) switches to the fractional
    resource class's table: a sub-host grant rounds WITHIN a host block
    (every count 1..chips_per_host-1 is a valid static chip-partition)
    instead of against the sub-torus shape catalog.
    """
    table = FeasibleTable.for_topology(topology)
    if n <= 0:
        return 0
    k = n if n <= table.total else table.total
    return (table.frac_round_down if fractional else table.round_down)[k]


def next_feasible_above(n: int, topology: "PoolTopology",
                        fractional: bool = False) -> Optional[int]:
    """Smallest feasible chip count > n, or None if the pool tops out."""
    table = FeasibleTable.for_topology(topology)
    k = n + 1
    if k > table.total:
        return None
    return (table.frac_next_at if fractional
            else table.next_at)[k if k > 0 else 0]


def is_feasible_count(n: int, topology: "PoolTopology",
                      fractional: bool = False) -> bool:
    """O(1) table lookup — this sits on the allocation hot path via
    enforce_feasibility and validate_result. A count above the pool's
    total can never tile it (factors are bounded by the host grid), so
    out-of-range counts are infeasible without a probe."""
    if n == 0:
        return True
    table = FeasibleTable.for_topology(topology)
    if n < 0 or n > table.total:
        return False
    return (table.frac_feasible if fractional else table.feasible)[n]


# ---- scan-based reference primitives (differential-test oracles) -----------


def _is_feasible_scan(n: int, topology: "PoolTopology",
                      fractional: bool = False) -> bool:
    """Pre-table is_feasible_count: one factorization enumeration per
    probe. Multi-host slices must be a contiguous block of *whole
    hosts*, i.e. a sub-grid of the host grid scaled by the host block —
    so the check factorizes n / chips_per_host over the host grid, not
    n over the raw torus (e.g. 36 chips on a (4,4,4)/(2,2,1) pool
    factor as 3x3x4 chips, but no union of whole 2x2x1 hosts forms
    that box: infeasible). `fractional` mirrors the table's fractional
    axis: any sub-host count is a valid static chip-partition."""
    if n == 0:
        return True
    if n < 0:
        return False
    cph = topology.chips_per_host
    if n < cph:
        return True if fractional else bool(
            _divisor_shapes(n, topology.host_block))
    return n % cph == 0 and bool(_divisor_shapes(n // cph, topology.host_grid))


def _round_to_feasible_scan(n: int, topology: "PoolTopology",
                            fractional: bool = False) -> int:
    for k in range(min(n, topology.total_chips), 0, -1):
        if _is_feasible_scan(k, topology, fractional):
            return k
    return 0


def _next_feasible_above_scan(n: int, topology: "PoolTopology",
                              fractional: bool = False) -> Optional[int]:
    for k in range(n + 1, topology.total_chips + 1):
        if _is_feasible_scan(k, topology, fractional):
            return k
    return None


@dataclasses.dataclass
class PoolTopology:
    """A TPU pool: a torus of chips partitioned into fixed host blocks.

    The placement manager packs at host granularity (the unit that fails,
    restarts, and runs one runtime process — like the reference's nodes) but
    scores host subsets by ICI contiguity instead of flat counts.
    """

    torus_dims: Tuple[int, ...] = (4, 4, 4)     # pool-wide chip torus
    host_block: Tuple[int, ...] = (2, 2, 1)     # chips per host, as a sub-block

    def __post_init__(self) -> None:
        if len(self.host_block) != len(self.torus_dims):
            raise ValueError("host_block rank must match torus_dims rank")
        for t, h in zip(self.torus_dims, self.host_block):
            if t % h != 0:
                raise ValueError(f"host block {self.host_block} does not tile torus {self.torus_dims}")

    @property
    def chips_per_host(self) -> int:
        return math.prod(self.host_block)

    @property
    def num_hosts(self) -> int:
        return math.prod(self.host_grid)

    @property
    def total_chips(self) -> int:
        return math.prod(self.torus_dims)

    @property
    def host_grid(self) -> Tuple[int, ...]:
        """Grid of hosts: torus dims divided by host block dims."""
        return tuple(t // h for t, h in zip(self.torus_dims, self.host_block))

    def host_coords(self) -> List[Tuple[int, ...]]:
        """Coordinates of every host in the host grid, lexicographic."""
        return list(itertools.product(*(range(d) for d in self.host_grid)))

    def host_name(self, coord: Tuple[int, ...]) -> str:
        return "host-" + "-".join(str(c) for c in coord)

    def host_distance(self, a: Tuple[int, ...], b: Tuple[int, ...]) -> int:
        """Torus (wraparound) L1 distance between two hosts — the ICI hop
        count between their blocks along the host grid."""
        dist = 0
        for ai, bi, di in zip(a, b, self.host_grid):
            d = abs(ai - bi)
            dist += min(d, di - d)
        return dist

    def contiguity_cost(self, coords: Iterable[Tuple[int, ...]]) -> int:
        """Sum of pairwise torus distances of a host set: 0 for a single
        host, minimal for a compact contiguous block. The placement manager
        minimizes this per job — the TPU analog of the reference's binary
        crossNode counter (placement_manager.go:472-477)."""
        coords = list(coords)
        return sum(self.host_distance(a, b)
                   for i, a in enumerate(coords) for b in coords[i + 1:])

    @property
    def host_diameter(self) -> int:
        """Longest torus distance between any two hosts (each axis wraps,
        so the farthest point sits half-way around every dimension)."""
        return sum(d // 2 for d in self.host_grid)

    def mean_hop_distance(self, coords: Iterable[Tuple[int, ...]]) -> float:
        """Mean pairwise inter-host hop distance of a host set — the
        per-collective-byte hop multiplier the comms cost model prices
        (placement/comms.py). 0.0 for zero or one host."""
        coords = list(coords)
        k = len(coords)
        if k <= 1:
            return 0.0
        return self.contiguity_cost(coords) / (k * (k - 1) / 2.0)

    def spread(self, coords: Iterable[Tuple[int, ...]]) -> float:
        """Normalized placement spread in [0, 1]: mean pairwise hop
        distance over the torus diameter. 0 = single host (all traffic
        intra-host); an adjacent block pays its real (small) inter-host
        hops; 1 = hosts scattered at maximal distance. The replay
        simulator degrades a job's speedup exponent by
        `comms_fraction * spread` (cluster/fake.py), and the migration
        payback gate prices a move by the spread delta it buys."""
        diameter = self.host_diameter
        if diameter <= 0:
            return 0.0
        return min(1.0, self.mean_hop_distance(coords) / diameter)

    def host_footprint(self, n: int) -> int:
        """Chips a grant of n physically occupies when the minimum
        allocation unit is a whole host (the sharing-off baseline of
        doc/fractional-sharing.md): n rounded up to whole host blocks.
        With fractional sharing on, a grant's footprint is itself."""
        if n <= 0:
            return 0
        cph = self.chips_per_host
        return ((n + cph - 1) // cph) * cph

    def slice_for(self, num_chips: int) -> Optional[SliceShape]:
        """Best contiguous shape for num_chips on this torus, if any."""
        shapes = feasible_shapes(num_chips, self.torus_dims)
        return shapes[0] if shapes else None

    def __str__(self) -> str:
        """Round-trippable "4x4x4/2x2x1" form — the VODA_TOPOLOGY env
        value backends hand to supervisors (torus dims / host block)."""
        return (f"{'x'.join(str(d) for d in self.torus_dims)}/"
                f"{'x'.join(str(d) for d in self.host_block)}")

    @staticmethod
    def parse(s: str) -> "PoolTopology":
        """Parse "4x4x4/2x2x1" (torus dims / host block). A bare torus
        with no "/block" part defaults to 1-chip hosts (every chip its
        own host block) — previously this raised a bare int("")
        ValueError. Malformed dims get a clear message instead."""
        torus, _, block = s.partition("/")
        try:
            torus_dims = tuple(int(d) for d in torus.split("x"))
            host_block = (tuple(int(d) for d in block.split("x"))
                          if block else (1,) * len(torus_dims))
        except ValueError:
            raise ValueError(
                f"invalid topology {s!r}: expected "
                f"'<d>x<d>x...[/<b>x<b>x...]', e.g. '4x4x4/2x2x1'"
            ) from None
        return PoolTopology(torus_dims=torus_dims, host_block=host_block)


def default_pool(num_hosts: int, chips_per_host: int = 4) -> PoolTopology:
    """Convenience: a 1D host ring with `chips_per_host`-chip hosts — the
    degenerate topology matching the reference's flat node list, used by
    tests and the fake backend when no real torus is modeled."""
    return PoolTopology(torus_dims=(num_hosts * chips_per_host,),
                        host_block=(chips_per_host,))
