"""Vectorized decide-path kernels for the allocation algorithms.

ROADMAP item 2: the decide-under-lock phase is the control-plane stall
tail, and at 10k jobs the pure per-job dict loops in `algorithms/` cost
~33 ms per pass (doc/perf_baseline.json, PR 7's characterization). This
module rebuilds the hot allocation kernels as one-extraction-pass
struct-of-arrays sweeps (numpy orderings, tight integer loops, a
lazy-heap auction for ElasticTiresias) while the original per-job
implementations stay in each algorithm class as `schedule_reference` —
the always-available fallback AND the differential-test oracle.

The contract is *bit-identical decisions*: for every input, a fastpath
kernel returns exactly the dict its oracle returns — same values, same
insertion order (placement packing tie-breaks on dict order, so order is
decision-relevant) — proven over seeded random pools by
tests/test_fastpath_oracle.py and `make modelcheck-selftest`
(`self_check` below). Replay determinism and the PR 6 model checker
depend on this equivalence, so every sweep below documents the oracle
behavior it replicates, including tie-breaking.

Kill-switch: VODA_PURE_ALLOCATOR=1 forces every algorithm onto its
oracle (`enabled()` returns False), mirroring VODA_NO_NATIVE for the
C++ kernels. numpy is required only for large-queue orderings; without
it the kernels fall back to equally-exact `sorted()` orderings.
"""

from __future__ import annotations

import heapq
import os
from typing import Dict, List, Optional, Sequence, Tuple

from vodascheduler_tpu_torch.algorithms.base import InvalidAllocationError
from vodascheduler_tpu_torch.common.job import JobInfo, TrainingJob
from vodascheduler_tpu_torch.common.types import JobStatus, ScheduleResult

try:  # pragma: no cover - exercised implicitly everywhere
    import numpy as _np
except Exception:  # pragma: no cover - numpy ships with the jax toolchain
    _np = None

# Below this queue length numpy's array-construction overhead exceeds
# the sort it saves; `sorted(range(n), key=...)` is exact and faster.
_NUMPY_SORT_MIN = 512


def enabled() -> bool:
    """Whether the fastpath kernels are active (the oracle runs when
    not). Env-gated like VODA_NO_NATIVE so differential tests and
    operators can pin the pure-Python decision path."""
    return not os.environ.get("VODA_PURE_ALLOCATOR")


# ---- extraction ------------------------------------------------------------


class JobVec:
    """Struct-of-arrays view of the job list: per-job fields as parallel
    lists indexed by the job's position in the input (so "original
    order" tie-breaks are just ascending index). Fields are extracted
    lazily, one comprehension sweep each — touching each TrainingJob's
    attribute chain once per pass instead of once per phase per sweep
    is most of the win over the oracle at 10k jobs, and kernels that
    never read a field (FIFO has no use for lease ages) never pay for
    its sweep."""

    __slots__ = ("jobs", "n", "_cfgs", "_metrics", "_cache")

    def __init__(self, jobs: Sequence[TrainingJob]) -> None:
        self.jobs = jobs
        self.n = len(jobs)
        self._cfgs = None
        self._metrics = None
        self._cache: Dict[str, list] = {}

    def _cfg_list(self):
        if self._cfgs is None:
            self._cfgs = [j.config for j in self.jobs]
        return self._cfgs

    def _metrics_list(self):
        if self._metrics is None:
            self._metrics = [j.metrics for j in self.jobs]
        return self._metrics

    def _field(self, name: str, build) -> list:
        got = self._cache.get(name)
        if got is None:
            got = self._cache[name] = build()
        return got

    @property
    def names(self) -> List[str]:
        return self._field("names", lambda: [j.name for j in self.jobs])

    @property
    def mins(self) -> List[int]:
        return self._field("mins", lambda: [
            c.min_num_chips for c in self._cfg_list()])

    @property
    def maxes(self) -> List[int]:
        return self._field("maxes", lambda: [
            c.max_num_chips for c in self._cfg_list()])

    @property
    def nums(self) -> List[int]:
        return self._field("nums", lambda: [
            c.num_chips for c in self._cfg_list()])

    @property
    def prios(self) -> List[int]:
        return self._field("prios", lambda: [j.priority for j in self.jobs])

    @property
    def submit(self) -> List[float]:
        return self._field("submit", lambda: [
            j.submit_time for j in self.jobs])

    @property
    def first_start(self) -> List[float]:
        return self._field("first_start", lambda: [
            m.first_start_time for m in self._metrics_list()])

    @property
    def running(self) -> List[float]:
        return self._field("running", lambda: [
            m.running_seconds for m in self._metrics_list()])

    @property
    def ssr(self) -> List[float]:
        return self._field("ssr", lambda: [
            m.seconds_since_restart for m in self._metrics_list()])

    @property
    def is_running(self) -> List[bool]:
        run = JobStatus.RUNNING
        return self._field("is_running", lambda: [
            j.status is run for j in self.jobs])

    @property
    def infos(self) -> List[Optional[JobInfo]]:
        return self._field("infos", lambda: [j.info for j in self.jobs])

    def remaining_seconds(self) -> List[float]:
        """srjf.remaining_seconds per job (0.0 when info is absent)."""
        return self._field("remaining", lambda: [
            info.estimated_remaining_seconds if info is not None else 0.0
            for info in self.infos])


def _stable_order(keys: List, n: int) -> List[int]:
    """Ascending stable argsort of `keys` — identical order to
    `sorted(range(n), key=keys.__getitem__)` (ties keep original
    index order), via numpy for large queues."""
    if _np is not None and n >= _NUMPY_SORT_MIN:
        return _np.argsort(_np.asarray(keys), kind="stable").tolist()
    return sorted(range(n), key=keys.__getitem__)


def _lex_order(primary: List, secondary: List, n: int) -> List[int]:
    """Stable argsort by (primary, secondary, original index) — the
    order of `queues_by_priority` iteration: partition by priority
    ascending, each partition sorted stably by first_start_time."""
    if _np is not None and n >= _NUMPY_SORT_MIN:
        # lexsort: LAST key is primary; stable overall.
        return _np.lexsort((_np.asarray(secondary),
                            _np.asarray(primary))).tolist()
    return sorted(range(n), key=lambda i: (primary[i], secondary[i]))


# ---- validation ------------------------------------------------------------


def _validate(vec: JobVec, result: List[int], total_chips: int) -> None:
    """Array-sided twin of base.validate_result for fastpath results
    (same checks, same error type/messages, same first-offender order —
    which is the result dict's order = input order here)."""
    mins, maxes = vec.mins, vec.maxes
    allocated = 0
    for i in range(vec.n):
        n = result[i]
        if 0 <= n <= maxes[i] and (n == 0 or n >= mins[i]):
            allocated += n
            continue
        if n < 0:
            raise InvalidAllocationError(
                f"{vec.names[i]}: negative allocation {n}")
        if 0 < n < mins[i]:
            raise InvalidAllocationError(
                f"{vec.names[i]}: allocation {n} below min {mins[i]}")
        raise InvalidAllocationError(
            f"{vec.names[i]}: allocation {n} above max {maxes[i]}")
    if allocated > max(0, total_chips):
        raise InvalidAllocationError(
            f"total allocated {allocated} exceeds capacity {total_chips}")


# ---- shared phases (FIFO/SRJF families) ------------------------------------


def _allocate_minimums(vec: JobVec, order: List[int],
                       result: List[int], free: int) -> int:
    """base.allocate_minimums: walk `order`, grant each job its min
    while supply lasts (result already zero-filled)."""
    mins = vec.mins
    for i in order:
        lo = mins[i]
        if free >= lo:
            result[i] = lo
            free -= lo
    return free


def _distribute_leftover(vec: JobVec, order: List[int],
                         result: List[int], free: int) -> int:
    """base.distribute_leftover, closed-form: the oracle round-robins
    one chip at a time over `eligible` (allocated, below max) in order,
    dropping capped jobs. After T complete rounds every eligible job
    has gained min(headroom, T); the T+1-th (partial) round tops up the
    first `free_left` still-eligible jobs in order. Computing T by
    water-filling gives the identical final counts without the
    O(free x eligible) sweep."""
    if free <= 0:
        return free
    maxes = vec.maxes
    eligible = [i for i in order if 0 < result[i] < maxes[i]]
    if not eligible:
        return free
    caps = [maxes[i] - result[i] for i in eligible]
    total_cap = sum(caps)
    if total_cap <= free:
        for k, i in enumerate(eligible):
            result[i] = maxes[i]
        return free - total_cap
    # Find T = number of complete rounds: largest T with
    # sum(min(cap, T)) <= free. Walk distinct cap levels ascending.
    m = len(caps)
    caps_sorted = sorted(caps)
    spent = 0          # chips consumed by fully-capped jobs so far
    k = 0              # jobs with cap <= T (fully capped)
    T = 0
    while True:
        # Next candidate level: the smallest cap above T, or unbounded.
        nxt = caps_sorted[k] if k < m else None
        if nxt is None:
            T += (free - spent) // (m - k) if m > k else 0
            break
        # Cost to raise T to nxt: (m - k) chips per unit.
        if spent + (m - k) * (nxt - T) <= free:
            spent += (m - k) * (nxt - T)
            T = nxt
            while k < m and caps_sorted[k] == T:
                k += 1
            if k == m:
                break
        else:
            T += (free - spent) // (m - k)
            break
    used = sum(c if c <= T else T for c in caps)
    free_left = free - used
    for idx, i in enumerate(eligible):
        grant = caps[idx] if caps[idx] <= T else T
        result[i] += grant
    if free_left > 0:
        for idx, i in enumerate(eligible):
            if caps[idx] > T:
                result[i] += 1
                free_left -= 1
                if free_left == 0:
                    break
    return free_left


def _finish(vec: JobVec, order: List[int], result: List[int],
            total_chips: int) -> ScheduleResult:
    """Build the result dict in the oracle's insertion order (`order`)
    and validate. Insertion order is decision-relevant downstream:
    placement packing tie-breaks on dict order."""
    _validate(vec, result, total_chips)
    names = vec.names
    return {names[i]: result[i] for i in order}


# ---- native batch dispatch (voda_native.cc; doc/observability.md
# "Fleet decide") -------------------------------------------------------------
#
# The integer sweeps and the ElasticTiresias auction have C++ twins in
# native/_voda_native.so. Dispatch order is native -> python fastpath ->
# oracle, each layer bit-identical to the next: VODA_NO_NATIVE drops the
# first layer (native.get_lib() returns None), VODA_PURE_ALLOCATOR drops
# the first two (enabled() above). The differential suite runs all three.

_SWEEP_MINIMUMS = 0   # allocate_minimums only (FIFO / SRJF)
_SWEEP_ELASTIC = 1    # + water-filled distribute_leftover
_SWEEP_FIXED = 2      # fixed NumProc (Tiresias)

# Below this queue length the pure-Python integer sweeps beat the
# numpy-marshalling round trip into the native kernel (measured ~5.2 ms
# python vs ~6.2 ms native at 10k; crossover sits in the tens of
# thousands). Tests force 0 to route every differential trial through
# the kernel regardless of pool size.
_SWEEP_NATIVE_MIN = 20000


def _native_sweep(vec: JobVec, order: List[int], total_chips: int,
                  mode: int) -> Optional[List[int]]:
    """The per-index result list from the native sweep kernel, or None
    (unavailable / VODA_NO_NATIVE / below the marshalling-economics
    floor). Unread arrays are aliased to an already-extracted field so
    a FIFO pass never pays the maxes/nums extraction sweeps it doesn't
    need."""
    from vodascheduler_tpu_torch import native

    if vec.n < _SWEEP_NATIVE_MIN:
        return None
    if mode == _SWEEP_FIXED:
        nums = vec.nums
        return native.alloc_sweep(order, nums, nums, nums, total_chips,
                                  mode)
    mins = vec.mins
    maxes = vec.maxes if mode == _SWEEP_ELASTIC else mins
    return native.alloc_sweep(order, mins, maxes, mins, total_chips, mode)


# Full-native auction engages only when the pool's jobs share at most
# this many distinct speedup curves. A fleet of fresh jobs shares ONE
# linear-prior dict (allocator._base_prior) and marshals for free; a
# pool where every job carries its own learned curve would pay an
# O(jobs x levels) dict-to-row extraction that costs more than the
# retained Python lazy-heap auction it replaces — there the native
# kernel still runs phases 0/1/compaction (pure integers) and hands
# (result, free) to the Python auction.
_ET_NATIVE_CURVES_MAX = 64

# Phases-only native mode engages above this queue length: below it the
# three Python integer sweeps cost less than the array marshalling they
# would replace (measured ~9 ms python vs ~12 ms native at 10k learned-
# curve jobs; the ratio inverts past a few tens of thousands of jobs
# where numpy's ~40 ns/element conversion beats ~400 ns/element of
# Python loop).
_ET_PHASES_NATIVE_MIN = 50000


def _native_et(vec: JobVec, order: List[int], total_chips: int
               ) -> Optional[Tuple[List[int], Optional[int]]]:
    """Native ElasticTiresias dispatch, or None (no kernel /
    VODA_NO_NATIVE). Returns (result, None) when the native auction
    completed the schedule, or (result, free) when only the integer
    phases ran natively and the caller must run the Python auction.
    Curve rows cover levels 0..max_chips+1 (the auction re-keys at
    result+1 after a min-grant, which can read one level past max —
    dict.get semantics, row guard in the kernel)."""
    from vodascheduler_tpu_torch.algorithms.elastic_tiresias import (
        COMPACTION_THRESHOLD,
        FLOOR_LIFT_AGE_SECONDS,
        FLOOR_LIFT_WEIGHT,
        LEASE_SECONDS,
    )
    from vodascheduler_tpu_torch import native

    if native.get_lib() is None:
        return None
    mins, maxes = vec.mins, vec.maxes
    n = vec.n
    infos = vec.infos
    # Dispatch economics: the kernel only repays its array marshalling
    # when the auction is substantial (leftover chips beyond the fixed
    # NumProc demand — each costs the Python heap a pop/push round) or
    # the queue is fleet-sized (the three integer sweeps alone dominate
    # marshalling past ~50k jobs). A saturated 10k pool decides faster
    # on the pure-Python fastpath, so it stays there.
    auction_heavy = total_chips > sum(vec.nums)
    if not auction_heavy and n < _ET_PHASES_NATIVE_MIN:
        return None
    # Distinct-curve probe, cheap-first: a 256-job sample bounds the
    # count from below, so a per-job-learned-curves pool bails without
    # sweeping all n ids.
    sample = {0 if info is None else id(info.speedup)
              for info in infos[:256]}
    if len(sample) > _ET_NATIVE_CURVES_MAX:
        curve_ids = sample
    else:
        curve_ids = {0 if info is None else id(info.speedup)
                     for info in infos}
    # min <= 0 stays off the full-native path: the initial gain divides
    # by min and the Python expression's ZeroDivisionError is the
    # contract — C++ would mint an inf instead.
    full = (len(curve_ids) <= _ET_NATIVE_CURVES_MAX
            and min(mins, default=1) > 0)
    if not full and n < _ET_PHASES_NATIVE_MIN:
        return None  # pure-Python fastpath beats marshalling here
    is_running, ssr, running_s = vec.is_running, vec.ssr, vec.running
    lease_ok = [1 if (r and s < LEASE_SECONDS) else 0
                for r, s in zip(is_running, ssr)]
    lift_ok = [1 if rs > FLOOR_LIFT_AGE_SECONDS else 0 for rs in running_s]
    if full and len(curve_ids) == 1:
        # The fleet steady state: every job shares one curve dict (the
        # linear prior) or carries none — one row, no per-job loop.
        speedup = next((info.speedup for info in infos
                        if info is not None), None)
        levels = (max(maxes) if maxes else 0) + 2
        curve_idx = [0] * n
        if speedup is None:
            flat = [0.0] * levels
        else:
            get = speedup.get
            flat = [get(g, 0.0) for g in range(levels)]
        offsets = [0, levels]
    elif full:
        curve_index: Dict[int, int] = {}
        curve_dicts: List[Optional[dict]] = []
        curve_levels: List[int] = []
        curve_idx = []
        for i in range(n):
            info = infos[i]
            speedup = info.speedup if info is not None else None
            key = 0 if speedup is None else id(speedup)
            c = curve_index.get(key)
            if c is None:
                c = curve_index[key] = len(curve_dicts)
                curve_dicts.append(speedup)
                curve_levels.append(0)
            need = maxes[i] + 2
            if need > curve_levels[c]:
                curve_levels[c] = need
            curve_idx.append(c)
        offsets = [0]
        flat = []
        for speedup, levels in zip(curve_dicts, curve_levels):
            if speedup is None:
                flat.extend([0.0] * levels)
            else:
                get = speedup.get
                flat.extend([get(g, 0.0) for g in range(levels)])
            offsets.append(len(flat))
    else:
        curve_idx, offsets, flat = [0] * n, [0, 0], []
    out = native.et_schedule(order, mins, maxes, vec.nums, vec.prios,
                             lease_ok, lift_ok, total_chips,
                             COMPACTION_THRESHOLD, FLOOR_LIFT_WEIGHT,
                             curve_idx, offsets, flat, run_auction=full)
    if out is None:
        return None
    result, free = out
    return (result, None) if full else (result, free)


# ---- the kernels -----------------------------------------------------------


def fifo(jobs: List[TrainingJob], total_chips: int) -> Optional[ScheduleResult]:
    if not enabled():
        return None
    vec = JobVec(jobs)
    order = _stable_order(vec.submit, vec.n)
    result = _native_sweep(vec, order, total_chips, _SWEEP_MINIMUMS)
    if result is None:
        result = [0] * vec.n
        _allocate_minimums(vec, order, result, total_chips)
    return _finish(vec, order, result, total_chips)


def elastic_fifo(jobs: List[TrainingJob],
                 total_chips: int) -> Optional[ScheduleResult]:
    if not enabled():
        return None
    vec = JobVec(jobs)
    order = _stable_order(vec.submit, vec.n)
    result = _native_sweep(vec, order, total_chips, _SWEEP_ELASTIC)
    if result is None:
        result = [0] * vec.n
        free = _allocate_minimums(vec, order, result, total_chips)
        _distribute_leftover(vec, order, result, free)
    return _finish(vec, order, result, total_chips)


def srjf(jobs: List[TrainingJob], total_chips: int) -> Optional[ScheduleResult]:
    if not enabled():
        return None
    vec = JobVec(jobs)
    order = _stable_order(vec.remaining_seconds(), vec.n)
    result = _native_sweep(vec, order, total_chips, _SWEEP_MINIMUMS)
    if result is None:
        result = [0] * vec.n
        _allocate_minimums(vec, order, result, total_chips)
    return _finish(vec, order, result, total_chips)


def elastic_srjf(jobs: List[TrainingJob],
                 total_chips: int) -> Optional[ScheduleResult]:
    if not enabled():
        return None
    vec = JobVec(jobs)
    order = _stable_order(vec.remaining_seconds(), vec.n)
    result = _native_sweep(vec, order, total_chips, _SWEEP_ELASTIC)
    if result is None:
        result = [0] * vec.n
        free = _allocate_minimums(vec, order, result, total_chips)
        _distribute_leftover(vec, order, result, free)
    return _finish(vec, order, result, total_chips)


def tiresias(jobs: List[TrainingJob],
             total_chips: int) -> Optional[ScheduleResult]:
    if not enabled():
        return None
    vec = JobVec(jobs)
    order = _lex_order(vec.prios, vec.first_start, vec.n)
    result = _native_sweep(vec, order, total_chips, _SWEEP_FIXED)
    if result is None:
        result = [0] * vec.n
        nums = vec.nums
        free = total_chips
        for i in order:
            want = nums[i]
            if free >= want:
                result[i] = want
                free -= want
    return _finish(vec, order, result, total_chips)


def ffdl(jobs: List[TrainingJob],
         total_chips: int) -> Optional[ScheduleResult]:
    """FfDLOptimizer: fast FIFO-trim ordering + the native/python DP.
    The DP itself is unchanged (native voda_ffdl_dp when built); the
    fastpath removes the per-job sort lambda and dict churn around it."""
    if not enabled():
        return None
    vec = JobVec(jobs)
    if vec.n == 0 or total_chips <= 0:
        return {name: 0 for name in vec.names}
    order = _stable_order(vec.submit, vec.n)
    K = total_chips
    feasible = order[:K]
    alloc = _ffdl_dp(vec, feasible, K)
    result = [0] * vec.n
    for i, g in zip(feasible, alloc):
        result[i] = g
    _validate(vec, result, total_chips)
    # Oracle insertion order: `{j.name: 0 for j in jobs}` = input order.
    names = vec.names
    return {names[i]: result[i] for i in range(vec.n)}


def _ffdl_dp(vec: JobVec, feasible: List[int], K: int) -> List[int]:
    """The DP knapsack over (jobs x chips); mirrors
    ffdl_optimizer.FfDLOptimizer (native kernel first, python fallback
    with identical transitions)."""
    from vodascheduler_tpu_torch import native

    lo = [vec.mins[i] for i in feasible]
    hi = [vec.maxes[i] for i in feasible]
    infos = [vec.infos[i] for i in feasible]
    speedup_rows = []
    empty = JobInfo()
    for info in infos:
        at = (info or empty).speedup_at
        speedup_rows.append([at(g) for g in range(K + 1)])
    native_alloc = native.ffdl_dp(K, lo, hi, speedup_rows)
    if native_alloc is not None:
        return native_alloc
    J = len(feasible)
    P = [[0.0] * (K + 1) for _ in range(J + 1)]
    SOL = [[0] * (K + 1) for _ in range(J + 1)]
    for j in range(1, J + 1):
        row = speedup_rows[j - 1]
        Pprev = P[j - 1]
        Pcur = P[j]
        Scur = SOL[j]
        jlo, jhi = lo[j - 1], hi[j - 1]
        for k in range(0, K + 1):
            best, best_g = Pprev[k], 0
            for g in range(jlo, min(jhi, k) + 1):
                p = row[g] + Pprev[k - g]
                if p > best:
                    best, best_g = p, g
            Pcur[k] = best
            Scur[k] = best_g
    alloc = [0] * J
    k = K
    for j in range(J, 0, -1):
        alloc[j - 1] = SOL[j][k]
        k -= SOL[j][k]
    return alloc


def elastic_tiresias(jobs: List[TrainingJob],
                     total_chips: int) -> Optional[ScheduleResult]:
    """ElasticTiresias without the O(free x n log n) re-sorting auction.

    Phases 0/1/compaction are the oracle's sequential greedy sweeps over
    pre-extracted arrays (grants depend on the running `free`, so they
    are inherently ordered — but over plain ints they cost ~0.2 us/job).

    Phase 2 (the marginal-gain auction) replaces sort-per-chip with a
    lazy max-heap. The oracle re-sorts `candidates` each iteration with
    two stable sorts (priority asc, then lifted gain desc) and takes
    [0]; only the winner's key ever changes, so the evolving list order
    equals a priority queue keyed (lifted gain desc, priority asc,
    recency) where a re-keyed winner precedes every equal-key entry (it
    was at position 0, and stable sorts preserve that precedence) and
    initial entries tie-break by candidate order. The heap encodes that
    exactly: counters start at the candidate index and every re-push
    takes the next DECREASING counter, so later updates sort first
    within an equal key. Gains, lifts, and the <=0 stop use the same
    float expressions as the oracle, so selection is bit-identical.

    Gains are computed lazily: the oracle's upfront gain map is only
    ever read by phase 2, and at each read the value is a pure function
    of the job's pre-phase-2 grant (next_gain at the grant, or the
    interpolated min-gain when ungranted) — so a saturated pool (free
    == 0 after phase 1, the steady state of a busy pool) skips the 2n
    speedup-curve lookups entirely.
    """
    if not enabled():
        return None
    from vodascheduler_tpu_torch.algorithms.elastic_tiresias import (
        COMPACTION_THRESHOLD,
        FLOOR_LIFT_AGE_SECONDS,
        FLOOR_LIFT_WEIGHT,
        LEASE_SECONDS,
    )

    vec = JobVec(jobs)
    n = vec.n
    order = _lex_order(vec.prios, vec.first_start, n)
    native_out = _native_et(vec, order, total_chips)
    if native_out is not None:
        result, free = native_out
        if free is None:
            # Full native run (auction included).
            _validate(vec, result, total_chips)
            names = vec.names
            return {names[i]: result[i] for i in range(n)}
        # Native phases + retained Python auction below.
    else:
        mins, maxes, nums, prios = vec.mins, vec.maxes, vec.nums, vec.prios
        result = [0] * n
        free = total_chips
        pendings = n
        leased = [False] * n

        # Phase 0: running jobs inside their preemption lease keep
        # their minimum, in queue order.
        is_running, ssr = vec.is_running, vec.ssr
        for i in order:
            if is_running[i] and ssr[i] < LEASE_SECONDS and free >= mins[i]:
                result[i] = mins[i]
                free -= mins[i]
                pendings -= 1
                leased[i] = True

        # Phase 1: fixed NumProc allocation by queue; leased jobs top
        # up to their full NumProc all-or-nothing.
        for i in order:
            if leased[i]:
                extra = nums[i] - result[i]
                if 0 < extra <= free:
                    result[i] += extra
                    free -= extra
                continue
            if free >= nums[i]:
                result[i] = nums[i]
                free -= nums[i]
                pendings -= 1

        # Compaction: deep pending backlog shrinks running low-priority
        # (queue >= 1) jobs to their minimum.
        if pendings > COMPACTION_THRESHOLD:
            for i in order:
                if prios[i] < 1:
                    continue
                if result[i] != 0:
                    free += result[i] - mins[i]
                    result[i] = mins[i]

    mins, maxes, prios = vec.mins, vec.maxes, vec.prios
    # Phase 2: greedy marginal-gain auction via lazy heap.
    if free > 0:
        infos = vec.infos
        running_s = vec.running
        empty = JobInfo()

        def gain_at(i: int) -> float:
            info = infos[i] or empty
            cur = result[i]
            if cur > 0:
                return info.speedup_at(cur + 1) - info.speedup_at(cur)
            return info.speedup_at(mins[i]) / mins[i]

        candidates = [i for i in range(n)
                      if result[i] < maxes[i]
                      and (result[i] > 0 or free >= mins[i])]
        if candidates:
            gains = {}
            version = {}
            heap = []
            for pos, i in enumerate(candidates):
                g = gain_at(i)
                gains[i] = g
                version[i] = 0
                lift = (FLOOR_LIFT_WEIGHT
                        if (result[i] <= mins[i]
                            and running_s[i] > FLOOR_LIFT_AGE_SECONDS)
                        else 1.0)
                heap.append((-(g * lift), prios[i], pos, i, 0))
            heapq.heapify(heap)
            alive = dict.fromkeys(candidates, True)
            next_counter = -1
            while free > 0 and heap:
                neg_key, _prio, _ctr, i, ver = heap[0]
                if not alive[i] or ver != version[i]:
                    heapq.heappop(heap)
                    continue
                if gains[i] <= 0:
                    break  # no algorithm-wide efficiency gain remains
                info = infos[i] or empty
                if result[i] == 0:
                    if free >= mins[i]:
                        result[i] = mins[i]
                        free -= mins[i]
                    else:
                        alive[i] = False
                        heapq.heappop(heap)
                        continue
                else:
                    result[i] += 1
                    free -= 1
                    if result[i] >= maxes[i]:
                        alive[i] = False
                        heapq.heappop(heap)
                        continue
                # Winner re-key: new gain at the new grant, fresh lift,
                # decreasing counter (front of its equal-key block).
                heapq.heappop(heap)
                g = info.speedup_at(result[i] + 1) - info.speedup_at(result[i])
                gains[i] = g
                version[i] = ver + 1
                lift = (FLOOR_LIFT_WEIGHT
                        if (result[i] <= mins[i]
                            and running_s[i] > FLOOR_LIFT_AGE_SECONDS)
                        else 1.0)
                heapq.heappush(heap, (-(g * lift), prios[i], next_counter,
                                      i, ver + 1))
                next_counter -= 1

    _validate(vec, result, total_chips)
    # Oracle insertion order: `{j.name: 0 for j in jobs}` = input order.
    names = vec.names
    return {names[i]: result[i] for i in range(n)}


# ---- self-check (wired into `make modelcheck-selftest`) --------------------

FASTPATH_ALGORITHMS = ("FIFO", "ElasticFIFO", "SRJF", "ElasticSRJF",
                       "Tiresias", "ElasticTiresias", "FfDLOptimizer")


def random_pool(rng, size: Optional[int] = None,
                degenerate: bool = False) -> Tuple[List[TrainingJob], int]:
    """A seeded random job pool for differential testing: ragged
    mins/maxes, mixed statuses/priorities/ages, learned curves next to
    fresh priors (and all-zero curves when `degenerate`)."""
    import dataclasses

    from vodascheduler_tpu_torch.common.job import (
        JobConfig,
        JobMetrics,
        JobSpec,
        base_job_info,
    )

    n = size if size is not None else rng.choice(
        (1, 2, 3, 5, 8, 13, 21, 40, 77, 150))
    jobs: List[TrainingJob] = []
    for i in range(n):
        lo = rng.choice((1, 1, 1, 2, 3, 4))
        hi = max(lo, rng.choice((1, 2, 4, 6, 8, 16)))
        num = rng.randint(lo, hi)
        spec = JobSpec(name=f"dj-{i:04d}", config=JobConfig(
            num_chips=num, min_num_chips=lo, max_num_chips=hi))
        job = TrainingJob.from_spec(spec, submit_time=rng.uniform(0, 1000))
        # Fixture construction, not a lifecycle transition: build the
        # record in its target state (the status-store discipline only
        # governs live mutation, which replace() is not).
        job = dataclasses.replace(
            job,
            status=rng.choice((JobStatus.RUNNING, JobStatus.WAITING,
                               JobStatus.WAITING)),
            priority=rng.choice((0, 0, 0, 1, 1, 2)),
            metrics=JobMetrics(
                running_seconds=rng.choice((0.0, 100.0, 2000.0, 90000.0)),
                seconds_since_restart=rng.choice((0.0, 60.0, 7200.0)),
                first_start_time=rng.choice((float("inf"), 10.0, 500.0,
                                             rng.uniform(0, 1000))),
            ))
        roll = rng.random()
        if degenerate or roll < 0.2:
            info = base_job_info(job.name, job.category, job.pool,
                                 max_chips=32)
            if degenerate or rng.random() < 0.5:
                # All-zero speedup: every marginal gain is <= 0.
                info.speedup = {k: 0.0 for k in info.speedup}
            info.estimated_remaining_seconds = rng.choice(
                (0.0, 0.0, 5000.0))
            job.info = info
        elif roll < 0.7:
            info = base_job_info(job.name, job.category, job.pool,
                                 max_chips=32)
            # Learned-curve shape: concave power law with noise; ties
            # on purpose (rounding to a coarse grid).
            alpha = rng.uniform(0.4, 1.0)
            info.speedup = {k: round(k ** alpha, 2)
                            for k in info.speedup}
            info.speedup[0] = 0.0
            info.estimated_remaining_seconds = round(
                rng.uniform(0, 50000), 1)
            job.info = info
        # else: info=None (the allocator would attach; kernels must
        # handle the bare case like the oracle's `job.info or JobInfo()`)
        jobs.append(job)
    total = rng.choice((0, 1, n, 2 * n, 4 * n, 8 * n))
    return jobs, total


def self_check(n_pools: int = 50, seed: int = 20260803,
               sizes: Optional[Sequence[int]] = None) -> List[str]:
    """Differential oracle sweep: for every fastpath algorithm, run
    `n_pools` seeded random pools and compare `schedule()` (fastpath)
    against `schedule_reference()` (oracle) for exact equality —
    values AND insertion order. Returns human-readable mismatches
    (empty = equivalent). Wired into `make modelcheck-selftest`."""
    import copy
    import random

    from vodascheduler_tpu_torch.algorithms import new_algorithm

    problems: List[str] = []
    rng = random.Random(seed)
    # Force the native kernels into play for every trial (the size
    # floors exist for marshalling economics, not correctness — the
    # differential proof must cover the native layer at EVERY pool
    # size; the VODA_NO_NATIVE re-run of this sweep covers the pure
    # fastpath layer).
    global _SWEEP_NATIVE_MIN, _ET_PHASES_NATIVE_MIN
    saved = (_SWEEP_NATIVE_MIN, _ET_PHASES_NATIVE_MIN)
    _SWEEP_NATIVE_MIN = _ET_PHASES_NATIVE_MIN = 0
    try:
        return _self_check_inner(n_pools, rng, sizes, problems)
    finally:
        _SWEEP_NATIVE_MIN, _ET_PHASES_NATIVE_MIN = saved


def _self_check_inner(n_pools, rng, sizes, problems: List[str]) -> List[str]:
    import copy

    from vodascheduler_tpu_torch.algorithms import new_algorithm

    for p in range(n_pools):
        size = None if sizes is None else sizes[p % len(sizes)]
        jobs, total = random_pool(rng, size=size,
                                  degenerate=(p % 7 == 3))
        for name in FASTPATH_ALGORITHMS:
            algo = new_algorithm(name)

            def run(fn):
                # Equivalence includes the failure edge: an input the
                # oracle rejects (InvalidAllocationError) must be
                # rejected identically by the kernel — the allocator's
                # allocation_failed retry path keys on it.
                try:
                    return fn(copy.deepcopy(jobs), total)
                except InvalidAllocationError as e:
                    return ("raises", type(e).__name__, str(e))

            fast = run(algo.schedule)
            oracle = run(algo.schedule_reference)
            if isinstance(fast, tuple) or isinstance(oracle, tuple):
                if fast != oracle:
                    problems.append(
                        f"pool {p} ({len(jobs)} jobs, {total} chips) "
                        f"{name}: failure-edge mismatch: "
                        f"{oracle!r} vs {fast!r}")
                continue
            if fast != oracle:
                diff = {k: (oracle.get(k), fast.get(k))
                        for k in set(oracle) | set(fast)
                        if oracle.get(k) != fast.get(k)}
                problems.append(
                    f"pool {p} ({len(jobs)} jobs, {total} chips) "
                    f"{name}: fastpath != oracle: {diff}")
            elif list(fast) != list(oracle):
                problems.append(
                    f"pool {p} ({len(jobs)} jobs, {total} chips) "
                    f"{name}: result insertion order diverged")
    return problems
