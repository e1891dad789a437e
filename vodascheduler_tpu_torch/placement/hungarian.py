"""Hungarian (Kuhn–Munkres) assignment, max-score square variant, with
canonical tie-breaking and warm-started incremental re-solve.

Reference counterpart: the external github.com/heyfey/munkres library the
reference calls as `ComputeMunkresMax` (placement_manager.go:505-512) to
relabel logical nodes onto physical ones, maximizing already-in-place
workers.

Three layers (ROADMAP item 2, the decide-path kernels):

1. **Solvers.** The O(n³) shortest-augmenting-path (Jonker–Volgenant)
   algorithm on the negated (minimization) form, exporting the dual
   potentials: a pure-Python row-augment loop (the oracle), a numpy
   inner loop for cold solves on big pools, and the C++ kernels in
   native/voda_native.cc (`voda_hungarian_warm`; the original
   `voda_hungarian_max` stays the ABI-stable raw fallback).

2. **Warm start.** `solve_max_warm` carries the previous solve's duals
   + assignment in a `WarmState`. Rows whose score vector changed are
   unassigned and re-augmented against the retained potentials; rows
   untouched by the churn keep their matches and their dual invariants
   (their cost vectors are unchanged, so feasibility and complementary
   slackness still hold). Most defragment passes touch a handful of
   logical hosts, so re-solve cost tracks the churn, not the fleet.

3. **Canonical extraction.** Optimal assignments are not unique, and a
   warm re-solve is free to find a different optimum than a cold solve
   — unacceptable when replay determinism and the differential-oracle
   suite demand bit-identical decisions. By LP complementary slackness,
   EVERY optimal assignment is tight (u[i]+v[j] == cost[i][j]) under
   ANY optimal dual, and every perfect matching of the tight subgraph
   is optimal — so the set of perfect matchings of the tight graph is
   the full set of optimal assignments, *independent of which dual the
   solver found*. Extracting the lexicographically-smallest perfect
   matching of that graph therefore yields one canonical assignment
   for cold, warm, python, numpy, and native paths alike; warm-vs-cold
   equality is a theorem, and tests/test_fastpath_oracle.py checks it
   over seeded churn sequences. Exactness caveat: tightness is tested
   with ==, which is exact for integer-valued scores (the placement
   overlap scores are worker counts); arbitrary-float scores remain
   optimal but may not canonicalize across solvers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

from vodascheduler_tpu_torch import native
from vodascheduler_tpu_torch.obs import profile as obs_profile

try:  # pragma: no cover - numpy ships with the jax toolchain
    import numpy as _np
except Exception:  # pragma: no cover
    _np = None

# Below this n the numpy solver's per-call overhead beats its
# vectorized inner loop; the pure-Python oracle is faster.
_NUMPY_SOLVE_MIN = 48


@dataclasses.dataclass
class WarmState:
    """One solve's reusable artifacts: the score matrix it answered
    (a float64 ndarray when numpy is present, else lists), the dual
    potentials, and the assignment. Opaque to callers — hand it back
    to `solve_max_warm` and replace it with the returned one."""

    score: object
    u: List[float]
    v: List[float]
    row_to_col: List[int]

    @property
    def n(self) -> int:
        return len(self.row_to_col)


def solve_max(score: Sequence[Sequence[float]]) -> List[Tuple[int, int]]:
    """Maximum-score canonical assignment on a square matrix.

    Returns [(row, col), ...] with each row and column used exactly
    once — the lexicographically-smallest optimal assignment (see
    module docstring), so equal inputs give equal outputs across every
    solver backend and across warm/cold paths.

    Profiled as its own `hungarian` phase (obs/profile.py, nested
    inside the pass's `placement` phase)."""
    n = _check_square(score)
    if n == 0:
        return []
    with obs_profile.phase("hungarian"):
        arr = _as_matrix(score)
        row_to_col, u, v = _solve_duals(arr, None, list(range(n)))
        row_to_col = _canonical(arr, row_to_col, u, v)
        return [(r, c) for r, c in enumerate(row_to_col)]


def solve_max_warm(score: Sequence[Sequence[float]],
                   state: Optional[WarmState]
                   ) -> Tuple[List[Tuple[int, int]], WarmState]:
    """Warm-started canonical assignment: identical output to
    `solve_max(score)` (canonicalization makes that a theorem for
    integer-valued scores), re-solving only rows whose score vector
    changed since `state`. Pass state=None (or a state of a different
    size) for a cold solve; always store the RETURNED state."""
    n = _check_square(score)
    if n == 0:
        return [], WarmState(score=[], u=[], v=[], row_to_col=[])
    arr = _as_matrix(score)
    if state is None or state.n != n:
        dirty = list(range(n))
        state = None
    elif _np is not None:
        dirty = _np.nonzero(
            (arr != state.score).any(axis=1))[0].tolist()
    else:  # pragma: no cover - numpy ships with the jax toolchain
        old = state.score
        dirty = [i for i in range(n) if list(score[i]) != list(old[i])]
    phase_name = "hungarian" if state is None else "hungarian_warm"
    with obs_profile.phase(phase_name):
        row_to_col, u, v = _solve_duals(arr, state, dirty)
        canon = _canonical(arr, row_to_col, u, v)
        new_state = WarmState(score=arr if _np is not None
                              else [list(row) for row in score],
                              u=u, v=v, row_to_col=row_to_col)
        return [(r, c) for r, c in enumerate(canon)], new_state


def _as_matrix(score):
    """The solver-internal matrix form: one float64 ndarray conversion
    at the boundary (every later stage — native marshalling, dirty-row
    diff, tight-graph build — reuses it for free); plain lists when
    numpy is absent."""
    if _np is None:  # pragma: no cover
        return score
    return _np.asarray(score, dtype=_np.float64)


def _check_square(score: Sequence[Sequence[float]]) -> int:
    n = len(score)
    for row in score:
        if len(row) != n:
            raise ValueError("score matrix must be square")
    return n


# ---- duals-exporting solvers ------------------------------------------------


def _solve_duals(score: Sequence[Sequence[float]],
                 state: Optional[WarmState],
                 dirty: List[int]) -> Tuple[List[int], List[float], List[float]]:
    """Optimal assignment + duals for cost = -score, re-augmenting only
    `dirty` rows against `state` (cold when state is None). Returns
    0-indexed (row_to_col, u, v)."""
    n = len(score)
    if state is None:
        row_to_col = [-1] * n
        u = [0.0] * n
        v = [0.0] * n
    else:
        row_to_col = list(state.row_to_col)
        u = list(state.u)
        v = list(state.v)
        for i in dirty:
            row_to_col[i] = -1
            u[i] = 0.0
        # (columns freed implicitly: the col->row map is rebuilt below)
        if not dirty:
            return row_to_col, u, v
    nat = _native_warm(score, row_to_col, u, v, dirty)
    if nat is not None:
        return nat
    if _np is not None and n >= _NUMPY_SOLVE_MIN:
        return _augment_rows_np(score, row_to_col, u, v, dirty)
    return _augment_rows_py(score, row_to_col, u, v, dirty)


def _native_warm(score, row_to_col, u, v, dirty):
    """C++ warm/cold augmentation (voda_hungarian_warm); None when the
    kernel is unavailable (the ctypes loader's Python-fallback
    contract)."""
    return native.hungarian_warm(score, row_to_col, u, v, dirty)


def _augment_rows_py(score, row_to_col, u, v,
                     rows: List[int]) -> Tuple[List[int], List[float], List[float]]:
    """Pure-Python JV augmentation of `rows` (ascending) against
    existing duals/partial matching — the oracle. 1-indexed internals
    per the classic formulation (e-maxx), converted at the boundary."""
    n = len(score)
    if _np is not None and hasattr(score, "tolist"):
        score = score.tolist()  # ndarray scalar indexing is ~10x a list's
    INF = math.inf
    u1 = [0.0] + [u[i] for i in range(n)]
    v1 = [0.0] + [v[j] for j in range(n)]
    p = [0] * (n + 1)     # p[col] = row matched to col (0 = none)
    for i, j in enumerate(row_to_col):
        if j >= 0:
            p[j + 1] = i + 1
    way = [0] * (n + 1)
    for row in rows:
        i = row + 1
        p[0] = i
        j0 = 0
        minv = [INF] * (n + 1)
        used = [False] * (n + 1)
        while True:
            used[j0] = True
            i0 = p[j0]
            delta = INF
            j1 = -1
            cost_row = score[i0 - 1]
            ui0 = u1[i0]
            for j in range(1, n + 1):
                if used[j]:
                    continue
                cur = -cost_row[j - 1] - ui0 - v1[j]
                if cur < minv[j]:
                    minv[j] = cur
                    way[j] = j0
                if minv[j] < delta:
                    delta = minv[j]
                    j1 = j
            for j in range(0, n + 1):
                if used[j]:
                    u1[p[j]] += delta
                    v1[j] -= delta
                else:
                    minv[j] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0:  # augment along the path
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    out = [-1] * n
    for j in range(1, n + 1):
        if p[j]:
            out[p[j] - 1] = j - 1
    return out, u1[1:], v1[1:]


def _augment_rows_np(score, row_to_col, u, v,
                     rows: List[int]) -> Tuple[List[int], List[float], List[float]]:
    """numpy JV augmentation: same algorithm as _augment_rows_py with
    the O(n) inner relaxation vectorized — the cold-solve kernel for
    big pools when the native library is absent."""
    n = len(score)
    cost = -_np.asarray(score, dtype=_np.float64)
    ua = _np.zeros(n + 1)
    va = _np.zeros(n + 1)
    ua[1:] = u
    va[1:] = v
    p = _np.zeros(n + 1, dtype=_np.int64)
    for i, j in enumerate(row_to_col):
        if j >= 0:
            p[j + 1] = i + 1
    way = _np.zeros(n + 1, dtype=_np.int64)
    INF = _np.inf
    for row in rows:
        i = row + 1
        p[0] = i
        j0 = 0
        minv = _np.full(n + 1, INF)
        used = _np.zeros(n + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = int(p[j0])
            cur = cost[i0 - 1] - ua[i0] - va[1:]
            live = ~used[1:]
            better = live & (cur < minv[1:])
            minv[1:][better] = cur[better]
            way[1:][better] = j0
            masked = _np.where(live, minv[1:], INF)
            j1 = int(_np.argmin(masked)) + 1
            delta = masked[j1 - 1]
            ua[p[used]] += delta
            va[used] -= delta
            minv[~used] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0:
            j1 = int(way[j0])
            p[j0] = p[j1]
            j0 = j1
    out = [-1] * n
    for j in range(1, n + 1):
        if p[j]:
            out[p[j] - 1] = j - 1
    return out, ua[1:].tolist(), va[1:].tolist()


# ---- canonical extraction ---------------------------------------------------


def _canonical(score, row_to_col: List[int], u: List[float],
               v: List[float]) -> List[int]:
    """Lexicographically-smallest perfect matching of the tight graph
    (see module docstring). Fixes rows in ascending order: row i takes
    the smallest tight column that still leaves the remaining rows a
    perfect matching (checked by Kuhn augmentation from the displaced
    row). The native kernel (voda_lexmin_pm) carries big fleets;
    Python rides small ones."""
    n = len(row_to_col)
    # Tight adjacency on cost = -score: u[i] + v[j] == -score[i][j].
    # The solver's own matching edges are tight by construction; force
    # them in case of float fuzz on non-integer scores.
    if _np is not None:
        cost = -_np.asarray(score, dtype=_np.float64)
        tight = (_np.asarray(u)[:, None] + _np.asarray(v)[None, :]) == cost
        tight[_np.arange(n), row_to_col] = True
        nat = native.lexmin_pm(tight, row_to_col)
        if nat is not None:
            return nat
        adj = [list(_np.nonzero(tight[i])[0]) for i in range(n)]
    else:  # pragma: no cover - numpy ships with the jax toolchain
        adj = []
        for i in range(n):
            row = score[i]
            ui = u[i]
            cols = [j for j in range(n) if ui + v[j] == -row[j]]
            if row_to_col[i] not in cols:
                cols.append(row_to_col[i])
                cols.sort()
            adj.append(cols)
    match_rc = list(row_to_col)
    match_cr = [-1] * n
    for i, j in enumerate(match_rc):
        match_cr[j] = i

    def try_reroute(start: int, fixed_through: int,
                    visited: List[bool]) -> bool:
        """Iterative Kuhn augment: find row `start` a new tight column,
        displacing only rows > fixed_through (fixed rows keep their
        columns), ending at the one free column. Mutates the matching
        only on success."""
        # Each stack frame: (row, iterator over its candidate columns,
        # column taken to reach this row).
        stack = [(start, iter(adj[start]))]
        path_cols: List[int] = []
        while stack:
            row, it = stack[-1]
            advanced = False
            for c in it:
                c = int(c)
                if visited[c]:
                    continue
                owner = match_cr[c]
                if owner != -1 and owner <= fixed_through:
                    continue
                visited[c] = True
                if owner == -1:
                    # Augment along the path: col c goes to `row`, and
                    # each earlier row takes the col that displaced it.
                    path_cols.append(c)
                    rows = [f[0] for f in stack]
                    for r, col in zip(reversed(rows), reversed(path_cols)):
                        match_rc[r] = col
                        match_cr[col] = r
                    return True
                stack.append((owner, iter(adj[owner])))
                path_cols.append(c)
                advanced = True
                break
            if not advanced:
                stack.pop()
                if path_cols:
                    path_cols.pop()
        return False

    for i in range(n):
        cur = match_rc[i]
        for c in adj[i]:
            c = int(c)
            if c >= cur:
                break  # adj is ascending; nothing smaller remains
            owner = match_cr[c]
            if owner != -1 and owner < i:
                continue  # column already fixed to an earlier row
            # Tentatively take c (freeing cur); the displaced owner
            # must reroute through non-fixed rows to the freed column.
            match_cr[cur] = -1
            match_rc[i] = c
            match_cr[c] = i
            ok = True
            if owner != -1:
                visited = [False] * n
                visited[c] = True
                ok = try_reroute(owner, i, visited)
            if ok:
                cur = c
                break
            match_rc[i] = cur  # revert
            match_cr[c] = owner
            match_cr[cur] = i
    return match_rc


def _solve_min(cost: List[List[float]]) -> List[int]:
    """Jonker-Volgenant-style O(n³) min-cost assignment (the raw,
    non-canonical oracle kept for parity tests and as the simplest
    statement of the algorithm). Returns col assigned to each row."""
    n = len(cost)
    neg_score = [[-c for c in row] for row in cost]
    out, _, _ = _augment_rows_py(neg_score, [-1] * n, [0.0] * n, [0.0] * n,
                                 list(range(n)))
    return out
