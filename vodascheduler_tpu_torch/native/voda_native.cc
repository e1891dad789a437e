// Native kernels for the rescheduling hot path.
//
// Reference context: the reference's only native-algorithm dependency is the
// external Go munkres library (github.com/heyfey/munkres) used by the
// placement manager (placement_manager.go:505-512). SURVEY.md §2.9 names the
// resched hot-path kernels as the natural C++ candidates for this framework:
// the Hungarian assignment (O(n^3) in hosts) and the FfDL DP knapsack
// (O(jobs x chips^2)), both called on every rescheduling pass.
//
// Contracts mirror the pure-Python implementations exactly
// (placement/hungarian.py, algorithms/ffdl_optimizer.py), which remain the
// always-available fallbacks and test oracles.
//
// Build: g++ -O2 -shared -fPIC -o _voda_native.so voda_native.cc
// (vodascheduler_tpu_torch/native/__init__.py builds on demand).

#include <algorithm>
#include <cstdint>
#include <limits>
#include <queue>
#include <vector>

namespace {
constexpr double kInf = std::numeric_limits<double>::infinity();
}

extern "C" {

// Maximum-score perfect assignment on an n x n matrix (row-major).
// Writes row_to_col[i] = assigned column. Jonker-Volgenant style
// shortest-augmenting-path with dual potentials on the negated
// (minimization) form — the same algorithm as hungarian.py::_solve_min.
void voda_hungarian_max(int32_t n, const double* score, int32_t* row_to_col) {
  if (n <= 0) return;
  // cost = -score (maximize -> minimize), 1-indexed internals.
  std::vector<double> u(n + 1, 0.0), v(n + 1, 0.0);
  std::vector<int32_t> p(n + 1, 0), way(n + 1, 0);

  for (int32_t i = 1; i <= n; ++i) {
    p[0] = i;
    int32_t j0 = 0;
    std::vector<double> minv(n + 1, kInf);
    std::vector<bool> used(n + 1, false);
    do {
      used[j0] = true;
      int32_t i0 = p[j0], j1 = -1;
      double delta = kInf;
      for (int32_t j = 1; j <= n; ++j) {
        if (used[j]) continue;
        double cur = -score[(i0 - 1) * n + (j - 1)] - u[i0] - v[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        if (minv[j] < delta) {
          delta = minv[j];
          j1 = j;
        }
      }
      for (int32_t j = 0; j <= n; ++j) {
        if (used[j]) {
          u[p[j]] += delta;
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      j0 = j1;
    } while (p[j0] != 0);
    while (j0) {  // augment
      int32_t j1 = way[j0];
      p[j0] = p[j1];
      j0 = j1;
    }
  }
  for (int32_t j = 1; j <= n; ++j) {
    if (p[j]) row_to_col[p[j] - 1] = j - 1;
  }
}

// Warm/cold JV augmentation with exported dual potentials
// (hungarian.py::_augment_rows_py semantics). score is n x n row-major;
// row_to_col (in/out, -1 = unassigned), u, v (in/out) carry the
// previous solve's state; `dirty` lists the rows to (re-)augment in
// ascending order. A cold solve is simply dirty = all rows with
// row_to_col = -1 and u = v = 0. Rows NOT in `dirty` keep their
// matches and dual invariants (their cost vectors are unchanged by
// contract), so re-solve cost tracks the churn, not the fleet.
void voda_hungarian_warm(int32_t n, const double* score, int32_t n_dirty,
                         const int32_t* dirty, int32_t* row_to_col,
                         double* u, double* v) {
  if (n <= 0 || n_dirty <= 0) return;
  std::vector<double> u1(n + 1, 0.0), v1(n + 1, 0.0);
  for (int32_t i = 0; i < n; ++i) u1[i + 1] = u[i];
  for (int32_t j = 0; j < n; ++j) v1[j + 1] = v[j];
  std::vector<int32_t> p(n + 1, 0), way(n + 1, 0);
  for (int32_t i = 0; i < n; ++i) {
    if (row_to_col[i] >= 0) p[row_to_col[i] + 1] = i + 1;
  }
  for (int32_t d = 0; d < n_dirty; ++d) {
    const int32_t i = dirty[d] + 1;
    p[0] = i;
    int32_t j0 = 0;
    std::vector<double> minv(n + 1, kInf);
    std::vector<bool> used(n + 1, false);
    do {
      used[j0] = true;
      int32_t i0 = p[j0], j1 = -1;
      double delta = kInf;
      const double* row = score + (i0 - 1) * n;
      const double ui0 = u1[i0];
      for (int32_t j = 1; j <= n; ++j) {
        if (used[j]) continue;
        double cur = -row[j - 1] - ui0 - v1[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        if (minv[j] < delta) {
          delta = minv[j];
          j1 = j;
        }
      }
      for (int32_t j = 0; j <= n; ++j) {
        if (used[j]) {
          u1[p[j]] += delta;
          v1[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      j0 = j1;
    } while (p[j0] != 0);
    while (j0) {  // augment
      int32_t j1 = way[j0];
      p[j0] = p[j1];
      j0 = j1;
    }
  }
  for (int32_t i = 0; i < n; ++i) row_to_col[i] = -1;
  for (int32_t j = 1; j <= n; ++j) {
    if (p[j]) row_to_col[p[j] - 1] = j - 1;
  }
  for (int32_t i = 0; i < n; ++i) u[i] = u1[i + 1];
  for (int32_t j = 0; j < n; ++j) v[j] = v1[j + 1];
}

// Lexicographically-smallest perfect matching of a tight bipartite
// graph (hungarian.py::_canonical semantics): fix rows in ascending
// order; row i takes the smallest adjacent column that still leaves
// the remaining rows a perfect matching. `tight` is n x n row-major
// 0/1; row_to_col (in/out) must enter as a perfect matching within
// the graph. Deterministic: output depends only on the graph.
//
// Feasibility of candidate column c for row i == "c's current owner
// can reroute to the column row i would free, alternating through
// unfixed rows". Rather than a Kuhn DFS per candidate (O(E) per try,
// ruinous on the dense tight graphs degenerate score matrices
// produce), one word-parallel alternating-reachability BFS per fixed
// row marks EVERY reroutable owner at once: a row is reroutable iff
// it is tight-adjacent to the freed column or to the matched column
// of an already-marked row. Bitset frontier expansion makes each BFS
// O(n^2/64); the whole extraction is O(n^3/64) worst case — ~30M
// word-ops at n = 1250 instead of billions of pointer chases.
void voda_lexmin_pm(int32_t n, const uint8_t* tight, int32_t* row_to_col) {
  if (n <= 0) return;
  const int32_t words = (n + 63) / 64;
  // Column-major adjacency bitsets: col_adj[c] = bitset of rows
  // tight-adjacent to column c.
  std::vector<uint64_t> col_adj(static_cast<size_t>(n) * words, 0);
  for (int32_t r = 0; r < n; ++r) {
    const uint8_t* row = tight + static_cast<int64_t>(r) * n;
    const uint64_t bit = 1ull << (r & 63);
    const int32_t word = r >> 6;
    for (int32_t c = 0; c < n; ++c) {
      if (row[c]) col_adj[static_cast<size_t>(c) * words + word] |= bit;
    }
  }
  std::vector<int32_t> col_to_row(n, -1);
  for (int32_t i = 0; i < n; ++i) col_to_row[row_to_col[i]] = i;

  std::vector<uint64_t> unfixed(words, 0);  // candidate displaceable rows
  for (int32_t r = 0; r < n; ++r) unfixed[r >> 6] |= 1ull << (r & 63);
  std::vector<uint64_t> marked(words);
  std::vector<int32_t> via_col(n);   // BFS parent: the col a marked row takes
  std::vector<int32_t> col_queue(n + 1);

  for (int32_t i = 0; i < n; ++i) {
    // Row i leaves the displaceable set (its column is being fixed).
    unfixed[i >> 6] &= ~(1ull << (i & 63));
    const int32_t cur = row_to_col[i];
    const uint8_t* adj = tight + static_cast<int64_t>(i) * n;
    // Cheap pre-check: any tight candidate below cur at all?
    int32_t first = 0;
    while (first < cur && !adj[first]) ++first;
    if (first >= cur) continue;

    // Alternating-reachability BFS from the column row i would free.
    std::fill(marked.begin(), marked.end(), 0);
    int32_t qh = 0, qt = 0;
    col_queue[qt++] = cur;
    while (qh < qt) {
      const int32_t c = col_queue[qh++];
      const uint64_t* cadj = col_adj.data() + static_cast<size_t>(c) * words;
      for (int32_t w = 0; w < words; ++w) {
        uint64_t add = cadj[w] & unfixed[w] & ~marked[w];
        if (!add) continue;
        marked[w] |= add;
        while (add) {
          const int32_t r = (w << 6) + __builtin_ctzll(add);
          add &= add - 1;
          via_col[r] = c;
          col_queue[qt++] = row_to_col[r];  // r's col becomes vacatable
        }
      }
    }

    // Smallest feasible candidate: a tight col < cur whose owner can
    // reroute (owner marked). Fixed columns' owners are fixed rows,
    // never marked, so they are skipped for free.
    for (int32_t c = first; c < cur; ++c) {
      if (!adj[c]) continue;
      const int32_t owner = col_to_row[c];
      if (owner < 0 || !(marked[owner >> 6] & (1ull << (owner & 63))))
        continue;
      // Augment: row i takes c; each displaced row takes its BFS
      // parent column (the previous owner of that column is the next
      // displaced row), terminating at the freed column `cur`.
      int32_t r = owner;
      while (true) {
        const int32_t take = via_col[r];
        const int32_t next = col_to_row[take];
        row_to_col[r] = take;
        col_to_row[take] = r;
        if (take == cur) break;
        r = next;
      }
      row_to_col[i] = c;
      col_to_row[c] = i;
      break;
    }
  }
}

// ---- decide-path batch kernels (algorithms/fastpath.py semantics) ----------
//
// The FIFO/SRJF-family greedy sweeps, the ElasticTiresias lazy-heap
// auction, and the fleet comms scoring — the three Python loops that
// became the wall at 100k jobs / 10+ pools (ROADMAP "next order of
// magnitude"). Contracts mirror the pure-Python fastpath kernels EXACTLY
// (which themselves mirror the algorithm oracles): identical integer
// sweeps, identical IEEE-754 double arithmetic in the auction, identical
// heap key ordering — proven bit-identical by the seeded differential
// suite (tests/test_fleet.py + fastpath.self_check runs all three layers).

// Greedy allocation sweep over a precomputed stable order.
// mode 0: allocate_minimums only (FIFO / SRJF).
// mode 1: allocate_minimums + water-filled distribute_leftover
//         (ElasticFIFO / ElasticSRJF) — the closed-form round-robin
//         equivalent fastpath.py::_distribute_leftover documents.
// mode 2: fixed NumProc sweep (Tiresias).
// `result` must enter zero-filled.
void voda_alloc_sweep(int32_t n, const int32_t* order, const int32_t* mins,
                      const int32_t* maxes, const int32_t* nums,
                      int32_t free_chips, int32_t mode, int32_t* result) {
  if (n <= 0) return;
  if (mode == 2) {
    for (int32_t k = 0; k < n; ++k) {
      const int32_t i = order[k];
      const int32_t want = nums[i];
      if (free_chips >= want) {
        result[i] = want;
        free_chips -= want;
      }
    }
    return;
  }
  for (int32_t k = 0; k < n; ++k) {
    const int32_t i = order[k];
    const int32_t lo = mins[i];
    if (free_chips >= lo) {
      result[i] = lo;
      free_chips -= lo;
    }
  }
  if (mode != 1 || free_chips <= 0) return;
  // Water-filling leftover distribution (one chip per eligible job per
  // round, order-stable partial last round).
  std::vector<int32_t> eligible;
  eligible.reserve(n);
  for (int32_t k = 0; k < n; ++k) {
    const int32_t i = order[k];
    if (result[i] > 0 && result[i] < maxes[i]) eligible.push_back(i);
  }
  if (eligible.empty()) return;
  const int64_t m = static_cast<int64_t>(eligible.size());
  std::vector<int64_t> caps(m), caps_sorted(m);
  int64_t total_cap = 0;
  for (int64_t idx = 0; idx < m; ++idx) {
    caps[idx] = maxes[eligible[idx]] - result[eligible[idx]];
    caps_sorted[idx] = caps[idx];
    total_cap += caps[idx];
  }
  const int64_t free64 = free_chips;
  if (total_cap <= free64) {
    for (int64_t idx = 0; idx < m; ++idx)
      result[eligible[idx]] = maxes[eligible[idx]];
    return;
  }
  std::sort(caps_sorted.begin(), caps_sorted.end());
  int64_t spent = 0, k = 0, T = 0;
  while (true) {
    if (k >= m) {
      T += (m > k) ? (free64 - spent) / (m - k) : 0;
      break;
    }
    const int64_t nxt = caps_sorted[k];
    if (spent + (m - k) * (nxt - T) <= free64) {
      spent += (m - k) * (nxt - T);
      T = nxt;
      while (k < m && caps_sorted[k] == T) ++k;
      if (k == m) break;
    } else {
      T += (free64 - spent) / (m - k);
      break;
    }
  }
  int64_t used = 0;
  for (int64_t idx = 0; idx < m; ++idx)
    used += caps[idx] <= T ? caps[idx] : T;
  int64_t free_left = free64 - used;
  for (int64_t idx = 0; idx < m; ++idx) {
    const int64_t grant = caps[idx] <= T ? caps[idx] : T;
    result[eligible[idx]] += static_cast<int32_t>(grant);
  }
  if (free_left > 0) {
    for (int64_t idx = 0; idx < m && free_left > 0; ++idx) {
      if (caps[idx] > T) {
        result[eligible[idx]] += 1;
        --free_left;
      }
    }
  }
}

namespace {
// One lazy-heap auction entry: ordering replicates the Python tuple
// (-(gain*lift), priority, counter) — counters are unique (initial
// entries use the candidate position, re-pushes take decreasing
// negatives), so three fields give a total order identical to heapq's.
struct AuctionEntry {
  double neg_key;
  int32_t prio;
  int64_t ctr;
  int32_t job;
  int32_t ver;
};
struct AuctionGreater {
  bool operator()(const AuctionEntry& a, const AuctionEntry& b) const {
    if (a.neg_key != b.neg_key) return a.neg_key > b.neg_key;
    if (a.prio != b.prio) return a.prio > b.prio;
    return a.ctr > b.ctr;
  }
};
}  // namespace

// ElasticTiresias: phases 0/1/compaction + (optionally) the phase-2
// lazy-heap marginal-gain auction (fastpath.py::elastic_tiresias
// semantics, which reproduce the oracle's stable-double-sort tie
// evolution — including the floor-lift reweighting, the raw-gain<=0
// stop, and the min-or-nothing rule). Speedup curves arrive
// deduplicated: job i reads row `curve_idx[i]` of `curves` (row c
// spans curve_off[c]..curve_off[c+1]); levels outside a row read 0.0
// like dict.get. lease_ok[i] = running && inside the preemption lease;
// lift_ok[i] = running_seconds > FLOOR_LIFT_AGE_SECONDS.
// With run_auction = 0 the kernel stops after compaction (curve arrays
// may be dummies) and the caller runs the retained Python auction on
// (result, free_out) — the dispatch fastpath.py picks when a pool
// carries many distinct learned curves, where marshalling every curve
// would cost more than the auction. `result` must enter zero-filled;
// free_out receives the post-phase free count either way.
void voda_et_schedule(int32_t n, const int32_t* order, const int32_t* mins,
                      const int32_t* maxes, const int32_t* nums,
                      const int32_t* prios, const uint8_t* lease_ok,
                      const uint8_t* lift_ok, int32_t free_chips,
                      int32_t compaction_threshold, double floor_lift_weight,
                      const int32_t* curve_idx, const int64_t* curve_off,
                      const double* curves, int32_t run_auction,
                      int32_t* result, int32_t* free_out) {
  if (n <= 0) {
    if (free_out) *free_out = free_chips;
    return;
  }
  auto level = [&](int32_t i, int64_t g) -> double {
    const int32_t c = curve_idx[i];
    const int64_t lo = curve_off[c], hi = curve_off[c + 1];
    return (g >= 0 && lo + g < hi) ? curves[lo + g] : 0.0;
  };
  std::vector<uint8_t> leased(n, 0);
  int32_t pendings = n;
  // Phase 0: leased running jobs keep their minimum, in queue order.
  for (int32_t k = 0; k < n; ++k) {
    const int32_t i = order[k];
    if (lease_ok[i] && free_chips >= mins[i]) {
      result[i] = mins[i];
      free_chips -= mins[i];
      --pendings;
      leased[i] = 1;
    }
  }
  // Phase 1: fixed NumProc by queue; leased jobs top up all-or-nothing.
  for (int32_t k = 0; k < n; ++k) {
    const int32_t i = order[k];
    if (leased[i]) {
      const int32_t extra = nums[i] - result[i];
      if (extra > 0 && extra <= free_chips) {
        result[i] += extra;
        free_chips -= extra;
      }
      continue;
    }
    if (free_chips >= nums[i]) {
      result[i] = nums[i];
      free_chips -= nums[i];
      --pendings;
    }
  }
  // Compaction: deep backlog shrinks running queue>=1 jobs to minimum.
  if (pendings > compaction_threshold) {
    for (int32_t k = 0; k < n; ++k) {
      const int32_t i = order[k];
      if (prios[i] < 1) continue;
      if (result[i] != 0) {
        free_chips += result[i] - mins[i];
        result[i] = mins[i];
      }
    }
  }
  if (free_out) *free_out = free_chips;
  if (!run_auction || free_chips <= 0) return;
  // Phase 2: the lazy-heap auction.
  std::vector<int32_t> candidates;
  candidates.reserve(n);
  for (int32_t i = 0; i < n; ++i) {
    if (result[i] < maxes[i] && (result[i] > 0 || free_chips >= mins[i]))
      candidates.push_back(i);
  }
  if (candidates.empty()) return;
  std::vector<double> gains(n, 0.0);
  std::vector<int32_t> version(n, 0);
  std::vector<uint8_t> alive(n, 0);
  std::priority_queue<AuctionEntry, std::vector<AuctionEntry>,
                      AuctionGreater> heap;
  for (size_t pos = 0; pos < candidates.size(); ++pos) {
    const int32_t i = candidates[pos];
    const double g = result[i] > 0
        ? level(i, result[i] + 1) - level(i, result[i])
        : level(i, mins[i]) / static_cast<double>(mins[i]);
    gains[i] = g;
    alive[i] = 1;
    const double lift =
        (result[i] <= mins[i] && lift_ok[i]) ? floor_lift_weight : 1.0;
    heap.push({-(g * lift), prios[i], static_cast<int64_t>(pos), i, 0});
  }
  int64_t next_counter = -1;
  while (free_chips > 0 && !heap.empty()) {
    const AuctionEntry e = heap.top();
    const int32_t i = e.job;
    if (!alive[i] || e.ver != version[i]) {
      heap.pop();
      continue;
    }
    if (gains[i] <= 0.0) break;  // no algorithm-wide gain remains
    if (result[i] == 0) {
      if (free_chips >= mins[i]) {
        result[i] = mins[i];
        free_chips -= mins[i];
      } else {
        alive[i] = 0;
        heap.pop();
        continue;
      }
    } else {
      result[i] += 1;
      free_chips -= 1;
      if (result[i] >= maxes[i]) {
        alive[i] = 0;
        heap.pop();
        continue;
      }
    }
    heap.pop();
    const double g = level(i, result[i] + 1) - level(i, result[i]);
    gains[i] = g;
    version[i] = e.ver + 1;
    const double lift =
        (result[i] <= mins[i] && lift_ok[i]) ? floor_lift_weight : 1.0;
    heap.push({-(g * lift), prios[i], next_counter--, i, e.ver + 1});
  }
}

// Fleet comms scoring (placement/manager.py::_fleet_stats semantics):
// per-job contiguity cost = sum of pairwise torus L1 host distances
// (topology.py::contiguity_cost, pure integers) over the job's host
// coords, plus the three fleet totals. `crossed[j]` arrives precomputed
// (len(used hosts) > 1 — slot bookkeeping stays in Python); job j's
// coords span offsets[j]..offsets[j+1] rows of `coords` (ndims ints
// each). out_totals = {cross, contiguity, comms}.
void voda_comms_score(int32_t ndims, const int32_t* grid, int32_t n_jobs,
                      const int64_t* offsets, const int32_t* coords,
                      const int32_t* weights, const uint8_t* crossed,
                      int64_t* out_contig, int64_t* out_totals) {
  int64_t cross = 0, contig_total = 0, comms_total = 0;
  for (int32_t j = 0; j < n_jobs; ++j) {
    const int64_t lo = offsets[j], hi = offsets[j + 1];
    int64_t contig = 0;
    for (int64_t a = lo; a < hi; ++a) {
      const int32_t* ca = coords + a * ndims;
      for (int64_t b = a + 1; b < hi; ++b) {
        const int32_t* cb = coords + b * ndims;
        for (int32_t d = 0; d < ndims; ++d) {
          const int32_t diff = ca[d] >= cb[d] ? ca[d] - cb[d] : cb[d] - ca[d];
          const int32_t wrap = grid[d] - diff;
          contig += diff < wrap ? diff : wrap;
        }
      }
    }
    out_contig[j] = contig;
    cross += crossed[j] ? 1 : 0;
    contig_total += crossed[j] ? contig : 0;
    comms_total += crossed[j] ? static_cast<int64_t>(weights[j]) * contig : 0;
  }
  out_totals[0] = cross;
  out_totals[1] = contig_total;
  out_totals[2] = comms_total;
}

// FfDL DP knapsack (ffdl_optimizer.py semantics, including the g=0 inherit
// case). speedup is J x (K+1) row-major: speedup[j*(K+1)+g] = job j's
// speedup at g chips. lo/hi are per-job chip bounds. Writes out_alloc[j].
void voda_ffdl_dp(int32_t J, int32_t K, const int32_t* lo, const int32_t* hi,
                  const double* speedup, int32_t* out_alloc) {
  if (J <= 0 || K < 0) return;
  const int32_t W = K + 1;
  std::vector<double> P((J + 1) * W, 0.0);
  std::vector<int32_t> SOL((J + 1) * W, 0);

  for (int32_t j = 1; j <= J; ++j) {
    const double* sp = speedup + (j - 1) * W;
    const double* Pprev = P.data() + (j - 1) * W;
    double* Pcur = P.data() + j * W;
    int32_t* Scur = SOL.data() + j * W;
    const int32_t jlo = lo[j - 1];
    const int32_t jhi = hi[j - 1];
    for (int32_t k = 0; k <= K; ++k) {
      double best = Pprev[k];  // g = 0: job unscheduled, inherit
      int32_t best_g = 0;
      const int32_t gmax = jhi < k ? jhi : k;
      for (int32_t g = jlo; g <= gmax; ++g) {
        const double cand = sp[g] + Pprev[k - g];
        if (cand > best) {
          best = cand;
          best_g = g;
        }
      }
      Pcur[k] = best;
      Scur[k] = best_g;
    }
  }

  int32_t k = K;
  for (int32_t j = J; j >= 1; --j) {  // backtrack
    out_alloc[j - 1] = SOL[j * W + k];
    k -= SOL[j * W + k];
  }
}

}  // extern "C"
