"""Fleet control plane: concurrent multi-pool decide + cross-pool routing.

ROADMAP item "next order of magnitude": one Scheduler owns one pool and
PRs 8-10 made a single pool fast, but the control plane still ran one
serial decide pass per pool — at 10+ heterogeneous pools (the reference
deploys one scheduler per GPU type, scheduler.go:189-190) the fleet
pass cost the SUM of the pools instead of the slowest pool. Two pieces
(doc/observability.md "Fleet decide"):

- `FleetCoordinator`: runs N pools' decide passes concurrently on one
  bounded executor (`VODA_FLEET_WORKERS`). The decide/actuate lock
  split (PR 4) makes this safe — each pool's pass locks only ITS
  scheduler, and the shared store/allocator/bus/registry are all
  internally locked leaf objects (the pinned lock order in
  doc/lock_order.json has no scheduler->scheduler edge, so two pools
  can never deadlock each other). Every fleet pass carries a
  fleet-generation token and emits one `fleet` span + one fleet-level
  `perf_report` (phase `fleet_decide`); `fleet_snapshot()` aggregates
  per-pool state LOCK-FREE (ledger snapshots + the schedulers'
  version-stamped status caches), so an operator view of a 100k-job
  fleet never waits out a pass.

- `FleetRouter`: places jobs admitted WITHOUT an explicit pool by
  fleet-wide score — free chips minus backlog, with family<->topology
  comms affinity (PR 10's integer comms weights steer collective-heavy
  families toward the densest feasible host blocks). Behind
  `VODA_FLEET_ROUTER=0` the static reference path is untouched (one
  queue per declared pool, unrouted specs rejected at admission).
  Every decision emits a closed-schema `fleet_route` record
  (obs/audit.py ROUTE_REASONS — two-sided vocabulary like every other
  reason code in the tree).
"""

from __future__ import annotations

import collections
import logging
import threading
import time as _walltime
from typing import Callable, Dict, List, Optional, Tuple

from vodascheduler_tpu_torch import config
from vodascheduler_tpu_torch.common.metrics import (
    Registry,
    nearest_rank_percentile,
)
from vodascheduler_tpu_torch.obs import audit as obs_audit
from vodascheduler_tpu_torch.obs import profile as obs_profile
from vodascheduler_tpu_torch.obs import tracer as obs_tracer

log = logging.getLogger(__name__)

# How many recent routing latencies the router retains for its p50/p99
# stats (GET /debug/fleet, `voda top --fleet`).
ROUTER_STATS_RING = 2048


class FleetRouter:
    """Cross-pool admission placement by fleet-wide score.

    A spec routes when it names no pool (`""`/`"auto"`) or names the
    process-wide default pool on a fleet that doesn't declare it (the
    "didn't say" shape a multi-pool deployment actually sees — the old
    behavior was a 400). Explicit configured pools pass through
    untouched, audited as `explicit_pool`.

    Scoring is deliberately integer and cheap: for each pool,
    `free_chips - backlog` (backlog = waiting jobs + queued bus events
    — both demand the free chips must first absorb), read LOCK-FREE
    from the schedulers' booking ledgers. Comms-weighted families
    (placement/comms.py) add `weight * chips_per_host` so a
    collective-heavy job prefers the densest feasible host block: on a
    TPU fleet the same 8 chips cost different step times depending on
    how many hops its collectives pay, and the router is the first
    chance to put the job somewhere those hops are cheap. Ties break on
    pool name (deterministic, replay-stable).
    """

    def __init__(self, schedulers: Dict[str, object],
                 enabled: Optional[bool] = None,
                 default_pool: Optional[str] = None,
                 tracer: Optional[obs_tracer.Tracer] = None,
                 bus=None, journal=None):
        self.schedulers = schedulers  # live dict, shared with the app
        self.enabled = config.FLEET_ROUTER if enabled is None else bool(enabled)
        self.default_pool = (config.DEFAULT_POOL if default_pool is None
                             else default_pool)
        self.tracer = tracer
        self.bus = bus
        # Durability seam (doc/durability.md): committed routing
        # decisions append `jroute` records to the fleet journal so a
        # restarted control plane can audit where every admitted job
        # was sent (the store's pool field is the recovery authority;
        # the journal is the durable decision trail).
        self.journal = journal
        self._lock = threading.Lock()
        self._routed_total = 0
        # In-flight correction: jobs this router has sent to a pool that
        # the pool's scheduler has not yet absorbed into its tables. A
        # bulk batch routes all its specs BEFORE the CREATE events
        # publish (admission's all-or-nothing hand-off), so the live
        # backlog is frozen mid-burst — without this term every spec of
        # a 5k burst would land on the same argmax pool.
        self._routed_to: Dict[str, int] = {}
        self._by_reason: Dict[str, int] = {}
        self._recent_route_ms: collections.deque = collections.deque(
            maxlen=ROUTER_STATS_RING)
        self._last_scores: Dict[str, int] = {}
        # Per-pool load cache keyed on the schedulers' state-version
        # tuple: within one frozen burst (no scheduler mutation) every
        # route costs O(pools) dict probes instead of O(fleet) ledger
        # copies; any pass/event bumps a version and invalidates.
        # Version-keyed (never wall-clock) so routing stays
        # replay-deterministic for the model checker.
        self._load_cache: Optional[Tuple[Tuple[int, ...],
                                         Dict[str, Tuple[int, int, int]]]] \
            = None

    # ---- routing ----------------------------------------------------------

    def needs_route(self, pool: str) -> bool:
        """Whether a spec's pool field asks for fleet placement."""
        if pool in ("", "auto"):
            return True
        return pool == self.default_pool and pool not in self.schedulers

    def route_pending(self, spec) -> Dict[str, object]:
        """Score `spec` and reserve its in-flight slot, WITHOUT emitting
        the audit record or counting stats — the caller owns the
        admission outcome and must `commit_routes` (success) or
        `abort_routes` (shed/rejection/rollback) the returned pending
        decision, so the audit trail only ever asserts placements that
        actually happened and a failed burst leaves no phantom backlog
        in the in-flight correction. Raises ValueError when routing is
        disabled and the spec names no configured pool (the static
        reference path's admission error)."""
        t0 = _walltime.monotonic()
        reasons: List[str] = []
        scores: Dict[str, int] = {}
        if not self.needs_route(spec.pool):
            pool = spec.pool
            self._add_route_reason(reasons, "explicit_pool")
        elif not self.enabled:
            # Static reference path: a defaulted pool that IS configured
            # still lands there; anything else is admission's 400.
            if self.default_pool in self.schedulers:
                pool = self.default_pool
                self._add_route_reason(reasons, "router_disabled")
            else:
                raise ValueError(
                    f"unknown pool {spec.pool!r} and the fleet router is "
                    f"disabled (VODA_FLEET_ROUTER=0); configured pools: "
                    f"{sorted(self.schedulers)}")
        elif len(self.schedulers) == 1:
            pool = next(iter(self.schedulers))
            self._add_route_reason(reasons, "single_pool")
        else:
            with obs_profile.phase("route"):
                pool, scores, affinity = self._score(spec)
            if affinity:
                self._add_route_reason(reasons, "affinity_preferred")
            self._add_route_reason(reasons, "best_score")
        took_ms = (_walltime.monotonic() - t0) * 1000.0
        routed = "explicit_pool" not in reasons
        if routed:
            # Reserved NOW (not at commit): later specs of the same
            # burst must see this decision in the in-flight correction.
            with self._lock:
                self._routed_to[pool] = self._routed_to.get(pool, 0) + 1
        return {"job": spec.name, "pool": pool, "reasons": reasons,
                "scores": scores, "took_ms": took_ms, "routed": routed}

    def commit_routes(self, pendings) -> None:
        """The admission outcome landed: count stats and emit the
        `fleet_route` audit records."""
        with self._lock:
            for p in pendings:
                self._routed_total += 1
                for code in p["reasons"]:
                    self._by_reason[code] = self._by_reason.get(code, 0) + 1
                self._recent_route_ms.append(p["took_ms"])
                if p["scores"]:
                    self._last_scores = dict(p["scores"])
        for p in pendings:
            if self.journal is not None:
                # FencedOut propagates (a deposed control plane must
                # not keep admitting); storage errors only cost audit.
                try:
                    self.journal.append("jroute", {"job": p["job"],
                                                   "pool": p["pool"]})
                except OSError:
                    log.exception("jroute append failed")
            self._emit(p["job"], p["pool"], p["reasons"], p["scores"])

    def abort_routes(self, pendings) -> None:
        """The admission was shed/rejected/rolled back: release the
        in-flight reservations (nothing was placed — audit stays
        silent, stats uncounted, and the correction cannot accrete
        phantom backlog from retried 429s)."""
        with self._lock:
            for p in pendings:
                if p["routed"]:
                    left = self._routed_to.get(p["pool"], 0) - 1
                    if left > 0:
                        self._routed_to[p["pool"]] = left
                    else:
                        self._routed_to.pop(p["pool"], None)

    def route(self, spec) -> Tuple[str, List[str]]:
        """Route-and-commit in one step — for standalone callers that
        own no batch outcome. The admission path uses
        `route_pending`/`commit_routes`/`abort_routes` instead."""
        pending = self.route_pending(spec)
        self.commit_routes([pending])
        return pending["pool"], pending["reasons"]

    def _fleet_loads(self) -> Dict[str, Tuple[int, int, int]]:
        """{pool: (free, waiting, pending)} from ONE ledger snapshot per
        pool, cached on the schedulers' state-version tuple — a burst
        against a quiet fleet pays the O(fleet) read once, not per
        spec. Versions are read lock-free; a racing mutation just makes
        the next route rebuild."""
        token = tuple(s.state_version for _, s in
                      sorted(self.schedulers.items()))
        cache = self._load_cache
        if cache is not None and cache[0] == token:
            return cache[1]
        loads: Dict[str, Tuple[int, int, int]] = {}
        for name, sched in self.schedulers.items():
            booked_map = sched.job_num_chips.snapshot()
            booked = sum(booked_map.values())
            waiting = sum(1 for n in booked_map.values() if n == 0)
            free = max(0, sched.total_chips - booked)
            pending = self.bus.pending(name) if self.bus is not None else 0
            loads[name] = (free, waiting, pending)
        self._load_cache = (token, loads)
        return loads

    def _score(self, spec) -> Tuple[str, Dict[str, int], bool]:
        """(winner, per-pool scores, affinity-decided?). Lock-free
        fleet reads: one cached ledger snapshot per pool plus len()
        probes — a router decision must never wait out a pool's
        in-flight decide pass."""
        from vodascheduler_tpu_torch.common.job import category_of
        from vodascheduler_tpu_torch.placement import comms as comms_mod

        profile = comms_mod.profile_for_job(
            spec.collectives, category_of(spec.name))
        weight = 0 if profile is None else profile.weight()
        scores: Dict[str, int] = {}
        affinity_terms: Dict[str, int] = {}
        with self._lock:
            routed_to = dict(self._routed_to)
        loads = self._fleet_loads()
        for name, sched in self.schedulers.items():
            free, waiting, pending = loads[name]
            # Routed-but-unabsorbed jobs count as backlog: once the
            # scheduler has accepted them they appear in its tables and
            # the correction self-cancels (clamped — explicit
            # admissions can make the table count exceed ours). A
            # routed job whose CREATE is queued-but-undrained would be
            # counted by BOTH inflight and pending; max() takes the
            # larger population instead of summing the overlap.
            absorbed = len(sched.ready_jobs) + len(sched.done_jobs)
            inflight = max(0, routed_to.get(name, 0) - absorbed)
            backlog = waiting + max(inflight, pending)
            affinity = 0
            if weight > 0:
                pm = getattr(sched, "placement_manager", None)
                topo = getattr(pm, "topology", None) if pm else None
                if topo is not None:
                    affinity = weight * topo.chips_per_host
            affinity_terms[name] = affinity
            scores[name] = free - backlog + affinity
        winner = min(scores, key=lambda p: (-scores[p], p))
        # Affinity "decided" when removing the term would change the pick.
        base_winner = min(scores,
                          key=lambda p: (-(scores[p] - affinity_terms[p]), p))
        return winner, scores, winner != base_winner

    def _add_route_reason(self, reasons: List[str], code: str) -> None:
        """Tag a decision with a ROUTE_REASONS entry (the vodalint vocab
        rule checks these literals forward, like `_add_reason`)."""
        if code not in reasons:
            reasons.append(code)

    def _emit(self, job: str, pool: str, reasons: List[str],
              scores: Dict[str, int]) -> None:
        tracer = self.tracer or obs_tracer.get_tracer()
        rec = {
            "kind": "fleet_route",
            "schema": obs_audit.SCHEMA_VERSION,
            "job": job,
            "pool": pool,
            "reasons": list(reasons),
            "scores": dict(scores),
        }
        try:
            tracer.emit(rec)
        except Exception:  # noqa: BLE001 - audit must never fail admission
            log.debug("fleet_route emit failed", exc_info=True)

    # ---- stats (GET /debug/fleet, voda top --fleet) -----------------------

    def stats(self) -> Dict[str, object]:
        with self._lock:
            recent = list(self._recent_route_ms)
            by_reason = dict(self._by_reason)
            last_scores = dict(self._last_scores)
            total = self._routed_total
        return {
            "enabled": self.enabled,
            "decisions_total": total,
            "by_reason": by_reason,
            "route_ms": {
                "count": len(recent),
                "p50": round(nearest_rank_percentile(recent, 0.50), 4),
                "p99": round(nearest_rank_percentile(recent, 0.99), 4),
            },
            "last_scores": last_scores,
        }


class FleetCoordinator:
    """Concurrent per-pool decide on one bounded fleet executor.

    The coordinator owns no scheduling state — every pool's Scheduler
    keeps its own lock, ledger, and audit rings. What the coordinator
    adds is the fan-out (a fleet pass costs the slowest pool, not the
    sum), the fleet-generation token stamping each fan-out, and the
    lock-free fleet-wide aggregation the operator surface reads. Its
    own `_lock` is a LEAF: never held across a scheduler call, so the
    witnessed lock order gains `fleet._lock` with no outgoing edge into
    any scheduler (pinned in doc/lock_order.json).
    """

    def __init__(self, schedulers: Dict[str, object],
                 workers: Optional[int] = None,
                 tracer: Optional[obs_tracer.Tracer] = None,
                 registry: Optional[Registry] = None,
                 router: Optional[FleetRouter] = None):
        self.schedulers = schedulers  # live dict, shared with the app
        self.workers = max(1, int(config.FLEET_WORKERS
                                  if workers is None else workers))
        self.tracer = tracer
        self.router = router
        self._lock = threading.Lock()
        self._generation = 0
        self._executor = None
        self._closed = False
        self._last_pass: Optional[Dict[str, object]] = None
        if registry is not None:
            registry.gauge("voda_fleet_pools", "Pools under the fleet "
                           "coordinator",
                           fn=lambda: float(len(self.schedulers)))
            registry.gauge("voda_fleet_generation",
                           "Fleet passes fanned out since start",
                           fn=lambda: float(self._generation))
        self.h_fleet_pass = None if registry is None else registry.histogram(
            "voda_fleet_pass_seconds",
            "Wall time of one concurrent multi-pool decide fan-out "
            "(the critical path across pools, not the sum)",
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0,
                     60.0))

    # ---- executor lifecycle ----------------------------------------------

    def _pool_executor(self):
        """The shared bounded executor, created lazily so a single-pool
        app never spawns fleet threads. Thread names are enumerable
        (voda-fleet-*) — the teardown hygiene the 16-pool test pins."""
        with self._lock:
            if self._closed:
                raise RuntimeError("fleet coordinator is closed")
            if self._executor is None:
                from concurrent.futures import ThreadPoolExecutor
                self._executor = ThreadPoolExecutor(
                    max_workers=self.workers,
                    thread_name_prefix="voda-fleet")
            return self._executor

    def close(self) -> None:
        """Join the fleet executor's threads. Idempotent; after close
        the coordinator refuses new fan-outs (pool schedulers keep
        serving their own serial paths)."""
        with self._lock:
            self._closed = True
            executor, self._executor = self._executor, None
        if executor is not None:
            executor.shutdown(wait=True)

    @property
    def generation(self) -> int:
        return self._generation

    # ---- the fleet pass ---------------------------------------------------

    def run_pending(self) -> int:
        """Pump every pool with a due pass concurrently (the real-time
        daemon's driver). Returns how many pools ran. Pools whose
        rate-limit window is closed cost one lock-free probe each."""
        due = [s for s in self.schedulers.values() if s.resched_pending]
        if not due:
            return 0
        self._fan_out([(s.pool_id, s.pump) for s in due])
        return len(due)

    def run_fleet_pass(self, pools: Optional[List[str]] = None,
                       profiler: Optional[obs_profile.PhaseTimer] = None
                       ) -> Dict[str, object]:
        """Trigger + run one decide pass on every named pool (default:
        all), fanned out on the fleet executor. One `fleet` span and one
        fleet-level perf_report (phase `fleet_decide`) cover the whole
        fan-out; per-pool passes keep their own spans/records untouched.
        Returns {generation, pools, wall_ms, per_pool_ms}."""
        names = list(pools if pools is not None else self.schedulers)
        with self._lock:
            self._generation += 1
            gen = self._generation
        tracer = self.tracer or obs_tracer.get_tracer()
        prof = profiler or obs_profile.PhaseTimer(cpu=False)
        per_pool_ms: Dict[str, float] = {}

        def one(name: str) -> Tuple[str, float]:
            sched = self.schedulers[name]
            t0 = _walltime.monotonic()
            sched.trigger_resched("manual")
            sched.pump()
            return name, (_walltime.monotonic() - t0) * 1000.0

        t0 = _walltime.monotonic()
        with tracer.span("fleet", component="fleet",
                         attrs={"generation": gen, "pools": len(names),
                                "workers": self.workers}) as sp:
            with prof.phase("fleet_decide"):
                for name, ms in self._fan_out(
                        [(n, (lambda n=n: one(n))) for n in names]):
                    per_pool_ms[name] = round(ms, 3)
            wall_ms = (_walltime.monotonic() - t0) * 1000.0
            sp.set_attr("wall_ms", round(wall_ms, 3))
        if self.h_fleet_pass is not None:
            self.h_fleet_pass.observe(wall_ms / 1000.0)
        result = {"generation": gen, "pools": names,
                  "wall_ms": round(wall_ms, 3),
                  "per_pool_ms": per_pool_ms}
        with self._lock:
            self._last_pass = result
        return result

    def _fan_out(self, tasks: List[Tuple[str, Callable]]) -> List[object]:
        """Run (name, fn) tasks on the bounded executor; serial when
        there is one task or one worker. Results in submission order.
        A raising pool is isolated (logged, skipped) — one pool's
        decide blowing up must not strand the rest of the fleet."""
        results: List[object] = []
        if len(tasks) <= 1 or self.workers <= 1:
            for name, fn in tasks:
                try:
                    results.append(fn())
                except Exception:
                    log.exception("fleet pass failed for pool %r", name)
            return results
        executor = self._pool_executor()
        # Tracer context rides into the workers explicitly (ambient is
        # thread-local): a per-pool resched span still roots its own
        # trace (new_trace=True), but anything else emitted inside the
        # fan-out parents onto the fleet span instead of orphaning.
        parent = obs_tracer.current_context()
        tracer = self.tracer or obs_tracer.get_tracer()

        def _with_ctx(fn):
            def run():
                with obs_tracer.use_context(parent, tracer):
                    return fn()
            return run

        futures = [(name, executor.submit(_with_ctx(fn)))
                   for name, fn in tasks]
        for name, fut in futures:
            try:
                results.append(fut.result())
            except Exception:
                log.exception("fleet pass failed for pool %r", name)
        return results

    # ---- lock-free fleet view --------------------------------------------

    def fleet_snapshot(self) -> Dict[str, object]:
        """Per-pool load aggregated WITHOUT taking any scheduler lock:
        ledger snapshots (the ledger's own leaf lock) and dict len()
        probes only, so this stays live mid-pass — the property the
        read-path snapshot caches established for single-pool reads,
        extended to the fleet."""
        pools: Dict[str, Dict[str, object]] = {}
        total_chips = 0
        total_booked = 0
        total_ready = 0
        for name, sched in sorted(self.schedulers.items()):
            booked_map = sched.job_num_chips.snapshot()
            booked = sum(booked_map.values())
            running = sum(1 for n in booked_map.values() if n > 0)
            waiting = len(booked_map) - running
            pools[name] = {
                "algorithm": sched.algorithm,
                "total_chips": sched.total_chips,
                "booked_chips": booked,
                "free_chips": max(0, sched.total_chips - booked),
                "ready_jobs": len(sched.ready_jobs),
                "running_jobs": running,
                "waiting_jobs": waiting,
            }
            total_chips += sched.total_chips
            total_booked += booked
            total_ready += len(sched.ready_jobs)
        return {
            "generation": self._generation,
            "pools": pools,
            "totals": {
                "pools": len(pools),
                "total_chips": total_chips,
                "booked_chips": total_booked,
                "ready_jobs": total_ready,
            },
        }

    def fleet_stats(self, n: int = 50) -> Dict[str, object]:
        """The GET /debug/fleet payload: the lock-free snapshot plus
        per-pool phase aggregates over each pool's last `n` profiled
        passes (decide/actuate p50/p95 and the per-phase breakdown the
        single-pool `voda top` renders, here one row per pool) and the
        router's decision stats."""
        out = self.fleet_snapshot()
        phases: Dict[str, Dict[str, object]] = {}
        for name, sched in sorted(self.schedulers.items()):
            records = sched.profile_records(n)
            decide = [r.get("decide_ms", 0.0) for r in records]
            actuate = [r.get("actuate_ms", 0.0) for r in records]
            per_phase: Dict[str, List[float]] = {}
            for rec in records:
                for pname, stats in (rec.get("phases") or {}).items():
                    per_phase.setdefault(pname, []).append(
                        stats.get("wall_ms", 0.0))
            phases[name] = {
                "passes": len(records),
                "decide_ms_p50": round(
                    nearest_rank_percentile(decide, 0.50), 3),
                "decide_ms_p95": round(
                    nearest_rank_percentile(decide, 0.95), 3),
                "actuate_ms_p50": round(
                    nearest_rank_percentile(actuate, 0.50), 3),
                "actuate_ms_p95": round(
                    nearest_rank_percentile(actuate, 0.95), 3),
                "phases": {
                    pname: {"p50": round(
                        nearest_rank_percentile(vals, 0.50), 3),
                        "p95": round(
                            nearest_rank_percentile(vals, 0.95), 3)}
                    for pname, vals in sorted(per_phase.items())
                },
            }
        out["profile"] = phases
        with self._lock:
            out["last_pass"] = dict(self._last_pass) if self._last_pass \
                else None
        if self.router is not None:
            out["router"] = self.router.stats()
        return out
