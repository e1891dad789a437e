"""FakeClusterBackend: hermetic simulated TPU cluster under a VirtualClock.

This fills the gap the reference left open: its only test file built fake
Kubernetes clientsets but no tests (SURVEY.md §4). Here the fake backend is
a first-class component — the engine of both the test suite and the
Philly-style trace replay (replay/), able to run hours of cluster time in
milliseconds.

Execution model: each job is an amount of *serial work*
(epochs × epoch_seconds at 1 chip). Running at n chips, work completes at
`speedup(n)` serial-seconds per second — speedup comes from a per-workload
profile (the same curves the metrics collector learns). Every (re)start or
migration pauses the job for `restart_overhead_seconds`, modeling the TPU
cold-resize cost: checkpoint, process restart, recompile, resharded
restore. A resize of a SINGLE-HOST job staying on its host models the
Tier-A in-place live reshard instead (doc/elastic-resize.md) — the only
case the real feasibility gate (one process, target within its devices)
admits: the pause is the much smaller `inplace_overhead_seconds` (reshard
+ recompile, no process exit, no checkpoint round-trip), it does not
count as a restart, and scale_job reports ResizePath.INPLACE — mirroring
what the real backends' supervisor control channel does. Multi-host
resizes are always cold (one process per host: any size change is a
membership change). Epoch completions emit metrics
rows exactly like the reference's training-side CSV logger
(examples/.../callbacks.py).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

from vodascheduler_tpu_torch.cluster.backend import (
    ClusterBackend,
    ClusterEvent,
    ClusterEventKind,
    JobHandle,
    ResizePath,
)
from vodascheduler_tpu_torch.common.clock import VirtualClock
from vodascheduler_tpu_torch.common.job import JobSpec, category_of
from vodascheduler_tpu_torch.obs import tracer as obs_tracer


@dataclasses.dataclass
class WorkloadProfile:
    """Ground-truth performance model of a workload in simulation."""

    epoch_seconds_at_1: float = 60.0
    # chips -> speedup; missing counts interpolate via Amdahl-like power law
    speedup: Optional[Dict[int, float]] = None
    speedup_exponent: float = 0.9      # used when no explicit curve
    # Share of a contiguously-placed step spent on ICI collectives
    # (placement/comms.py CollectiveProfile.comms_fraction): with a
    # topology installed (set_topology), the backend degrades the
    # job's speedup by comms_fraction x the normalized spread of its
    # host set — the placement-sensitive step-time model ROADMAP item 3
    # asks for. 0.0 = placement-insensitive (the pre-comms model).
    comms_fraction: float = 0.0
    # Throughput fraction this workload loses when its hosts are FULLY
    # co-tenant (placement/comms.py FAMILY_INTERFERENCE): with a
    # topology installed, co-tenant step time is interference-sensitive
    # — rate x= (1 - interference_fraction x cotenancy), where
    # cotenancy is the chip-weighted share of the job's hosts' chips
    # owned by OTHER jobs (doc/fractional-sharing.md). Multiplicative,
    # not exponent-shaped like comms: a 1-chip tenant has speedup 1.0
    # and an exponent degradation could never price its HBM/host
    # contention. 0.0 = interference-free (the pre-fractional model).
    interference_fraction: float = 0.0
    fail_at_epoch: Optional[int] = None  # inject a failure
    # Checkpoint-restart pause for THIS workload (overrides the backend
    # default): restore + recompile scales with model size, so a ResNet
    # resize is far cheaper than a Mixtral resize.
    restart_overhead_seconds: Optional[float] = None
    # In-place (Tier-A) resize pause for this workload: reshard +
    # recompile only. None falls back to the backend default.
    inplace_overhead_seconds: Optional[float] = None

    def speedup_at(self, n: int) -> float:
        if n <= 0:
            return 0.0
        if self.speedup and n in self.speedup:
            return self.speedup[n]
        return float(n) ** self.speedup_exponent


@dataclasses.dataclass
class MetricsRow:
    """One epoch's telemetry (reference CSV columns, callbacks.py:104-154).

    step_time_sec is the trainer-reported mean step time for the epoch
    (CSV column `step_time_sec`); 0.0 means "not reported" and the
    collector falls back to deriving step curves from epoch time."""

    job: str
    epoch: int
    epoch_time_sec: float
    workers: int
    timestamp: float
    step_time_sec: float = 0.0
    # Placement context at the epoch's end (doc/learned-models.md): the
    # normalized spread of the job's host set and the chip-weighted
    # co-tenancy share — what the learned-model plane needs to decompose
    # an observed step time into scaling vs placement vs interference.
    # Real CSV rows default to 0.0 (contiguous/exclusive) until the
    # trainer-side logger grows the columns.
    spread: float = 0.0
    cotenancy: float = 0.0


@dataclasses.dataclass
class _SimJob:
    spec: JobSpec
    profile: WorkloadProfile
    num_workers: int
    placements: List[Tuple[str, int]]
    progress_serial: float = 0.0      # serial-seconds of work completed
    epochs_done: int = 0
    last_update: float = 0.0
    busy_until: float = 0.0           # restart overhead window
    epoch_started_serial: float = 0.0
    epoch_started_workers: int = 0
    epoch_started_at: float = 0.0
    generation: int = 0               # invalidates stale timers
    restarts: int = 0
    resizes_inplace: int = 0
    # Normalized spread of the current host set (topology.spread),
    # recomputed whenever placements change; degrades the speedup via
    # the profile's comms_fraction (see _effective_speedup).
    comms_spread: float = 0.0
    # Chip-weighted share of this job's hosts' chips owned by OTHER
    # jobs, in [0, 1) — recomputed for every co-tenant whenever any
    # placement on a shared host changes; degrades the rate via the
    # profile's interference_fraction (doc/fractional-sharing.md).
    cotenancy: float = 0.0

    @property
    def total_serial(self) -> float:
        return self.spec.config.epochs * self.profile.epoch_seconds_at_1


class FakeClusterBackend(ClusterBackend):
    supports_inplace_resize = True

    def __init__(self, clock: VirtualClock,
                 restart_overhead_seconds: float = 10.0,
                 inplace_overhead_seconds: Optional[float] = None,
                 actuation_latency_seconds: float = 0.0):
        self.clock = clock
        self.restart_overhead_seconds = restart_overhead_seconds
        # WALL-clock latency of each start/scale/stop call (a real
        # time.sleep, never a virtual-clock advance): models the blocking
        # backend round trip (ack poll loop, pod churn) so concurrency
        # tests can pin a parallel pass at the per-wave max instead of
        # the serial sum without real restart-scale sleeps dominating.
        self.actuation_latency_seconds = actuation_latency_seconds
        # Serializes simulation-state mutation: the scheduler's actuation
        # waves call start/scale/stop from several threads at once, and
        # epoch-boundary timers can fire concurrently (a stress test's
        # clock-advancer thread). Reentrant: migrate -> scale_job.
        # Invariant: no sleep and no emit() while holding it — emitting
        # re-enters the scheduler (its own lock) and would invert lock
        # order against scheduler->backend calls.
        self._state_lock = threading.RLock()
        # job -> modeled seconds of its most recent actuation call (the
        # scheduler's replay-pricing hint, see
        # ClusterBackend.actuation_price_seconds).
        self._actuation_price: Dict[str, float] = {}
        # Tier-A pause default: reshard + recompile, no process lifecycle
        # and no checkpoint round-trip. When not measured (replay passes
        # restart_costs.default_inplace_seconds), a tenth of the cold
        # cost is the documented heuristic — compile-dominated, see
        # doc/elastic-resize.md.
        self.inplace_overhead_seconds = (
            restart_overhead_seconds / 10.0
            if inplace_overhead_seconds is None
            else inplace_overhead_seconds)
        self.hosts: Dict[str, int] = {}
        # Placement-sensitive step-time model (ROADMAP item 3,
        # doc/placement.md): when a topology is installed, a job's
        # speedup is degraded by comms_fraction x spread(host set) —
        # WHERE a job lands now moves its modeled step time. Off (None)
        # by default so direct backend tests keep count-only physics.
        self._topology = None
        self._host_coords: Dict[str, Tuple[int, ...]] = {}
        # ∫ chips x modeled step-time penalty dt: the fleet's comms
        # loss, reported by replay as comms_penalty_mean (busy-weighted
        # mean fraction of throughput lost to placement spread).
        self.comms_penalty_chip_seconds: float = 0.0
        # ∫ chips x modeled co-tenant interference penalty dt
        # (doc/fractional-sharing.md): the throughput share lost to
        # sharing hosts, reported by replay as
        # interference_penalty_mean — the honest price of the raw-
        # utilization points fractional sharing recovers.
        self.interference_penalty_chip_seconds: float = 0.0
        # host -> {job: chips} live occupancy, maintained incrementally
        # at every placement change; the cotenancy recompute reads only
        # the touched hosts' entries, so a 10k-job pool's churn pass
        # never pays an O(jobs) occupancy scan per backend call.
        self._occupancy: Dict[str, Dict[str, int]] = {}
        self.jobs: Dict[str, _SimJob] = {}
        self.profiles: Dict[str, WorkloadProfile] = {}
        self.default_profile = WorkloadProfile()
        self.metrics_rows: Dict[str, List[MetricsRow]] = {}
        self.completed: List[str] = []
        self.failed: List[str] = []
        # accounting for utilization metrics (chip-seconds actually serving
        # jobs vs capacity)
        self.busy_chip_seconds: float = 0.0
        self.restarts_total: int = 0  # cumulative across all jobs, ever
        # Resize-path mix (bench.py reports it): in-place live reshards
        # vs cold checkpoint-restart resizes. restarts_total counts cold
        # resizes (and starts/migrations) but never in-place ones.
        self.resizes_inplace_total: int = 0
        self.cold_resizes_total: int = 0
        # (timestamp, total_chips) after each fleet change — lets callers
        # integrate capacity over time (preemption changes the denominator)
        self.capacity_history: List[Tuple[float, int]] = []
        # One-shot deterministic faults (inject_fault): the chaos plane's
        # unit of adversity. Ordered, consumed first-match, so a replayed
        # action sequence reproduces the exact same failure.
        self._armed_faults: List[str] = []

    # ---- deterministic fault injection (ROADMAP item 5; the model
    # checker's fault alphabet, analysis/modelcheck.py) -------------------

    FAULT_KINDS = ("start", "scale", "scale_ack", "stop")

    def inject_fault(self, kind: str) -> None:
        """Arm a one-shot fault: the next matching backend call fails
        deterministically. Kinds: "start" (start_job raises before
        applying anything), "scale" (scale_job raises before applying —
        the resize never happened), "scale_ack" (scale_job APPLIES the
        resize, then raises — the supervisor crashed after resharding
        but before the ack, so backend truth and the caller's view
        diverge), "stop" (stop_job raises before applying)."""
        if kind not in self.FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}")
        with self._state_lock:
            self._armed_faults.append(kind)

    def armed_faults(self) -> List[str]:
        with self._state_lock:
            return list(self._armed_faults)

    def _consume_fault(self, kind: str) -> None:
        with self._state_lock:
            if kind in self._armed_faults:
                self._armed_faults.remove(kind)
                raise RuntimeError(f"injected backend fault: {kind}")

    # ---- fleet management -------------------------------------------------

    def add_host(self, name: str, chips: int, announce: bool = True) -> None:
        with self._state_lock:
            self.hosts[name] = chips
            self.capacity_history.append((self.clock.now(),
                                          self.total_chips()))
        if announce:
            self.emit(ClusterEvent(ClusterEventKind.HOST_ADDED, name,
                                   timestamp=self.clock.now()))

    def remove_host(self, name: str, announce: bool = True) -> None:
        with self._state_lock:
            self.hosts.pop(name, None)
            self.capacity_history.append((self.clock.now(),
                                          self.total_chips()))
        if announce:
            self.emit(ClusterEvent(ClusterEventKind.HOST_REMOVED, name,
                                   timestamp=self.clock.now()))

    def capacity_chip_seconds(self, start: float, end: float) -> float:
        """∫ total_chips dt over [start, end], from capacity_history."""
        if end <= start:
            return 0.0
        total = 0.0
        chips = 0
        t_prev = start
        with self._state_lock:
            history = list(self.capacity_history)
        for t, c in history:
            if t <= start:
                chips = c
                continue
            if t >= end:
                break
            total += (t - t_prev) * chips
            t_prev = t
            chips = c
        total += (end - t_prev) * chips
        return total

    def set_topology(self, topology) -> None:
        """Install the pool torus (placement/topology.py PoolTopology):
        host names resolve to grid coords and the step-time model
        becomes placement-sensitive. The replay harness always installs
        its topology; hermetic tests that want count-only physics
        simply never call this."""
        with self._state_lock:
            self._topology = topology
            self._host_coords = {topology.host_name(c): c
                                 for c in topology.host_coords()}
            # Physics flipped placement-sensitive: refresh every live
            # job's spread AND cotenancy (the occupancy map is already
            # maintained; only the derived factors were dormant).
            for sim in self.jobs.values():
                sim.comms_spread = self._spread_of(sim.placements)
                sim.cotenancy = self._cotenancy_of(sim)

    def _spread_of(self, placements: List[Tuple[str, int]]) -> float:
        """Normalized spread of a placement's host set; 0.0 without a
        topology, an empty placement, or unknown host names."""
        if self._topology is None or not placements:
            return 0.0
        coords = [self._host_coords[h] for h, n in placements
                  if n > 0 and h in self._host_coords]
        return self._topology.spread(coords)

    def _spread_speedup(self, sim: _SimJob) -> float:
        """The job's speedup at its current size AND placement: the
        profile curve degraded by `comms_fraction x spread` on the
        exponent — a contiguous block keeps (nearly) the ideal curve, a
        scattered host set pays its collectives over long ICI paths
        every step. Power-law form so explicit speedup curves degrade
        consistently with exponent-modeled ones."""
        base = sim.profile.speedup_at(sim.num_workers)
        f = sim.profile.comms_fraction
        if f <= 0.0 or sim.comms_spread <= 0.0 or base <= 1.0:
            return base
        return base ** (1.0 - f * sim.comms_spread)

    def _effective_speedup(self, sim: _SimJob) -> float:
        """Spread-degraded speedup further scaled by co-tenant
        interference (doc/fractional-sharing.md): rate x=
        (1 - interference_fraction x cotenancy). Multiplicative — a
        1-chip tenant's base speedup is 1.0, where an exponent
        degradation could never price its HBM/host-resource contention
        against co-residents."""
        base = self._spread_speedup(sim)
        fi = sim.profile.interference_fraction
        if fi <= 0.0 or sim.cotenancy <= 0.0 or base <= 0.0:
            return base
        return base * max(0.0, 1.0 - fi * sim.cotenancy)

    # ---- co-tenant interference (doc/fractional-sharing.md) --------------

    def _cotenancy_of(self, sim: _SimJob) -> float:
        """Chip-weighted share of the job's hosts' chips owned by other
        jobs, in [0, 1). 0.0 without a topology (the pre-fractional
        physics hermetic tests keep by never calling set_topology)."""
        if self._topology is None:
            return 0.0
        total = sum(n for _, n in sim.placements if n > 0)
        if total <= 0:
            return 0.0
        name = sim.spec.name
        acc = 0.0
        for h, n in sim.placements:
            if n <= 0:
                continue
            chips = self.hosts.get(h, 0)
            if chips <= 0:
                continue
            foreign = sum(c for j, c in self._occupancy.get(h, {}).items()
                          if j != name)
            acc += (n / total) * min(1.0, foreign / chips)
        return acc

    def _set_placements(self, sim: _SimJob,
                        placements: List[Tuple[str, int]]) -> None:
        """Swap a job's placements, maintain the incremental occupancy
        map, and refresh spread + cotenancy — for the job itself AND
        for every co-tenant on a touched host. Each affected co-tenant
        is accrued at its OLD rate first (the rate change must not be
        backdated over the closed window) and its epoch timer re-armed
        at the new rate. Callers hold the state lock and re-arm SIM's
        own timer themselves."""
        name = sim.spec.name
        touched = set()
        for h, n in sim.placements:
            if n <= 0:
                continue
            touched.add(h)
            tenants = self._occupancy.get(h)
            if tenants is not None:
                tenants.pop(name, None)
                if not tenants:
                    del self._occupancy[h]
        sim.placements = placements
        for h, n in placements:
            if n <= 0:
                continue
            touched.add(h)
            tenants = self._occupancy.setdefault(h, {})
            tenants[name] = tenants.get(name, 0) + n
        sim.comms_spread = self._spread_of(placements)
        sim.cotenancy = self._cotenancy_of(sim)
        if self._topology is None or not touched:
            return
        affected = set()
        for h in touched:
            affected.update(self._occupancy.get(h, ()))
        affected.discard(name)
        # Sorted: set iteration is hash-order, and the re-armed epoch
        # timers' insertion order breaks VirtualClock ties — an
        # unsorted walk made replay differ across PYTHONHASHSEED
        # (surfaced by the learned-model plane, whose telemetry->
        # decision feedback amplifies tie-order microdifferences).
        for other_name in sorted(affected):
            other = self.jobs.get(other_name)
            if other is None:
                continue
            new_cot = self._cotenancy_of(other)
            if abs(new_cot - other.cotenancy) < 1e-12:
                continue
            if (other.profile.interference_fraction > 0.0
                    and other.num_workers > 0):
                # Its modeled rate just moved: close the old window at
                # the old rate, invalidate the old-rate epoch timer,
                # re-arm at the new rate.
                self._accrue(other)
                other.cotenancy = new_cot
                other.generation += 1
                self._schedule_next_event(other)
            else:
                other.cotenancy = new_cot

    def list_hosts(self) -> Dict[str, int]:
        with self._state_lock:
            return dict(self.hosts)

    def register_profile(self, name: str, profile: WorkloadProfile) -> None:
        """Register under an exact job name or a category (family) name.
        Exact-name entries win, so per-job fault injection never
        cross-contaminates same-family jobs."""
        self.profiles[name] = profile

    def _profile_for(self, spec: JobSpec) -> WorkloadProfile:
        return self.profiles.get(
            spec.name,
            self.profiles.get(category_of(spec.name), self.default_profile))

    # ---- ClusterBackend --------------------------------------------------

    def start_job(self, spec: JobSpec, num_workers: int,
                  placements: Optional[List[Tuple[str, int]]] = None) -> None:
        self._consume_fault("start")
        # Simulated counterparts of the real chain's backend + supervisor
        # spans (cluster/local.py, runtime/supervisor.py): same
        # names/components/attrs, parented on the ambient resched context
        # — a replay trace and a live trace of the same workload are
        # directly diffable.
        self._actuation_sleep()
        tracer = obs_tracer.active_tracer()
        with tracer.span("backend.start", component="backend",
                         attrs={"job": spec.name, "chips": num_workers}):
            with tracer.span("supervisor.start", component="supervisor",
                             attrs={"job": spec.name, "chips": num_workers,
                                    "simulated": True}):
                self._start_job_traced(spec, num_workers, placements)

    def _actuation_sleep(self) -> None:
        """The modeled blocking round trip of one backend call — real
        wall time, never virtual time, and never under the state lock
        (serializing the sleeps would turn a parallel wave back into the
        sum the wave exists to avoid)."""
        if self.actuation_latency_seconds > 0:
            # vodalint: ignore[clock-discipline] models the REAL blocking
            # round trip of a backend call; a clock.sleep would advance
            # virtual time and break the max-vs-sum wave pinning
            time.sleep(self.actuation_latency_seconds)

    def _start_job_traced(self, spec: JobSpec, num_workers: int,
                          placements: Optional[List[Tuple[str, int]]]) -> None:
        with self._state_lock:
            now = self.clock.now()
            existing = self.jobs.get(spec.name)
            if existing is not None:
                # restart of a halted job: training state survived
                # (checkpoint)
                sim = existing
                sim.num_workers = num_workers
            else:
                sim = _SimJob(spec=spec, profile=self._profile_for(spec),
                              num_workers=num_workers,
                              placements=[], last_update=now)
                self.jobs[spec.name] = sim
                self.metrics_rows.setdefault(spec.name, [])
            self._set_placements(sim, placements or [])
            sim.restarts += 1
            self.restarts_total += 1
            overhead = self._overhead(sim)
            # Price a START at just the call round trip: every real
            # backend's start_job returns once the processes/pods are
            # launched — the checkpoint restore + recompile (the busy
            # window below) runs inside the job, not on the scheduler's
            # thread. Only resizes block the caller longer (see
            # _scale_job_locked).
            self._actuation_price[spec.name] = self.actuation_latency_seconds
            sim.busy_until = now + overhead
            sim.last_update = now
            sim.epoch_started_at = now
            sim.epoch_started_serial = sim.progress_serial
            sim.epoch_started_workers = num_workers
            sim.generation += 1
            self._schedule_next_event(sim)

    def scale_job(self, name: str, num_workers: int,
                  placements: Optional[List[Tuple[str, int]]] = None
                  ) -> Optional[ResizePath]:
        with self._state_lock:
            if name not in self.jobs:
                return None
        self._consume_fault("scale")
        self._actuation_sleep()
        with self._state_lock:
            path = self._scale_job_locked(name, num_workers, placements)
        # The ack-crash fault class: the resize was APPLIED above, but
        # the caller sees a failure — backend truth and scheduler
        # bookkeeping diverge until the failure path re-reads
        # running_jobs().
        self._consume_fault("scale_ack")
        return path

    def _scale_job_locked(self, name: str, num_workers: int,
                          placements: Optional[List[Tuple[str, int]]]
                          ) -> Optional[ResizePath]:
        sim = self.jobs.get(name)
        if sim is None:
            return None  # vanished during the modeled round trip
        self._accrue(sim)
        # Tier decision, mirroring the REAL feasibility gate
        # (runtime/supervisor.py: single process, target within its
        # devices): the job must sit on ONE host before and after, and
        # it must be the same host — that is the only case where the
        # process group provably survives. Multi-host jobs model one
        # process per host (cluster/multihost.py), so any multi-host
        # resize is a membership change → cold, even with the host set
        # unchanged. No placements on either side = can't prove
        # stability (direct scale_job callers without a placement
        # manager) — conservative cold path.
        old_hosts = ({h for h, _ in sim.placements}
                     if sim.placements else None)
        new_hosts = ({h for h, _ in placements}
                     if placements is not None else None)
        inplace = (sim.num_workers > 0 and num_workers > 0
                   and old_hosts is not None and new_hosts is not None
                   and len(old_hosts) == 1 and old_hosts == new_hosts)
        # Simulated backend.scale + supervisor.resize spans: same schema
        # the real chain writes for its control-channel resize handling,
        # so one fake-backend resched stitches scheduler -> ... -> backend
        # -> supervisor exactly like a live run (and replay/live traces
        # diff cleanly).
        tracer = obs_tracer.active_tracer()
        with tracer.span(
                "backend.scale", component="backend",
                attrs={"job": name, "chips": num_workers,
                       "path": "inplace" if inplace else "restart"}), \
            tracer.span(
                "supervisor.resize", component="supervisor",
                attrs={"job": name, "from_chips": sim.num_workers,
                       "to_chips": num_workers,
                       "path": "inplace" if inplace else "restart",
                       "simulated": True}):
            sim.num_workers = num_workers
            if placements is not None:
                self._set_placements(sim, placements)
            if inplace:
                sim.resizes_inplace += 1
                self.resizes_inplace_total += 1
            else:
                sim.restarts += 1
                self.restarts_total += 1
                self.cold_resizes_total += 1
            now = self.clock.now()
            overhead = (self._inplace_overhead(sim) if inplace
                        else self._overhead(sim))
            # A resize DOES block its caller: the in-place path waits for
            # the supervisor's resharded-step ack (≈ the in-place
            # overhead), the cold path waits out the SIGTERM checkpoint
            # drain + respawn (≈ the restart overhead on LocalBackend —
            # conservative for GKE, whose pod churn returns in seconds).
            self._actuation_price[name] = (
                overhead + self.actuation_latency_seconds)
            sim.busy_until = now + overhead
            sim.epoch_started_at = now
            sim.epoch_started_serial = sim.progress_serial
            sim.epoch_started_workers = num_workers
            sim.generation += 1
            self._schedule_next_event(sim)
        return ResizePath.INPLACE if inplace else ResizePath.RESTART

    def stop_job(self, name: str) -> None:
        """Halt: remove from running set; progress (checkpoint) is kept in
        the sim record so a later start resumes where it left off."""
        with self._state_lock:
            if name not in self.jobs:
                return
        self._consume_fault("stop")
        self._actuation_sleep()
        with obs_tracer.active_tracer().span(
                "backend.stop", component="backend", attrs={"job": name}), \
                self._state_lock:
            sim = self.jobs.get(name)
            if sim is None:
                return  # completed/failed during the modeled round trip
            self._accrue(sim)
            sim.num_workers = 0
            self._set_placements(sim, [])
            sim.generation += 1  # cancel pending timers
            # A halt's checkpoint drain is folded into the NEXT start's
            # restart overhead (that's where the sim charges it), so the
            # stop itself prices at just the call round trip.
            self._actuation_price[name] = self.actuation_latency_seconds

    def migrate_workers(self, name: str,
                        placements: List[Tuple[str, int]]) -> None:
        with self._state_lock:
            sim = self.jobs.get(name)
            if sim is None:
                return
            num_workers = sim.num_workers
        # Same-size re-placement: still a checkpoint-restart on TPU.
        self.scale_job(name, num_workers, placements)

    def actuation_price_seconds(self, name: str) -> Optional[float]:
        with self._state_lock:
            return self._actuation_price.get(name)

    def running_jobs(self) -> Dict[str, JobHandle]:
        with self._state_lock:
            return {name: JobHandle(name=name, num_workers=sim.num_workers,
                                    placements=list(sim.placements))
                    for name, sim in self.jobs.items() if sim.num_workers > 0}

    def _overhead(self, sim: _SimJob) -> float:
        if sim.profile.restart_overhead_seconds is not None:
            return sim.profile.restart_overhead_seconds
        return self.restart_overhead_seconds

    def _inplace_overhead(self, sim: _SimJob) -> float:
        if sim.profile.inplace_overhead_seconds is not None:
            return sim.profile.inplace_overhead_seconds
        return self.inplace_overhead_seconds

    # ---- simulation engine -----------------------------------------------

    def _rate(self, sim: _SimJob, at: float) -> float:
        if sim.num_workers <= 0 or at < sim.busy_until:
            return 0.0
        return self._effective_speedup(sim)

    def _accrue(self, sim: _SimJob) -> None:
        """Bring progress up to now. Callers hold the state lock."""
        now = self.clock.now()
        start = max(sim.last_update, sim.busy_until)
        if now > start and sim.num_workers > 0:
            dt = now - start
            rate = self._effective_speedup(sim)
            sim.progress_serial = min(sim.total_serial,
                                      sim.progress_serial + dt * rate)
            self.busy_chip_seconds += dt * sim.num_workers
            ideal = sim.profile.speedup_at(sim.num_workers)
            if ideal > 0.0 and rate < ideal:
                # Busy-weighted loss split into its two modeled causes:
                # spread (comms over long ICI paths) and co-tenant
                # interference (doc/fractional-sharing.md).
                spread_rate = self._spread_speedup(sim)
                self.comms_penalty_chip_seconds += (
                    dt * sim.num_workers * (1.0 - spread_rate / ideal))
                if rate < spread_rate:
                    self.interference_penalty_chip_seconds += (
                        dt * sim.num_workers
                        * (spread_rate - rate) / ideal)
        sim.last_update = now

    def sync_accounting(self) -> None:
        """Bring every job's busy-chip-second integral up to the current
        clock time — utilization readers (replay steady-state windows)
        sample between events, where lazy per-job accrual would lag."""
        with self._state_lock:
            for sim in self.jobs.values():
                self._accrue(sim)

    def _schedule_next_event(self, sim: _SimJob) -> None:
        """Schedule the next epoch-completion (or failure) timer."""
        if sim.num_workers <= 0:
            return
        rate = self._effective_speedup(sim)
        if rate <= 0:
            return
        next_epoch = sim.epochs_done + 1
        if sim.profile.fail_at_epoch is not None and next_epoch > sim.profile.fail_at_epoch:
            return  # failure fired at its epoch boundary
        target_serial = min(next_epoch * sim.profile.epoch_seconds_at_1,
                            sim.total_serial)
        remaining = target_serial - sim.progress_serial
        now = self.clock.now()
        overhead_left = max(0.0, sim.busy_until - now)
        eta = now + overhead_left + max(0.0, remaining) / rate
        generation = sim.generation
        self.clock.call_at(eta, lambda: self._on_epoch_boundary(sim, generation))

    def _on_epoch_boundary(self, sim: _SimJob, generation: int) -> None:
        with self._state_lock:
            event = self._epoch_boundary_inner(sim, generation)
        if event is not None:
            # Emit OUTSIDE the state lock: the scheduler's handler takes
            # its own lock, and an actuation-wave worker may already hold
            # it while calling into this backend.
            self.emit(event)

    def _epoch_boundary_inner(self, sim: _SimJob,
                              generation: int) -> Optional[ClusterEvent]:
        if sim.generation != generation or sim.spec.name not in self.jobs:
            return None  # stale timer: job was resized/stopped meanwhile
        self._accrue(sim)
        now = self.clock.now()
        sim.epochs_done += 1
        # The boundary timer is authoritative: snap progress to the epoch
        # boundary. Without the snap, float rounding at large clock values
        # (epsilon/rate underflowing against now ~1e9) can strand progress
        # just short of the boundary and respawn a zero-delay timer forever.
        sim.progress_serial = min(sim.total_serial,
                                  max(sim.progress_serial,
                                      sim.epochs_done * sim.profile.epoch_seconds_at_1))
        # Report the step-time-derived epoch time at the current worker
        # count, the way a real trainer's logger does (mean step time x
        # steps/epoch, callbacks.py:104-154) — NOT the wall span, which on
        # TPU includes restart pauses and partial epochs at the old size and
        # would pollute the learned speedup curves with spurious negative
        # marginal gains.
        rate = self._effective_speedup(sim)
        clean_epoch_time = (sim.profile.epoch_seconds_at_1 / rate
                            if rate > 0 else now - sim.epoch_started_at)
        # Step time the way a real trainer's logger reports it (mean
        # step x steps/epoch backs the epoch figure), stamped with the
        # placement context the learned-model plane decomposes against
        # (doc/learned-models.md): the same spread/cotenancy the
        # step-time model degraded this epoch's rate by.
        steps = max(1, sim.spec.steps_per_epoch)
        self.metrics_rows[sim.spec.name].append(MetricsRow(
            job=sim.spec.name,
            epoch=sim.epochs_done - 1,  # 0-based like the reference CSV
            epoch_time_sec=clean_epoch_time,
            workers=sim.num_workers,
            timestamp=now,
            step_time_sec=clean_epoch_time / steps,
            spread=sim.comms_spread,
            cotenancy=sim.cotenancy,
        ))
        sim.epoch_started_at = now
        sim.epoch_started_serial = sim.progress_serial
        sim.epoch_started_workers = sim.num_workers

        if (sim.profile.fail_at_epoch is not None
                and sim.epochs_done >= sim.profile.fail_at_epoch):
            self.failed.append(sim.spec.name)
            # Vacate the host share so co-tenants' interference rates
            # recover the moment the tenancy ends.
            self._set_placements(sim, [])
            del self.jobs[sim.spec.name]
            return ClusterEvent(
                ClusterEventKind.JOB_FAILED, sim.spec.name,
                detail=f"injected failure at epoch {sim.epochs_done}",
                timestamp=now)

        if sim.epochs_done >= sim.spec.config.epochs:
            self.completed.append(sim.spec.name)
            self._set_placements(sim, [])
            del self.jobs[sim.spec.name]
            return ClusterEvent(ClusterEventKind.JOB_COMPLETED,
                                sim.spec.name, timestamp=now)

        self._schedule_next_event(sim)
        return None

    # ---- introspection ---------------------------------------------------

    def total_chips(self) -> int:
        with self._state_lock:
            return sum(self.hosts.values())

    def job_progress(self, name: str) -> float:
        with self._state_lock:
            sim = self.jobs.get(name)
            if sim is None:
                return 1.0 if name in self.completed else 0.0
            return (sim.progress_serial / sim.total_serial
                    if sim.total_serial else 0.0)
