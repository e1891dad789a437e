"""The placement manager: chip→host binding with migration minimization.

Reference counterpart: pkg/placement/placement_manager.go. The algorithm
skeleton is preserved because it is sound for any accelerator pool:

  1. release slots of shrunk/terminated jobs, tail-first (the release-order
     contract: worker ranks are torn down from the highest index,
     placement_manager.go:337-367)
  2. re-pack all requests onto empty *logical* hosts with best-fit
     consolidation (:415-487)
  3. bind logical hosts onto physical ones with a Hungarian assignment
     maximizing workers that stay put (:492-544)
  4. rebuild per-job views and diff old vs new worker→host maps; changed
     workers must migrate (:548-620)

TPU-first deltas:
  - hosts carry coordinates on the pool's ICI host grid (topology.py); both
    best-fit and spill tie-break on torus contiguity with the job's
    already-placed hosts, so multi-host jobs ride short ICI paths. The
    reference's binary crossNode counter generalizes to a contiguity cost.
  - "delete the pod" becomes a restart set handed to the job runtime: on
    TPU any host-set change is a checkpoint-restart resize anyway, so
    migration and elastic resize share one mechanism (SURVEY.md §7).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Set, Tuple

from vodascheduler_tpu_torch.common.metrics import Registry, timed
from vodascheduler_tpu_torch.obs import tracer as obs_tracer
from vodascheduler_tpu_torch.placement import hungarian
from vodascheduler_tpu_torch.placement.state import HostSlots, HostState, JobPlacement
from vodascheduler_tpu_torch.placement.topology import PoolTopology
from vodascheduler_tpu_torch.common.types import ScheduleResult


@dataclasses.dataclass
class PlacementDecision:
    """Result of one placement pass."""

    # job -> ordered (host, chips) assignment (order = release order)
    placements: Dict[str, List[Tuple[str, int]]]
    # job -> worker indexes that changed host and must restart
    migrations: Dict[str, List[int]]
    # jobs whose entire worker set moved (launcher restart in the reference,
    # placement_manager.go:603-605)
    full_restarts: List[str]
    num_jobs_cross_host: int = 0
    total_contiguity_cost: int = 0
    workers_migrated: int = 0
    # Fleet comms score: sum over jobs of comms_weight x contiguity cost
    # — the integer objective the bandwidth-aware placement minimizes
    # (doc/placement.md). 0 with comms scoring disabled or no weights.
    total_comms_score: int = 0


class PlacementManager:
    """Owns host/job placement state for one TPU pool."""

    def __init__(self, pool_id: str = "default",
                 topology: Optional[PoolTopology] = None,
                 registry=None, fast_diff: Optional[bool] = None,
                 comms_enabled: Optional[bool] = None):
        self.pool_id = pool_id
        self.topology = topology
        self.host_states: Dict[str, HostState] = {}
        self.job_placements: Dict[str, JobPlacement] = {}
        # --- bandwidth-aware placement (ROADMAP item 3) ---
        # Integer per-job comms weights (placement/comms.py): the host
        # pick and the defragment bind score candidate host sets by
        # contiguity x weight. Empty map (or the VODA_PLACEMENT_COMMS=0
        # count-only reference knob) reproduces the pre-comms decisions
        # exactly — the A/B the bench's topology mix runs.
        self.comms_enabled = (os.environ.get("VODA_PLACEMENT_COMMS") != "0"
                              if comms_enabled is None
                              else bool(comms_enabled))
        self.comms_weights: Dict[str, int] = {}
        self._comms_total = 0
        # --- fractional sub-host sharing (doc/fractional-sharing.md) ---
        # Integer per-job co-tenant interference weights: set by the
        # scheduler for FRACTIONAL-class jobs only (whole-host jobs
        # never carry one), priced into _pick_host so a sub-host tenant
        # prefers the least-co-tenanted host that fits. Empty map =
        # count-only picks, bit-identical to the pre-fractional
        # decisions.
        self.interference_weights: Dict[str, int] = {}
        # --- decide-path fast kernels (ROADMAP item 2) ---
        # The incremental pass used to snapshot + re-diff + re-score
        # every job every pass (O(jobs) dict/list churn while the
        # scheduler lock is held — ~27 ms of the 10k-job decide phase
        # in doc/perf_baseline.json). The fast path tracks the jobs a
        # pass actually MUTATES (copy-on-write snapshots at first
        # touch) and diffs/rescores only those; untouched jobs keep
        # their expansion, their per-job stats entry, and their row in
        # the persistent placements view by construction. The full-scan
        # implementation remains as `_place_reference` — the
        # differential oracle (VODA_PURE_PLACEMENT=1 forces it, and
        # tests/test_fastpath_oracle.py proves decision equality over
        # seeded churn sequences).
        self.fast_diff = (not os.environ.get("VODA_PURE_PLACEMENT")
                          if fast_diff is None else bool(fast_diff))
        self._caches_valid = False
        self._placements_view: Dict[str, List[Tuple[str, int]]] = {}
        self._job_stats: Dict[str, Tuple[int, int]] = {}  # (crossed, contig)
        self._cross_total = 0
        self._contig_total = 0
        self._prune_pending: Set[str] = set()  # zeroed by remove_host
        self._pass_old: Optional[Dict[str, List[Tuple[str, int]]]] = None
        # Warm-start state for defragment's Hungarian bind: duals +
        # assignment carried between full repacks (placement/hungarian
        # solve_max_warm; canonical extraction keeps warm == cold).
        self._bind_warm: Optional[hungarian.WarmState] = None
        # Reference series: pkg/placement/metrics.go:11-50 (algo duration
        # summary + migrated/deleted/cross-node gauges of the last pass).
        if registry is None:
            registry = Registry()
        pool_l = {"pool": pool_id}  # N pools, one registry, no collisions
        self.m_algo_duration = registry.summary(
            "voda_placement_algo_duration_seconds",
            "Placement pass duration", ("mode",), const_labels=pool_l)
        self.m_workers_migrated = registry.gauge(
            "voda_placement_workers_migrated",
            "Workers that changed host in the last placement pass",
            const_labels=pool_l)
        self.m_full_restarts = registry.gauge(
            "voda_placement_full_restarts",
            "Jobs whose entire worker set moved in the last pass "
            "(reference: launchers deleted)", const_labels=pool_l)
        self.m_jobs_cross_host = registry.gauge(
            "voda_placement_jobs_cross_host",
            "Jobs spanning more than one host after the last pass",
            const_labels=pool_l)
        registry.gauge(
            "voda_placement_cotenant_hosts",
            "Hosts currently shared by more than one job (fractional "
            "sub-host co-tenancy, doc/fractional-sharing.md)",
            fn=lambda: float(self.cotenant_host_count()),
            const_labels=pool_l)

    # ---- host membership (reference: node informer handlers :174-304) ----

    def add_host(self, name: str, num_chips: int,
                 coord: Optional[Tuple[int, ...]] = None) -> None:
        existing = self.host_states.get(name)
        if existing is not None:
            # Re-announced host (capacity update): adjust free slots by the
            # delta, keep placed workers.
            delta = num_chips - existing.total_slots
            existing.total_slots = num_chips
            existing.free_slots += delta
            if coord is not None:
                existing.coord = coord
            return
        self.host_states[name] = HostState(name=name, total_slots=num_chips,
                                           coord=coord)

    def remove_host(self, name: str) -> None:
        """Reference deleteNode semantics (placement_manager.go:282-304):
        jobs lose their workers on the host; their placement entries zero
        out so the next place() migrates them."""
        host = self.host_states.pop(name, None)
        if host is None:
            return
        for job_name in list(host.job_num_workers):
            placement = self.job_placements.get(job_name)
            if placement is None:
                continue
            for hs in placement.host_slots:
                if hs.host == name:
                    placement.num_workers -= hs.num_slots
                    hs.num_slots = 0
            # The zeroed entries must be pruned (and the job's stats +
            # placements-view row refreshed) by the next fast pass.
            self._prune_pending.add(job_name)

    def add_hosts_from_topology(self, topology: PoolTopology) -> None:
        self.topology = topology
        for coord in topology.host_coords():
            self.add_host(topology.host_name(coord), topology.chips_per_host,
                          coord=coord)

    @property
    def total_chips(self) -> int:
        return sum(h.total_slots for h in self.host_states.values())

    # ---- comms weights (bandwidth-aware objective) -----------------------

    def set_comms_weights(self, weights: Dict[str, int]) -> None:
        """Install per-job integer comms weights (the scheduler derives
        them from job categories each pass, memoized). Weights are
        category-static in practice; if one DOES change for a job with
        cached stats, the incremental comms total is patched in place so
        the fast path's running total never drifts from the fleet sum."""
        old = self.comms_weights
        if self._caches_valid:
            for job, w in weights.items():
                prev = old.get(job, 0)
                if prev != w and job in self._job_stats:
                    self._comms_total += (w - prev) * self._job_stats[job][1]
            for job, prev in old.items():
                if job not in weights and job in self._job_stats:
                    self._comms_total -= prev * self._job_stats[job][1]
        self.comms_weights = dict(weights)

    def _weight_of(self, job: str) -> int:
        if not self.comms_enabled:
            return 0
        return self.comms_weights.get(job, 0)

    # ---- fractional co-tenancy (doc/fractional-sharing.md) ---------------

    def set_interference_weights(self, weights: Dict[str, int]) -> None:
        """Install per-job integer interference weights (the scheduler
        derives them from job categories for fractional-class jobs each
        pass, memoized like the comms weights)."""
        self.interference_weights = dict(weights)

    def _interference_of(self, job: str) -> int:
        return self.interference_weights.get(job, 0)

    def _foreign_chips(self, host: HostState, job: str) -> int:
        """Chips other jobs occupy on `host` — the co-tenant load an
        interference-priced pick minimizes."""
        occupied = host.total_slots - host.free_slots
        return max(0, occupied - host.job_num_workers.get(job, 0))

    def cotenant_host_count(self) -> int:
        """Hosts currently shared by more than one job — the fleet
        co-tenancy gauge (`voda_placement_cotenant_hosts`)."""
        return sum(1 for h in self.host_states.values()
                   if len(h.job_num_workers) > 1)

    def fractional_fleet_stats(self) -> Dict[str, int]:
        """Fleet fractional-sharing totals for the perf record and
        `voda top`: how many interference-weighted (fractional) jobs
        hold placements, how many hosts are co-tenant, and the summed
        interference price (Σ weight x foreign chips) those tenants
        currently pay."""
        jobs = 0
        price = 0
        for job, w in self.interference_weights.items():
            if w <= 0:
                continue
            placement = self.job_placements.get(job)
            if placement is None:
                continue
            jobs += 1
            for hs in placement.host_slots:
                host = self.host_states.get(hs.host)
                if host is not None and hs.num_slots > 0:
                    price += w * self._foreign_chips(host, job)
        return {"fractional_jobs": jobs,
                "cotenant_hosts": self.cotenant_host_count(),
                "interference_price": price}

    def job_fractional_stats(self, job: str) -> Optional[Dict[str, object]]:
        """The fractional delta block `voda explain` renders
        (doc/fractional-sharing.md): the job's partition size, the
        host(s) it partitions, its co-tenants, and its current
        interference price (weight x foreign chips). None for jobs with
        no placement or no interference weight (whole-host jobs)."""
        w = self._interference_of(job)
        placement = self.job_placements.get(job)
        if w <= 0 or placement is None:
            return None
        hosts: List[str] = []
        co_tenants: List[str] = []
        price = 0
        partition = 0
        for hs in placement.host_slots:
            if hs.num_slots <= 0:
                continue
            partition += hs.num_slots
            host = self.host_states.get(hs.host)
            if host is None:
                continue
            hosts.append(hs.host)
            price += w * self._foreign_chips(host, job)
            for tenant in host.job_num_workers:
                if tenant != job and tenant not in co_tenants:
                    co_tenants.append(tenant)
        return {"partition": partition, "hosts": hosts,
                "co_tenants": sorted(co_tenants),
                "interference_price": price}

    def job_comms_stats(self, job: str) -> Optional[Tuple[int, int, int]]:
        """(weight, contiguity cost, comms score) of one placed job —
        the columns `voda explain` / `voda top` surface. None for jobs
        with no placement."""
        placement = self.job_placements.get(job)
        if placement is None:
            return None
        if self._caches_valid and job in self._job_stats:
            contig = self._job_stats[job][1]
        else:
            contig = self._job_stats_of(placement)[1]
        weight = self._weight_of(job)
        return weight, contig, weight * contig

    def job_spread(self, job: str) -> float:
        """Normalized spread of one job's CURRENT host set — sugar over
        spread_of_pairs for introspection/tests. 0.0 without a topology
        or placement."""
        placement = self.job_placements.get(job)
        if placement is None:
            return 0.0
        return self.spread_of_pairs(
            [(hs.host, hs.num_slots) for hs in placement.host_slots])

    def spread_of_pairs(self, pairs: List[Tuple[str, int]]) -> float:
        """Normalized spread of an arbitrary (host, chips) binding —
        prices a PROPOSED placement (the migration gate compares the
        backend's live binding against this pass's target)."""
        if self.topology is None:
            return 0.0
        coords = [self.host_states[h].coord for h, n in pairs
                  if n > 0 and h in self.host_states
                  and self.host_states[h].coord is not None]
        return self.topology.spread(coords)

    # ---- the placement pass ----------------------------------------------

    def place(self, job_requests: ScheduleResult) -> PlacementDecision:
        """Incremental placement (TPU-first redesign of the reference's
        Place, :306-332).

        The reference repacks every job from scratch each pass and then
        Hungarian-relabels nodes to maximize stay-put workers (:492-544) —
        acceptable when a moved worker is a cheap pod delete under Elastic
        Horovod, but on TPU every moved worker is a checkpoint-restart of
        its whole job. Here jobs that keep their size keep their hosts
        outright; only growth deltas and new jobs are packed (anchored to
        the job's existing hosts for ICI contiguity). Migrations then only
        arise from host loss — or from an explicit defragment() pass, which
        is where the reference's full repack + Hungarian machinery lives
        on.

        Two implementations, decision-identical (the differential
        suite's contract): the touched-set fast path (ctor comment)
        and the full-scan reference."""
        with timed(self.m_algo_duration, mode="incremental"), \
                obs_tracer.active_tracer().span(
                    "placement.place", component="placement",
                    attrs={"pool": self.pool_id, "mode": "incremental",
                           "num_jobs": len(job_requests)}) as sp:
            if self.fast_diff:
                decision = self._place_fast(job_requests)
            else:
                decision = self._place_reference(job_requests)
            sp.set_attr("workers_migrated", decision.workers_migrated)
            sp.set_attr("jobs_cross_host", decision.num_jobs_cross_host)
        self._observe(decision)
        return decision

    def _place_reference(self, job_requests: ScheduleResult) -> PlacementDecision:
        """The full-scan pass: snapshot every job, release, pack, re-score
        and re-diff the whole fleet — the differential-test oracle."""
        self._caches_valid = False  # a later fast pass must rebuild
        self._pass_old = None
        old_worker_hosts = {job: self._expand_workers(p)
                            for job, p in self.job_placements.items()}
        self._release_slots(job_requests)
        cross, contiguity, comms = self._place_incremental(job_requests)
        return self._decision(old_worker_hosts, cross, contiguity, comms)

    def _place_fast(self, job_requests: ScheduleResult) -> PlacementDecision:
        """The touched-set pass: copy-on-write snapshots at first
        mutation, growth-only packing without per-job re-pruning, and a
        diff/stats/view refresh restricted to the touched jobs."""
        if not self._caches_valid:
            self._rebuild_caches()
        self._pass_old = {}
        if self._prune_pending:
            # Entries zeroed by remove_host since the last pass: prune
            # them now (the reference pruned every job every pass; zeros
            # only ever come from host removal, so this is the whole
            # set). Touch first — the snapshot ignores zero entries, so
            # pruning itself never reads as a migration.
            hosts = self.host_states
            for job in self._prune_pending:
                placement = self.job_placements.get(job)
                if placement is None:
                    continue
                self._touch(job, placement)
                placement.host_slots = [
                    hs for hs in placement.host_slots
                    if hs.num_slots > 0 and hs.host in hosts]
            self._prune_pending.clear()
        self._release_slots(job_requests)
        self._pack_growth(job_requests)
        decision = self._decision_fast()
        self._pass_old = None
        return decision

    def _touch(self, job: str, placement: Optional[JobPlacement]) -> None:
        """Record `job`'s pre-mutation placement once per pass (the
        copy-on-write snapshot the end-of-pass diff runs against)."""
        old = self._pass_old
        if old is None or job in old:
            return
        if placement is None:
            old[job] = []
        else:
            old[job] = [(hs.host, hs.num_slots)
                        for hs in placement.host_slots if hs.num_slots > 0]

    def _rebuild_caches(self) -> None:
        """Full recompute of the persistent placements view and per-job
        cross/contiguity stats (after reference-mode passes, restore, or
        defragment rewrote the world)."""
        view: Dict[str, List[Tuple[str, int]]] = {}
        stats: Dict[str, Tuple[int, int]] = {}
        cross_total = 0
        contig_total = 0
        comms_total = 0
        for job, placement in self.job_placements.items():
            view[job] = [(hs.host, hs.num_slots)
                         for hs in placement.host_slots]
            crossed, contig = self._job_stats_of(placement)
            stats[job] = (crossed, contig)
            cross_total += crossed
            contig_total += contig
            comms_total += self._weight_of(job) * contig
        self._placements_view = view
        self._job_stats = stats
        self._cross_total = cross_total
        self._contig_total = contig_total
        self._comms_total = comms_total
        self._caches_valid = True

    def _job_stats_of(self, placement: JobPlacement) -> Tuple[int, int]:
        """(crossed 0/1, contiguity cost) for one job — the per-job term
        of the fleet stats the reference recomputed wholesale."""
        used = {hs.host for hs in placement.host_slots if hs.num_slots > 0}
        if len(used) <= 1:
            return 0, 0
        contig = 0
        if self.topology is not None:
            host_states = self.host_states
            coords = [host_states[h].coord for h in used
                      if h in host_states
                      and host_states[h].coord is not None]
            contig = self.topology.contiguity_cost(coords)
        return 1, contig

    def _pack_growth(self, job_requests: ScheduleResult) -> None:
        """The reference `_place_incremental` loop restricted to jobs
        that actually grow (requested > placed). Restricting BEFORE the
        demand sort is order-preserving: a stable filter commutes with
        the stable sort, and no-growth jobs were side-effect-free in the
        reference loop (their per-job prune is a no-op outside host
        churn, which _place_fast handles via _prune_pending)."""
        jp = self.job_placements
        growth: List[Tuple[str, int]] = []
        for job, requested in job_requests.items():
            placement = jp.get(job)
            if placement is None or requested > placement.num_workers:
                growth.append((job, requested))
        if not growth:
            return
        growth.sort(key=lambda kv: kv[1], reverse=True)
        hosts = self._hosts_sorted()
        host_states = self.host_states
        for job, requested in growth:
            placement = jp.get(job)
            if placement is None:
                placement = jp[job] = JobPlacement(name=job)
            self._touch(job, placement)
            delta = requested - placement.num_workers
            if delta <= 0:
                continue
            my_hosts = [host_states[hs.host] for hs in placement.host_slots
                        if hs.host in host_states and hs.num_slots > 0]
            weight = self._weight_of(job)
            interference = self._interference_of(job)
            while delta > 0:
                best = self._pick_host(hosts, delta, my_hosts,
                                       prefer_own=True, weight=weight,
                                       interference=interference, job=job)
                if best is None:
                    break  # tolerated inconsistency: place what fits
                take = min(best.free_slots, delta)
                self._commit_slots(best, job, take)
                delta -= take
                placement.num_workers += take
                if placement.host_slots and placement.host_slots[-1].host == best.name:
                    placement.host_slots[-1].num_slots += take
                else:
                    placement.host_slots.append(HostSlots(best.name, take))
                if best not in my_hosts:
                    my_hosts.append(best)
            if placement.num_workers == 0:
                del jp[job]

    def _commit_slots(self, host: HostState, job: str, take: int) -> None:
        """Commit `take` chips of `host` to `job` — the single
        partition-commit seam every packing loop goes through. The
        modelcheck seeded-bug tooth subclasses exactly this to prove
        `chip_oversubscribed` has teeth (an overlapping-partition
        commit that forgets the free-slot decrement)."""
        host.job_num_workers[job] = host.job_num_workers.get(job, 0) + take
        host.free_slots -= take

    def _decision_fast(self) -> PlacementDecision:
        """Diff + stats + view refresh over the touched jobs only; the
        untouched fleet contributes its cached terms unchanged."""
        migrations: Dict[str, List[int]] = {}
        full_restarts: List[str] = []
        migrated = 0
        view = self._placements_view
        stats = self._job_stats
        jp = self.job_placements
        for job, old_pairs in (self._pass_old or {}).items():
            placement = jp.get(job)
            if placement is None:  # released outright this pass
                view.pop(job, None)
                crossed, contig = stats.pop(job, (0, 0))
                self._cross_total -= crossed
                self._contig_total -= contig
                self._comms_total -= self._weight_of(job) * contig
                continue
            pairs = [(hs.host, hs.num_slots) for hs in placement.host_slots]
            view[job] = pairs
            crossed, contig = self._job_stats_of(placement)
            old_crossed, old_contig = stats.get(job, (0, 0))
            stats[job] = (crossed, contig)
            self._cross_total += crossed - old_crossed
            self._contig_total += contig - old_contig
            self._comms_total += self._weight_of(job) * (contig - old_contig)

            new_hosts = self._expand_pairs(pairs)
            old_hosts = self._expand_pairs(old_pairs)
            moved = [i for i in range(min(len(old_hosts), len(new_hosts)))
                     if old_hosts[i] != new_hosts[i]]
            if moved:
                migrations[job] = moved
                migrated += len(moved)
                if len(moved) == len(new_hosts):
                    full_restarts.append(job)
        return PlacementDecision(
            placements=dict(view),
            migrations=migrations,
            full_restarts=full_restarts,
            num_jobs_cross_host=self._cross_total,
            total_contiguity_cost=self._contig_total,
            workers_migrated=migrated,
            total_comms_score=self._comms_total,
        )

    @staticmethod
    def _expand_pairs(pairs: List[Tuple[str, int]]) -> List[str]:
        hosts: List[str] = []
        for host, num in pairs:
            hosts.extend([host] * num)
        return hosts

    def defragment(self, job_requests: ScheduleResult) -> PlacementDecision:
        """Full repack + Hungarian stay-put relabeling (the reference's
        Place semantics, :306-332). Consolidates fragmentation at the cost
        of migrations; callers weigh that cost explicitly."""
        with timed(self.m_algo_duration, mode="defragment"), \
                obs_tracer.active_tracer().span(
                    "placement.place", component="placement",
                    attrs={"pool": self.pool_id, "mode": "defragment",
                           "num_jobs": len(job_requests)}):
            old_worker_hosts = {job: self._expand_workers(p)
                                for job, p in self.job_placements.items()}

            self._release_slots(job_requests)
            # Empty logical hosts mirroring the physical fleet (:317-320).
            logical = [HostState(name=f"TBD-{i}", total_slots=h.total_slots,
                                 coord=h.coord)
                       for i, h in enumerate(self._hosts_sorted())]
            cross, contiguity, comms = self._best_fit(job_requests, logical)
            self._bind_hosts(logical)
            self._update_job_placements()
            # The bind may have relabeled coords under the packed jobs:
            # re-score contiguity/comms from the POST-bind world (the
            # packed-on-logical stats would misprice any moved block).
            cross, contiguity, comms = self._fleet_stats()
            decision = self._decision(old_worker_hosts, cross, contiguity,
                                      comms)
            # The repack rewrote the world: the fast path's incremental
            # view/stats rebuild on its next pass.
            self._caches_valid = False
            self._prune_pending.clear()
        self._observe(decision)
        return decision

    def _observe(self, decision: PlacementDecision) -> None:
        self.m_workers_migrated.set(decision.workers_migrated)
        self.m_full_restarts.set(len(decision.full_restarts))
        self.m_jobs_cross_host.set(decision.num_jobs_cross_host)

    def _fleet_stats(self) -> Tuple[int, int, int]:
        """(#jobs crossing hosts, total contiguity, total comms score)
        over the whole current fleet — the post-bind re-score defragment
        needs (the Hungarian relabel moves coords under packed jobs).
        Batched onto the native comms kernel when available (the O(jobs
        x hosts^2) pairwise torus sums were the 100k-fleet re-score
        wall); `_fleet_stats_reference` is the retained Python oracle —
        VODA_NO_NATIVE (or no topology) falls back to it, and the
        differential suite pins native == reference."""
        native_out = self._fleet_stats_native()
        if native_out is not None:
            return native_out
        return self._fleet_stats_reference()

    def _fleet_stats_reference(self) -> Tuple[int, int, int]:
        cross = 0
        contiguity = 0
        comms = 0
        for job, placement in self.job_placements.items():
            crossed, contig = self._job_stats_of(placement)
            cross += crossed
            contiguity += contig
            comms += self._weight_of(job) * contig
        return cross, contiguity, comms

    def _fleet_stats_native(self) -> Optional[Tuple[int, int, int]]:
        """One `voda_comms_score` call for the whole fleet. Only the
        pairwise torus sums move to C++; which hosts a job occupies (the
        crossed flag) stays Python bookkeeping, so the kernel's contract
        is pure integer geometry — bit-identical trivially (the pairwise
        sum is permutation-invariant, so set iteration order is
        irrelevant)."""
        if self.topology is None or not self.job_placements:
            return None
        from vodascheduler_tpu_torch import native

        if native.get_lib() is None:
            return None
        grid = self.topology.host_grid
        ndims = len(grid)
        host_states = self.host_states
        offsets: List[int] = [0]
        coords: List[int] = []
        weights: List[int] = []
        crossed: List[int] = []
        n_coords = 0
        for job, placement in self.job_placements.items():
            used = {hs.host for hs in placement.host_slots
                    if hs.num_slots > 0}
            if len(used) > 1:
                crossed.append(1)
                for h in used:
                    st = host_states.get(h)
                    if st is not None and st.coord is not None:
                        coords.extend(st.coord)
                        n_coords += 1
            else:
                crossed.append(0)
            offsets.append(n_coords)
            weights.append(self._weight_of(job))
        out = native.comms_score(grid, offsets, coords, weights, crossed)
        if out is None:
            return None
        _contigs, totals = out
        return totals

    def _decision(self, old_worker_hosts: Dict[str, List[str]],
                  cross: int, contiguity: int,
                  comms: int = 0) -> PlacementDecision:
        migrations: Dict[str, List[int]] = {}
        full_restarts: List[str] = []
        migrated = 0
        for job, placement in self.job_placements.items():
            new_hosts = self._expand_workers(placement)
            old_hosts = old_worker_hosts.get(job, [])
            moved = [i for i in range(min(len(old_hosts), len(new_hosts)))
                     if old_hosts[i] != new_hosts[i]]
            if moved:
                migrations[job] = moved
                migrated += len(moved)
                if len(moved) == len(new_hosts):
                    full_restarts.append(job)

        return PlacementDecision(
            placements={job: [(hs.host, hs.num_slots) for hs in p.host_slots]
                        for job, p in self.job_placements.items()},
            migrations=migrations,
            full_restarts=full_restarts,
            num_jobs_cross_host=cross,
            total_contiguity_cost=contiguity,
            workers_migrated=migrated,
            total_comms_score=comms,
        )

    def _place_incremental(self, job_requests: ScheduleResult
                           ) -> Tuple[int, int, int]:
        """Pack only growth deltas and new jobs into current free slots.
        Returns (#jobs crossing hosts, total contiguity cost, total
        comms score) over ALL placed jobs."""
        hosts = self._hosts_sorted()
        # Biggest demand first, like _best_fit.
        for job, requested in sorted(job_requests.items(),
                                     key=lambda kv: kv[1], reverse=True):
            placement = self.job_placements.setdefault(job, JobPlacement(name=job))
            # prune dead-host / zeroed entries before packing the delta
            placement.host_slots = [hs for hs in placement.host_slots
                                    if hs.num_slots > 0 and hs.host in self.host_states]
            delta = requested - placement.num_workers
            if delta <= 0:
                continue  # pinned: same size (or release already trimmed it)
            my_hosts = [self.host_states[hs.host] for hs in placement.host_slots
                        if hs.host in self.host_states and hs.num_slots > 0]
            weight = self._weight_of(job)
            interference = self._interference_of(job)
            while delta > 0:
                best = self._pick_host(hosts, delta, my_hosts,
                                       prefer_own=True, weight=weight,
                                       interference=interference, job=job)
                if best is None:
                    break  # tolerated inconsistency: place what fits
                take = min(best.free_slots, delta)
                self._commit_slots(best, job, take)
                delta -= take
                placement.num_workers += take
                # merge into an existing tail entry for the same host
                if placement.host_slots and placement.host_slots[-1].host == best.name:
                    placement.host_slots[-1].num_slots += take
                else:
                    placement.host_slots.append(HostSlots(best.name, take))
                if best not in my_hosts:
                    my_hosts.append(best)
            if placement.num_workers == 0:
                del self.job_placements[job]

        # Stats over the whole fleet.
        return self._fleet_stats()

    # ---- step 1: release (reference :337-411) ----------------------------

    def _release_slots(self, job_requests: ScheduleResult) -> None:
        for placement in list(self.job_placements.values()):
            requested = job_requests.get(placement.name)
            if requested is None:
                # Terminated: release everything.
                self._touch(placement.name, placement)
                for hs in placement.host_slots:
                    host = self.host_states.get(hs.host)
                    if host is not None:
                        host.free_slots += hs.num_slots
                        host.job_num_workers.pop(placement.name, None)
                placement.host_slots.clear()
                placement.num_workers = 0
                del self.job_placements[placement.name]
            elif requested < placement.num_workers:
                # Scaled down: trim from the tail — worker ranks die from
                # the highest index first (release-order contract).
                self._touch(placement.name, placement)
                to_release = placement.num_workers - requested
                while to_release > 0 and placement.host_slots:
                    tail = placement.host_slots[-1]
                    host = self.host_states.get(tail.host)
                    take = min(tail.num_slots, to_release)
                    tail.num_slots -= take
                    to_release -= take
                    placement.num_workers -= take
                    if host is not None:
                        host.free_slots += take
                        host.job_num_workers[placement.name] -= take
                        if host.job_num_workers[placement.name] <= 0:
                            del host.job_num_workers[placement.name]
                    if tail.num_slots == 0:
                        placement.host_slots.pop()

    # ---- step 2: best-fit packing (reference :415-487) -------------------

    def _hosts_sorted(self) -> List[HostState]:
        return sorted(self.host_states.values(), key=lambda h: h.name)

    def _best_fit(self, job_requests: ScheduleResult,
                  hosts: List[HostState]) -> Tuple[int, int, int]:
        """Pack requests onto empty logical hosts. Returns (#jobs crossing
        hosts, total contiguity cost, total comms score)."""
        requests = sorted(job_requests.items(), key=lambda kv: kv[1],
                          reverse=True)
        total_free = sum(h.total_slots for h in hosts)
        cross_host = 0
        total_contiguity = 0
        total_comms = 0

        for job, requested in requests:
            remaining = requested
            my_hosts: List[HostState] = []
            weight = self._weight_of(job)
            interference = self._interference_of(job)
            while remaining > 0:
                if total_free == 0:
                    # Tolerated inconsistency with the scheduler's capacity
                    # view (reference :433-454): place what fits, never
                    # crash.
                    break
                best = self._pick_host(hosts, remaining, my_hosts,
                                       weight=weight,
                                       interference=interference, job=job)
                if best is None:
                    break
                take = min(best.free_slots, remaining)
                self._commit_slots(best, job, take)
                total_free -= take
                remaining -= take
                my_hosts.append(best)
            if len(my_hosts) > 1:
                cross_host += 1
                if self.topology is not None:
                    coords = [h.coord for h in my_hosts if h.coord is not None]
                    contig = self.topology.contiguity_cost(coords)
                    total_contiguity += contig
                    total_comms += weight * contig
        return cross_host, total_contiguity, total_comms

    def _pick_host(self, hosts: List[HostState], requested: int,
                   my_hosts: List[HostState],
                   prefer_own: bool = False,
                   weight: int = 0,
                   interference: int = 0,
                   job: str = "") -> Optional[HostState]:
        """Best-fit with ICI tie-breaking — comms-weighted when the job
        carries a communication weight.

        Reference semantics (:456-480): prefer the host with the *fewest*
        free slots still >= requested (consolidation); if none fits, spill
        onto the host with the most free slots. TPU delta: among candidates
        of equal free-slot count, prefer the one closest (torus distance)
        to hosts the job already occupies.

        Bandwidth-aware delta (ROADMAP item 3, doc/placement.md): for a
        job with comms weight > 0 that already has an anchor, contiguity
        leads instead of tie-breaking:
          - fitting: take the CLOSEST host that fits the whole delta
            (free-slot tightness demoted to the tie-break — the job's
            collectives pay hops every step, the packing looseness is
            someone else's future problem);
          - spill: minimize hop distance per chip obtained (d / free):
            a near fragment beats a far empty host only when its
            per-chip hop cost is genuinely lower, so the job neither
            scatters across far empties nor shatters into fragments.
        Weight 0 (or comms scoring disabled) reduces exactly to the
        count-only pick in both branches, making VODA_PLACEMENT_COMMS=0
        a true reference path.

        `prefer_own` (the incremental grow path): when a host the job
        already occupies can absorb the whole remaining delta, take it —
        an unchanged host set keeps the process group stable, which is
        what lets the backend resize in place (Tier A,
        doc/elastic-resize.md) instead of checkpoint-restarting. The
        resize-cost saving beats the consolidation a tighter foreign
        host would buy; defragment() still consolidates explicitly.
        """
        if prefer_own and my_hosts:
            own = [h for h in my_hosts if h.free_slots >= requested]
            if own:
                return min(own, key=lambda h: h.free_slots)
        fitting = [h for h in hosts if h.free_slots >= requested]
        if fitting:
            if interference > 0:
                # Fractional co-tenancy price (doc/fractional-sharing.md):
                # a sub-host tenant pays `interference_fraction x
                # cotenancy` of its throughput every step, so the pick
                # trades packing tightness for the least-co-tenanted
                # host that fits — weight x foreign chips leads,
                # tightness demoted to the tie-break (mirroring what
                # the comms branch below does for contiguity). Weight 0
                # (every whole-host job) never reaches this branch, so
                # the count-only pick is untouched.
                return min(fitting,
                           key=lambda h: (interference
                                          * self._foreign_chips(h, job),
                                          h.free_slots))
            if (weight > 0 and self.comms_enabled
                    and self.topology is not None and my_hosts):
                anchor = [h.coord for h in my_hosts if h.coord is not None]
                if anchor:
                    topology = self.topology

                    def cost(h: HostState):
                        d = (sum(topology.host_distance(h.coord, a)
                                 for a in anchor)
                             if h.coord is not None else 1 << 30)
                        return (d, h.free_slots)

                    # min() is first-wins on ties: same deterministic
                    # list-order tie-break as the count-only path.
                    return min(fitting, key=cost)
            best_free = min(h.free_slots for h in fitting)
            candidates = [h for h in fitting if h.free_slots == best_free]
        else:
            nonempty = [h for h in hosts if h.free_slots > 0]
            if not nonempty:
                return None
            if (weight > 0 and self.comms_enabled
                    and self.topology is not None and my_hosts):
                anchor = [h.coord for h in my_hosts if h.coord is not None]
                if anchor:
                    topology = self.topology

                    def spill_score(h: HostState):
                        d = (sum(topology.host_distance(h.coord, a)
                                 for a in anchor)
                             if h.coord is not None else 1 << 30)
                        return (d / h.free_slots, -h.free_slots, d)

                    return min(nonempty, key=spill_score)
            max_free = max(h.free_slots for h in nonempty)
            candidates = [h for h in nonempty if h.free_slots == max_free]
        if len(candidates) > 1 and self.topology is not None and my_hosts:
            anchor = [h.coord for h in my_hosts if h.coord is not None]
            if anchor:
                candidates.sort(key=lambda h: sum(
                    self.topology.host_distance(h.coord, a) for a in anchor)
                    if h.coord is not None else 1 << 30)
        return candidates[0]

    # ---- step 3: Hungarian binding (reference :492-544) ------------------

    def _bind_hosts(self, logical: List[HostState]) -> None:
        physical = self._hosts_sorted()
        n = len(physical)
        if n == 0:
            return
        score = [[self._overlap(lg, ph) for ph in physical] for lg in logical]
        # Comms-weighted bind (doc/placement.md): _best_fit packed jobs
        # contiguously on logical hosts whose coords mirror the sorted
        # physical fleet; a bind that relabels a logical host far from
        # its packed coord tears that contiguity up again. Score each
        # (logical, physical) pair as
        #     int(overlap) * STAY - comms_load(lg) * hop(lg, ph)
        # with STAY strictly greater than any achievable penalty, so
        # stay-put workers remain the primary objective (migration
        # minimization — the reference's contract) and the comms term
        # breaks ties among equally-stay-put optima toward bindings
        # that keep comms-heavy blocks where they were packed. All
        # integer, so the canonical lex-min extraction and warm-start
        # theorems (hungarian.py) keep holding; with comms disabled or
        # no weights the matrix is the raw overlap — bit-identical to
        # the count-only bind.
        if (self.comms_enabled and self.topology is not None
                and self.comms_weights):
            topology = self.topology
            loads = [sum(self._weight_of(job)
                         for job in lg.job_num_workers) for lg in logical]
            max_penalty = max(loads, default=0) * topology.host_diameter
            if max_penalty > 0:
                # Dominance must hold per ASSIGNMENT, not per cell: the
                # solver compares total scores, and n rows can each pay
                # up to max_penalty — a stay = max_penalty + 1 scale
                # would let summed comms penalties outbid a stay-put
                # worker (one extra migration to save hops, the exact
                # trade the primary objective forbids).
                stay = len(logical) * max_penalty + 1
                score = [
                    [int(score[i][j]) * stay
                     - (loads[i] * topology.host_distance(lg.coord, ph.coord)
                        if lg.coord is not None and ph.coord is not None
                        else 0)
                     for j, ph in enumerate(physical)]
                    for i, lg in enumerate(logical)]
        # Warm-started canonical assignment: duals + matching carried
        # from the previous defragment; only rows whose overlap vector
        # changed re-solve (canonical extraction guarantees the result
        # equals a cold solve_max — hungarian.py module docstring).
        assignment, self._bind_warm = hungarian.solve_max_warm(
            score, self._bind_warm)
        for row, col in assignment:
            logical[row].name = physical[col].name
            logical[row].coord = physical[col].coord
        self.host_states = {h.name: h for h in logical}

    @staticmethod
    def _overlap(position: HostState, candidate: HostState) -> float:
        """Workers already in place if `position` is bound to `candidate`
        (reference score, :534-544)."""
        return float(sum(min(workers, candidate.job_num_workers.get(job, 0))
                         for job, workers in position.job_num_workers.items()))

    # ---- step 4: rebuild job views (reference :548-567) ------------------

    def _update_job_placements(self) -> None:
        new: Dict[str, JobPlacement] = {}
        for host in self._hosts_sorted():
            for job, workers in host.job_num_workers.items():
                if workers <= 0:
                    continue
                placement = new.setdefault(job, JobPlacement(name=job))
                placement.host_slots.append(HostSlots(host.name, workers))
                placement.num_workers += workers
        self.job_placements = new

    # ---- helpers ---------------------------------------------------------

    @staticmethod
    def _expand_workers(placement: JobPlacement) -> List[str]:
        """Worker index -> host, expanding host_slots in order. Index k of a
        5-worker job placed [(A,3),(B,2)] lives on A,A,A,B,B."""
        hosts: List[str] = []
        for hs in placement.host_slots:
            hosts.extend([hs.host] * hs.num_slots)
        return hosts

    # ---- crash resume (reference constructStatusOnRestart :640-680) ------

    def restore(self, placements: Dict[str, List[Tuple[str, int]]]) -> None:
        """Reconstruct state from externally persisted placements (the
        backend's view of running workers — the TPU analog of reading pod
        tolerations)."""
        self._caches_valid = False
        for job, host_slots in placements.items():
            placement = JobPlacement(name=job)
            for host_name, workers in host_slots:
                host = self.host_states.get(host_name)
                if host is None:
                    continue
                host.free_slots -= workers
                host.job_num_workers[job] = host.job_num_workers.get(job, 0) + workers
                placement.host_slots.append(HostSlots(host_name, workers))
                placement.num_workers += workers
            if placement.num_workers > 0:
                self.job_placements[job] = placement
