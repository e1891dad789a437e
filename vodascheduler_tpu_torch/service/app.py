"""VodaApp: the whole control plane composed in one process.

Reference counterpart: the Helm deployment (SURVEY.md §1) — training
service, per-pool scheduler, resource allocator, and metrics-collector
CronJob as separate pods wired by RabbitMQ/Mongo/kube-dns. Idiomatic
single-binary redesign (SURVEY.md §2.3: "idiomatically: one process or
lightweight services"): the same components with the same REST surface,
composed in-process — the EventBus replaces RabbitMQ, the FileJobStore
replaces Mongo, and each piece still stands alone for a split deployment
(rest.RemoteAllocator, deploy/).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, List, Optional, Union

from vodascheduler_tpu_torch import config
from vodascheduler_tpu_torch.allocator import ResourceAllocator
from vodascheduler_tpu_torch.common.clock import Clock
from vodascheduler_tpu_torch.common.events import EventBus
from vodascheduler_tpu_torch.common.metrics import Registry
from vodascheduler_tpu_torch.common.store import FileJobStore
from vodascheduler_tpu_torch.metricscollector.collector import (
    CsvDirRowSource,
    MetricsCollector,
)
from vodascheduler_tpu_torch.placement import PlacementManager
from vodascheduler_tpu_torch.scheduler.scheduler import Scheduler
from vodascheduler_tpu_torch.service.admission import AdmissionService
from vodascheduler_tpu_torch.service.daemon import SchedulerDaemon
from vodascheduler_tpu_torch.service.rest import (
    make_allocator_server,
    make_scheduler_server,
    make_service_server,
)

log = logging.getLogger(__name__)


@dataclasses.dataclass
class PoolSpec:
    """One TPU pool of the control plane.

    The reference deploys one scheduler per GPU type, each its own Helm
    release fed by a per-type queue (helm/voda-scheduler/,
    scheduler.go:189-190). Here N pools compose into one process: one
    scheduler + placement manager + backend per pool over the shared
    store/bus/allocator.
    """

    name: str
    topology: Optional[object] = None    # placement.topology.PoolTopology
    chips: Optional[int] = None          # capacity when no topology given
    algorithm: Optional[str] = None      # per-pool override


def parse_pools(spec: str, default_algorithm: str) -> List[PoolSpec]:
    """Parse `--pools "v5p=4x4x4/2x2x1,v5e=16"`: each entry is
    name=torus/host_block (a real topology) or name=N (flat chip count).
    An optional :Algorithm suffix overrides the default per pool."""
    from vodascheduler_tpu_torch.placement.topology import PoolTopology
    out: List[PoolSpec] = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, _, rest = entry.partition("=")
        algo = default_algorithm
        if ":" in rest:
            rest, _, algo = rest.partition(":")
        if not rest:
            out.append(PoolSpec(name=name, algorithm=algo))
        elif "/" in rest:
            out.append(PoolSpec(name=name, topology=PoolTopology.parse(rest),
                                algorithm=algo))
        else:
            out.append(PoolSpec(name=name, chips=int(rest), algorithm=algo))
    if not out:
        raise ValueError(f"no pools in {spec!r}")
    names = [p.name for p in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate pool names in {spec!r}: {names}")
    return out


class VodaApp:
    def __init__(self, workdir: str = config.WORKDIR,
                 pool: str = config.DEFAULT_POOL,
                 algorithm: str = config.DEFAULT_ALGORITHM,
                 backend: str = "local",
                 hermetic_devices: Optional[int] = None,
                 chips: Optional[int] = None,
                 host: str = "127.0.0.1",
                 service_port: int = config.SERVICE_PORT,
                 scheduler_port: int = config.SCHEDULER_PORT,
                 allocator_port: int = config.ALLOCATOR_PORT,
                 rate_limit_seconds: float = config.RATE_LIMIT_SECONDS,
                 collector_interval_seconds: float = 60.0,
                 resume: bool = False,
                 pools: Union[None, str, List[PoolSpec]] = None,
                 standby: Optional[bool] = None,
                 kube: Optional[object] = None):
        self.workdir = os.path.abspath(workdir)
        os.makedirs(self.workdir, exist_ok=True)
        self.clock = Clock()
        self.store = FileJobStore(os.path.join(self.workdir, "state.json"))
        self.registry = Registry()
        # Bounded, instrumented event bus (doc/observability.md
        # "Ingestion plane"): per-pool queue depth and drop counts land
        # on the shared /metrics surface.
        self.bus = EventBus(registry=self.registry)

        # Decision-audit tracing plane (doc/observability.md): JSONL sink
        # under the workdir unless VODA_TRACE_DIR points elsewhere.
        # Installed as the process-global tracer so every component —
        # including the REST layer's access events and the supervisors
        # spawned with the dir in their env — records into one trace.
        from vodascheduler_tpu_torch import obs
        self.tracer = obs.Tracer(
            clock=self.clock,
            trace_dir=os.environ.get("VODA_TRACE_DIR")
            or os.path.join(self.workdir, "trace"),
            ring_size=int(os.environ.get("VODA_TRACE_RING", "4096")),
            max_bytes=int(float(os.environ.get("VODA_TRACE_MAX_MB", "64"))
                          * 1024 * 1024))
        obs.set_tracer(self.tracer)

        self.allocator = ResourceAllocator(self.store, registry=self.registry)

        # Pool set: explicit multi-pool spec, or the single-pool args
        # (reference: one scheduler Deployment per GPU type; here one
        # Scheduler per pool in-process, same shared store/bus).
        if pools is None:
            pool_specs = [PoolSpec(name=pool, chips=chips,
                                   algorithm=algorithm)]
        elif isinstance(pools, str):
            pool_specs = parse_pools(pools, algorithm)
        else:
            pool_specs = list(pools)
        names = [p.name for p in pool_specs]
        if len(set(names)) != len(names):
            # Two schedulers with one pool_id would race on the same bus
            # topic and collide their const-labeled metric series.
            raise ValueError(f"duplicate pool names: {names}")

        # Durability plane (doc/durability.md): one leadership lease for
        # the process (fencing epochs), one write-ahead journal per pool
        # plus a fleet journal for router decisions. VODA_JOURNAL=0
        # runs the ephemeral pre-durability control plane.
        self.lease = None
        self.journals: Dict[str, object] = {}
        self.fleet_journal = None
        self.hot_standby = None
        self._takeovers: Dict[str, dict] = {}
        takeover_epoch = 0
        t_takeover = 0.0
        standby = config.STANDBY if standby is None else bool(standby)
        if config.JOURNAL:
            import time as _walltime

            from vodascheduler_tpu_torch.durability.journal import Journal
            from vodascheduler_tpu_torch.durability.leader import FileLease
            from vodascheduler_tpu_torch.durability.leader import LeaseHeld
            # Holder identity must be unique per INSTANCE, not per
            # process: two VodaApps in one process (hermetic tests, an
            # embedded standby) would otherwise silently re-acquire
            # each other's lease as "their own".
            self.lease = FileLease(
                os.path.join(self.workdir, "leader.lease"),
                holder=f"pid:{os.getpid()}.{id(self):x}",
                ttl_seconds=config.LEASE_TTL_SECONDS, clock=self.clock)
            try:
                self.lease.try_acquire()
            except LeaseHeld:
                if standby:
                    # Hot standby (doc/durability.md "Hot standby"): a
                    # live leader holds the lease — tail its journals
                    # via shipping, apply them continuously, and block
                    # here until the lease is won; construction then
                    # resumes as a WARM takeover (the appliers'
                    # materialized states skip the replay).
                    from vodascheduler_tpu_torch.durability.shipping import (
                        FileTailSource,
                    )
                    from vodascheduler_tpu_torch.durability.standby import (
                        HotStandby,
                    )
                    self.hot_standby = HotStandby(
                        {ps.name: FileTailSource(os.path.join(
                            self.workdir, "journal", f"{ps.name}.wal"))
                         for ps in pool_specs},
                        acquire=self.lease.try_acquire,
                        clock=self.clock, registry=self.registry)
                    log.info("standing by: tailing %d pool journal(s) "
                             "until the leader's lease expires (%s)",
                             len(pool_specs), self.workdir)
                    self.hot_standby.run_until_leader()
                    t_takeover = _walltime.monotonic()
                    takeover_epoch = self.lease.epoch
                    self._takeovers = self.hot_standby.prepare_takeovers()
                    resume = True
                else:
                    # A crash restart arrives with the dead leader's
                    # lease still unexpired (the PRIMARY recovery
                    # scenario): wait it out, bounded by one TTL +
                    # slack, instead of dying. A lease that keeps being
                    # RENEWED past the deadline is a genuinely live
                    # leader — then two leaders journaling one workdir
                    # is the split brain fencing exists to prevent, and
                    # startup fails loudly.
                    deadline = (self.clock.now()
                                + config.LEASE_TTL_SECONDS + 2.0)
                    while True:
                        try:
                            self.lease.try_acquire()
                            break
                        except LeaseHeld:
                            if self.clock.now() >= deadline:
                                raise
                            log.info("waiting out the previous leader's "
                                     "lease (%s)", self.workdir)
                            self.clock.sleep(1.0)
            self.fleet_journal = Journal(
                os.path.join(self.workdir, "journal", "fleet.wal"),
                epoch=self.lease.epoch, fence=self.lease.current_epoch,
                clock=self.clock, fsync=config.JOURNAL_FSYNC,
                compact_bytes=config.JOURNAL_COMPACT_BYTES)
            self.lease.announce(self.fleet_journal, op="acquire")
            for ps in pool_specs:
                bundle = self._takeovers.get(ps.name)
                self.journals[ps.name] = Journal(
                    os.path.join(self.workdir, "journal",
                                 f"{ps.name}.wal"),
                    epoch=self.lease.epoch,
                    fence=self.lease.current_epoch, clock=self.clock,
                    fsync=config.JOURNAL_FSYNC,
                    compact_bytes=config.JOURNAL_COMPACT_BYTES,
                    resume_hint=(bundle["resume_hint"]
                                 if bundle is not None else None))

        # Cold multi-pool resume: replay every pool's journal
        # concurrently on a bounded executor BEFORE the serial scheduler
        # construction below, so an N-pool restart pays the slowest
        # pool's replay, not the sum (doc/durability.md "Hot standby").
        self._recovered_states: Dict[str, object] = {
            name: b["state"] for name, b in self._takeovers.items()}
        if resume and not self._takeovers and len(self.journals) > 1:
            from vodascheduler_tpu_torch.durability.recover import (
                read_states_parallel,
            )
            with_state = {name: jnl for name, jnl in self.journals.items()
                          if jnl.has_state()}
            self._recovered_states = read_states_parallel(
                with_state, workers=config.FLEET_WORKERS)

        if backend not in ("local", "gke"):
            raise ValueError(f"unknown backend {backend!r} (local = "
                             "supervisor subprocesses on this machine; gke = "
                             "worker pods via the in-cluster k8s API; "
                             "simulation lives in replay/)")

        from vodascheduler_tpu_torch.cluster.local import LocalBackend
        self.backends: Dict[str, object] = {}
        self.placements: Dict[str, PlacementManager] = {}
        self.schedulers: Dict[str, Scheduler] = {}
        self.collectors: Dict[str, MetricsCollector] = {}
        single = len(pool_specs) == 1
        for ps in pool_specs:
            # Single-pool keeps the flat jobs/ dir (back-compat with
            # existing workdirs); multi-pool namespaces per pool.
            jobs_dir = os.path.join(self.workdir, "jobs") if single else \
                os.path.join(self.workdir, "jobs", ps.name)
            pool_chips = ps.chips
            if pool_chips is None and ps.topology is not None:
                pool_chips = ps.topology.total_chips
            if backend == "gke":
                # All pools share the ONE provisioned namespace
                # (deploy/gke provisions voda-scheduler: RBAC + the
                # voda-state PVC); pods carry a voda/pool label so each
                # pool's backend only lists/adopts its own jobs. Capacity
                # comes from live node discovery, never a declared count.
                if ps.chips is not None:
                    raise ValueError(
                        f"pool {ps.name!r}: chips= is meaningless with "
                        "--backend gke (capacity is discovered from TPU "
                        "node allocatable); declare a topology or drop it")
                from vodascheduler_tpu_torch.cluster.gke import (
                    GkeBackend,
                    InClusterKube,
                )
                # Worker pods mount the shared PVC at /jobs; the control
                # plane mounts the same volume at workdir. Metrics CSVs
                # land in <PVC>/metrics/<pool>/ and the collector reads
                # them through the workdir-side mount.
                pod_metrics = f"/jobs/metrics/{ps.name}" if not single \
                    else "/jobs/metrics"
                from vodascheduler_tpu_torch.cluster.gke import DEFAULT_NAMESPACE
                be = GkeBackend(kube if kube is not None else InClusterKube(),
                                namespace=os.environ.get(
                                    "VODA_NAMESPACE", DEFAULT_NAMESPACE),
                                topology=ps.topology,
                                pool="" if single else ps.name,
                                pod_metrics_dir=pod_metrics,
                                clock=self.clock)
                be.metrics_dir = os.path.join(
                    self.workdir, *pod_metrics.split("/")[2:])
                os.makedirs(be.metrics_dir, exist_ok=True)
            else:
                # The backends stamp events with the SAME injected clock
                # as the scheduler — one time base across the app
                # (vodalint clock-discipline; a private Clock() fallback
                # here would silently drift a future virtual-time mode).
                be = LocalBackend(jobs_dir, chips=pool_chips,
                                  hermetic_devices=hermetic_devices,
                                  topology=ps.topology, clock=self.clock)
            pm = PlacementManager(pool_id=ps.name, topology=ps.topology,
                                  registry=self.registry)
            jnl = self.journals.get(ps.name)
            sched = Scheduler(
                pool_id=ps.name, backend=be, store=self.store,
                allocator=self.allocator, clock=self.clock, bus=self.bus,
                algorithm=ps.algorithm or algorithm,
                rate_limit_seconds=rate_limit_seconds,
                resume=resume, registry=self.registry,
                recovered_state=self._recovered_states.get(ps.name),
                placement_manager=pm, journal=jnl, tracer=self.tracer)
            bundle = self._takeovers.get(ps.name)
            if bundle is not None:
                # Warm takeover complete for this pool: stamp the
                # end-to-end budget + the takeover_report record
                # (doc/durability.md "Hot standby").
                from vodascheduler_tpu_torch.durability.standby import (
                    finish_takeover,
                )
                finish_takeover(
                    sched, self.hot_standby.pools[ps.name], t_takeover,
                    takeover_epoch, bundle["suffix_records"],
                    registry=self.registry)
            self.backends[ps.name] = be
            self.placements[ps.name] = pm
            self.schedulers[ps.name] = sched
            # The collector journals its learned-model state (`jmodel`)
            # through the pool's journal and fires the audited drift
            # trigger at the pool's scheduler (doc/learned-models.md).
            self.collectors[ps.name] = MetricsCollector(
                self.store, CsvDirRowSource(be.metrics_dir),
                interval_seconds=collector_interval_seconds,
                registry=self.registry, pool=ps.name,
                journal=jnl,
                drift_trigger=lambda job, s=sched: s.trigger_resched(
                    "model_drift_detected"))

        # Back-compat single-pool attributes (first pool).
        first = pool_specs[0].name
        self.backend = self.backends[first]
        self.placement = self.placements[first]
        self.scheduler = self.schedulers[first]
        self.collector = self.collectors[first]
        # Fleet control plane (doc/observability.md "Fleet decide"):
        # concurrent per-pool decide on one bounded executor + the
        # cross-pool admission router for specs that name no pool.
        from vodascheduler_tpu_torch.scheduler.fleet import (
            FleetCoordinator,
            FleetRouter,
        )
        self.router = FleetRouter(self.schedulers, tracer=self.tracer,
                                  bus=self.bus,
                                  journal=self.fleet_journal)
        self.fleet = FleetCoordinator(self.schedulers, tracer=self.tracer,
                                      registry=self.registry,
                                      router=self.router)
        self.admission = AdmissionService(self.store, self.bus, self.clock,
                                          registry=self.registry,
                                          valid_pools=set(names),
                                          tracer=self.tracer,
                                          router=self.router,
                                          deposed=self._deposed)
        # Card telemetry on the shared /metrics endpoints (reference
        # delegates this to a separate nvidia_smi_exporter, SURVEY.md §5.5).
        # Collected in hermetic CPU mode (the device count only), or when
        # explicitly enabled. The GPU monitor reads NVML, never CUDA: the
        # server creates no CUDA context and holds no card memory the
        # training supervisors need.
        periodic = [(collector_interval_seconds, self._collect_and_resched)]
        if self.lease is not None:
            # Leader renewal at TTL/3; a failed renew means a standby
            # took over — the journals fence on their next append and
            # the schedulers stop themselves (doc/durability.md).
            periodic.append((max(1.0, config.LEASE_TTL_SECONDS / 3.0),
                             self._renew_lease))
        self.tpu_monitor = None
        if (hermetic_devices is not None
                or os.environ.get("VODA_TPU_MONITOR") == "1"):
            # Register the gauges only when collection actually runs — a
            # disabled monitor must not export voda_gpu_devices=0 as if a
            # healthy host had no accelerators. Enabled without NVML, the
            # monitor raises here. An NVML read costs microseconds, so it
            # samples at the collector's interval when that is shorter.
            from vodascheduler_tpu_torch.runtime.gpu_monitor import GpuMonitor
            self.tpu_monitor = GpuMonitor(self.registry,
                                          hermetic_devices=hermetic_devices)
            periodic.append((min(30.0, collector_interval_seconds),
                             self.tpu_monitor.collect_once))
        self.daemon = SchedulerDaemon(list(self.schedulers.values()),
                                      periodic=periodic,
                                      coordinator=self.fleet)

        # Warm the native kernels off the resched hot path (first use would
        # otherwise block a resched on a synchronous g++ build).
        import threading

        from vodascheduler_tpu_torch import native
        threading.Thread(target=native.get_lib,
                         name="voda-native-warmup", daemon=True).start()

        self.service_server = make_service_server(
            self.admission, self.registry, host=host, port=service_port)
        self.scheduler_server = make_scheduler_server(
            self.schedulers, self.registry, host=host, port=scheduler_port,
            fleet=self.fleet,
            standby_stats=(self.hot_standby.stats
                           if self.hot_standby is not None else None))
        self.allocator_server = make_allocator_server(
            self.allocator, self.registry, host=host, port=allocator_port)

    def _deposed(self) -> bool:
        """Whether a standby took the leadership lease: admissions on a
        deposed control plane must 503 (retry against the current
        leader), never ack a mutation the fenced scheduler drops
        (doc/durability.md). One small lease-file read per admission
        request (the batch path checks once per burst)."""
        return (self.lease is not None
                and self.lease.current_epoch() != self.lease.epoch)

    def _renew_lease(self) -> None:
        if self.lease is not None and not self.lease.renew():
            log.warning("leadership lease lost (a standby took over); "
                        "admissions now answer 503 and the schedulers "
                        "fence on their next journal append")

    def _collect_and_resched(self) -> None:
        """Collector pass; fresh curves can change info-driven allocations
        (reference: collector writes Mongo, next resched reads it §3.5)."""
        for name, collector in self.collectors.items():
            if collector.collect_all() > 0:
                self.schedulers[name].trigger_resched("metrics_update")

    def start(self) -> None:
        self.daemon.start()
        self.service_server.start()
        self.scheduler_server.start()
        self.allocator_server.start()
        log.info("voda up: service=:%d scheduler=:%d allocator=:%d workdir=%s",
                 self.service_server.port, self.scheduler_server.port,
                 self.allocator_server.port, self.workdir)

    def stop(self) -> None:
        self.service_server.stop()
        self.scheduler_server.stop()
        self.allocator_server.stop()
        self.daemon.stop()
        self.fleet.close()
        for sched in self.schedulers.values():
            sched.stop()
        # The bus joins its drainer threads before the backends close:
        # a late drain delivering into a closed backend is the teardown
        # race the 16-pool hygiene test pins (doc/observability.md
        # "Fleet decide").
        self.bus.close()
        for be in self.backends.values():
            if hasattr(be, "close"):
                be.close()
        self.store.flush()
        for jnl in self.journals.values():
            jnl.close()
        if self.fleet_journal is not None:
            self.fleet_journal.close()
        if self.lease is not None:
            # Clean shutdown: expire the lease now so a standby takes
            # over without waiting out the TTL.
            self.lease.release()


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="voda-server",
        description="Run the full control plane (service+scheduler+allocator)")
    parser.add_argument("--workdir", default=config.WORKDIR)
    parser.add_argument("--pool", default=config.DEFAULT_POOL)
    parser.add_argument("--algorithm", default=config.DEFAULT_ALGORITHM)
    parser.add_argument("--hermetic-devices", type=int, default=None,
                        help="give each job an N-device virtual CPU mesh "
                             "(no TPU needed)")
    parser.add_argument("--chips", type=int, default=None,
                        help="pool capacity override")
    parser.add_argument("--pools", default=None,
                        help="multi-pool spec: name=torus/hostblock or "
                             "name=chips, comma-separated, optional "
                             ":Algorithm suffix — e.g. "
                             "'v5p=4x4x4/2x2x1,v5e=16:ElasticFIFO'. One "
                             "scheduler per pool (reference: one scheduler "
                             "deployment per GPU type)")
    parser.add_argument("--backend", default="local",
                        choices=["local", "gke"],
                        help="execution substrate: local supervisor "
                             "subprocesses, or GKE worker pods (in-cluster)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--resume", action="store_true",
                        help="reconstruct state from store + running jobs "
                             "(reference: -resume flag)")
    parser.add_argument("--standby", action="store_true",
                        help="hot standby (doc/durability.md): if a live "
                             "leader holds the lease, tail its journals "
                             "and take over the moment the lease expires "
                             "(also VODA_STANDBY=1)")
    parser.add_argument("--collector-interval", type=float, default=60.0)
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    app = VodaApp(workdir=args.workdir, pool=args.pool,
                  algorithm=args.algorithm, backend=args.backend,
                  hermetic_devices=args.hermetic_devices, chips=args.chips,
                  host=args.host, resume=args.resume,
                  collector_interval_seconds=args.collector_interval,
                  pools=args.pools,
                  standby=True if args.standby else None)
    app.start()
    try:
        import threading
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        app.stop()
    return 0
