"""The port's fleet layer routes and decides exactly as the JAX package's.

Two pools in each package, `a` (2 hosts x 4 chips, a 4x2 torus) and `b`
(1 host x 8 chips), each with its scheduler on the fake cluster, share a
store, a bus, an allocator and a tracer on one `VirtualClock`. A
`FleetRouter` (journaling its routes) places every spec, since none names a
pool, and a `FleetCoordinator` runs a fleet pass at the end. The seeded
trace of `test_torch_scheduler.py` arrives (every third job with a
collectives descriptor, so that the router's affinity term plays). Compared
for equality:

- the pool each job was routed to, and every pass's allocation and
  placements in each pool;
- every job's final status;
- the audit records (routes and passes; spans left out), ids included,
  less the fields that time the host;
- the router's stats, the fleet journal's bytes, the fleet snapshot and
  the last fleet pass's pools and generation.
"""

import importlib

from tests.test_torch_scheduler import START, _strip, _trace

PKGS = ("vodascheduler_tpu", "vodascheduler_tpu_torch")
N_JOBS = 20


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def run_fleet(pkg, trace):
    clock = _mod(pkg, "common.clock").VirtualClock(start=START)
    tracer = _mod(pkg, "obs.tracer").Tracer(clock=clock)
    store = _mod(pkg, "common.store").JobStore()
    bus = _mod(pkg, "common.events").EventBus()
    allocator = _mod(pkg, "allocator").ResourceAllocator(store)
    fake = _mod(pkg, "cluster.fake")
    topology = _mod(pkg, "placement.topology").PoolTopology
    journal_mod = _mod(pkg, "durability.journal")
    job_mod = _mod(pkg, "common.job")
    sched_mod = _mod(pkg, "scheduler")
    passes = []

    class RecordingScheduler(sched_mod.Scheduler):
        def resched(self):
            super().resched()
            live = self.backend.running_jobs()
            passes.append((self.pool_id, clock.now(),
                           dict(self.job_num_chips),
                           {n: sorted(h.placements)
                            for n, h in sorted(live.items())}))

    topologies = {"a": topology(torus_dims=(4, 2), host_block=(2, 2)),
                  "b": topology(torus_dims=(8,), host_block=(8,))}
    schedulers, backends = {}, {}
    for pool, topo in topologies.items():
        backend = fake.FakeClusterBackend(clock, restart_overhead_seconds=5.0)
        for coord in topo.host_coords():
            backend.add_host(topo.host_name(coord), topo.chips_per_host,
                             announce=False)
        schedulers[pool] = RecordingScheduler(
            pool, backend, store, allocator, clock, bus=bus,
            placement_manager=_mod(pkg, "placement").PlacementManager(
                pool, topology=topo),
            algorithm="ElasticTiresias", rate_limit_seconds=1.0,
            tracer=tracer)
        backends[pool] = backend
    storage = journal_mod.MemoryStorage()
    router = sched_mod.FleetRouter(
        schedulers, enabled=True, tracer=tracer, bus=bus,
        journal=journal_mod.Journal(storage=storage, clock=clock))
    fleet = sched_mod.FleetCoordinator(schedulers, workers=2, tracer=tracer,
                                       router=router)
    admission = _mod(pkg, "service").AdmissionService(
        store, bus, clock, valid_pools=set(topologies), tracer=tracer,
        router=router)
    names, t = [], 0.0
    try:
        for i, j in enumerate(trace):
            clock.advance(j["arrival"] - t)
            t = j["arrival"]
            collectives = ({"allreduce_bytes_per_chip": 4e9,
                            "comms_fraction": 0.3} if i % 3 == 0 else None)
            spec = job_mod.JobSpec(
                name=j["name"], pool="", priority=j["priority"],
                collectives=collectives,
                config=job_mod.JobConfig(min_num_chips=j["min_chips"],
                                         max_num_chips=j["max_chips"],
                                         epochs=j["epochs"]))
            name = admission.create_training_job(spec)
            for backend in backends.values():
                backend.register_profile(name, fake.WorkloadProfile(
                    epoch_seconds_at_1=j["epoch_seconds"]))
            names.append(name)
        for _ in range(2000):
            if all(store.get_job(n).status.is_terminal for n in names):
                break
            clock.advance(10.0)
        last_pass = fleet.run_fleet_pass()
        snapshot = fleet.fleet_snapshot()
    finally:
        fleet.close()
        for sched in schedulers.values():
            sched.stop()
    return {
        "routed": {n: store.get_job(n).pool for n in names},
        "passes": passes,
        "completed": {n: store.get_job(n).status.value for n in names},
        "audit": _strip([r for r in tracer.records()
                         if r.get("kind") != "span"]),
        # route_ms times the host's routing calls
        "router": {k: v for k, v in router.stats().items()
                   if k != "route_ms"},
        "journal": bytes(storage.data),
        "snapshot": _strip(snapshot),
        "last_pass": (sorted(last_pass["pools"]), last_pass["generation"]),
    }


def test_routes_and_passes_equal_the_reference():
    trace = [dict(j) for j in _trace()[:N_JOBS]]
    ref, port = (run_fleet(pkg, trace) for pkg in PKGS)
    assert set(ref["completed"].values()) == {"Completed"}
    assert set(ref["routed"].values()) == {"a", "b"}
    assert {p for p, *_ in ref["passes"]} == {"a", "b"}
    assert [r for r in ref["audit"] if r["kind"] == "fleet_route"]
    assert ref["journal"]
    for key in ref:
        assert port[key] == ref[key], key
