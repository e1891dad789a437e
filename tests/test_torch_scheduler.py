"""The port's scheduler decides exactly as the JAX package's does.

Both packages hold the same control-plane code (the port's is a copy,
`test_torch_control_plane_copy.py`), so the bar is equality, not a
tolerance. The same world is built in each package (the assembly of
`tests/test_scheduler.py`: 2 hosts x 4 chips, `FakeClusterBackend` under a
`VirtualClock`, `PlacementManager`, `ResourceAllocator`,
`AdmissionService`), and the same seeded trace of 30 jobs (varied min/max
chips, epochs, epoch times, priorities and arrivals) runs through it under
ElasticFIFO, ElasticTiresias, FfDLOptimizer and AFS-L, each with the
native library and with VODA_NO_NATIVE=1. Compared for equality:

- every pass's allocation (job -> chips) and every running job's
  placements (host -> chips) after it;
- every job's sequence of statuses with their (virtual) times, and its
  completion time;
- the decision-audit and perf records, ids and timestamps included (the
  tracer runs on the virtual clock, so its ids are replay-deterministic),
  less the fields that time the host (wall and CPU milliseconds), which
  no replay reproduces.
"""

import importlib

import numpy as np
import pytest

ALGORITHMS = ("ElasticFIFO", "ElasticTiresias", "FfDLOptimizer", "AFS-L")
N_JOBS = 30
START = 1753760000.0
# Fields of the audit and perf records measured on the host's clock
# (resize_seconds is the wall time of the backend call).
HOST_TIMED = {"duration_ms", "cpu_ms", "decide_ms", "actuate_ms", "phases",
              "actuation", "wall_ms", "resize_seconds"}


def _trace(seed=0):
    rng = np.random.RandomState(seed)
    arrivals = np.cumsum(rng.exponential(40.0, N_JOBS))
    jobs = []
    for i in range(N_JOBS):
        lo = int(rng.choice([1, 1, 2]))
        hi = max(lo, int(rng.choice([1, 2, 4, 8])))
        jobs.append(dict(name=f"job{i}-m{i % 3}", arrival=float(arrivals[i]),
                         min_chips=lo, max_chips=hi,
                         epochs=int(rng.randint(1, 8)),
                         epoch_seconds=float(rng.uniform(10.0, 120.0)),
                         priority=int(rng.randint(0, 2))))
    return jobs


def _strip(record):
    if isinstance(record, dict):
        return {k: _strip(v) for k, v in record.items()
                if k not in HOST_TIMED}
    if isinstance(record, list):
        return [_strip(v) for v in record]
    return record


def run_world(pkg, algorithm, trace):
    """The trace through `pkg`'s scheduler; everything it decided."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    fake = mod("cluster.fake")
    job_mod = mod("common.job")
    store_mod = mod("common.store")
    clock = mod("common.clock").VirtualClock(start=START)
    statuses = {}

    class RecordingStore(store_mod.JobStore):
        def _record(self, job):
            seq = statuses.setdefault(job.name, [])
            if not seq or seq[-1][0] != job.status.value:
                seq.append((job.status.value, clock.now()))

        def insert_job(self, job):
            super().insert_job(job)
            self._record(job)

        def update_job(self, job):
            super().update_job(job)
            self._record(job)

    passes = []

    class RecordingScheduler(mod("scheduler").Scheduler):
        def resched(self):
            super().resched()
            live = self.backend.running_jobs()
            passes.append((
                clock.now(), dict(self.job_num_chips),
                {n: sorted(h.placements) for n, h in sorted(live.items())}))

    store = RecordingStore()
    bus = mod("common.events").EventBus()
    backend = fake.FakeClusterBackend(clock, restart_overhead_seconds=5.0)
    for i in range(2):
        backend.add_host(f"host-{i}", 4, announce=False)
    sched = RecordingScheduler(
        "pool", backend, store, mod("allocator").ResourceAllocator(store),
        clock, bus=bus, placement_manager=mod("placement").PlacementManager(
            "pool"), algorithm=algorithm, rate_limit_seconds=1.0,
        tracer=mod("obs.tracer").Tracer(clock=clock))
    admission = mod("service").AdmissionService(store, bus, clock)
    names, t = [], 0.0
    try:
        for j in trace:
            clock.advance(j["arrival"] - t)
            t = j["arrival"]
            backend.register_profile(j["name"], fake.WorkloadProfile(
                epoch_seconds_at_1=j["epoch_seconds"]))
            names.append(admission.create_training_job(job_mod.JobSpec(
                name=j["name"], pool="pool", priority=j["priority"],
                config=job_mod.JobConfig(min_num_chips=j["min_chips"],
                                         max_num_chips=j["max_chips"],
                                         epochs=j["epochs"]))))
        for _ in range(2000):
            if all(store.get_job(n).status.is_terminal for n in names):
                break
            clock.advance(10.0)
    finally:
        sched.stop()
    return {
        "names": names,
        "passes": passes,
        "statuses": statuses,
        "completed": {n: store.get_job(n).status.value for n in names},
        "audit": _strip(sched.audit_records(0)),
        "profile": _strip(sched.profile_records(0)),
    }


@pytest.fixture(scope="module")
def trace():
    return _trace()


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_same_decisions_as_the_reference(algorithm, native, trace,
                                         monkeypatch):
    if native:
        monkeypatch.delenv("VODA_NO_NATIVE", raising=False)
        from vodascheduler_tpu_torch import native as port_native
        assert port_native.get_lib() is not None
    else:
        monkeypatch.setenv("VODA_NO_NATIVE", "1")
    ref = run_world("vodascheduler_tpu", algorithm, trace)
    port = run_world("vodascheduler_tpu_torch", algorithm, trace)
    assert set(ref["completed"].values()) == {"Completed"}
    assert len(ref["passes"]) > N_JOBS
    for key in ("names", "passes", "statuses", "completed", "audit",
                "profile"):
        assert port[key] == ref[key], key
