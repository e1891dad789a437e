"""The port's durability plane journals, recovers and leases exactly as the
JAX package's does.

Both packages hold the same code (the port's is a copy,
`test_torch_control_plane_copy.py`), so the bar is equality. The seeded
30-job trace of `test_torch_scheduler.py` runs in each package on the fake
cluster (2 hosts x 4 chips, a `VirtualClock`, a tracer on that clock) with
a write-ahead journal on `MemoryStorage` under a `MemoryLease`. Compared:

- the journal's bytes, record for record;
- `recover.read_state` of the journal;
- the snapshot that a forced compaction writes, and the bytes left after it;
- a crash: the journal is cut after a fixed record (plus half of the next
  frame, the torn tail a kill leaves), a new scheduler resumes from it at
  the next lease epoch on the same store and backend, and the rest of the
  trace arrives. Its recovery report, every pass after it, every job's
  statuses and the audit records must be equal;
- the `FileLease` protocol (acquire, held, renew, expiry, takeover at the
  next epoch, deposed renew, release) and its lease file.
"""

import dataclasses
import importlib
import json

import pytest

from tests.test_torch_scheduler import START, _strip, _trace

PKGS = ("vodascheduler_tpu", "vodascheduler_tpu_torch")
ALGORITHMS = ("ElasticFIFO", "ElasticTiresias")
# The crash cuts the journal after this record; the rest of the trace
# arrives after the resume.
CUT_RECORD, CRASH_AFTER_JOB = 100, 15


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


class _World:
    """The trace's world in one package: the fake cluster, a recording
    store and scheduler, a journal on memory storage."""

    def __init__(self, pkg, algorithm):
        self.pkg, self.algorithm = pkg, algorithm
        self.clock = _mod(pkg, "common.clock").VirtualClock(start=START)
        self.statuses, self.passes = {}, []
        clock, statuses = self.clock, self.statuses
        store_mod = _mod(pkg, "common.store")

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

        self.store = RecordingStore()
        self.bus = _mod(pkg, "common.events").EventBus()
        self.fake = _mod(pkg, "cluster.fake")
        self.backend = self.fake.FakeClusterBackend(
            clock, restart_overhead_seconds=5.0)
        for i in range(2):
            self.backend.add_host(f"host-{i}", 4, announce=False)
        self.tracer = _mod(pkg, "obs.tracer").Tracer(clock=clock)
        self.lease = _mod(pkg, "durability.leader").MemoryLease()
        self.storage = _mod(pkg, "durability.journal").MemoryStorage()
        self.sched = self.scheduler(self.journal(self.storage))
        self.admission = _mod(pkg, "service").AdmissionService(
            self.store, self.bus, clock)
        self.names, self.t = [], 0.0

    def journal(self, storage):
        return _mod(self.pkg, "durability.journal").Journal(
            storage=storage, epoch=self.lease.epoch,
            fence=self.lease.current_epoch, clock=self.clock)

    def scheduler(self, journal, resume=False):
        passes, clock = self.passes, self.clock

        class RecordingScheduler(_mod(self.pkg, "scheduler").Scheduler):
            def resched(self):
                super().resched()
                live = self.backend.running_jobs()
                passes.append((
                    clock.now(), dict(self.job_num_chips),
                    {n: sorted(h.placements)
                     for n, h in sorted(live.items())}))

        store = self.store
        return RecordingScheduler(
            "pool", self.backend, store,
            _mod(self.pkg, "allocator").ResourceAllocator(store), clock,
            bus=self.bus,
            placement_manager=_mod(self.pkg, "placement").PlacementManager(
                "pool"),
            algorithm=self.algorithm, rate_limit_seconds=1.0,
            tracer=self.tracer, journal=journal, resume=resume)

    def arrive(self, jobs):
        job_mod = _mod(self.pkg, "common.job")
        for j in jobs:
            self.clock.advance(j["arrival"] - self.t)
            self.t = j["arrival"]
            self.backend.register_profile(j["name"], self.fake.WorkloadProfile(
                epoch_seconds_at_1=j["epoch_seconds"]))
            self.names.append(self.admission.create_training_job(
                job_mod.JobSpec(
                    name=j["name"], pool="pool", priority=j["priority"],
                    config=job_mod.JobConfig(min_num_chips=j["min_chips"],
                                             max_num_chips=j["max_chips"],
                                             epochs=j["epochs"]))))

    def drain(self):
        for _ in range(2000):
            if all(self.store.get_job(n).status.is_terminal
                   for n in self.names):
                return
            self.clock.advance(10.0)

    def decided(self, sched):
        return {"passes": self.passes, "statuses": self.statuses,
                "completed": {n: self.store.get_job(n).status.value
                              for n in self.names},
                "audit": _strip(sched.audit_records(0))}


def _state(pkg, journal):
    return dataclasses.asdict(
        _mod(pkg, "durability.recover").read_state(journal))


def _full_run(pkg, algorithm, trace):
    w = _World(pkg, algorithm)
    try:
        w.arrive(trace)
        w.drain()
    finally:
        w.sched.stop()
    journal = w.sched.journal
    out = {"bytes": bytes(w.storage.data), "state": _state(pkg, journal),
           "decided": w.decided(w.sched)}
    assert journal.maybe_compact(force=True)
    out["snapshot"] = journal.load_snapshot()
    out["state_after_compaction"] = _state(pkg, journal)
    out["bytes_after_compaction"] = bytes(w.storage.data)
    return out


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_journal_state_and_snapshot_equal_the_reference(algorithm):
    trace = _trace()
    ref, port = (_full_run(pkg, algorithm, trace) for pkg in PKGS)
    assert set(ref["decided"]["completed"].values()) == {"Completed"}
    assert ref["bytes"].count(b"\n") > 2 * len(trace)
    for key in ("bytes", "state", "decided", "snapshot",
                "state_after_compaction", "bytes_after_compaction"):
        assert port[key] == ref[key], key
    # compaction keeps the logical state, less the replay counters
    counters = {"records", "last_seq", "duplicate_records"}
    for key, value in ref["state"].items():
        if key not in counters:
            assert ref["state_after_compaction"][key] == value, key


def _crash_and_resume(pkg, algorithm, trace):
    w = _World(pkg, algorithm)
    w.arrive(trace[:CRASH_AFTER_JOB])
    w.sched.stop()
    journal_mod = _mod(pkg, "durability.journal")
    records = w.sched.journal.records()
    assert len(records) > CUT_RECORD + 1

    def framed(rec):
        return journal_mod.frame(json.dumps(
            rec, separators=(",", ":"), default=str).encode())

    cut = b"".join(framed(r) for r in records[:CUT_RECORD])
    torn = framed(records[CUT_RECORD])
    storage = journal_mod.MemoryStorage()
    storage.data = bytearray(cut + torn[:len(torn) // 2])
    w.lease.advance_epoch()
    journal = w.journal(storage)
    w.passes.clear()
    sched = w.scheduler(journal, resume=True)
    try:
        report = _strip(sched._last_recovery_report)
        w.arrive(trace[CRASH_AFTER_JOB:])
        w.drain()
    finally:
        sched.stop()
    return {"torn_trimmed": journal.torn_trimmed, "report": report,
            "decided": w.decided(sched), "state": _state(pkg, journal)}


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_resume_after_a_crash_cut_equals_the_reference(algorithm):
    trace = _trace()
    ref, port = (_crash_and_resume(pkg, algorithm, trace) for pkg in PKGS)
    assert ref["torn_trimmed"] == 1
    assert ref["report"]["divergences"], "the cut lost no state"
    assert ref["decided"]["passes"]
    assert set(ref["decided"]["completed"].values()) == {"Completed"}
    for key in ("torn_trimmed", "report", "decided", "state"):
        assert port[key] == ref[key], key


def _lease_story(pkg, path):
    leader = _mod(pkg, "durability.leader")
    clock = _mod(pkg, "common.clock").VirtualClock(start=100.0)
    a = leader.FileLease(path, holder="a", ttl_seconds=10.0, clock=clock)
    b = leader.FileLease(path, holder="b", ttl_seconds=10.0, clock=clock)
    steps = [("a acquires", a.try_acquire())]
    with pytest.raises(leader.LeaseHeld):
        b.try_acquire()
    steps.append(("a renews", a.renew()))
    clock.advance(11.0)
    steps += [("b takes over", b.try_acquire()),
              ("epoch", b.current_epoch()),
              ("a renews, deposed", a.renew()),
              ("epoch", b.current_epoch()),
              ("file", a.read())]
    b.release()
    steps += [("file after release", a.read()),
              ("a acquires again", a.try_acquire()),
              ("file", b.read())]
    return steps


def test_file_lease_protocol_equals_the_reference(tmp_path):
    ref, port = (_lease_story(pkg, str(tmp_path / f"{pkg}.lease"))
                 for pkg in PKGS)
    assert [v for k, v in ref[:6]] == [1, True, 2, 2, False, 2]
    assert ref[-2] == ("a acquires again", 3)
    assert port == ref
