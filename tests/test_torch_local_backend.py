"""The port's GPU LocalBackend under the port's scheduler, on the CPU.

- The story, hermetic (`hermetic_devices=1`: one chip, the supervisors on
  the CPU), with `llama_tiny` jobs of at most one chip under
  ElasticTiresias: job A starts; at its first checkpoint the queue-0
  threshold and the lease are lowered (the module constants
  `examples/e2e_tpu_scheduler.py` lowers) so that A is demoted, and B
  arrives. B preempts A (SIGTERM, a checkpoint, exit 3), the knobs go back
  so that B is not demoted in turn, B completes, and A resumes (`resumed
  at step N on 1 chips`, N > 0) and completes. One CSV row per epoch each;
  A's last-epoch loss equals an uninterrupted CPU `TrainSession`'s (1e-5
  relative), since a batch is a function of (seed, step). The real clock
  has no ticker of its own, so the test pumps the scheduler and ticks its
  time metrics, as a service daemon would.
- The backend alone, its spawn stubbed: with four cards and no hermetic
  mode each grant gets distinct `CUDA_VISIBLE_DEVICES` indices and a stop
  returns them; a grow beyond the grant goes the cold path, and an
  in-place shrink hands back the cards it left; a stop is SIGTERM, the
  grace period, then SIGKILL.
- A grant of two cards, which the supervisor cannot train yet, ends as a
  `job_failed` event carrying its message, and the scheduler goes on to
  run the next job.

Every wait has its own deadline (the story takes about 27 s alone on
the CPU, about 75 s beside five other test workers: most of it is three
supervisors importing torch). The supervisors run with one torch thread
each.
"""

import json
import os
import re
import signal
import subprocess
import time

import pytest

from vodascheduler_tpu_torch.algorithms import elastic_tiresias, tiresias
from vodascheduler_tpu_torch.allocator import ResourceAllocator
from vodascheduler_tpu_torch.cluster import local
from vodascheduler_tpu_torch.cluster.backend import (ClusterEventKind,
                                                     ResizePath)
from vodascheduler_tpu_torch.cluster.local import LocalBackend
from vodascheduler_tpu_torch.common.clock import Clock
from vodascheduler_tpu_torch.common.events import EventBus
from vodascheduler_tpu_torch.common.job import JobConfig, JobSpec
from vodascheduler_tpu_torch.common.store import JobStore
from vodascheduler_tpu_torch.common.types import PREEMPTED_EXIT_CODE
from vodascheduler_tpu_torch.metricscollector.csv_logger import read_epoch_csv
from vodascheduler_tpu_torch.models import get_model
from vodascheduler_tpu_torch.placement import PlacementManager
from vodascheduler_tpu_torch.runtime.train import TrainSession
from vodascheduler_tpu_torch.scheduler import Scheduler
from vodascheduler_tpu_torch.service import AdmissionService

from tests.torch_parity import assert_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 90.0          # seconds, each wait
TICK = 0.5           # seconds between time-metric ticks, as a daemon's
STEPS_PER_EPOCH = 4
# A trains 12 steps past its first checkpoint, of 0.25 s each at least:
# time enough for B to arrive and preempt it before it ends.
A_EPOCHS, B_EPOCHS, STEP_DELAY = 4, 2, 0.25

# Slows every step so that the scheduler acts between A's steps.
SLOW_SCRIPT = '''
import time
from vodascheduler_tpu_torch.models import get_model as _get


def get_model(spec):
    bundle = _get(spec.model)
    loss_fn = bundle.loss_fn

    def slow_loss(module, batch):
        time.sleep({delay})
        return loss_fn(module, batch)

    bundle.loss_fn = slow_loss
    return bundle
'''


class RecordingBackend(LocalBackend):
    """Notes every spawn and every stop's exit code."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.spawns, self.stops = [], []

    def _spawn(self, spec, num_chips):
        self.spawns.append((spec.name, num_chips))
        return super()._spawn(spec, num_chips)

    def _stop_proc(self, name):
        proc = self._procs.get(name)
        super()._stop_proc(name)
        if proc is not None:
            self.stops.append((name, proc.popen.returncode))


@pytest.fixture
def supervisor_env(monkeypatch):
    """One torch thread per supervisor, the repo importable, nothing of
    the environment that would change where a job runs or traces."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", REPO)
    for name in ("VODA_TRACE_DIR", "VODA_FORCE_CPU_DEVICES",
                 "VODA_FLASH_ATTENTION", "VODA_PROFILE"):
        monkeypatch.delenv(name, raising=False)


def _world(backend):
    store, bus, clock = JobStore(), EventBus(), Clock()
    sched = Scheduler("cpu", backend, store, ResourceAllocator(store), clock,
                      bus=bus, placement_manager=PlacementManager("cpu"),
                      algorithm="ElasticTiresias", rate_limit_seconds=0.2)
    return store, sched, AdmissionService(store, bus, clock)


def _spec(name, epochs, script, chips=1):
    return JobSpec(name=name, pool="cpu", model="llama_tiny",
                   global_batch_size=2, steps_per_epoch=STEPS_PER_EPOCH,
                   config=JobConfig(min_num_chips=chips, max_num_chips=chips,
                                    epochs=epochs),
                   extra={"script": script} if script else {})


def _wait(sched, cond, what):
    """Pump the scheduler and tick its time metrics until `cond()`."""
    deadline = time.monotonic() + WAIT
    last_tick = 0.0
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        sched.pump()
        if time.monotonic() - last_tick >= TICK:
            last_tick = time.monotonic()
            sched.update_time_metrics()
        time.sleep(0.05)


def _log(workdir, name):
    path = os.path.join(workdir, name, "supervisor.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def _status(store, name):
    return store.get_job(name).status.value


def test_preempted_job_resumes_and_both_complete(tmp_path, supervisor_env,
                                                 monkeypatch):
    workdir = str(tmp_path)
    script = tmp_path / "slow.py"
    script.write_text(SLOW_SCRIPT.format(delay=STEP_DELAY))
    backend = RecordingBackend(os.path.join(workdir, "jobs"),
                               hermetic_devices=1)
    jobs = backend.workdir
    store, sched, admission = _world(backend)
    try:
        a = admission.create_training_job(_spec("a", A_EPOCHS, str(script)))
        _wait(sched, lambda: os.path.isdir(os.path.join(
            jobs, a, "ckpt", f"step_{STEPS_PER_EPOCH:010d}")),
            "A's first checkpoint")
        # A has trained past its first checkpoint: lower the queue-0
        # threshold and the lease (one quantum) so that it is demoted.
        monkeypatch.setitem(tiresias.TIRESIAS_THRESHOLDS_SEC, 0, 0.5)
        monkeypatch.setattr(elastic_tiresias, "LEASE_SECONDS", 0.5)
        sched.update_time_metrics()
        assert sched.ready_jobs[a].priority == 1
        b = admission.create_training_job(_spec("b", B_EPOCHS, str(script)))
        _wait(sched, lambda: _status(store, b) == "Running"
              and _status(store, a) == "Waiting", "B to preempt A")
        # B must not be demoted in turn and lose the card back to A.
        monkeypatch.setitem(tiresias.TIRESIAS_THRESHOLDS_SEC, 0, 3600.0)
        monkeypatch.setattr(elastic_tiresias, "LEASE_SECONDS", 3600.0)
        _wait(sched, lambda: _status(store, b) == "Completed",
              "B to complete")
        _wait(sched, lambda: _status(store, a) == "Completed",
              "A to complete")
    finally:
        sched.stop()
        backend.close()

    assert backend.spawns == [(a, 1), (b, 1), (a, 1)]
    assert backend.stops == [(a, PREEMPTED_EXIT_CODE)]
    log_a = _log(jobs, a)
    resumed = re.findall(r"resumed at step (\d+) on 1 chips", log_a)
    assert len(resumed) == 1 and int(resumed[0]) >= STEPS_PER_EPOCH
    assert f"checkpoint step {resumed[0]} bytes" in log_a
    assert "resumed at step" not in _log(jobs, b)
    for name, epochs in ((a, A_EPOCHS), (b, B_EPOCHS)):
        rows = read_epoch_csv(os.path.join(backend.metrics_dir,
                                           f"{name}.csv"))
        assert [r["epoch"] for r in rows] == [str(e) for e in range(epochs)]

    # The same job without the interruption, in this process.
    session = TrainSession(get_model("llama_tiny"), global_batch_size=2,
                           device="cpu")
    want = session.run_steps(A_EPOCHS * STEPS_PER_EPOCH)
    got = float(re.findall(rf"epoch {A_EPOCHS - 1} loss (\S+)", log_a)[-1])
    assert_close("preempted job's last-epoch loss", got, want, 0.0, 1e-5)


# ---- the backend alone, its spawn stubbed -----------------------------------


class FakePopen:
    """A supervisor that runs until signalled; records what it was sent.
    One that `hangs` outlives any grace period."""

    def __init__(self, cmd, env, hangs):
        self.cmd, self.env, self.hangs = cmd, env, hangs
        self.calls, self.returncode = [], None

    def poll(self):
        return self.returncode

    def send_signal(self, sig):
        self.calls.append(signal.Signals(sig).name)

    def wait(self, timeout=None):
        self.calls.append(("wait", timeout))
        if self.hangs and timeout is not None:
            raise subprocess.TimeoutExpired(self.cmd, timeout)
        self.returncode = -9 if self.hangs else PREEMPTED_EXIT_CODE
        return self.returncode

    def kill(self):
        self.calls.append("SIGKILL")


class Spawns(list):
    hangs = False


@pytest.fixture
def stub_spawn(monkeypatch):
    """The backend's Popen replaced: the list of FakePopens it made."""
    made = Spawns()

    def popen(cmd, env=None, **kwargs):
        made.append(FakePopen(cmd, env, made.hangs))
        return made[-1]

    monkeypatch.setattr(local.subprocess, "Popen", popen)
    return made


def _cards(p):
    return p.env["CUDA_VISIBLE_DEVICES"]


def test_each_grant_gets_its_own_cards(tmp_path, stub_spawn):
    backend = LocalBackend(str(tmp_path), chips=4, topology="2x2",
                           poll_interval_seconds=0.01)
    try:
        assert backend.list_hosts() == {"localhost": 4}
        backend.start_job(_spec("a", 1, ""), 1)
        backend.start_job(_spec("b", 1, "", chips=2), 2)
        backend.start_job(_spec("c", 1, ""), 1)
        assert [_cards(p) for p in stub_spawn] == ["0", "1,2", "3"]
        with pytest.raises(RuntimeError, match="only 0 of 4"):
            backend.start_job(_spec("d", 1, ""), 1)
        backend.stop_job("b")
        assert stub_spawn[1].calls[0] == "SIGTERM"
        backend.start_job(_spec("e", 1, "", chips=2), 2)
        assert _cards(stub_spawn[-1]) == "1,2"
        p = stub_spawn[0]
        assert p.cmd[1:4] == ["-m", "vodascheduler_tpu_torch.runtime."
                              "supervisor", "--workdir"]
        assert p.cmd[4:] == [os.path.join(backend.workdir, "a"),
                             "--num-chips", "1", "--metrics-dir",
                             backend.metrics_dir]
        for p in stub_spawn:
            assert "VODA_TOPOLOGY" not in p.env
            assert "VODA_FORCE_CPU_DEVICES" not in p.env
            assert p.env["VODA_PLACEMENT_SPREAD"] == "0.0"
        # Co-tenancy at spawn: c saw a and b's 3 of 4 chips held.
        assert stub_spawn[2].env["VODA_PLACEMENT_COTENANCY"] == "0.7500"
    finally:
        backend.close()
    assert backend._free_cards == [0, 1, 2, 3]


def test_a_grow_beyond_the_grant_takes_the_cold_path(tmp_path, stub_spawn):
    backend = LocalBackend(str(tmp_path), chips=4,
                           poll_interval_seconds=0.01)
    try:
        backend.start_job(_spec("a", 1, ""), 1)
        assert backend.scale_job("a", 2) is ResizePath.RESTART
        # No in-place request was written: the job sees only its grant.
        assert not os.path.exists(os.path.join(backend.workdir, "a",
                                               "control", "cmd.json"))
        assert stub_spawn[0].calls[0] == "SIGTERM"
        assert _cards(stub_spawn[1]) == "0,1"
        assert backend.running_jobs()["a"].num_workers == 2
    finally:
        backend.close()


def test_an_inplace_shrink_hands_back_the_cards_it_left(tmp_path,
                                                        stub_spawn):
    """A shrink the supervisor acks in place returns the cards it no
    longer uses; the job then sees only what it kept, so growing again
    takes the cold path."""
    backend = LocalBackend(str(tmp_path), chips=4,
                           poll_interval_seconds=0.01)
    try:
        backend.start_job(_spec("a", 1, "", chips=2), 2)
        control = os.path.join(backend.workdir, "a", "control")
        os.makedirs(control)
        with open(os.path.join(control, "ack_1.json"), "w") as f:
            json.dump({"seq": 1, "ok": True, "path": "inplace",
                       "num_chips": 1}, f)
        assert backend.scale_job("a", 1) is ResizePath.INPLACE
        assert backend._free_cards == [1, 2, 3]
        assert backend.running_jobs()["a"].num_workers == 1
        assert backend.scale_job("a", 2) is ResizePath.RESTART
        assert [_cards(p) for p in stub_spawn] == ["0,1", "0,1"]
        assert stub_spawn[0].calls[0] == "SIGTERM"
    finally:
        backend.close()


@pytest.mark.parametrize("hangs", [False, True])
def test_stop_is_sigterm_then_grace_then_sigkill(tmp_path, stub_spawn,
                                                 hangs):
    backend = LocalBackend(str(tmp_path), chips=1, stop_grace_seconds=0.25,
                           poll_interval_seconds=0.01)
    stub_spawn.hangs = hangs
    try:
        backend.start_job(_spec("a", 1, ""), 1)
        backend.stop_job("a")
    finally:
        backend.close()
    want = ["SIGTERM", ("wait", 0.25)]
    if hangs:
        want += ["SIGKILL", ("wait", None)]
    assert stub_spawn[0].calls == want
    assert backend.running_jobs() == {} and backend._free_cards == [0]


def test_a_two_card_grant_fails_with_the_supervisors_message(
        tmp_path, supervisor_env):
    """Until multi-GPU training is ported a supervisor cannot train on two
    devices: the grant ends as job_failed with its message, and the
    scheduler runs the next job."""
    backend = LocalBackend(os.path.join(str(tmp_path), "jobs"), chips=2,
                           hermetic_devices=1)
    store, sched, admission = _world(backend)
    events = []
    scheduler_cb = backend._event_cb

    def observed(ev):
        events.append(ev)
        scheduler_cb(ev)

    backend.set_event_callback(observed)
    try:
        wide = admission.create_training_job(_spec("wide", 1, "", chips=2))
        _wait(sched, lambda: _status(store, wide) == "Failed",
              "the two-card job to fail")
        failed = [e for e in events if e.name == wide]
        assert [e.kind for e in failed] == [ClusterEventKind.JOB_FAILED]
        assert failed[0].detail.startswith("exit code 1: NotImplementedError")
        assert "item 10" in failed[0].detail
        narrow = admission.create_training_job(_spec("narrow", 1, ""))
        _wait(sched, lambda: _status(store, narrow) == "Completed",
              "the next job to complete")
    finally:
        sched.stop()
        backend.close()
