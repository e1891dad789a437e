"""The port's server and CLI, hermetically on the CPU, and its GPU monitor.

- The story: the port's `VodaApp` (`hermetic_devices=1`, 2 chips, free
  ports, the journal on) takes `llama_tiny` jobs of at most one chip from
  `cli.main(["create", "-f", ...])`: A (slowed, 4 epochs of 4 steps), B
  (2 epochs) and C, which waits for a chip and is deleted with `cli
  delete`; `cli get jobs` lists them. B completes; once A has its first
  checkpoint, `app.stop()` stops it (SIGTERM, a checkpoint, exit 3): A's
  steps after its first epoch wait for a gate file that the test creates
  just before the stop, so A cannot complete first when B starts late. A
  second `VodaApp(resume=True)` on the same workdir takes the lease at the
  next epoch, recovers the journal, and A resumes from its checkpoint
  (`resumed at step N on 1 chips`, N >= 4) and completes, one CSV row per
  epoch. `cli get jobs` shows A and B Completed and C Canceled, and `cli
  fsck` finds the pool's journal clean.
- The GPU monitor with a stand-in NVML reader: every series per card,
  a vanished card stops exporting; hermetic mode exports the device count
  alone; enabled where NVML cannot be loaded, the monitor and the app
  raise at construction.
- In a subprocess whose meta-path hook refuses ``jax``, ``flax``,
  ``optax`` and ``vodascheduler_tpu``, the port's `VodaApp` constructs,
  starts and stops, and the CLI imports.
- On the card (marked ``cuda``, skipped without one): NVML's total memory
  of card 0 equals `torch.cuda.mem_get_info()`'s within 1%, its free
  memory torch's within 256 MiB, and a
  `VodaApp` with the monitor on reads the card and leaves CUDA
  uninitialised in its process.

Every wait has its own deadline of 90 s (the story takes about 30 s
alone on the CPU, most of it four supervisors importing torch).
"""

import contextlib
import io
import os
import re
import subprocess
import sys
import time
import urllib.request

import pytest
import torch
import yaml

from vodascheduler_tpu_torch import cli
from vodascheduler_tpu_torch.common.metrics import Registry
from vodascheduler_tpu_torch.metricscollector.csv_logger import read_epoch_csv
from vodascheduler_tpu_torch.runtime import gpu_monitor
from vodascheduler_tpu_torch.runtime.gpu_monitor import GpuMonitor
from vodascheduler_tpu_torch.service.app import VodaApp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 90.0
STEPS_PER_EPOCH, A_EPOCHS, STEP_DELAY = 4, 4, 0.25

# Slows every step and, once a process has taken its first epoch's steps,
# holds each further step until the gate file exists (for at most `wait`
# seconds), so that A is still training when the server stops however
# late B starts: the test opens the gate just before it stops the server.
SLOW_SCRIPT = '''
import os
import time
from vodascheduler_tpu_torch.models import get_model as _get


def get_model(spec):
    bundle = _get(spec.model)
    loss_fn = bundle.loss_fn
    steps = [0]

    def slow_loss(module, batch):
        time.sleep({delay})
        steps[0] += 1
        deadline = time.monotonic() + {wait}
        while (steps[0] > {gated_after} and not os.path.exists({gate!r})
               and time.monotonic() < deadline):
            time.sleep(0.05)
        return loss_fn(module, batch)

    bundle.loss_fn = slow_loss
    return bundle
'''


@pytest.fixture
def supervisor_env(monkeypatch):
    """One torch thread per supervisor, the repo importable, nothing of
    the environment that would change where a job runs or what the app
    monitors."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", REPO)
    for name in ("VODA_TRACE_DIR", "VODA_FORCE_CPU_DEVICES",
                 "VODA_FLASH_ATTENTION", "VODA_PROFILE", "VODA_TPU_MONITOR"):
        monkeypatch.delenv(name, raising=False)


def _app(workdir, resume=False):
    app = VodaApp(workdir=workdir, hermetic_devices=1, chips=2,
                  service_port=0, scheduler_port=0, allocator_port=0,
                  rate_limit_seconds=0.2, collector_interval_seconds=1.0,
                  resume=resume)
    app.daemon.poll_seconds = 0.1
    app.start()
    return app


def _cli(app, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main([
            "--server", f"http://127.0.0.1:{app.service_server.port}",
            "--scheduler-server",
            f"http://127.0.0.1:{app.scheduler_server.port}", *args])
    return rc, out.getvalue()


def _create(app, path, **spec):
    with open(path, "w") as f:
        yaml.safe_dump(spec, f)
    rc, out = _cli(app, "create", "-f", str(path))
    assert rc == 0
    return re.fullmatch(r"job created: (\S+)\n", out).group(1)


def _wait(cond, what):
    deadline = time.monotonic() + WAIT
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.05)


def _jobs(app):
    _, out = _cli(app, "get", "jobs")
    return dict(re.findall(r"^(\S+)\s+default\s+(\S+)", out, re.M))


def _log(app, name):
    path = os.path.join(app.workdir, "jobs", name, "supervisor.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def test_cli_jobs_survive_a_server_restart(tmp_path, supervisor_env):
    workdir = str(tmp_path / "voda")
    script = tmp_path / "slow.py"
    gate = tmp_path / "gate"
    script.write_text(SLOW_SCRIPT.format(delay=STEP_DELAY, wait=WAIT,
                                         gated_after=STEPS_PER_EPOCH,
                                         gate=str(gate)))
    job = dict(model="llama_tiny", global_batch_size=2,
               steps_per_epoch=STEPS_PER_EPOCH)
    app = _app(workdir)
    try:
        a = _create(app, tmp_path / "a.yaml", name="a", extra={
            "script": str(script)},
            config={"max_num_chips": 1, "epochs": A_EPOCHS}, **job)
        b = _create(app, tmp_path / "b.yaml", name="b",
                    config={"max_num_chips": 1, "epochs": 2}, **job)
        c = _create(app, tmp_path / "c.yaml", name="c",
                    config={"max_num_chips": 1, "epochs": 2}, **job)
        _wait(lambda: _jobs(app).get(c) == "Waiting", "C to wait")
        assert _cli(app, "delete", c) == (0, f"job deleted: {c}\n")
        _wait(lambda: _jobs(app).get(b) == "Completed", "B to complete")
        epoch0 = os.path.join(app.workdir, "jobs", a, "ckpt",
                              f"step_{STEPS_PER_EPOCH:010d}")
        _wait(lambda: os.path.isdir(epoch0), "A's first checkpoint")
        assert _jobs(app)[a] == "Running"
    finally:
        gate.touch()
        app.stop()
    log_a = _log(app, a)
    saved = re.findall(r"^checkpoint step (\d+) bytes", log_a, re.M)
    assert saved and int(saved[-1]) >= STEPS_PER_EPOCH

    app = _app(workdir, resume=True)
    try:
        assert app.lease.epoch == 2
        _wait(lambda: _jobs(app).get(a) == "Completed", "A to complete")
        assert _jobs(app) == {a: "Completed", b: "Completed", c: "Canceled"}
    finally:
        app.stop()
    resumed = re.findall(r"resumed at step (\d+) on 1 chips", _log(app, a))
    assert resumed == [saved[-1]]
    rows = read_epoch_csv(os.path.join(app.workdir, "jobs", "metrics",
                                       f"{a}.csv"))
    assert [r["epoch"] for r in rows] == [str(e) for e in range(A_EPOCHS)]
    rc, out = _cli(app, "fsck", os.path.join(workdir, "journal",
                                             "default.wal"))
    assert rc == 0 and '"problems": []' in out


# ---- the GPU monitor ---------------------------------------------------------


class FakeNvml:
    """Stands in for NvmlReader: two cards, the second without power
    readings (an unsupported counter is left out)."""

    def __init__(self):
        self.count = 2

    def device_count(self):
        return self.count

    def read(self, index):
        out = {"memory_bytes_in_use": 2e9 + index,
               "memory_bytes_total": 8.5e10, "memory_bytes_free": 8.3e10,
               "utilization_pct": 97.0, "memory_utilization_pct": 41.0}
        if index == 0:
            out.update(power_watts=612.5, power_limit_watts=700.0)
        return out


def _series(registry):
    return {line.split(" ")[0]: float(line.split(" ")[1])
            for line in registry.exposition().splitlines()
            if line.startswith("voda_gpu")}


def test_gpu_monitor_exports_every_card():
    registry, nvml = Registry(), FakeNvml()
    monitor = GpuMonitor(registry, reader=nvml)
    monitor.collect_once()
    series = _series(registry)
    assert series["voda_gpu_devices"] == 2.0
    assert series['voda_gpu_memory_bytes_in_use{accelerator="0"}'] == 2e9
    assert series['voda_gpu_memory_bytes_in_use{accelerator="1"}'] == 2e9 + 1
    assert series['voda_gpu_memory_bytes_total{accelerator="1"}'] == 8.5e10
    assert series['voda_gpu_utilization_pct{accelerator="0"}'] == 97.0
    assert series['voda_gpu_power_limit_watts{accelerator="0"}'] == 700.0
    assert 'voda_gpu_power_watts{accelerator="1"}' not in series
    assert len(series) == 1 + 7 + 5
    nvml.count = 1
    monitor.collect_once()
    series = _series(registry)
    assert series["voda_gpu_devices"] == 1.0
    assert not [s for s in series if 'accelerator="1"' in s]


def test_hermetic_monitor_exports_the_device_count_alone():
    registry = Registry()
    monitor = GpuMonitor(registry, hermetic_devices=3, reader=FakeNvml())
    monitor.collect_once()
    assert monitor.reader is None
    assert _series(registry) == {"voda_gpu_devices": 3.0}
    assert "voda_gpu_memory" not in registry.exposition()


def test_monitor_without_nvml_raises(tmp_path, supervisor_env, monkeypatch):
    monkeypatch.setattr(gpu_monitor, "NVML_LIBRARY", "libnvidia-ml-absent.so")
    with pytest.raises(RuntimeError, match="NVML"):
        GpuMonitor(Registry())
    with pytest.raises(OSError):
        gpu_monitor.NvmlReader()
    monkeypatch.setenv("VODA_TPU_MONITOR", "1")
    with pytest.raises(RuntimeError, match="NVML"):
        VodaApp(workdir=str(tmp_path), chips=1, service_port=0,
                scheduler_port=0, allocator_port=0)


def test_hermetic_app_exports_its_device_count(tmp_path, supervisor_env):
    app = _app(str(tmp_path))
    try:
        url = f"http://127.0.0.1:{app.scheduler_server.port}/metrics"

        def count():
            with urllib.request.urlopen(url, timeout=10.0) as r:
                text = r.read().decode()
            return [line for line in text.splitlines()
                    if line.startswith("voda_gpu")]

        _wait(lambda: count() == ["voda_gpu_devices 1.0"],
              "the monitor's first collection")
    finally:
        app.stop()


BLOCKED_APP = r'''
import importlib.abc
import sys

BLOCKED = ("jax", "flax", "optax", "vodascheduler_tpu")


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, Block())

from vodascheduler_tpu_torch import cli
from vodascheduler_tpu_torch.service.app import VodaApp

app = VodaApp(workdir=sys.argv[1], hermetic_devices=1, chips=1,
              service_port=0, scheduler_port=0, allocator_port=0)
app.start()
app.tpu_monitor.collect_once()
print(app.registry.exposition().count("voda_gpu_devices 1.0"))
app.stop()
assert callable(cli.main)
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("ok")
'''


def test_app_and_cli_run_with_jax_and_the_jax_package_blocked(
        tmp_path, supervisor_env):
    proc = subprocess.run([sys.executable, "-c", BLOCKED_APP,
                           str(tmp_path)], capture_output=True, text=True,
                          timeout=WAIT, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.split() == ["1", "ok"]


# ---- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_nvml_memory_is_the_cards(cuda):
    free, total = torch.cuda.mem_get_info(0)
    nvml = gpu_monitor.NvmlReader().read(0)
    # NVML's total counts the memory reserved on the card, which CUDA's
    # leaves out (about 480 MiB on an H100 80GB); its used is total less
    # free.
    assert nvml["memory_bytes_total"] == pytest.approx(total, rel=1e-2)
    assert nvml["memory_bytes_free"] == pytest.approx(free, abs=1 << 28)
    assert (nvml["memory_bytes_in_use"] + nvml["memory_bytes_free"]
            == nvml["memory_bytes_total"])
    assert 0 < nvml["power_watts"] <= nvml["power_limit_watts"]


CARD_APP = r'''
import sys

import torch

from vodascheduler_tpu_torch.service.app import VodaApp

app = VodaApp(workdir=sys.argv[1], chips=1, service_port=0,
              scheduler_port=0, allocator_port=0)
app.tpu_monitor.collect_once()
used = app.tpu_monitor.m_series["memory_bytes_in_use"].value(accelerator="0")
total = app.tpu_monitor.m_series["memory_bytes_total"].value(accelerator="0")
app.stop()
print(int(app.backend.chips), int(0 < used <= total),
      int(torch.cuda.is_initialized()))
'''


@pytest.mark.cuda
def test_app_monitor_reads_the_card_without_a_cuda_context(cuda, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, VODA_TPU_MONITOR="1")
    proc = subprocess.run([sys.executable, "-c", CARD_APP, str(tmp_path)],
                          capture_output=True, text=True, timeout=WAIT,
                          cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    chips, read, initialised = map(int, proc.stdout.split()[-3:])
    assert chips >= 1 and read == 1 and initialised == 0
