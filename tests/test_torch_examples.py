"""The port's one-card jobs of the new families, and its examples, on the
CPU (VODA_FORCE_CPU_DEVICES=1):

- the supervisor runs a digits_mlp job (the real digits) to its end, one
  CSV row and one loss line per epoch;
- it runs a resnet_tiny job, is stopped by SIGTERM after its first
  checkpoint (exit 3), and resumes (`resumed at step N`) with the
  BatchNorm statistics exactly as they were, their initial values: the
  resumed run's last loss equals an uninterrupted run's (1e-6 relative,
  one fp32 process against another);
- examples/torch/custom-cnn.yaml's script loads through the supervisor's
  `load_bundle` and trains;
- every script of examples/torch/ runs to its end.

Every subprocess has its own timeout.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest
import torch
import yaml

from vodascheduler_tpu_torch.common.job import JobConfig, JobSpec
from vodascheduler_tpu_torch.metricscollector.csv_logger import read_epoch_csv
from vodascheduler_tpu_torch.models import get_model
from vodascheduler_tpu_torch.models.resnet import BatchNorm
from vodascheduler_tpu_torch.runtime import supervisor as tsup
from vodascheduler_tpu_torch.runtime.train import TrainSession

from tests.torch_parity import assert_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 180


def _env():
    return dict(os.environ, VODA_FORCE_CPU_DEVICES="1",
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))


def _spec(workdir, **kw):
    spec = JobSpec(**kw)
    with open(os.path.join(workdir, "spec.json"), "w") as f:
        json.dump(spec.to_dict(), f)
    return spec


def _supervise(workdir):
    return subprocess.Popen(
        [sys.executable, "-m", "vodascheduler_tpu_torch.runtime.supervisor",
         "--workdir", str(workdir), "--num-chips", "1"], cwd=REPO,
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _losses(text):
    return {int(e): float(x) for e, x in
            re.findall(r"^epoch (\d+) loss (\S+)$", text, re.M)}


def test_digits_job_runs_to_its_end(tmp_path):
    _spec(tmp_path, name="digits", model="digits_mlp", global_batch_size=16,
          steps_per_epoch=3, config=JobConfig(epochs=2))
    out, err = _supervise(tmp_path).communicate(timeout=TIMEOUT)
    losses = _losses(out)
    assert sorted(losses) == [0, 1], out + err
    rows = read_epoch_csv(str(tmp_path / "metrics" / "digits.csv"))
    assert [r["epoch"] for r in rows] == ["0", "1"]
    assert '"flash_fwd": 0' in out  # no attention kernel on this path


def test_resnet_job_resumes_with_its_statistics_exact(tmp_path):
    _spec(tmp_path, name="resnet", model="resnet_tiny", global_batch_size=4,
          steps_per_epoch=2, config=JobConfig(epochs=4))
    proc = _supervise(tmp_path)
    first = tmp_path / "ckpt" / f"step_{2:010d}"
    deadline = time.monotonic() + TIMEOUT
    while not first.is_dir():
        assert proc.poll() is None and time.monotonic() < deadline, \
            proc.communicate()
        time.sleep(0.05)
    proc.send_signal(signal.SIGTERM)
    out1, err1 = proc.communicate(timeout=TIMEOUT)
    assert proc.returncode == 3, out1 + err1
    proc = _supervise(tmp_path)
    out2, err2 = proc.communicate(timeout=TIMEOUT)
    assert proc.returncode == 0, out2 + err2
    resumed = re.search(r"resumed at step (\d+) on 1 chips", out2)
    assert resumed and int(resumed.group(1)) >= 2

    bundle = get_model("resnet_tiny")
    session = TrainSession.resume(bundle, 1, str(tmp_path / "ckpt"),
                                  global_batch_size=4, device="cpu")
    assert session.step == 8
    bns = [m for m in session.module.modules() if isinstance(m, BatchNorm)]
    assert bns and all(torch.equal(m.mean, torch.zeros_like(m.mean))
                       and torch.equal(m.var, torch.ones_like(m.var))
                       for m in bns)
    straight = TrainSession(bundle, 1, global_batch_size=4, device="cpu")
    loss = straight.run_steps(8)
    assert_close("resnet_tiny resumed job's last loss", _losses(out2)[3],
                 loss, atol=0, rtol=1e-5)


def test_buffers_ride_in_the_checkpoint(tmp_path):
    """Statistics set away from their init come back exactly on resume,
    and the resumed session's next steps equal the uninterrupted one's."""
    bundle = get_model("resnet_tiny")
    a = TrainSession(bundle, 1, global_batch_size=2, device="cpu")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in a.module.modules():
            if isinstance(m, BatchNorm):
                m.mean.normal_(generator=g)
                m.var.uniform_(0.5, 1.5, generator=g)
    a.run_steps(2)
    a.save(str(tmp_path))
    b = TrainSession.resume(bundle, 1, str(tmp_path), global_batch_size=2,
                            device="cpu")
    for (n, x), (_, y) in zip(a.module.named_buffers(),
                              b.module.named_buffers()):
        assert torch.equal(x, y), n
    assert b.run_steps(2) == a.run_steps(2)


def test_custom_cnn_script_loads_through_the_supervisor(tmp_path):
    with open(os.path.join(REPO, "examples", "torch", "custom-cnn.yaml")) as f:
        raw = yaml.safe_load(f)
    spec = JobSpec.from_dict(raw)
    assert spec.extra["script"] == "examples/torch/custom_cnn_script.py"
    bundle = tsup.load_bundle(spec)
    session = TrainSession(bundle, 1, global_batch_size=4, device="cpu")
    assert session.module.conv0.weight.shape[0] == 48  # extra.width
    losses = [session.run_steps(1) for _ in range(3)]
    assert all(map(lambda x: x == x, losses)) and session.step == 3
    assert session.module(torch.zeros(2, 28, 28, 1)).dtype == torch.float32


@pytest.mark.parametrize("script,args,want", [
    ("mnist_mlp_elastic.py", ["--epochs", "2", "--steps-per-epoch", "2",
                              "--batch-size", "8"], "training complete"),
    ("digits_real_data_elastic.py", ["--epochs", "2", "--steps-per-epoch",
                                     "3"], "accuracy="),
    ("cifar10_resnet_elastic.py", ["--epochs", "1", "--steps-per-epoch", "2",
                                   "--batch-size", "4"], "training complete"),
    ("synthetic_benchmark.py", ["--model", "vit_tiny", "--batch-size", "4",
                                "--num-warmup-batches", "1",
                                "--num-batches-per-iter", "2",
                                "--num-iters", "1"], "examples/sec on cpu"),
])
def test_example_runs_on_the_cpu(tmp_path, script, args, want):
    if script != "synthetic_benchmark.py":
        args = args + ["--workdir", str(tmp_path)]
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "torch", script),
         *args], cwd=REPO, env=_env(), capture_output=True, text=True,
        timeout=TIMEOUT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert want in out.stdout
    if script != "synthetic_benchmark.py":
        assert (tmp_path / "metrics").is_dir()
        # a second run resumes at the end and exits 0 at once
        again = subprocess.run(
            [sys.executable, os.path.join(REPO, "examples", "torch", script),
             *args], cwd=REPO, env=_env(), capture_output=True, text=True,
            timeout=TIMEOUT)
        assert again.returncode == 0 and "resumed at step" in again.stdout


def test_examples_need_a_device():
    env = _env()
    env.pop("VODA_FORCE_CPU_DEVICES")
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "torch",
                                      "mnist_mlp_elastic.py"),
         "--workdir", "unused"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=TIMEOUT)
    assert out.returncode != 0 and "VODA_FORCE_CPU_DEVICES" in out.stderr
