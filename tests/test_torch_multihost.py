"""The port's MultiHostBackend (the JAX package's file, text for text) with
the port's supervisor: real multi-process jobs on the CPU.

Two virtual hosts of two CPU chips each. Each host's supervisor is its
agent: the two agents meet at the backend's coordinator address, number
their ranks (host-0's 0–1, host-1's 2–3) and spawn them; the four ranks
form one gloo process group and train llama_tiny over dp=4.

- A 4-chip job completes; process 0 writes the CSV rows (workers 4).
- A second 4-chip job, after its first checkpoint, is scaled to 2 chips:
  the backend SIGTERMs both hosts' agents (the ranks checkpoint together
  and exit 3) and starts one host's agent at 2 chips, which resumes the
  4-rank checkpoint on 2 ranks (`resumed at step N on 2 chips`) and
  completes.
"""

import os
import time

from vodascheduler_tpu_torch.cluster.backend import ClusterEventKind
from vodascheduler_tpu_torch.cluster.multihost import MultiHostBackend
from vodascheduler_tpu_torch.common.job import JobConfig, JobSpec
from vodascheduler_tpu_torch.metricscollector.csv_logger import read_epoch_csv
from vodascheduler_tpu_torch.runtime.checkpoint import latest_step

TIMEOUT = 120.0

SLOW_SCRIPT = '''
import time
from vodascheduler_tpu_torch.models import get_model as _get


def get_model(spec):
    bundle = _get(spec.model)
    loss_fn = bundle.loss_fn

    def slow_loss(module, batch):
        time.sleep(0.4)
        return loss_fn(module, batch)

    bundle.loss_fn = slow_loss
    return bundle
'''


def _wait(predicate, what, logs):
    deadline = time.monotonic() + TIMEOUT
    while not predicate():
        assert time.monotonic() < deadline, f"timed out: {what}\n{logs()}"
        time.sleep(0.1)


def _logs(root, job):
    out = []
    d = os.path.join(root, job)
    for name in sorted(os.listdir(d)) if os.path.isdir(d) else []:
        if name.startswith("supervisor_p") and name.endswith(".log"):
            with open(os.path.join(d, name)) as f:
                out.append(f"--- {name} ---\n{f.read()[-4000:]}")
    return "\n".join(out)


def _spec(name, epochs, script=""):
    return JobSpec(name=name, model="llama_tiny", global_batch_size=4,
                   steps_per_epoch=2,
                   config=JobConfig(min_num_chips=1, max_num_chips=4,
                                    epochs=epochs),
                   extra={"script": script} if script else {})


def test_four_chip_job_and_its_resize_to_two(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    monkeypatch.delenv("VODA_TRACE_DIR", raising=False)
    root = str(tmp_path)
    backend = MultiHostBackend(root, num_hosts=2, chips_per_host=2,
                               stop_grace_seconds=60.0)
    events = []
    backend.set_event_callback(events.append)

    def done(name, kind):
        return any(e.name == name and e.kind == kind for e in events)

    try:
        backend.start_job(_spec("whole", epochs=2), num_workers=4,
                          placements=[("host-0", 2), ("host-1", 2)])
        script = tmp_path / "slow.py"
        script.write_text(SLOW_SCRIPT)
        backend.start_job(_spec("scaled", epochs=4, script=str(script)),
                          num_workers=4,
                          placements=[("host-0", 2), ("host-1", 2)])
        _wait(lambda: latest_step(os.path.join(root, "scaled", "ckpt"))
              is not None, "the first checkpoint of the scaled job",
              lambda: _logs(root, "scaled"))
        backend.scale_job("scaled", 2)
        assert backend.running_jobs()["scaled"].num_workers == 2
        for name in ("whole", "scaled"):
            _wait(lambda n=name: done(n, ClusterEventKind.JOB_COMPLETED),
                  f"{name} to complete", lambda n=name: _logs(root, n))
    finally:
        backend.close()
    assert not [e for e in events if e.kind == ClusterEventKind.JOB_FAILED]

    whole = _logs(root, "whole")
    assert "distributed rank 0 of 4 backend gloo plan MeshPlan(dp=4" in whole
    assert "agent 1 of 2: ranks 2..3 of 4 on cpu" in whole
    rows = read_epoch_csv(os.path.join(backend.metrics_dir, "whole.csv"))
    assert [int(r["epoch"]) for r in rows] == [0, 1]
    assert all(int(r["workers"]) == 4 for r in rows)
    assert latest_step(os.path.join(root, "whole", "ckpt")) == 4

    scaled = _logs(root, "scaled")
    resumed = [line for line in scaled.splitlines()
               if line.startswith("resumed at step ")]
    assert len(resumed) == 1 and resumed[0].endswith(" on 2 chips"), scaled
    assert int(resumed[0].split()[3]) in (2, 4, 6)
    assert latest_step(os.path.join(root, "scaled", "ckpt")) == 8
    rows = read_epoch_csv(os.path.join(backend.metrics_dir, "scaled.csv"))
    assert {int(r["workers"]) for r in rows} == {4, 2}
