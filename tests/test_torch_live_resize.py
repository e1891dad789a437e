"""The in-place resize of the port, on the CPU: a running job's process
group changes the size of its mesh within the ranks it holds, and its
state moves rank to rank with no checkpoint (the counterpart of
tests/test_live_resize.py).

One spawned group of 4 gloo ranks (tests/torch_dist_workers.py) runs every
session-level story, each a `TrainSession` of its own:

- against the JAX package: llama_tiny, B=8, fp32, from the same weights
  on the same numpy batches, the JAX `TrainSession` on 2 of its CPU
  devices at fsdp=2, 3 steps, `resize(4)` at fsdp=2 × tp=2, 3 steps,
  `resize(1)`, 2 steps, and the port's 4 ranks the same: every step's
  loss within 1e-4 relative, the final parameters within 1e-4 absolute
  (the whole-slice AdamW bars of test_torch_parallel_train.py);
- 2 → 4 → 2 round trips at fsdp (fsdp=2, fsdp=4) and tp (tp=2, tp=4, which
  splits the heads and not the kv heads): every module and optimizer
  tensor, whole, bitwise across each resize, and the next step's loss
  that of an uninterrupted run at the same plan, exactly;
- Adafactor on a scanned Llama whose leaves factor: 1 step at fsdp=2, a
  resize to fsdp=2 × tp=2, 2 steps, against one device within 1e-6;
- refused resizes before each round trip (8 rows over 3 data ranks; 8
  chips on 4 ranks) raise a plain error on every rank before anything
  moves: the state bitwise as before, and the session trains on.

Then the supervisor, through `LocalBackend(hermetic_devices=4)`: a running
2-chip job of llama_tiny, and one of mixtral_tiny (ep2 at 2 chips, ep4 at
4), (4 rank processes, two waiting) is resized to 4 and then to 1,
each `INPLACE` with the same pid and no checkpoint; a later re-placement
(SIGTERM) checkpoints from the live rank and the job resumes at 1 chip and
completes, its last CSV row at 1 chip. And the rule for ranks beyond the
mesh: on CUDA they leave, on the CPU they wait; with the CUDA rule forced
on CPU ranks, the survivor of a shrink trains, nacks a grow, checkpoints
on SIGTERM, and its agent exits with its code.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_dist_workers as workers
from tests.torch_parity import assert_close
from vodascheduler_tpu.models import llama as jllama
from vodascheduler_tpu.models.registry import ModelBundle as JaxBundle
from vodascheduler_tpu.models.registry import _lm_batch, _lm_fused_loss
from vodascheduler_tpu.parallel.mesh import MeshPlan as JaxPlan
from vodascheduler_tpu.parallel.sharding import TRANSFORMER_RULES
from vodascheduler_tpu.runtime.train import TrainSession as JaxSession
from vodascheduler_tpu_torch import bridge
from vodascheduler_tpu_torch.cluster.backend import (ClusterEventKind,
                                                     ResizePath)
from vodascheduler_tpu_torch.cluster.local import LocalBackend
from vodascheduler_tpu_torch.common.job import JobConfig, JobSpec
from vodascheduler_tpu_torch.common.types import PREEMPTED_EXIT_CODE
from vodascheduler_tpu_torch.metricscollector.csv_logger import read_epoch_csv
from vodascheduler_tpu_torch.runtime import supervisor as tsup
from vodascheduler_tpu_torch.runtime.checkpoint import list_steps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 8
WAIT = 90.0  # seconds, each wait on a supervisor
AF = {"optimizer": "adafactor",
      "cfg": {"dim": 128, "mlp_hidden": 256, "scan_layers": True}}
FSDP2, TP2 = {"fsdp": 2}, {"tp": 2}
# (plan at 2 chips, plan at 4) of each round trip
TRIPS = {"fsdp": (FSDP2, {"fsdp": 4}), "tp": (TP2, {"tp": 4})}


def _jax_bundle():
    jcfg = dataclasses.replace(jllama.LLAMA_TINY, dtype="float32")
    return JaxBundle(name="llama_tiny", module=jllama.Llama(jcfg),
                     make_batch=_lm_batch(jcfg.vocab_size, workers.SEQ),
                     loss_fn=_lm_fused_loss, rules=TRANSFORMER_RULES,
                     seq_len=workers.SEQ)


def _trip(plans):
    """2 steps, two refused resizes, 2 -> 4 -> 2, a step; the whole state
    before and after each resize."""
    at2, at4 = plans
    return [["steps", 2], ["state"], ["refuse", 3, None],
            ["refuse", 8, None], ["state"], ["resize", 4, at4], ["state"],
            ["resize", 2, at2], ["state"], ["steps", 1]]


@pytest.fixture(scope="module")
def jax_start():
    """The JAX session at 2 chips (fsdp=2) and its initial parameters."""
    session = JaxSession(_jax_bundle(), 2, global_batch_size=BATCH,
                         devices=jax.devices()[:2], plan=JaxPlan(fsdp=2))
    params = jax.tree.map(np.array, session.state["params"])
    return session, params


@pytest.fixture(scope="module")
def stories(jax_start, tmp_path_factory):
    """Every session-level story on one group of 4 gloo ranks; each rank's
    records by story."""
    tmp = tmp_path_factory.mktemp("live_resize")
    path = str(tmp / "jax_params.pt")
    torch.save(bridge.flax_to_state_dict(jax_start[1]), path)
    one_af = workers.train(0, 1, steps=3, batch=BATCH, **AF)
    af_path = str(tmp / "af_params.pt")
    torch.save(one_af["before"], af_path)
    runs = {
        "parity": dict(chips=2, plan=FSDP2, params=path, actions=[
            ["steps", 3], ["resize", 4, {"fsdp": 2, "tp": 2}], ["steps", 3],
            ["resize", 1, None], ["steps", 2], ["state"]]),
        "adafactor": dict(chips=2, plan=FSDP2, params=af_path, **AF,
                          actions=[["steps", 1],
                                   ["resize", 4, {"fsdp": 2, "tp": 2}],
                                   ["steps", 2], ["state"]]),
    }
    for name, plans in TRIPS.items():
        runs[f"trip_{name}"] = dict(chips=2, plan=plans[0],
                                    actions=_trip(plans))
        runs[f"straight_{name}"] = dict(chips=2, plan=plans[0],
                                        actions=[["steps", 3]])
    out = workers.run_ranks("resize_stories", 4, tmp, deadline=180.0,
                            stories=runs)
    return {"ranks": out, "one_af": one_af}


def _rank0(stories, name):
    return stories["ranks"][0][name]


def _bitwise(got, want, what):
    assert set(got) == set(want) and got, what
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    assert not bad, f"{what}: {bad[:5]}"


def test_four_ranks_track_the_jax_package_across_2_4_1(jax_start, stories):
    session, params = jax_start
    batches = workers.lm_batches(params["embed"]["embedding"].shape[0], 8,
                                 BATCH)
    jlosses = []
    for n, resize in ((3, (4, JaxPlan(fsdp=2, tp=2))), (3, (1, None)),
                      (2, None)):
        for _ in range(n):
            b = batches[session.step]
            jb = jax.device_put({k: jnp.asarray(v, jnp.int32)
                                 for k, v in b.items()},
                                session.setup.batch_shardings)
            session.state, loss = session.setup.train_step(session.state, jb)
            jlosses.append(float(loss))
        if resize:
            session.resize(resize[0], devices=jax.devices()[:resize[0]],
                           plan=resize[1])
    records = _rank0(stories, "parity")
    losses = [x for r in records if "losses" in r for x in r["losses"]]
    assert [r["chips"] for r in records if "chips" in r] == [4, 1]
    assert [r["plan"]["tp"] for r in records if "plan" in r] == [2, 1]
    assert len(losses) == len(jlosses) == 8
    for i, (got, want) in enumerate(zip(losses, jlosses)):
        assert_close(f"2 -> 4 -> 1 loss step {i}", got, want, atol=0,
                     rtol=1e-4)
    ref = bridge.flax_to_state_dict(jax.tree.map(np.asarray,
                                                 session.state["params"]))
    state = records[-1]
    for key, want in ref.items():
        assert_close(f"2 -> 4 -> 1 params {key}", state[f"model/{key}"],
                     want, atol=1e-4, rtol=0)
    # the ranks beyond each mesh hold no model and take no step, and a
    # rank taken back holds the state
    for rank in (1, 2, 3):
        rec = stories["ranks"][rank]["parity"]
        assert [r["active"] for r in rec if "active" in r] == [True, False]
        assert [len(r["losses"]) for r in rec if "losses" in r] == [
            3 if rank == 1 else 0, 3, 0]
        assert rec[-1] == {}


def _states(records):
    return [r for r in records
            if not {"losses", "chips", "error"} & set(r)]


@pytest.mark.parametrize("trip", sorted(TRIPS))
def test_round_trips_are_bitwise(stories, trip):
    records = _rank0(stories, f"trip_{trip}")
    before, _, grown, back = _states(records)  # _: after the refusals
    _bitwise(grown, before, f"{trip}: 2 -> 4")
    _bitwise(back, before, f"{trip}: 4 -> 2")
    assert any(k.endswith("/exp_avg_sq") for k in before)
    at2, at4 = TRIPS[trip]
    ones = dict.fromkeys(("dp", "fsdp", "tp", "sp", "ep", "pp"), 1)
    assert [r["plan"] for r in records if "plan" in r] == [
        {**ones, **at4}, {**ones, **at2}]
    straight = _rank0(stories, f"straight_{trip}")[0]["losses"]
    assert records[-1]["losses"] == straight[2:], trip
    # a rank new to the 4-rank mesh held the state whole there
    _bitwise(_states(stories["ranks"][3][f"trip_{trip}"])[2], before,
             f"{trip}: rank 3 at 4")


def test_adafactor_across_a_resize_equals_one_device(stories):
    records = _rank0(stories, "adafactor")
    one = stories["one_af"]
    losses = [x for r in records if "losses" in r for x in r["losses"]]
    for i, (got, want) in enumerate(zip(losses, one["losses"])):
        assert_close(f"adafactor 2 -> 4 loss step {i}", got, want, atol=0,
                     rtol=1e-6)
    assert len(losses) == 3
    state = records[-1]
    assert any(k.endswith("/v_row") for k in state)
    for key, want in one["after"].items():
        assert_close(f"adafactor 2 -> 4 params {key}", state[f"model/{key}"],
                     want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("trip", sorted(TRIPS))
def test_refused_resizes_leave_the_session_training(stories, trip):
    """Each refusal raises on every rank before anything moves: the state
    is as before, and the round trip that follows ends on the
    uninterrupted run's step (test_round_trips_are_bitwise)."""
    for rank, records in enumerate(stories["ranks"]):
        records = records[f"trip_{trip}"]
        errors = [r for r in records if "error" in r]
        assert [e["error"] for e in errors] == ["ValueError"] * 2, rank
        assert "does not divide over 3 data ranks" in errors[0]["message"]
        assert ("the job holds 4 ranks" in errors[1]["message"]
                and "checkpoint-restart" in errors[1]["message"])
        if rank < 2:
            before, refused = _states(records)[:2]
            _bitwise(refused, before, f"{trip}: refused, rank {rank}")


def test_ranks_beyond_the_mesh_leave_on_cuda_and_wait_on_the_cpu():
    assert tsup.leaves_at_resize(torch.device("cuda", 0))
    assert not tsup.leaves_at_resize(torch.device("cpu"))


# ---- the supervisor --------------------------------------------------------

# Slows every step of a rank process so that the test acts between chunks;
# `force_leave` forces the CUDA rule for ranks beyond the mesh (a rank runs
# the supervisor as __main__).
SLOW_SCRIPT = '''
import os
import sys
import time
from vodascheduler_tpu_torch.models import get_model as _get

if {force_leave}:
    sys.modules["__main__"].leaves_at_resize = lambda device: True


def get_model(spec):
    bundle = _get(spec.model)
    loss_fn = bundle.loss_fn

    def slow_loss(module, batch):
        if os.environ.get("VODA_RANK"):  # not the one-device restart
            time.sleep({delay})
        return loss_fn(module, batch)

    bundle.loss_fn = slow_loss
    return bundle
'''


def _spec(root, name, steps, force_leave=False, delay=0.1,
          model="llama_tiny"):
    script = os.path.join(str(root), f"{name}.py")
    with open(script, "w") as f:
        f.write(SLOW_SCRIPT.format(force_leave=force_leave, delay=delay))
    return JobSpec(name=name, model=model, global_batch_size=BATCH,
                   steps_per_epoch=steps,
                   config=JobConfig(epochs=1, max_num_chips=4),
                   extra={"script": script})


def _wait(cond, what, log_path, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            text = open(log_path).read() if os.path.exists(log_path) else ""
            raise AssertionError(f"timed out waiting for {what}:\n"
                                 f"{text[-3000:]}")
        time.sleep(0.05)


@pytest.fixture
def supervisor_env(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", REPO)
    for name in ("VODA_TRACE_DIR", "VODA_FORCE_CPU_DEVICES",
                 "VODA_FLASH_ATTENTION", "VODA_PROFILE",
                 "VODA_COORDINATOR_ADDRESS", "VODA_NUM_PROCESSES"):
        monkeypatch.delenv(name, raising=False)


@pytest.mark.parametrize("model", ["llama_tiny", "mixtral_tiny"])
def test_local_backend_resizes_a_running_job_in_place(tmp_path,
                                                      supervisor_env, model):
    """One epoch spans the job, so that its only scheduled save is the
    last: any checkpoint seen at an ack would be the resize's own. The MoE
    job moves its experts from ep2 to ep4 and back to one rank."""
    backend = LocalBackend(str(tmp_path), hermetic_devices=4,
                           stop_grace_seconds=60.0)
    try:
        events = []
        backend.set_event_callback(events.append)
        backend.start_job(_spec(tmp_path, "live", 120, model=model),
                          num_workers=2)
        pid = backend._procs["live"].popen.pid
        ckpt_dir = str(tmp_path / "live" / "ckpt")
        log_path = str(tmp_path / "live" / "supervisor.log")
        _wait(lambda: os.path.exists(log_path)
              and "warmup step" in open(log_path).read(),
              "the warmup step", log_path)
        for old, new in ((2, 4), (4, 1)):
            assert backend.scale_job("live", new) is ResizePath.INPLACE
            assert backend._procs["live"].popen.pid == pid
            assert backend.running_jobs()["live"].num_workers == new
            assert list_steps(ckpt_dir) == []
            assert f"resized in-place {old} -> {new} chips" in open(
                log_path).read()
        # A re-placement is a checkpoint-restart at the job's size: the
        # live rank saves, and the job resumes on one chip.
        backend.migrate_workers("live", [("localhost", 1)])
        saved = list_steps(ckpt_dir)
        assert len(saved) == 1 and 0 < saved[0] < 120
        _wait(lambda: any(e.kind == ClusterEventKind.JOB_COMPLETED
                          for e in events), "the job's completion", log_path)
        text = open(log_path).read()
        assert f"resumed at step {saved[0]} on 1 chips" in text
        assert "agent 0 of 1: ranks 0..3 of 4 on cpu" in text
        rows = read_epoch_csv(os.path.join(backend.metrics_dir, "live.csv"))
        assert [r["workers"] for r in rows] == ["1"]
        assert list_steps(ckpt_dir)[-1] == 120
    finally:
        backend.close()


def _output(workdir, name):
    with open(os.path.join(workdir, name)) as f:
        return f.read()


def test_ranks_that_leave_the_job_and_its_survivor(tmp_path,
                                                   supervisor_env):
    """Two CPU ranks with the CUDA rule: a resize to 1 is acked in place
    and rank 1 leaves (LEFT_EXIT_CODE); the survivor trains on, nacks a
    resize back to 2 (the job holds one rank now), checkpoints on SIGTERM
    from its own group, and the agent exits with its code."""
    workdir = tmp_path / "leave"
    workdir.mkdir()
    spec = _spec(tmp_path, "leave", 400, force_leave=True)
    (workdir / "spec.json").write_text(json.dumps(spec.to_dict()))
    env = dict(os.environ, VODA_FORCE_CPU_DEVICES="2")
    with open(workdir / "out.log", "w") as out, \
            open(workdir / "err.log", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "vodascheduler_tpu_torch.runtime."
             "supervisor", "--workdir", str(workdir), "--num-chips", "2"],
            stdout=out, stderr=err, env=env, cwd=str(workdir))
    log_path = str(workdir / "out.log")
    try:
        _wait(lambda: "warmup step" in _output(workdir, "out.log"),
              "the warmup step", log_path)
        seq = tsup.request_resize(str(workdir), 1)
        _wait(lambda: tsup.read_resize_ack(str(workdir), seq),
              "the ack of a resize to 1", log_path)
        ack = tsup.read_resize_ack(str(workdir), seq)
        assert ack["ok"] and ack["path"] == "inplace" and ack["num_chips"] == 1
        seq = tsup.request_resize(str(workdir), 2)
        _wait(lambda: tsup.read_resize_ack(str(workdir), seq),
              "the ack of a resize to 2", log_path)
        ack = tsup.read_resize_ack(str(workdir), seq)
        assert not ack["ok"] and ack["path"] == "restart_required"
        assert "(1 devices held" in ack["reason"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=WAIT) == PREEMPTED_EXIT_CODE
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = _output(workdir, "out.log")
    assert "supervisor: rank 1 leaves the job at 1 chips" in out
    assert "resized in-place 2 -> 1 chips" in out
    assert "the ranks exited" not in _output(workdir, "err.log")
    saved = list_steps(str(workdir / "ckpt"))
    assert saved and f"checkpoint step {saved[-1]} bytes" in out
