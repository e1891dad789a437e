"""The port's job contract with the scheduler, on the CPU.

- Wire compatibility with the JAX package: a spec it writes reads back
  field for field; its EpochCsvLogger and the port's write byte-identical
  files for the same calls, and its readers read the port's file; its
  `request_resize` reaches the port's ControlChannel and the port's ack
  reaches its `read_resize_ack`; the port's span records carry its keys
  and stitch to its TraceContext.
- The session's switches: VODA_FLASH_ATTENTION, and the one-device
  resize: `resize(1)` rebuilds on the device with the state bitwise, and
  any other size raises.
- The supervisor as a subprocess (VODA_FORCE_CPU_DEVICES=1, llama_tiny, 2
  steps per epoch, 3 epochs): an uninterrupted run that answers a resize
  to 1 in place and nacks one to 2 while it trains on, and a run stopped by
  SIGTERM (exit 3) and restarted (`resumed at step`, exit 0) whose epoch
  losses equal the uninterrupted run's; 3 CSV rows each. Without CUDA and
  without the CPU request it exits non-zero and says why.

Every subprocess and every wait has its own timeout.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import pytest

from vodascheduler_tpu.common import job as jax_job
from vodascheduler_tpu.metricscollector import csv_logger as jax_csv
from vodascheduler_tpu.obs import tracer as jax_tracer
from vodascheduler_tpu.runtime import supervisor as jax_sup
from vodascheduler_tpu_torch.common import job as tjob
from vodascheduler_tpu_torch.common.types import PREEMPTED_EXIT_CODE
from vodascheduler_tpu_torch.metricscollector import csv_logger as tcsv
from vodascheduler_tpu_torch.models.registry import get_model
from vodascheduler_tpu_torch.obs import tracer as ttracer
from vodascheduler_tpu_torch.runtime import supervisor as tsup
from vodascheduler_tpu_torch.runtime.train import TrainSession

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120


# ---- wire compatibility ---------------------------------------------------


def test_job_spec_written_by_the_jax_package_reads_back():
    spec = jax_job.JobSpec(
        name="llama-20261016-120000", pool="h100", model="llama_350m_af",
        config=jax_job.JobConfig(num_chips=1, min_num_chips=1,
                                 max_num_chips=4, epochs=3),
        priority=2, user="u", global_batch_size=8, steps_per_epoch=3,
        workdir="/w", collectives={"comms_fraction": 0.1},
        resource_class="whole_host",
        extra={"trace_context": '{"trace_id": "t", "parent_span": "s"}'})
    d = json.loads(json.dumps(spec.to_dict()))
    port = tjob.JobSpec.from_dict(d)
    assert port.to_dict() == spec.to_dict()
    assert [f.name for f in dataclasses.fields(port)] == [
        f.name for f in dataclasses.fields(spec)]
    assert port.config.max_num_chips == 4 and port.kind.value == "JAXJob"
    back = jax_job.JobSpec.from_dict(port.to_dict())
    assert back == spec
    assert tjob.JobSpec.from_dict({"name": "x"}).to_dict() == \
        jax_job.JobSpec.from_dict({"name": "x"}).to_dict()
    assert PREEMPTED_EXIT_CODE == 3


def _log(module, root, rows):
    logger = module.EpochCsvLogger(str(root), "job", total_epochs=3,
                                   global_batch_size=8)
    for r in rows:
        logger.log_epoch(**r)
    return (root / "job.csv").read_bytes()


ROWS = [dict(epoch_time_sec=3.25, step_time_sec=1.083333, workers=1,
             start_time="1792190060.5"),
        dict(epoch_time_sec=2.5, step_time_sec=0.8333333, workers=2,
             start_time="1792190063.0", spread=0.25, cotenancy=0.5)]


def test_epoch_csv_is_byte_identical(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    ref = _log(jax_csv, tmp_path / "jax", ROWS)
    got = _log(tcsv, tmp_path / "port", ROWS)
    assert got == ref
    path = str(tmp_path / "port" / "job.csv")
    assert jax_csv.read_epoch_csv(path) == tcsv.read_epoch_csv(path)
    assert jax_csv.resume_epoch(path) == tcsv.resume_epoch(path) == 2
    assert tcsv.FIELDS == jax_csv.FIELDS
    # a restart appends under the replayed epoch number
    assert _log(tcsv, tmp_path / "port", ROWS[:1]) == _log(
        jax_csv, tmp_path / "jax", ROWS[:1])


def test_old_header_migrates_as_the_reference_migrates_it(tmp_path):
    old = ("epoch,epoch_time_sec,step_time_sec,workers,global_batch_size,"
           "local_batch_size,start_time,total_epochs\n"
           "0,1.000000,0.500000,1,8,8,1.0,3\n")
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "job.csv").write_text(old)
    ref = _log(jax_csv, tmp_path / "jax", ROWS[1:])
    got = _log(tcsv, tmp_path / "port", ROWS[1:])
    assert got == ref and b"spread" in got


def test_control_channel_speaks_the_reference_wire(tmp_path):
    workdir = str(tmp_path)
    stale = jax_sup.request_resize(workdir, 4)
    channel = tsup.ControlChannel(workdir)
    assert channel.poll() is None  # predates this supervisor
    trace = {"trace_id": "t1", "parent_span": "s1"}
    seq = jax_sup.request_resize(workdir, 1, trace=trace)
    assert seq == stale + 1
    cmd = channel.poll()
    assert cmd == {"op": "resize", "num_chips": 1, "seq": seq,
                   "trace": trace}
    assert channel.poll() is None
    assert jax_sup.read_resize_ack(workdir, seq) is None
    channel.ack(seq, ok=True, path="inplace", num_chips=1, step=5)
    assert jax_sup.read_resize_ack(workdir, seq) == {
        "seq": seq, "ok": True, "path": "inplace", "num_chips": 1, "step": 5}
    # and the other way round
    seq2 = tsup.request_resize(workdir, 2)
    jax_channel = jax_sup.ControlChannel(workdir)
    seq3 = tsup.request_resize(workdir, 2)
    assert jax_channel.poll()["seq"] == seq3 == seq2 + 1
    jax_channel.ack(seq3, ok=False, path="restart_required", reason="r")
    assert tsup.read_resize_ack(workdir, seq3)["path"] == "restart_required"
    assert tsup.read_resize_ack(workdir, seq) is None  # pruned


def test_spans_carry_the_reference_keys_and_stitch(tmp_path):
    jt = jax_tracer.Tracer(trace_dir=str(tmp_path / "jax"))
    root = jt.start_span("resched", component="scheduler", new_trace=True)
    ctx = ttracer.TraceContext.from_dict(
        json.loads(json.dumps(root.context.to_dict())))
    tt = ttracer.Tracer(trace_dir=str(tmp_path / "port"))
    span = tt.start_span("supervisor.start", component="supervisor",
                         parent=ctx, attrs={"job": "j"})
    span.set_attr("step", 3)
    span.end()
    root.end()
    rec = json.loads((tmp_path / "port" / "trace.jsonl").read_text())
    ref = jt.records(kind="span")[0]
    assert rec.keys() == ref.keys()
    assert rec["trace_id"] == ref["trace_id"]
    assert rec["parent_span"] == ref["span_id"]
    assert rec["attrs"] == {"job": "j", "step": 3}
    assert ttracer.TraceContext.from_dict(None) is None
    assert ttracer.TraceContext.from_dict(ctx.to_dict()) == ctx
    assert jax_tracer.TraceContext.from_dict(span.context.to_dict()) \
        .span_id == span.span_id


# ---- session switches ------------------------------------------------------


def test_flash_attention_switch(monkeypatch):
    bundle = get_model("llama_tiny")
    monkeypatch.setenv("VODA_FLASH_ATTENTION", "1")
    with pytest.raises(RuntimeError, match="VODA_FLASH_ATTENTION=1"):
        TrainSession(bundle, device="cpu")
    for flag in ("0", "auto"):
        monkeypatch.setenv("VODA_FLASH_ATTENTION", flag)
        assert TrainSession(bundle, device="cpu").module.attn_fn is None
    monkeypatch.delenv("VODA_FLASH_ATTENTION")
    assert TrainSession(bundle, device="cpu").module.attn_fn is None


def test_one_card_resize():
    """Without a process group `resize(1)` rebuilds on the device: a new
    module and optimizer holding the same state bitwise, and the next step
    an uninterrupted run's, exactly; `resize(2)` raises before anything
    moves (a one-device job grows through a restart)."""
    from tests.torch_dist_workers import whole_state

    bundle = get_model("llama_tiny")
    straight = TrainSession(bundle, global_batch_size=2, device="cpu")
    want = [float(straight.train_step(straight.make_batch()))
            for _ in range(3)]
    session = TrainSession(bundle, global_batch_size=2, device="cpu")
    session.run_steps(2)
    before = whole_state(session)
    module, optimizer = session.module, session.optimizer
    assert session.resize(1) is session
    assert session.module is not module and session.optimizer is not optimizer
    assert session.num_chips == 1 and session.step == 2
    for what in ("1 -> 1", "refused 1 -> 2"):
        after = whole_state(session)
        assert set(after) == set(before) and any("exp_avg" in k
                                                 for k in after), what
        assert all(after[k].equal(v) for k, v in before.items()), what
        if what == "1 -> 1":
            with pytest.raises(ValueError, match="checkpoint-restart"):
                session.resize(2)
    assert session.num_chips == 1
    assert float(session.train_step(session.make_batch())) == want[2]


def test_memory_reading_is_none_without_cuda():
    from vodascheduler_tpu_torch.runtime.gpu_monitor import hbm_in_use_bytes
    assert hbm_in_use_bytes() is None


def test_device_requests_beyond_one_card(tmp_path, monkeypatch):
    """More chips than visible devices exit 2. VODA_FORCE_CPU_DEVICES=2
    forms two gloo ranks, and the coordinator's environment for one
    process one rank with a process group; each trains the job to its
    end, rank 0 writing the rows."""
    monkeypatch.setenv("VODA_FORCE_CPU_DEVICES", "1")
    assert tsup.run_job(str(tmp_path), 2) == 2
    two = _workdir(tmp_path, "two", delay=0)
    code, out, err = _finish(
        _start(two, {"VODA_FORCE_CPU_DEVICES": "2"}, num_chips=2), two)
    assert code == 0, err
    assert "distributed rank 0 of 2 backend gloo plan MeshPlan(dp=2" in out
    assert "params DTensor\n" in out
    assert len(_epoch_losses(out)) == 3
    assert [int(r["workers"]) for r in _csv_rows(two, "two")] == [2, 2, 2]
    one = _workdir(tmp_path, "one", delay=0)
    coordinator = {"VODA_COORDINATOR_ADDRESS": f"127.0.0.1:{_free_port()}",
                   "VODA_NUM_PROCESSES": "1", "VODA_PROCESS_ID": "0"}
    code, out, err = _finish(_start(one, coordinator), one)
    assert code == 0, err
    assert "distributed rank 0 of 1 backend gloo plan MeshPlan(dp=1" in out
    assert len(_epoch_losses(out)) == 3 and len(_csv_rows(one, "one")) == 3


FAILING_RANK_SCRIPT = '''
import os
from vodascheduler_tpu_torch.models import get_model as _get


def get_model(spec):
    if os.environ.get("VODA_RANK") == "1":
        raise RuntimeError("rank 1 cannot build its model")
    return _get(spec.model)
'''


def test_a_failed_rank_fails_the_agent_with_its_message(tmp_path):
    """A rank that fails ends its agent: the other rank, waiting for it in
    a collective, is killed, and the agent exits with the failure's code,
    its message the last line on stderr (the backend's failure detail)."""
    workdir = _workdir(tmp_path, "failing", delay=0)
    script = os.path.join(workdir, "failing.py")
    with open(script, "w") as f:
        f.write(FAILING_RANK_SCRIPT)
    spec = json.loads(_output(workdir, "spec.json"))
    spec["extra"]["script"] = script
    with open(os.path.join(workdir, "spec.json"), "w") as f:
        json.dump(spec, f)
    t0 = time.monotonic()
    code, out, err = _finish(
        _start(workdir, {"VODA_FORCE_CPU_DEVICES": "2"}, num_chips=2),
        workdir)
    assert code == 1
    assert err.strip().splitlines()[-1] == (
        "supervisor: rank 1 failed: RuntimeError: rank 1 cannot build its "
        "model")
    assert time.monotonic() - t0 < TIMEOUT


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---- the supervisor as a subprocess ----------------------------------------

# A user script that slows every step, so that a test can act between
# chunks; the numbers are llama_tiny's.
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


def _workdir(root, name, delay, trace=None):
    workdir = root / name
    workdir.mkdir()
    script = workdir / "slow.py"
    script.write_text(SLOW_SCRIPT.format(delay=delay))
    extra = {"script": str(script)}
    if trace:
        extra["trace_context"] = json.dumps(trace)
    spec = jax_job.JobSpec(name=name, model="llama_tiny", global_batch_size=2,
                           steps_per_epoch=2,
                           config=jax_job.JobConfig(epochs=3), extra=extra)
    (workdir / "spec.json").write_text(json.dumps(spec.to_dict()))
    return str(workdir)


def _start(workdir, env_extra=None, force_cpu=True, num_chips=1):
    """The supervisor in a subprocess, its stdout and stderr to files of
    the workdir (read back by `_output` and `_finish`)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("VODA_FORCE_CPU_DEVICES", "VODA_TRACE_DIR")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # Two threads: the job is tiny, and the test runs beside other workers.
    env["OMP_NUM_THREADS"] = "2"
    if force_cpu:
        env["VODA_FORCE_CPU_DEVICES"] = "1"
    env.update(env_extra or {})
    with open(os.path.join(workdir, "out.log"), "w") as out, \
            open(os.path.join(workdir, "err.log"), "w") as err:
        return subprocess.Popen(
            [sys.executable, "-m",
             "vodascheduler_tpu_torch.runtime.supervisor",
             "--workdir", workdir, "--num-chips", str(num_chips)],
            stdout=out, stderr=err, text=True, env=env, cwd=workdir)


def _output(workdir, name="out.log"):
    with open(os.path.join(workdir, name)) as f:
        return f.read()


def _wait_for(proc, cond, what):
    deadline = time.monotonic() + TIMEOUT
    while not cond():
        assert proc.poll() is None, f"the supervisor exited before {what}"
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.05)
    return cond()


def _finish(proc, workdir):
    proc.wait(timeout=TIMEOUT)
    return proc.returncode, _output(workdir), _output(workdir, "err.log")


def _epoch_losses(out):
    return [line for line in out.splitlines() if line.startswith("epoch ")]


def _csv_rows(workdir, name):
    return jax_csv.read_epoch_csv(os.path.join(workdir, "metrics",
                                               f"{name}.csv"))


def test_supervisor_resizes_in_place_and_is_stopped_and_resumed(tmp_path):
    trace = {"trace_id": "tr", "parent_span": "sp"}
    trace_dir = str(tmp_path / "trace")

    # The uninterrupted run, answering resize commands as it trains; a
    # command written before it started is void.
    straight = _workdir(tmp_path, "straight", delay=0.5, trace=trace)
    stale = jax_sup.request_resize(straight, 1)
    proc = _start(straight, {"VODA_TRACE_DIR": trace_dir})
    _wait_for(proc, lambda: "warmup step" in _output(straight),
              "the warmup step")
    seq1 = jax_sup.request_resize(straight, 1, trace=trace)
    ack1 = _wait_for(proc, lambda: jax_sup.read_resize_ack(straight, seq1),
                     "the ack of a resize to 1")
    seq2 = jax_sup.request_resize(straight, 2)
    ack2 = _wait_for(proc, lambda: jax_sup.read_resize_ack(straight, seq2),
                     "the ack of a resize to 2")
    rc, out, err = _finish(proc, straight)
    assert rc == 0, err
    assert ack1 == {"seq": seq1, "ok": True, "path": "inplace",
                    "num_chips": 1, "step": ack1["step"]}
    assert not ack2["ok"] and ack2["path"] == "restart_required"
    assert "2 needs a process-group change" in ack2["reason"]
    rows = _csv_rows(straight, "straight")
    assert [r["epoch"] for r in rows] == ["0", "1", "2"]
    assert all(r["workers"] == "1" and r["global_batch_size"] == "2"
               for r in rows)
    want = _epoch_losses(out)
    assert len(want) == 3
    spans = [json.loads(line) for line in
             open(os.path.join(trace_dir, "trace.jsonl"))]
    start = next(s for s in spans if s["name"] == "supervisor.start")
    assert (start["trace_id"], start["parent_span"]) == ("tr", "sp")
    resize = [s for s in spans if s["name"] == "supervisor.resize"]
    assert [(s["attrs"]["seq"], s["attrs"]["to_chips"]) for s in resize] == [
        (seq1, 1), (seq2, 2)] and seq1 == stale + 1
    assert resize[0]["trace_id"] == "tr" and resize[1]["attrs"]["ok"] is False

    # The same job stopped by SIGTERM after its first epoch, and restarted.
    stopped = _workdir(tmp_path, "stopped", delay=0.5)
    proc = _start(stopped)
    _wait_for(proc, lambda: os.path.exists(os.path.join(
        stopped, "ckpt", "step_0000000002")), "the epoch-0 checkpoint")
    proc.send_signal(signal.SIGTERM)
    rc, out1, err = _finish(proc, stopped)
    assert rc == PREEMPTED_EXIT_CODE, err
    saved = max(int(n[5:]) for n in os.listdir(os.path.join(stopped, "ckpt")))
    assert saved in (2, 4)
    assert f"checkpoint step {saved} bytes" in out1
    rc, out2, err = _finish(_start(stopped), stopped)
    assert rc == 0, err
    assert f"resumed at step {saved} on 1 chips" in out2
    assert _epoch_losses(out1 + out2) == want
    assert [r["epoch"] for r in _csv_rows(stopped, "stopped")] == [
        "0", "1", "2"]


def test_supervisor_profiles_one_chunk_and_stamps_placement(tmp_path):
    """VODA_PROFILE=1 traces the first chunk after the warmup step into
    <workdir>/profile/, and every CSV row carries the placement context
    the backend stamps into the environment."""
    workdir = _workdir(tmp_path, "profiled", delay=0)
    rc, out, err = _finish(_start(workdir, {
        "VODA_PROFILE": "1", "VODA_PLACEMENT_SPREAD": "0.25",
        "VODA_PLACEMENT_COTENANCY": "0.5"}), workdir)
    assert rc == 0, err
    traces = os.listdir(os.path.join(workdir, "profile"))
    assert traces == ["trace_step2.json"]
    with open(os.path.join(workdir, "profile", traces[0])) as f:
        assert json.load(f)["traceEvents"]
    rows = _csv_rows(workdir, "profiled")
    assert len(rows) == 3
    assert all((r["spread"], r["cotenancy"]) == ("0.2500", "0.5000")
               for r in rows)
    assert float(rows[0]["step_time_sec"]) > 0


def test_supervisor_without_cuda_or_cpu_request_says_why(tmp_path):
    workdir = _workdir(tmp_path, "nocuda", delay=0)
    rc, out, err = _finish(_start(workdir, {"CUDA_VISIBLE_DEVICES": ""},
                                  force_cpu=False), workdir)
    assert rc not in (0, PREEMPTED_EXIT_CODE)
    assert "no CUDA device" in err and "VODA_FORCE_CPU_DEVICES" in err
    assert not os.path.exists(os.path.join(workdir, "ckpt"))
