"""Per-job worker supervisor: the process that trains.

    python -m vodascheduler_tpu_torch.runtime.supervisor --workdir W --num-chips 1

Counterpart of the JAX package's ``runtime/supervisor.py``, with the same
contract towards the backend that spawns it:

- it trains the job of ``<workdir>/spec.json`` to the end of its epoch
  budget, checkpoints every epoch under ``<workdir>/ckpt`` and writes one
  CSV row per epoch to ``<metrics_dir>/<job>.csv``;
- on SIGTERM (or SIGINT) it saves and exits with PREEMPTED_EXIT_CODE; the
  next incarnation resumes from the checkpoint and prints
  ``resumed at step N on C chips``;
- between step chunks it answers in-place resize commands on the file
  channel under ``<workdir>/control``.

It runs on CUDA. ``VODA_FORCE_CPU_DEVICES=1`` asks for the CPU (the tests
do); with neither, it exits non-zero. Multi-process and multi-device jobs
(``VODA_COORDINATOR_ADDRESS``, ``VODA_FORCE_CPU_DEVICES`` above 1) wait for
ROADMAP A10. Exit codes: 0 = training complete; PREEMPTED_EXIT_CODE =
checkpointed and exited on request; 2 = fewer devices than asked for;
anything else = failure.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
from typing import Optional, Tuple

import torch

from vodascheduler_tpu_torch.common.types import PREEMPTED_EXIT_CODE
from vodascheduler_tpu_torch.obs import tracer as obs_tracer

# Chunk size between stop-flag checks: small enough that SIGTERM turns into
# a checkpoint promptly, big enough to amortise the checks.
STEPS_PER_CHUNK = 10

# ---- control channel (backend <-> supervisor) ----------------------------
#
# A command file under <workdir>/control/ (atomic rename writes, increasing
# seq) polled between step chunks, and one ack file per command. Commands
# that predate this process are void, so a checkpoint-restart fallback never
# replays the in-place request it replaced. The files are the JAX package's
# byte for byte: either package's backend drives either supervisor.

CONTROL_DIRNAME = "control"
_CMD_FILE = "cmd.json"


def _atomic_write_json(path: str, payload: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def _read_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


class ControlChannel:
    """Supervisor side: poll for commands issued after this process
    started, and ack them."""

    def __init__(self, workdir: str):
        self.dir = os.path.join(workdir, CONTROL_DIRNAME)
        os.makedirs(self.dir, exist_ok=True)
        stale = _read_json(os.path.join(self.dir, _CMD_FILE))
        self._last_seq = int(stale.get("seq", 0)) if stale else 0

    def poll(self):
        """The newest not-yet-seen command, or None."""
        cmd = _read_json(os.path.join(self.dir, _CMD_FILE))
        if cmd and int(cmd.get("seq", 0)) > self._last_seq:
            self._last_seq = int(cmd["seq"])
            return cmd
        return None

    def ack(self, seq: int, **fields) -> None:
        seq = int(seq)
        _atomic_write_json(os.path.join(self.dir, f"ack_{seq}.json"),
                           {"seq": seq, **fields})
        # Prune superseded acks: the backend only reads the ack of the seq
        # it just issued.
        for name in os.listdir(self.dir):
            if name.startswith("ack_") and name.endswith(".json"):
                try:
                    if int(name[4:-5]) < seq:
                        os.unlink(os.path.join(self.dir, name))
                except (ValueError, OSError):
                    pass


def request_resize(workdir: str, num_chips: int,
                   trace: Optional[dict] = None) -> int:
    """Backend side: enqueue an in-place resize; returns the command seq
    to pass to read_resize_ack. `trace` ({trace_id, parent_span}) rides the
    command so the supervisor's resize span stitches into the scheduler's
    trace."""
    d = os.path.join(workdir, CONTROL_DIRNAME)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, _CMD_FILE)
    prev = _read_json(path)
    seq = (int(prev.get("seq", 0)) if prev else 0) + 1
    cmd = {"op": "resize", "num_chips": int(num_chips), "seq": seq}
    if trace:
        cmd["trace"] = dict(trace)
    _atomic_write_json(path, cmd)
    return seq


def read_resize_ack(workdir: str, seq: int):
    """Backend side: the ack for command `seq`, or None while pending."""
    return _read_json(os.path.join(workdir, CONTROL_DIRNAME,
                                   f"ack_{int(seq)}.json"))


def _devices() -> Tuple[torch.device, int]:
    """(device to train on, devices visible to this process)."""
    forced = os.environ.get("VODA_FORCE_CPU_DEVICES")
    if os.environ.get("VODA_COORDINATOR_ADDRESS") or (forced
                                                      and int(forced) > 1):
        raise NotImplementedError(
            "multi-process jobs (VODA_COORDINATOR_ADDRESS) and multi-device "
            "CPU jobs (VODA_FORCE_CPU_DEVICES above 1) need torch.distributed "
            "training, which is not ported yet (ROADMAP queue A, item 10)")
    if forced:
        return torch.device("cpu"), 1
    if not torch.cuda.is_available():
        raise RuntimeError(
            "supervisor: no CUDA device is visible and VODA_FORCE_CPU_DEVICES "
            "is unset; set VODA_FORCE_CPU_DEVICES=1 to train on the CPU")
    return torch.device("cuda", 0), torch.cuda.device_count()


def load_bundle(spec):
    """Resolve the job's ModelBundle: a user script, or the registry.

    `spec.extra["script"]` names a Python file defining `get_model(spec)`
    (or argless `get_model()`) returning a ModelBundle: users bring their
    own model, data and loss, the supervisor owns the elastic run loop
    around it."""
    script = spec.extra.get("script", "")
    if not script:
        from vodascheduler_tpu_torch.models import get_model
        return get_model(spec.model)

    import importlib.util
    import inspect

    path = _resolve_script(script)
    mod_name = "voda_user_script_" + os.path.splitext(os.path.basename(path))[0]
    spec_obj = importlib.util.spec_from_file_location(mod_name, path)
    if spec_obj is None or spec_obj.loader is None:
        raise FileNotFoundError(f"user script not loadable: {path}")
    module = importlib.util.module_from_spec(spec_obj)
    sys.modules[mod_name] = module
    spec_obj.loader.exec_module(module)
    get = getattr(module, "get_model", None)
    if get is None:
        raise AttributeError(f"user script {path} must define get_model()")
    if inspect.signature(get).parameters:
        return get(spec)
    return get()


def _resolve_script(script: str) -> str:
    """A relative script path is tried against the supervisor's cwd, then
    the repo root (the parent of the package)."""
    if os.path.isabs(script):
        return script
    candidates = [os.path.abspath(script)]
    import vodascheduler_tpu_torch
    pkg_parent = os.path.dirname(
        os.path.dirname(os.path.abspath(vodascheduler_tpu_torch.__file__)))
    candidates.append(os.path.join(pkg_parent, script))
    for c in candidates:
        if os.path.exists(c):
            return c
    raise FileNotFoundError(
        f"user script {script!r} not found (tried: {candidates})")


def _report(session) -> None:
    """Greppable evidence of what this incarnation ran: the kernels'
    launches and its latest committed checkpoint."""
    from vodascheduler_tpu_torch.ops import flash_attention as fa
    print(f"kernel launches {json.dumps(fa.launches)}", flush=True)
    if session.last_save is not None:
        step, nbytes, copy_s, write_s = session.last_save
        print(f"checkpoint step {step} bytes {nbytes} host_copy_s "
              f"{copy_s:.3f} write_s {write_s:.3f}", flush=True)


def run_job(workdir: str, num_chips: int,
            metrics_dir: Optional[str] = None) -> int:
    """Train the job described by `<workdir>/spec.json` at num_chips until
    its epoch budget completes, checkpointing every epoch."""
    # The control channel must exist before any slow start-up: its
    # constructor marks the commands that predate this process, and one
    # landing during start-up must be seen as fresh.
    control = ControlChannel(workdir)
    device, visible = _devices()
    if visible < num_chips:
        print(f"supervisor: need {num_chips} devices, have {visible}",
              file=sys.stderr)
        return 2

    from vodascheduler_tpu_torch.common.job import JobSpec
    from vodascheduler_tpu_torch.metricscollector.csv_logger import (
        EpochCsvLogger,
    )
    from vodascheduler_tpu_torch.runtime.checkpoint import latest_step
    from vodascheduler_tpu_torch.runtime.gpu_monitor import hbm_in_use_bytes
    from vodascheduler_tpu_torch.runtime.train import (
        ResizeStateInvalid,
        TrainSession,
    )

    with open(os.path.join(workdir, "spec.json")) as f:
        spec = JobSpec.from_dict(json.load(f))

    ckpt_dir = os.path.join(workdir, "ckpt")
    metrics_dir = metrics_dir or os.path.join(workdir, "metrics")
    bundle = load_bundle(spec)

    stop_requested = {"flag": False}

    def on_sigterm(signum, frame):
        stop_requested["flag"] = True

    signal.signal(signal.SIGTERM, on_sigterm)
    signal.signal(signal.SIGINT, on_sigterm)

    resumed = latest_step(ckpt_dir) is not None
    if resumed:
        session = TrainSession.resume(
            bundle, num_chips, ckpt_dir, device=device,
            global_batch_size=spec.global_batch_size)
        # The restart half of the checkpoint-restart resize contract:
        # greppable evidence that this incarnation resumed training.
        print(f"resumed at step {session.step} on {num_chips} chips",
              flush=True)
    else:
        session = TrainSession(bundle, num_chips, device=device,
                               global_batch_size=spec.global_batch_size)

    # Cross-process stitching: the backend stamped the scheduler's trace
    # context into the spec (or the environment); this span records the
    # incarnation's start under the trace that launched it.
    trace_parent = None
    raw_ctx = ((spec.extra or {}).get("trace_context", "")
               or os.environ.get("VODA_TRACE_CONTEXT", ""))
    if raw_ctx:
        try:
            trace_parent = obs_tracer.TraceContext.from_dict(
                json.loads(raw_ctx))
        except (ValueError, TypeError):
            trace_parent = None
    tracer = obs_tracer.get_tracer()
    tracer.start_span(
        "supervisor.start", component="supervisor", parent=trace_parent,
        attrs={"job": spec.name, "chips": num_chips, "resumed": resumed,
               "step": session.step}).end()

    steps_per_epoch = max(1, spec.steps_per_epoch)
    total_steps = spec.config.epochs * steps_per_epoch
    logger = EpochCsvLogger(metrics_dir, spec.name,
                            total_epochs=spec.config.epochs,
                            global_batch_size=spec.global_batch_size)
    # Trust the checkpoint for position; the CSV may lag a crash.
    logger.next_epoch = session.step // steps_per_epoch
    # Placement context the backend stamps per incarnation; every row of
    # this process carries it.
    placement_spread = float(os.environ.get("VODA_PLACEMENT_SPREAD") or 0.0)
    placement_cotenancy = float(os.environ.get("VODA_PLACEMENT_COTENANCY")
                                or 0.0)

    # The first step after a (re)start builds or loads the kernels and
    # warms the allocator. It must not enter the telemetry: the collector's
    # speedup curves are per-size epoch-time means. So one warmup step
    # runs untimed, and epoch time is extrapolated from the timed steps.
    # VODA_PROFILE=1 traces the first timed chunk with torch.profiler into
    # <workdir>/profile/.
    profile_pending = os.environ.get("VODA_PROFILE") == "1"
    profile_dir = os.path.join(workdir, "profile")

    warmup_pending = True
    warmup_step_time = 0.0
    last_loss = float("nan")
    while session.step < total_steps:
        epoch_end_step = min(total_steps,
                             (session.step // steps_per_epoch + 1)
                             * steps_per_epoch)
        steps_this_epoch = epoch_end_step - session.step
        if warmup_pending:
            t0 = time.monotonic()
            last_loss = session.run_steps(1)
            warmup_step_time = time.monotonic() - t0
            warmup_pending = False
            print(f"warmup step {session.step} took {warmup_step_time:.3f} s",
                  flush=True)
        timed_steps = 0
        timed_time = 0.0
        profiled_steps = 0
        profiled_time = 0.0
        while session.step < epoch_end_step:
            if stop_requested["flag"]:
                # Durable before exit (save drains any in-flight epoch
                # write first, then waits for this one).
                session.save(ckpt_dir, wait=True)
                session.finish_saves()
                _report(session)
                return PREEMPTED_EXIT_CODE
            cmd = control.poll()
            if cmd is not None and cmd.get("op") == "resize":
                seq = int(cmd.get("seq", 0))
                new_n = int(cmd.get("num_chips", 0))
                # The cross-process leaf of the scheduler's resched trace,
                # ended by the ack whichever arm takes it; it carries the
                # device memory in use before and after.
                rs = tracer.start_span(
                    "supervisor.resize", component="supervisor",
                    parent=obs_tracer.TraceContext.from_dict(
                        cmd.get("trace")),
                    attrs={"job": spec.name, "from_chips": num_chips,
                           "to_chips": new_n, "seq": seq})
                mem_before = hbm_in_use_bytes()
                if mem_before is not None:
                    rs.set_attr("hbm_in_use_before_bytes", int(mem_before))

                def ack(seq, _span=rs, **fields):
                    mem_after = hbm_in_use_bytes()
                    if mem_after is not None:
                        _span.set_attr("hbm_in_use_after_bytes",
                                       int(mem_after))
                    for k, v in fields.items():
                        _span.set_attr(k, v)
                    _span.end()
                    control.ack(seq, **fields)

                # The in-place gate: a target beyond this process's
                # visible devices needs the checkpoint-restart path; nack
                # and let the backend fall back (it SIGTERMs and respawns).
                if not 0 < new_n <= visible:
                    ack(seq, ok=False, path="restart_required",
                        reason=(f"resize to {new_n} needs a process-group "
                                f"change ({visible} devices visible across "
                                "1 processes)"))
                elif new_n == num_chips:
                    ack(seq, ok=True, path="inplace", num_chips=num_chips,
                        step=session.step)
                else:
                    try:
                        # On one card no other size succeeds
                        # (TrainSession.resize).
                        session.resize(new_n)
                    except ResizeStateInvalid as e:
                        # The live state may be gone: nack and exit
                        # through the preemption protocol; the backend
                        # restores the last committed checkpoint.
                        ack(seq, ok=False, path="restart_required",
                            reason=str(e)[:300])
                        print(f"supervisor: {e}; exiting for "
                              "checkpoint-restart", file=sys.stderr)
                        _report(session)
                        return PREEMPTED_EXIT_CODE
                    except Exception as e:  # noqa: BLE001
                        # A set-up failure: the session was never mutated.
                        # Nack so the backend takes the cold path, and keep
                        # training at the old size until its SIGTERM.
                        ack(seq, ok=False, path="restart_required",
                            reason=f"{type(e).__name__}: {str(e)[:300]}")
                        print(f"supervisor: in-place resize to {new_n} "
                              f"infeasible ({type(e).__name__}: {e}); "
                              "continuing at current size", file=sys.stderr)
                continue
            n = min(STEPS_PER_CHUNK, epoch_end_step - session.step)
            if profile_pending:
                # The profiled chunk enters the telemetry only when it is
                # the epoch's only post-warmup sample.
                profile_pending = False
                activities = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                os.makedirs(profile_dir, exist_ok=True)
                t0 = time.monotonic()
                with torch.profiler.profile(activities=activities) as prof:
                    last_loss = session.run_steps(n)
                profiled_time += time.monotonic() - t0
                profiled_steps += n
                prof.export_chrome_trace(os.path.join(
                    profile_dir, f"trace_step{session.step}.json"))
                continue
            t0 = time.monotonic()
            last_loss = session.run_steps(n)
            timed_time += time.monotonic() - t0
            timed_steps += n
        # Fallback order when an epoch has no cleanly timed steps: the
        # profiled chunk (trace overhead included) beats the warmup step
        # (start-up included).
        if timed_steps:
            step_time = timed_time / timed_steps
        elif profiled_steps:
            step_time = profiled_time / profiled_steps
        else:
            step_time = warmup_step_time
        logger.log_epoch(epoch_time_sec=step_time * steps_this_epoch,
                         step_time_sec=step_time,
                         workers=num_chips,
                         start_time=str(time.time()),
                         spread=placement_spread,
                         cotenancy=placement_cotenancy)
        # Greppable per-epoch loss: it shows the loss continuing across a
        # checkpoint restart. Not in the CSV, whose columns are the
        # collector's contract.
        print(f"epoch {(session.step - 1) // steps_per_epoch} "
              f"loss {last_loss:.6f}", flush=True)
        # Async: the next epoch's steps overlap this save's write (the
        # device->host copy is synchronous inside save).
        session.save(ckpt_dir, wait=False)

    session.finish_saves()
    _report(session)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--workdir", required=True)
    parser.add_argument("--num-chips", type=int, required=True)
    parser.add_argument("--metrics-dir", default=None)
    args = parser.parse_args(argv)
    return run_job(args.workdir, args.num_chips, metrics_dir=args.metrics_dir)


if __name__ == "__main__":
    sys.exit(main())
