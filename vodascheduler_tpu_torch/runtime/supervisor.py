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

It runs on CUDA. ``VODA_FORCE_CPU_DEVICES=N`` asks for N CPU devices (the
tests do); with neither, it exits non-zero.

One device and no coordinator: the supervisor trains in its own process;
such a job grows only through a restart (the reference's one process
holds every chip of its host and resizes within them). Otherwise it is its
host's agent (the backend's contract is unchanged: one supervisor per
host): it spawns one rank process per device it holds, each with one
device. The agents meet in a TCPStore at the coordinator's address (agent
``VODA_PROCESS_ID`` 0 serves it; without a coordinator the agent takes a
free port): each publishes its local count, and its ranks' global ranks
start at the sum of the counts before it. The ranks form one process group
(NCCL on CUDA, gloo on the CPU; no fallback between them) over that store,
and the job's mesh (`TrainSession`, runtime/train.py) covers its first
``--num-chips`` ranks. The agent forwards SIGTERM and SIGINT to its ranks.

At each chunk boundary the job's live ranks take one all-reduce (MAX): the
stop flag of any rank, the resize that rank 0 read from the channel and
let through its gate, and whether training is done, so that every rank
acts at the same boundary. On a stop the mesh's ranks checkpoint together
and every rank exits PREEMPTED_EXIT_CODE. A resize runs in place (the
reference's in-place arm) when the job has one agent and the target lies
between 1 and the job's live ranks: every rank rebuilds and the live state
moves rank to rank (`TrainSession.resize`), the first step runs at the new
size, and rank 0 acks. A rank beyond the new mesh leaves the job on CUDA,
exiting LEFT_EXIT_CODE so that the backend can hand its card to another
job, and waits on the CPU, where a later grow takes it back
(`leaves_at_resize`); once ranks have left, a resize to another size
fails its set-up (a new mesh is built by every rank of the process group).
Anything else is nacked ``restart_required``, and a restart with reshard
serves it. Rank 0 alone writes the CSV rows, the spans
and the control channel's acks. The agent exits with the code of the ranks
that stayed, or with the first failure's, its message the last line on
stderr.

Exit codes: 0 = training complete; PREEMPTED_EXIT_CODE = checkpointed and
exited on request; 2 = fewer devices than asked for; LEFT_EXIT_CODE (a
rank's only) = left the job at a resize; anything else = failure.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
from typing import List, Optional, Tuple

import torch

from vodascheduler_tpu_torch.common.types import PREEMPTED_EXIT_CODE
from vodascheduler_tpu_torch.obs import tracer as obs_tracer

# Chunk size between stop-flag checks: small enough that SIGTERM turns into
# a checkpoint promptly, big enough to amortise the checks.
STEPS_PER_CHUNK = 10

# The exit code of a rank that left the job at a resize (`leaves_at_resize`):
# its agent exits with the other ranks' code.
LEFT_EXIT_CODE = 4

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


def _local_devices() -> Tuple[str, List[str]]:
    """(device type, this host's devices): the CPU devices asked for with
    VODA_FORCE_CPU_DEVICES, else the visible CUDA cards (as
    CUDA_VISIBLE_DEVICES names them)."""
    forced = os.environ.get("VODA_FORCE_CPU_DEVICES")
    if forced:
        return "cpu", [str(i) for i in range(int(forced))]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "supervisor: no CUDA device is visible and VODA_FORCE_CPU_DEVICES "
            "is unset; set VODA_FORCE_CPU_DEVICES=1 to train on the CPU")
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    names = ([c.strip() for c in visible.split(",") if c.strip()]
             if visible else [])
    count = torch.cuda.device_count()
    return "cuda", (names[:count] if len(names) >= count
                    else [str(i) for i in range(count)])


def _devices() -> Tuple[torch.device, int]:
    """(device to train on, devices visible to this process)."""
    kind, local = _local_devices()
    if kind == "cpu":
        return torch.device("cpu"), len(local)
    return torch.device("cuda", 0), len(local)


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
    its epoch budget completes, checkpointing every epoch: in this process
    on one device with no coordinator, else as the host's agent of rank
    processes (module docstring)."""
    if os.environ.get(_RANK_ENV) is not None:
        return _run_rank(workdir, num_chips, metrics_dir)
    if num_chips == 1 and not os.environ.get("VODA_COORDINATOR_ADDRESS"):
        return _train(workdir, num_chips, metrics_dir)
    return _run_agent(workdir, num_chips, metrics_dir)


def _train(workdir: str, num_chips: int, metrics_dir: Optional[str],
           rank: Optional[int] = None,
           ranks_left: Optional[dict] = None) -> int:
    """The training loop: one device (`rank` None), or one rank of the
    job's process group; `ranks_left["any"]` is set when ranks of the group
    leave the job (`_settle`)."""
    # The control channel must exist before any slow start-up: its
    # constructor marks the commands that predate this process, and one
    # landing during start-up must be seen as fresh.
    control = ControlChannel(workdir)
    lead = rank in (None, 0)
    device, visible = _devices()  # a rank's: its one device
    if rank is None and visible < num_chips:
        print(f"supervisor: need {num_chips} devices, have {visible}",
              file=sys.stderr)
        return 2

    from vodascheduler_tpu_torch.metricscollector.csv_logger import (
        EpochCsvLogger,
    )
    from vodascheduler_tpu_torch.runtime.checkpoint import latest_step
    from vodascheduler_tpu_torch.runtime.train import (
        ResizeStateInvalid,
        TrainSession,
    )

    spec = _read_spec(workdir)
    ckpt_dir = os.path.join(workdir, "ckpt")
    metrics_dir = metrics_dir or os.path.join(workdir, "metrics")
    bundle = load_bundle(spec)
    topology = _topology()

    stop_requested = {"flag": False}

    def on_sigterm(signum, frame):
        stop_requested["flag"] = True

    signal.signal(signal.SIGTERM, on_sigterm)
    signal.signal(signal.SIGINT, on_sigterm)

    session = TrainSession(bundle, num_chips, device=device,
                           global_batch_size=spec.global_batch_size,
                           topology=topology)
    if _settle(session, device, ranks_left):  # more ranks than chips
        return LEFT_EXIT_CODE
    resumed = (session.active
               and latest_step(ckpt_dir, session.ckpt_group) is not None)
    if resumed:
        t0 = time.monotonic()
        session.restore(ckpt_dir)
        restore_s = time.monotonic() - t0
    if lead and session.mesh is not None:
        # Greppable evidence of the sharded path: the backend, the plan
        # and the parameters' types.
        kinds = sorted({type(p).__name__
                        for p in session.module.parameters()})
        print(f"distributed rank {rank} of {num_chips} backend "
              f"{torch.distributed.get_backend()} plan {session.plan} "
              f"params {'/'.join(kinds)}", flush=True)
    if resumed and lead:
        # The restart half of the checkpoint-restart resize contract:
        # greppable evidence that this incarnation resumed training.
        print(f"resumed at step {session.step} on {num_chips} chips",
              flush=True)
        print(f"restore took {restore_s:.3f} s", flush=True)

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
    if lead:
        tracer.start_span(
            "supervisor.start", component="supervisor", parent=trace_parent,
            attrs={"job": spec.name, "chips": num_chips, "resumed": resumed,
                   "step": session.step}).end()

    steps_per_epoch = max(1, spec.steps_per_epoch)
    total_steps = spec.config.epochs * steps_per_epoch
    logger = None
    if lead:
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
    # The agents that hold the job's ranks: the in-place resize runs
    # within one.
    agents = int(os.environ.get("VODA_NUM_PROCESSES") or 1)

    # The first step after a (re)start builds or loads the kernels and
    # warms the allocator. It must not enter the telemetry: the collector's
    # speedup curves are per-size epoch-time means. So one warmup step
    # runs untimed, and epoch time is extrapolated from the timed steps.
    # VODA_PROFILE=1 traces the first timed chunk with torch.profiler into
    # <workdir>/profile/.
    profile_pending = lead and os.environ.get("VODA_PROFILE") == "1"
    profile_dir = os.path.join(workdir, "profile")

    # The untimed step: a start's warmup, or the first at a new size.
    first_step = True
    resized = None  # (start, old size, request) of a resize to be acked
    warmup_step_time = 0.0
    last_loss = float("nan")
    epoch = None  # the current epoch's end and timed samples (mesh ranks)
    while True:
        if session.active and session.step < total_steps:
            if epoch is None:
                epoch = _Epoch(session.step, steps_per_epoch, total_steps)
            if first_step:
                first_step = False
                t0 = time.monotonic()
                try:
                    last_loss = session.run_steps(1)
                except Exception as e:  # noqa: BLE001
                    if resized is None:
                        raise
                    # The first step at the new size failed: nack and exit
                    # through the preemption protocol; the backend restores
                    # the last committed checkpoint.
                    if lead:
                        resized[2].ack(ok=False, path="restart_required",
                                       reason=f"{type(e).__name__}: "
                                              f"{str(e)[:300]}")
                    print(f"supervisor: first step after in-place resize "
                          f"to {num_chips} failed ({type(e).__name__}: "
                          f"{e}); exiting for checkpoint-restart",
                          file=sys.stderr)
                    return PREEMPTED_EXIT_CODE
                # It stays out of the epoch's samples; after a resize it
                # re-anchors the warmup fallback to the new size.
                warmup_step_time = time.monotonic() - t0
                if resized is None and lead:
                    print(f"warmup step {session.step} took "
                          f"{warmup_step_time:.3f} s", flush=True)
                elif lead:
                    # Acked after the first step at the new size, so that
                    # the ack means "training at the new size".
                    resize_ms = (time.monotonic() - resized[0]) * 1000.0
                    resized[2].ack(ok=True, path="inplace",
                                   num_chips=num_chips, step=session.step,
                                   resize_ms=round(resize_ms, 1))
                    # Greppable fast-path evidence (the counterpart of the
                    # cold path's "resumed at step" line).
                    print(f"resized in-place {resized[1]} -> {num_chips} "
                          f"chips at step {session.step} "
                          f"({resize_ms:.0f} ms)", flush=True)
                resized = None
            else:
                n = min(STEPS_PER_CHUNK, epoch.end - session.step)
                if profile_pending:
                    # The profiled chunk enters the telemetry only when it
                    # is the epoch's only post-warmup sample.
                    profile_pending = False
                    activities = [torch.profiler.ProfilerActivity.CPU]
                    if device.type == "cuda":
                        activities.append(
                            torch.profiler.ProfilerActivity.CUDA)
                    os.makedirs(profile_dir, exist_ok=True)
                    t0 = time.monotonic()
                    with torch.profiler.profile(
                            activities=activities) as prof:
                        last_loss = session.run_steps(n)
                    epoch.profiled_time += time.monotonic() - t0
                    epoch.profiled_steps += n
                    prof.export_chrome_trace(os.path.join(
                        profile_dir, f"trace_step{session.step}.json"))
                else:
                    t0 = time.monotonic()
                    last_loss = session.run_steps(n)
                    epoch.timed_time += time.monotonic() - t0
                    epoch.timed_steps += n
            if session.step == epoch.end:
                if lead:
                    step_time = epoch.step_time(warmup_step_time)
                    logger.log_epoch(epoch_time_sec=step_time * epoch.steps,
                                     step_time_sec=step_time,
                                     workers=num_chips,
                                     start_time=str(time.time()),
                                     spread=placement_spread,
                                     cotenancy=placement_cotenancy)
                    # Greppable per-epoch loss: it shows the loss
                    # continuing across a checkpoint restart. Not in the
                    # CSV, whose columns are the collector's contract.
                    print(f"epoch {(session.step - 1) // steps_per_epoch} "
                          f"loss {last_loss:.6f}", flush=True)
                # Async: the next epoch's steps overlap this save's write
                # (the device->host copy is synchronous inside save).
                session.save(ckpt_dir, wait=False)
                epoch = None

        # Rank 0 alone reads the channel and acks; the resize it lets
        # through its gate reaches every rank with the agreement below.
        request, target = None, 0
        cmd = control.poll() if lead else None
        if cmd is not None and cmd.get("op") == "resize":
            request = _ResizeRequest(cmd, spec.name, num_chips, control)
            refusal = _refusal(request.num_chips, session, agents)
            if refusal is not None:
                # A target beyond the job's ranks needs the
                # checkpoint-restart path: nack, and the backend falls
                # back (it SIGTERMs and respawns).
                request.ack(ok=False, path="restart_required",
                            reason=refusal)
            elif request.num_chips == num_chips:
                request.ack(ok=True, path="inplace", num_chips=num_chips,
                            step=session.step)
            else:
                target = request.num_chips
        stop, target, done = _agree(
            session, stop_requested["flag"], target,
            lead and session.step >= total_steps)
        if stop or done:
            if target and lead:
                request.ack(ok=False, path="restart_required",
                            reason="the job is stopping" if stop
                            else "the job has completed")
            if stop and session.active:
                # Durable before exit (save drains any in-flight epoch
                # write first, then waits for this one). Every rank of the
                # mesh saves: the save is collective.
                session.save(ckpt_dir, wait=True)
            session.finish_saves()
            if lead:
                _report(session)
            return PREEMPTED_EXIT_CODE if stop else 0
        if not target:
            continue
        t0 = time.monotonic()
        try:
            session.resize(target)
        except ResizeStateInvalid as e:
            # The ranks may stand at different points of the move: nack and
            # exit through the preemption protocol; the backend restores
            # the last committed checkpoint.
            if lead:
                request.ack(ok=False, path="restart_required",
                            reason=str(e)[:300])
                _report(session)
            print(f"supervisor: {e}; exiting for checkpoint-restart",
                  file=sys.stderr)
            return PREEMPTED_EXIT_CODE
        except Exception as e:  # noqa: BLE001
            # A set-up failure, the same on every rank, before anything
            # moved: nack so the backend takes the cold path, and keep
            # training at the old size until its SIGTERM.
            if lead:
                request.ack(ok=False, path="restart_required",
                            reason=f"{type(e).__name__}: {str(e)[:300]}")
                print(f"supervisor: in-place resize to {target} infeasible "
                      f"({type(e).__name__}: {e}); continuing at current "
                      "size", file=sys.stderr)
            continue
        resized, num_chips = (t0, num_chips, request), target
        if _settle(session, device, ranks_left):
            return LEFT_EXIT_CODE
        # A rank beyond the new mesh waits for a grow that takes it back.
        first_step = session.active
        if epoch is not None:
            # The epoch's timed steps ran at the old size; the row must
            # reflect the size it reports.
            epoch.reset()
        if not session.active:
            epoch = None


class _Epoch:
    """The current epoch as one incarnation's mesh rank sees it: the step
    it ends at, its steps from where this rank began it, and the timed
    samples of its step time."""

    def __init__(self, step: int, steps_per_epoch: int, total_steps: int):
        self.end = min(total_steps,
                       (step // steps_per_epoch + 1) * steps_per_epoch)
        self.steps = self.end - step
        self.reset()

    def reset(self) -> None:
        self.timed_steps = 0
        self.timed_time = 0.0
        self.profiled_steps = 0
        self.profiled_time = 0.0

    def step_time(self, warmup_step_time: float) -> float:
        """The timed steps' mean; without any, the profiled chunk (trace
        overhead included) beats the warmup step (start-up included)."""
        if self.timed_steps:
            return self.timed_time / self.timed_steps
        if self.profiled_steps:
            return self.profiled_time / self.profiled_steps
        return warmup_step_time


class _ResizeRequest:
    """A resize command rank 0 read, with its span (the cross-process leaf
    of the scheduler's resched trace, ended by the ack whichever arm takes
    it; it carries the device memory in use before and after)."""

    def __init__(self, cmd: dict, job: str, from_chips: int,
                 control: ControlChannel):
        from vodascheduler_tpu_torch.runtime.gpu_monitor import (
            hbm_in_use_bytes,
        )
        self.seq = int(cmd.get("seq", 0))
        self.num_chips = int(cmd.get("num_chips", 0))
        self._control = control
        self._hbm_in_use_bytes = hbm_in_use_bytes
        self.span = obs_tracer.get_tracer().start_span(
            "supervisor.resize", component="supervisor",
            parent=obs_tracer.TraceContext.from_dict(cmd.get("trace")),
            attrs={"job": job, "from_chips": from_chips,
                   "to_chips": self.num_chips, "seq": self.seq})
        mem_before = hbm_in_use_bytes()
        if mem_before is not None:
            self.span.set_attr("hbm_in_use_before_bytes", int(mem_before))

    def ack(self, **fields) -> None:
        mem_after = self._hbm_in_use_bytes()
        if mem_after is not None:
            self.span.set_attr("hbm_in_use_after_bytes", int(mem_after))
        for k, v in fields.items():
            self.span.set_attr(k, v)
        self.span.end()
        self._control.ack(self.seq, **fields)


def _refusal(new_n: int, session, agents: int) -> Optional[str]:
    """Why the in-place arm refuses a resize to `new_n`, or None (the
    reference's gate): the resize runs within the ranks of one agent's
    process group, 1 to its live ranks (one device without a process
    group: 1)."""
    if agents > 1:
        return (f"resize to {new_n} needs a process-group change (the "
                f"job's ranks span {agents} processes)")
    if not 0 < new_n <= session.ranks:
        return (f"resize to {new_n} needs a process-group change "
                f"({session.ranks} devices held across 1 processes)")
    return None


def leaves_at_resize(device: torch.device) -> bool:
    """Whether a rank beyond the job's mesh leaves the job, or waits for a
    grow that takes it back: a CUDA rank leaves, so that its card goes back
    to the backend (LocalBackend returns a shrink's cards to its free
    list); a CPU rank waits, since the backend still counts its device
    visible."""
    return device.type == "cuda"


def _settle(session, device: torch.device,
            ranks_left: Optional[dict]) -> bool:
    """After the mesh was built at a start or a resize, under a process
    group whose ranks beyond the mesh leave (`leaves_at_resize`): the
    mesh's ranks become the job's, `ranks_left["any"]` is set, and True on
    a rank that leaves."""
    if (session.plan is None or session.ranks == session.num_chips
            or not leaves_at_resize(device)):
        return False
    if ranks_left is not None:
        ranks_left["any"] = True
    leaving = not session.active
    session.leave_idle_ranks()
    if leaving:
        print(f"supervisor: rank {torch.distributed.get_rank()} leaves the "
              f"job at {session.num_chips} chips", flush=True)
    return leaving


def _read_spec(workdir: str):
    from vodascheduler_tpu_torch.common.job import JobSpec
    with open(os.path.join(workdir, "spec.json")) as f:
        return JobSpec.from_dict(json.load(f))


def _topology():
    """The pool topology the backend stamps (VODA_TOPOLOGY), for mesh
    planning; None without it."""
    raw = os.environ.get("VODA_TOPOLOGY")
    if not raw:
        return None
    from vodascheduler_tpu_torch.placement.topology import PoolTopology
    return PoolTopology.parse(raw)


def _agree(session, stop: bool, target: int,
           done: bool) -> Tuple[bool, int, bool]:
    """One agreement a chunk boundary, so that every rank of the job,
    waiting ranks too, acts at the same one: under a process group one
    all-reduce (MAX) over the job's live ranks of this rank's stop flag,
    the resize rank 0 let through its gate (0: none) and whether training
    is done (rank 0's reading)."""
    if session.plan is None:
        return stop, target, done
    t = torch.tensor([int(stop), target, int(done)], dtype=torch.int64,
                     device=session.device)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX,
                                 group=session.job_group)
    stop, target, done = t.tolist()
    return bool(stop), int(target), bool(done)


# ---- the host's agent and its ranks ----------------------------------------

# Set by the agent for each rank process it spawns.
_RANK_ENV = "VODA_RANK"
_WORLD_ENV = "VODA_WORLD_SIZE"
_STORE_ENV = "VODA_STORE_ADDRESS"
# The store's keys for the rendezvous and the process group.
_AGENT_KEY = "voda/agent/{}"
_PG_PREFIX = "voda/pg"
# How long a rendezvous or a collective may wait for a peer.
RENDEZVOUS_TIMEOUT_S = 300.0
# Seconds between a rank's failure and the kill of the agent's other ranks,
# which wait for it in a collective.
FAILURE_GRACE_S = 2.0


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _error_path(workdir: str, rank: int) -> str:
    return os.path.join(workdir, "ranks", f"rank_{rank}.error")


def _run_agent(workdir: str, num_chips: int,
               metrics_dir: Optional[str]) -> int:
    """Spawn this host's ranks, one device each, after the rendezvous that
    numbers them; forward signals; exit with their code."""
    import datetime
    import subprocess

    from torch.distributed import TCPStore

    from vodascheduler_tpu_torch.runtime.train import plan_for

    kind, local = _local_devices()
    coord = os.environ.get("VODA_COORDINATOR_ADDRESS")
    if coord:
        host, port = coord.rsplit(":", 1)
        nprocs = int(os.environ.get("VODA_NUM_PROCESSES", "1"))
        pid = int(os.environ.get("VODA_PROCESS_ID", "0"))
    else:
        host, port, nprocs, pid = "127.0.0.1", _free_port(), 1, 0
        if num_chips > len(local):
            print(f"supervisor: need {num_chips} devices, have "
                  f"{len(local)}", file=sys.stderr)
            return 2
    # One rank a device the agent holds; the job's mesh covers the first
    # num_chips of the ranks, and the others leave or wait (_settle).
    count = len(local)
    # Refuse a plan the port cannot run before any process group forms.
    spec = _read_spec(workdir)
    plan = plan_for(load_bundle(spec), num_chips, spec.global_batch_size,
                    topology=_topology())

    store = TCPStore(host, int(port), is_master=pid == 0,
                     wait_for_workers=False,
                     timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S))
    store.set(_AGENT_KEY.format(pid), str(count))
    counts = [int(store.get(_AGENT_KEY.format(i))) for i in range(nprocs)]
    world, first = sum(counts), sum(counts[:pid])
    if world < num_chips:
        print(f"supervisor: need {num_chips} devices, the job's hosts have "
              f"{world}", file=sys.stderr)
        return 2
    print(f"agent {pid} of {nprocs}: ranks {first}..{first + count - 1} of "
          f"{world} on {kind}, plan {plan}", flush=True)

    os.makedirs(os.path.join(workdir, "ranks"), exist_ok=True)
    procs = []
    pending = []  # signals that came before every rank had started

    def forward(signum, frame):
        pending.append(signum)
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    signal.signal(signal.SIGTERM, forward)
    signal.signal(signal.SIGINT, forward)
    for i in range(count):
        env = dict(os.environ)
        env.update({_RANK_ENV: str(first + i), _WORLD_ENV: str(world),
                    _STORE_ENV: f"{host}:{port}"})
        if kind == "cuda":
            env["CUDA_VISIBLE_DEVICES"] = local[i]
        else:
            env["VODA_FORCE_CPU_DEVICES"] = "1"
        try:
            os.unlink(_error_path(workdir, first + i))
        except OSError:
            pass
        cmd = [sys.executable, "-m", "vodascheduler_tpu_torch.runtime."
               "supervisor", "--workdir", workdir, "--num-chips",
               str(num_chips)]
        if metrics_dir:
            cmd += ["--metrics-dir", metrics_dir]
        procs.append(subprocess.Popen(cmd, env=env))

    for signum in pending:
        forward(signum, None)
    failed = None  # (rank, code) of the first failure
    failed_at = 0.0
    while True:
        codes = [p.poll() for p in procs]
        if failed is None:
            for i, c in enumerate(codes):
                if c not in (None, 0, PREEMPTED_EXIT_CODE, LEFT_EXIT_CODE):
                    failed, failed_at = (first + i, c), time.monotonic()
                    break
        if all(c is not None for c in codes):
            break
        if failed is not None and time.monotonic() - failed_at > \
                FAILURE_GRACE_S:
            # The other ranks wait for the failed one in a collective.
            for p in procs:
                if p.poll() is None:
                    p.kill()
        time.sleep(0.1)
    if failed is None:
        # The ranks that stayed in the job to its end (rank 0 always does).
        kept = {c for c in codes if c != LEFT_EXIT_CODE}
        if len(kept) == 1:
            return kept.pop()
        # Some completed and some checkpointed: the ranks disagreed.
        print(f"supervisor: the ranks exited {codes}", file=sys.stderr)
        return 1
    rank, code = failed
    try:
        with open(_error_path(workdir, rank)) as f:
            message = f.read().strip()
    except OSError:
        message = f"exit code {code}"
    print(f"supervisor: rank {rank} failed: {message}", file=sys.stderr)
    return code if code > 0 else 1


def _die_with_agent() -> None:
    """Have the kernel kill this rank when its agent dies (a SIGKILL after
    the backend's grace reaches the agent alone), so that no rank outlives
    it holding its device."""
    import ctypes
    pr_set_pdeathsig = 1  # <sys/prctl.h>
    try:
        ctypes.CDLL(None, use_errno=True).prctl(pr_set_pdeathsig,
                                                signal.SIGKILL)
    except (OSError, AttributeError):
        return
    if os.getppid() == 1:  # the agent died before the call
        os.kill(os.getpid(), signal.SIGKILL)


def _run_rank(workdir: str, num_chips: int,
              metrics_dir: Optional[str]) -> int:
    """One rank: join the job's process group over the agent's store,
    then train."""
    import datetime
    import traceback

    from torch.distributed import PrefixStore, TCPStore

    rank, world = int(os.environ[_RANK_ENV]), int(os.environ[_WORLD_ENV])
    host, port = os.environ[_STORE_ENV].rsplit(":", 1)
    timeout = datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S)
    _die_with_agent()
    try:
        kind, _ = _local_devices()
        store = PrefixStore(_PG_PREFIX, TCPStore(
            host, int(port), is_master=False, timeout=timeout))
        kwargs = {}
        if kind == "cuda":
            torch.cuda.set_device(0)
            kwargs["device_id"] = torch.device("cuda", 0)
        torch.distributed.init_process_group(
            "nccl" if kind == "cuda" else "gloo", store=store, rank=rank,
            world_size=world, timeout=timeout, **kwargs)
        ranks_left = {"any": False}
        try:
            return _train(workdir, num_chips, metrics_dir, rank=rank,
                          ranks_left=ranks_left)
        finally:
            # Once ranks have left, no rank destroys the process group:
            # on NCCL that waits for every rank of it.
            if not ranks_left["any"]:
                torch.distributed.destroy_process_group()
    except BaseException as e:
        if isinstance(e, SystemExit):
            raise
        traceback.print_exc()
        with open(_error_path(workdir, rank), "w") as f:
            f.write(f"{type(e).__name__}: {str(e)[:500]}")
        return 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--workdir", required=True)
    parser.add_argument("--num-chips", type=int, required=True)
    parser.add_argument("--metrics-dir", default=None)
    args = parser.parse_args(argv)
    return run_job(args.workdir, args.num_chips, metrics_dir=args.metrics_dir)


if __name__ == "__main__":
    sys.exit(main())
