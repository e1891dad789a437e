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

One device and no coordinator: the supervisor trains in its own process.
Otherwise it is its host's agent (the backend's contract is unchanged: one
supervisor per host): for ``--num-chips N`` it spawns one rank process per
local device (every local device under ``VODA_COORDINATOR_ADDRESS``, else
N), each with one device. The agents meet in a TCPStore at the
coordinator's address (agent ``VODA_PROCESS_ID`` 0 serves it; without a
coordinator the agent takes a free port): each publishes its local count,
and its ranks' global ranks start at the sum of the counts before it. The
ranks form a process group of N (NCCL on CUDA, gloo on the CPU; no
fallback between them) over that store and train one job over the mesh
of `TrainSession` (runtime/train.py). The agent forwards SIGTERM and
SIGINT to its ranks; the ranks agree on stopping with one all-reduce (MAX)
at each chunk boundary, checkpoint together and exit PREEMPTED_EXIT_CODE.
Rank 0 alone writes the CSV rows, the spans and the control channel's
acks, and nacks an in-place resize to another size (a restart with
reshard serves it). The agent exits with its ranks' code, or with the
first failure's, its message the last line on stderr.

Exit codes: 0 = training complete; PREEMPTED_EXIT_CODE = checkpointed and
exited on request; 2 = fewer devices than asked for; anything else =
failure.
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
           rank: Optional[int] = None) -> int:
    """The training loop: one device (`rank` None), or one rank of the
    job's process group."""
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
    from vodascheduler_tpu_torch.runtime.gpu_monitor import hbm_in_use_bytes
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
    resumed = latest_step(ckpt_dir, session.ckpt_group) is not None
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

    # The first step after a (re)start builds or loads the kernels and
    # warms the allocator. It must not enter the telemetry: the collector's
    # speedup curves are per-size epoch-time means. So one warmup step
    # runs untimed, and epoch time is extrapolated from the timed steps.
    # VODA_PROFILE=1 traces the first timed chunk with torch.profiler into
    # <workdir>/profile/.
    profile_pending = lead and os.environ.get("VODA_PROFILE") == "1"
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
            if lead:
                print(f"warmup step {session.step} took "
                      f"{warmup_step_time:.3f} s", flush=True)
        timed_steps = 0
        timed_time = 0.0
        profiled_steps = 0
        profiled_time = 0.0
        while session.step < epoch_end_step:
            if _agree_to_stop(stop_requested["flag"], session):
                # Durable before exit (save drains any in-flight epoch
                # write first, then waits for this one). Every rank saves:
                # the save is collective.
                session.save(ckpt_dir, wait=True)
                session.finish_saves()
                if lead:
                    _report(session)
                return PREEMPTED_EXIT_CODE
            # Rank 0 alone reads the channel and acks; the other ranks go
            # on to the same chunk, so the ranks stay in step.
            cmd = control.poll() if lead else None
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
                # visible devices, or any other size of a process group,
                # needs the checkpoint-restart path; nack and let the
                # backend fall back (it SIGTERMs and respawns).
                if session.mesh is not None and new_n != num_chips:
                    ack(seq, ok=False, path="restart_required",
                        reason=(f"resize to {new_n} needs a process-group "
                                f"change ({num_chips} ranks; an in-place "
                                "resize of a process group is ROADMAP A11)"))
                elif not 0 < new_n <= visible:
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
                if session.mesh is None:
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
        if lead:
            logger.log_epoch(epoch_time_sec=step_time * steps_this_epoch,
                             step_time_sec=step_time,
                             workers=num_chips,
                             start_time=str(time.time()),
                             spread=placement_spread,
                             cotenancy=placement_cotenancy)
            # Greppable per-epoch loss: it shows the loss continuing
            # across a checkpoint restart. Not in the CSV, whose columns
            # are the collector's contract.
            print(f"epoch {(session.step - 1) // steps_per_epoch} "
                  f"loss {last_loss:.6f}", flush=True)
        # Async: the next epoch's steps overlap this save's write (the
        # device->host copy is synchronous inside save).
        session.save(ckpt_dir, wait=False)

    session.finish_saves()
    if lead:
        _report(session)
    return 0


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


def _agree_to_stop(flag: bool, session) -> bool:
    """Whether to stop now: this process's flag, or under a process group
    the flag of any rank (one all-reduce MAX), so that every rank stops at
    the same chunk boundary and none waits in a collective alone."""
    if session.mesh is None:
        return flag
    t = torch.tensor([1 if flag else 0], dtype=torch.int32,
                     device=session.device)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
    return bool(t.item())


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
        count = len(local)
    else:
        host, port, nprocs, pid = "127.0.0.1", _free_port(), 1, 0
        count = num_chips
    if count > len(local):
        print(f"supervisor: need {count} devices, have {len(local)}",
              file=sys.stderr)
        return 2
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
    if world != num_chips:
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
                if c not in (None, 0, PREEMPTED_EXIT_CODE):
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
        if len(set(codes)) == 1:
            return codes[0]
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
        try:
            return _train(workdir, num_chips, metrics_dir, rank=rank)
        finally:
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
