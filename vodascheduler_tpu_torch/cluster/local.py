"""LocalBackend: real training processes on this machine's GPUs.

Reference counterpart: the JAX package's ``cluster/local.py``, whose
behaviour this keeps: each job is a supervisor subprocess
(``python -m vodascheduler_tpu_torch.runtime.supervisor``, the same
arguments, its output in ``<workdir>/<job>/supervisor.log``). Resize is
two-tiered: scale_job first asks the RUNNING supervisor to resize in place
over its control channel (runtime/supervisor.py request_resize /
read_resize_ack) and falls back to the cold path — SIGTERM (the supervisor
checkpoints and exits with PREEMPTED_EXIT_CODE), then a fresh process at
the new count that resumes from the checkpoint — when the supervisor nacks,
dies or times out. A stop is SIGTERM, a grace period, then SIGKILL. A
monitor thread reports jobs that completed or failed on their own.

Where the card differs from the TPU host:

- devices are counted with ``torch.cuda.device_count()``, which creates no
  CUDA context: the control plane holds nothing on the card;
- the backend keeps a free list of card indices and gives each job its
  grant through ``CUDA_VISIBLE_DEVICES``. A job sees only its grant (the
  TPU backend shows every job all of the host's chips), so a grow beyond
  the grant always takes the cold path;
- ``VODA_TOPOLOGY`` is not set: the port's supervisor does not read it;
- a failed job's event carries the last line of its supervisor's log
  beside the exit code, e.g. why a grant above one card cannot train yet.

Hermetic mode is the reference's: ``hermetic_devices=N`` gives every job
``VODA_FORCE_CPU_DEVICES`` (tests, machines without a GPU), and the card
indices are not handed out.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from vodascheduler_tpu_torch.cluster.backend import (
    ClusterBackend,
    ClusterEvent,
    ClusterEventKind,
    JobHandle,
    ResizePath,
)
from vodascheduler_tpu_torch import config
from vodascheduler_tpu_torch.common.clock import Clock
from vodascheduler_tpu_torch.common.job import JobSpec
from vodascheduler_tpu_torch.common.types import PREEMPTED_EXIT_CODE
from vodascheduler_tpu_torch.cluster.backend import spec_dict_with_trace
from vodascheduler_tpu_torch.obs import tracer as obs_tracer
from vodascheduler_tpu_torch.runtime.supervisor import (
    read_resize_ack,
    request_resize,
)


class _Proc:
    def __init__(self, popen: subprocess.Popen, num_chips: int,
                 devices_visible: int, cards: Optional[List[int]]):
        self.popen = popen
        self.num_chips = num_chips
        # Devices this incarnation can see (its CPU device count, or its
        # grant of cards) — the in-place resize feasibility bound.
        self.devices_visible = devices_visible
        # Card indices of the grant (None in hermetic mode).
        self.cards = cards
        self.expected_stop = False


class LocalBackend(ClusterBackend):
    supports_inplace_resize = True

    def __init__(self, workdir: str, chips: Optional[int] = None,
                 hermetic_devices: Optional[int] = None,
                 metrics_dir: Optional[str] = None,
                 host_name: str = "localhost",
                 stop_grace_seconds: Optional[float] = None,
                 poll_interval_seconds: float = 0.2,
                 topology: Optional[object] = None,
                 clock: Optional[Clock] = None):
        self.workdir = os.path.abspath(workdir)
        # Event timestamps go through the injected Clock so a
        # VirtualClock harness sees virtual-time stamps. (Subprocess
        # pacing stays wall-clock: it waits on a real OS process.)
        self.clock = clock or Clock()
        self.metrics_dir = metrics_dir or os.path.join(self.workdir, "metrics")
        self.hermetic_devices = hermetic_devices
        self.host_name = host_name
        # Kept for the reference's constructor; the port's supervisor
        # plans no mesh, so it is not handed to the jobs.
        self.topology = topology
        self.stop_grace_seconds = config.stop_grace_seconds(
            stop_grace_seconds)
        self.poll_interval_seconds = poll_interval_seconds
        if chips is None:
            chips = hermetic_devices or self._detect_chips()
        self.chips = chips
        os.makedirs(self.workdir, exist_ok=True)
        os.makedirs(self.metrics_dir, exist_ok=True)
        self._procs: Dict[str, _Proc] = {}
        self._specs: Dict[str, JobSpec] = {}
        # Card indices no job holds, handed out lowest first.
        self._free_cards: List[int] = list(range(chips))
        # Guards the proc/spec tables and the free list; never held across
        # a spawn, a SIGTERM drain, or the in-place ack poll.
        self._lock = threading.Lock()
        # Jobs mid-spawn (Popen issued, not yet in _procs): duplicate-
        # start guard for the lock-free spawn stretch.
        self._starting: set = set()
        self._monitor: Optional[threading.Thread] = None
        self._closed = threading.Event()

    @staticmethod
    def _detect_chips() -> int:
        import torch
        return torch.cuda.device_count()

    # ---- ClusterBackend interface ----------------------------------------

    def list_hosts(self) -> Dict[str, int]:
        return {self.host_name: self.chips}

    def start_job(self, spec: JobSpec, num_workers: int,
                  placements: Optional[List[Tuple[str, int]]] = None) -> None:
        with obs_tracer.active_tracer().span(
                "backend.start", component="backend",
                attrs={"job": spec.name, "chips": num_workers}):
            with self._lock:
                if spec.name in self._procs or spec.name in self._starting:
                    raise RuntimeError(f"job {spec.name!r} already running")
                self._starting.add(spec.name)
                self._specs[spec.name] = spec
            try:
                proc = self._spawn(spec, num_workers)
                with self._lock:
                    self._procs[spec.name] = proc
            finally:
                with self._lock:
                    self._starting.discard(spec.name)
        self._ensure_monitor()

    def scale_job(self, name: str, num_workers: int,
                  placements: Optional[List[Tuple[str, int]]] = None
                  ) -> ResizePath:
        """Two-tier resize: in place when the running supervisor can take
        the new count on the devices it already sees, else checkpoint-
        restart at the new size. Blocks for the ack (bounded by
        VODA_INPLACE_RESIZE_TIMEOUT_SECONDS) as the reference does."""
        spec = self._specs.get(name)
        if spec is None:
            raise KeyError(f"unknown job {name!r}")
        with obs_tracer.active_tracer().span(
                "backend.scale", component="backend",
                attrs={"job": name, "chips": num_workers}) as sp:
            if self._try_inplace_resize(name, num_workers):
                sp.set_attr("path", "inplace")
                return ResizePath.INPLACE
            sp.set_attr("path", "restart")
            self._restart_at(name, spec, num_workers)
            return ResizePath.RESTART

    def _restart_at(self, name: str, spec: JobSpec, num_workers: int) -> None:
        """The cold path: checkpoint-stop, respawn at the new size."""
        self._stop_proc(name)
        proc = self._spawn(spec, num_workers)
        with self._lock:
            self._procs[name] = proc
        self._ensure_monitor()

    def stop_job(self, name: str) -> None:
        self._stop_proc(name)
        with self._lock:
            self._specs.pop(name, None)

    def migrate_workers(self, name: str,
                        placements: List[Tuple[str, int]]) -> None:
        # Single-host: a re-placement is a same-size checkpoint-restart
        # (not scale_job, which would ack a same-count resize in place).
        proc = self._procs.get(name)
        spec = self._specs.get(name)
        if proc is not None and spec is not None:
            self._restart_at(name, spec, proc.num_chips)

    def running_jobs(self) -> Dict[str, JobHandle]:
        with self._lock:
            return {
                name: JobHandle(name=name, num_workers=p.num_chips,
                                placements=[(self.host_name, p.num_chips)])
                for name, p in self._procs.items()
            }

    # ---- process management ----------------------------------------------

    def _job_dir(self, name: str) -> str:
        return os.path.join(self.workdir, name)

    def _take_cards(self, n: int) -> List[int]:
        with self._lock:
            if n > len(self._free_cards):
                raise RuntimeError(
                    f"grant of {n} cards, but only {len(self._free_cards)} "
                    f"of {self.chips} are free")
            cards = self._free_cards[:n]
            del self._free_cards[:n]
            return cards

    def _return_cards(self, cards: Optional[List[int]]) -> None:
        """Caller holds self._lock."""
        if cards:
            self._free_cards = sorted(self._free_cards + cards)

    def _spawn(self, spec: JobSpec, num_chips: int) -> _Proc:
        """Launch one supervisor process. Deliberately NOT under the
        table lock (the caller registers the returned _Proc): spawns of
        different jobs in one actuation wave overlap."""
        job_dir = self._job_dir(spec.name)
        os.makedirs(job_dir, exist_ok=True)
        with open(os.path.join(job_dir, "spec.json"), "w") as f:
            json.dump(spec_dict_with_trace(spec), f)
        env = dict(os.environ)
        # The supervisor's spans land in the same JSONL sink as the
        # control plane's; an explicit VODA_TRACE_DIR in the environment
        # wins.
        tracer = obs_tracer.current_tracer() or obs_tracer.get_tracer()
        if tracer.trace_dir and "VODA_TRACE_DIR" not in env:
            env["VODA_TRACE_DIR"] = tracer.trace_dir
        cards = None
        if self.hermetic_devices:
            # The CPU device count must cover the job's chip count,
            # whatever the configured floor is.
            env["VODA_FORCE_CPU_DEVICES"] = str(
                max(self.hermetic_devices, num_chips))
            devices_visible = max(self.hermetic_devices, num_chips)
        else:
            cards = self._take_cards(num_chips)
            env["CUDA_VISIBLE_DEVICES"] = ",".join(map(str, cards))
            devices_visible = num_chips
        # Placement context for the epoch CSV: a single-host backend is
        # contiguous by construction (spread 0); co-tenancy is the share
        # of this host's chips other jobs hold at spawn.
        with self._lock:
            foreign = sum(p.num_chips for other, p in self._procs.items()
                          if other != spec.name)
        env["VODA_PLACEMENT_SPREAD"] = "0.0"
        env["VODA_PLACEMENT_COTENANCY"] = (
            f"{min(1.0, foreign / self.chips):.4f}" if self.chips else "0.0")
        cmd = [sys.executable, "-m",
               "vodascheduler_tpu_torch.runtime.supervisor",
               "--workdir", job_dir, "--num-chips", str(num_chips),
               "--metrics-dir", self.metrics_dir]
        log_path = os.path.join(job_dir, "supervisor.log")
        try:
            with open(log_path, "a") as log_f:
                popen = subprocess.Popen(cmd, env=env, stdout=log_f,
                                         stderr=log_f,
                                         start_new_session=True)
        except BaseException:
            with self._lock:
                self._return_cards(cards)
            raise
        return _Proc(popen, num_chips, devices_visible, cards)

    def _try_inplace_resize(self, name: str, num_chips: int) -> bool:
        """Tier A: ask the running supervisor to resize in place. True on
        an acked resize; False (caller falls back to checkpoint-restart)
        when the target exceeds the process's visible devices, the
        supervisor nacks, dies, or the ack times out."""
        with self._lock:
            proc = self._procs.get(name)
        if (proc is None or proc.popen.poll() is not None
                or num_chips > proc.devices_visible):
            return False
        job_dir = self._job_dir(name)
        ctx = obs_tracer.current_context()
        seq = request_resize(job_dir, num_chips,
                             trace=ctx.to_dict() if ctx else None)
        deadline = (time.monotonic()
                    + config.INPLACE_RESIZE_TIMEOUT_SECONDS)
        while time.monotonic() < deadline:
            ack = read_resize_ack(job_dir, seq)
            if ack is not None:
                if ack.get("ok"):
                    with self._lock:
                        proc.num_chips = num_chips
                        if proc.cards is not None:
                            # A shrink hands the cards it left back; the
                            # process may still see them, so it can no
                            # longer grow in place.
                            self._return_cards(proc.cards[num_chips:])
                            del proc.cards[num_chips:]
                            proc.devices_visible = num_chips
                    return True
                return False
            if proc.popen.poll() is not None:
                return False  # died mid-request: cold path handles it
            # vodalint: ignore[clock-discipline] paces a REAL subprocess
            # ack poll (monotonic deadline)
            time.sleep(min(0.05, self.poll_interval_seconds))
        return False

    def _stop_proc(self, name: str) -> None:
        with self._lock:
            proc = self._procs.get(name)
            if proc is None:
                return
            proc.expected_stop = True
        if proc.popen.poll() is None:
            proc.popen.send_signal(signal.SIGTERM)
            try:
                proc.popen.wait(timeout=self.stop_grace_seconds)
            except subprocess.TimeoutExpired:
                proc.popen.kill()
                proc.popen.wait()
        with self._lock:
            self._procs.pop(name, None)
            self._return_cards(proc.cards)

    def _last_log_line(self, name: str) -> str:
        """The supervisor log's last non-empty line (its error, when it
        failed), at most 300 characters."""
        try:
            with open(os.path.join(self._job_dir(name), "supervisor.log"),
                      "rb") as f:
                f.seek(max(0, os.fstat(f.fileno()).st_size - 4096))
                lines = f.read().decode(errors="replace").splitlines()
        except OSError:
            return ""
        lines = [ln.strip() for ln in lines if ln.strip()]
        return lines[-1][:300] if lines else ""

    def _ensure_monitor(self) -> None:
        with self._lock:
            if self._monitor is None or not self._monitor.is_alive():
                self._monitor = threading.Thread(
                    target=self._monitor_loop,
                    name="voda-monitor-local", daemon=True)
                self._monitor.start()

    def _monitor_loop(self) -> None:
        while not self._closed.is_set():
            exited: List[Tuple[str, int]] = []
            with self._lock:
                for name, proc in list(self._procs.items()):
                    code = proc.popen.poll()
                    if code is None or proc.expected_stop:
                        continue
                    self._procs.pop(name)
                    self._specs.pop(name, None)
                    self._return_cards(proc.cards)
                    exited.append((name, code))
            for name, code in exited:
                if code == 0:
                    self.emit(ClusterEvent(ClusterEventKind.JOB_COMPLETED,
                                           name,
                                           timestamp=self.clock.now()))
                else:
                    # Includes a PREEMPTED exit the backend did not request
                    # (external SIGTERM): surface it rather than stranding
                    # a job the scheduler still believes is running.
                    detail = (f"preempted outside scheduler control "
                              f"(exit code {code})"
                              if code == PREEMPTED_EXIT_CODE
                              else f"exit code {code}")
                    last = self._last_log_line(name)
                    if last:
                        detail = f"{detail}: {last}"
                    self.emit(ClusterEvent(
                        ClusterEventKind.JOB_FAILED, name,
                        detail=detail, timestamp=self.clock.now()))
            with self._lock:
                # Idle-exit decided under the same lock that registers new
                # processes, so a job started after the poll above cannot be
                # orphaned.
                if not self._procs:
                    self._monitor = None
                    return
            # Interruptible pause: close() wakes the monitor immediately.
            self._closed.wait(self.poll_interval_seconds)

    def close(self) -> None:
        """Stop all jobs (checkpoints preserved) and the monitor."""
        self._closed.set()
        for name in list(self._procs):
            self._stop_proc(name)
