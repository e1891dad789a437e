"""MultiHostBackend: multi-process jobs with backend-issued coordinators.

Reference counterpart: the MPI-Operator's hostfile + discovery-script
machinery plus the scheduler's ConfigMap host-list sync
(pkg/scheduler/scheduler/scheduler.go:1074-1112 of the reference,
examples/yaml/tensorflow2/tensorflow2-keras-mnist-elastic.yaml:32-44) —
the part of the reference that tells each worker who its peers are.

TPU-native redesign (SURVEY.md §2.3): there is no hostfile and no SSH.
The backend issues a *coordinator address* per job launch and spawns one
supervisor process per placement entry with
`VODA_COORDINATOR_ADDRESS` / `VODA_NUM_PROCESSES` / `VODA_PROCESS_ID`
set; each supervisor calls `jax.distributed.initialize` with them and the
processes form one global GSPMD mesh over ICI/DCN. Process ids follow the
placement manager's host order, so `build_mesh`'s host-major device sort
puts the tp axis on intra-host chips.

Resize/migrate keep the restart-with-reshard contract: SIGTERM every
process (each checkpoints collectively and exits PREEMPTED), then launch
a fresh process set — with a *fresh coordinator port* — at the new
placements. Elastic scale on a TPU pod is exactly this restart; there is
no Horovod-style in-place ring rebuild to emulate.

On one machine this runs hermetically: each virtual host's supervisor is
its own OS process with its own N-device CPU platform
(VODA_FORCE_CPU_DEVICES), which exercises the real multi-controller JAX
path — coordinator handshake, cross-process collectives, distributed
orbax save/restore — without TPU hardware. A real pod deployment runs the
same supervisor command per physical host (see deploy/ and
cluster/gke.py); only the spawn transport differs.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from vodascheduler_tpu_torch import config
from vodascheduler_tpu_torch.cluster.backend import (
    ClusterBackend,
    ClusterEvent,
    ClusterEventKind,
    JobHandle,
    ResizePath,
    spec_dict_with_trace,
)
from vodascheduler_tpu_torch.common.clock import Clock
from vodascheduler_tpu_torch.common.job import JobSpec
from vodascheduler_tpu_torch.common.types import PREEMPTED_EXIT_CODE
from vodascheduler_tpu_torch.obs import tracer as obs_tracer


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _ProcSet:
    """The supervisor processes of one job launch (one per host)."""

    def __init__(self, procs: List[subprocess.Popen], num_chips: int,
                 placements: List[Tuple[str, int]]):
        self.procs = procs
        self.num_chips = num_chips
        self.placements = placements
        self.expected_stop = False


class MultiHostBackend(ClusterBackend):
    def __init__(self, workdir: str,
                 hosts: Optional[Dict[str, int]] = None,
                 num_hosts: int = 2, chips_per_host: int = 4,
                 metrics_dir: Optional[str] = None,
                 stop_grace_seconds: Optional[float] = None,
                 poll_interval_seconds: float = 0.2,
                 topology: Optional[object] = None,
                 clock: Optional[Clock] = None):
        self.workdir = os.path.abspath(workdir)
        # Event timestamps come from the injected Clock (vodalint
        # clock-discipline): a VirtualClock harness gets virtual stamps.
        self.clock = clock or Clock()
        self.metrics_dir = metrics_dir or os.path.join(self.workdir, "metrics")
        self.hosts = dict(hosts) if hosts is not None else {
            f"host-{i}": chips_per_host for i in range(num_hosts)}
        # Pool topology forwarded to supervisors as VODA_TOPOLOGY (mesh
        # planning keeps tp within this pool's host block).
        self.topology = topology
        self.stop_grace_seconds = config.stop_grace_seconds(
            stop_grace_seconds)
        self.poll_interval_seconds = poll_interval_seconds
        os.makedirs(self.workdir, exist_ok=True)
        os.makedirs(self.metrics_dir, exist_ok=True)
        self._jobs: Dict[str, _ProcSet] = {}
        self._specs: Dict[str, JobSpec] = {}
        # Guards the job/spec tables; never held across a spawn or the
        # SIGTERM drain, so one actuation wave's concurrent per-job
        # restarts overlap instead of serializing on the table.
        self._lock = threading.Lock()
        # Jobs mid-spawn (duplicate-start guard for the lock-free spawn).
        self._starting: set = set()
        self._monitor: Optional[threading.Thread] = None
        self._closed = threading.Event()

    # ---- ClusterBackend interface ----------------------------------------

    def list_hosts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.hosts)

    def start_job(self, spec: JobSpec, num_workers: int,
                  placements: Optional[List[Tuple[str, int]]] = None) -> None:
        with self._lock:
            if spec.name in self._jobs or spec.name in self._starting:
                raise RuntimeError(f"job {spec.name!r} already running")
            self._starting.add(spec.name)
            self._specs[spec.name] = spec
        try:
            pset = self._spawn(spec, num_workers, placements)
            with self._lock:
                self._jobs[spec.name] = pset
        finally:
            with self._lock:
                self._starting.discard(spec.name)
        self._ensure_monitor()

    def scale_job(self, name: str, num_workers: int,
                  placements: Optional[List[Tuple[str, int]]] = None
                  ) -> "ResizePath":
        """Restart the whole process set at the new size. The reference
        edits Worker.Replicas and lets Horovod re-form (scheduler.go:542);
        on TPU the new topology means new processes + resharded restore.
        Always the cold path: any multi-host resize changes
        jax.distributed membership, the case the Tier-A in-place reshard
        excludes by contract (doc/elastic-resize.md)."""
        spec = self._specs.get(name)
        if spec is None:
            raise KeyError(f"unknown job {name!r}")
        with obs_tracer.active_tracer().span(
                "backend.scale", component="backend",
                attrs={"job": name, "chips": num_workers, "path": "restart"}):
            self._stop_set(name)
            pset = self._spawn(spec, num_workers, placements)
            with self._lock:
                self._jobs[name] = pset
        self._ensure_monitor()
        return ResizePath.RESTART

    def stop_job(self, name: str) -> None:
        self._stop_set(name)
        with self._lock:
            self._specs.pop(name, None)

    def migrate_workers(self, name: str,
                        placements: List[Tuple[str, int]]) -> None:
        pset = self._jobs.get(name)
        if pset is not None:
            self.scale_job(name, pset.num_chips, placements)

    def running_jobs(self) -> Dict[str, JobHandle]:
        with self._lock:
            return {
                name: JobHandle(name=name, num_workers=p.num_chips,
                                placements=list(p.placements))
                for name, p in self._jobs.items()
            }

    # ---- host churn (spot-instance semantics, reference node informers) --

    def add_host(self, name: str, chips: int) -> None:
        with self._lock:
            self.hosts[name] = chips
        self.emit(ClusterEvent(ClusterEventKind.HOST_ADDED, name,
                               timestamp=self.clock.now()))

    def remove_host(self, name: str) -> None:
        """Remove a host; jobs with processes on it die like on a real
        preemption (the coordinator peers notice the lost process)."""
        with self._lock:
            self.hosts.pop(name, None)
            doomed = [j for j, p in self._jobs.items()
                      if any(h == name for h, _ in p.placements)]
        for j in doomed:
            self._stop_set(j)  # checkpointed stop; scheduler restarts it
        self.emit(ClusterEvent(ClusterEventKind.HOST_REMOVED, name,
                               timestamp=self.clock.now()))

    # ---- process management ----------------------------------------------

    def _job_dir(self, name: str) -> str:
        return os.path.join(self.workdir, name)

    def _default_placements(self, num_workers: int) -> List[Tuple[str, int]]:
        """Pack hosts in order until the chip demand is covered (the
        placement manager normally decides this; this is the fallback when
        the scheduler runs placement-free, like the reference's
        -placement=false mode)."""
        out: List[Tuple[str, int]] = []
        remaining = num_workers
        for host, chips in self.hosts.items():
            if remaining <= 0:
                break
            take = min(chips, remaining)
            out.append((host, take))
            remaining -= take
        if remaining > 0:
            raise RuntimeError(
                f"not enough chips: need {num_workers}, pool has "
                f"{sum(self.hosts.values())}")
        return out

    def _spawn(self, spec: JobSpec, num_chips: int,
               placements: Optional[List[Tuple[str, int]]]) -> _ProcSet:
        """Launch one process set. Runs WITHOUT the table lock (the
        caller registers the returned _ProcSet) so concurrent wave
        members' spawns overlap."""
        if placements is None or not placements:
            with self._lock:
                placements = self._default_placements(num_chips)
        total = sum(c for _, c in placements)
        if total != num_chips:
            raise ValueError(
                f"placements cover {total} chips, job wants {num_chips}")
        job_dir = self._job_dir(spec.name)
        os.makedirs(job_dir, exist_ok=True)
        with open(os.path.join(job_dir, "spec.json"), "w") as f:
            json.dump(spec_dict_with_trace(spec), f)
        port = _free_port()
        procs: List[subprocess.Popen] = []
        single = len(placements) == 1
        try:
            self._spawn_procs(spec, num_chips, placements, port, single,
                              job_dir, procs)
        except Exception:
            # Partial spawn (e.g. Popen resource exhaustion on the 2nd
            # host): already-started supervisors would keep training
            # untracked and hold their chips. Kill them, then surface
            # the failure — the scheduler reverts and retries.
            for p in procs:
                try:
                    p.kill()
                except Exception:  # noqa: BLE001 - best-effort
                    pass
            raise
        return _ProcSet(procs, num_chips, list(placements))

    def _placement_context(self, name: str,
                           placements: List[Tuple[str, int]]
                           ) -> Tuple[float, float]:
        """(spread, cotenancy) of this incarnation's placement — the
        CSV placement-context columns (doc/learned-models.md): the
        topology-normalized spread of its host set and the
        chip-weighted share of its hosts' chips held by OTHER jobs,
        mirroring the fake backend's physics definitions so real-mode
        and simulated rows feed the estimators identically."""
        spread = 0.0
        if self.topology is not None and placements:
            coord_of = {self.topology.host_name(c): c
                        for c in self.topology.host_coords()}
            coords = [coord_of[h] for h, n in placements
                      if n > 0 and h in coord_of]
            if coords:
                spread = self.topology.spread(coords)
        total = sum(n for _, n in placements if n > 0)
        cot = 0.0
        if total > 0:
            with self._lock:
                occupancy: Dict[str, int] = {}
                for other, pset in self._jobs.items():
                    if other == name:
                        continue
                    for h, n in pset.placements:
                        occupancy[h] = occupancy.get(h, 0) + n
            for h, n in placements:
                chips = self.hosts.get(h, 0)
                if n <= 0 or chips <= 0:
                    continue
                cot += (n / total) * min(1.0, occupancy.get(h, 0) / chips)
        return spread, cot

    def _spawn_procs(self, spec: JobSpec, num_chips: int,
                     placements: List[Tuple[str, int]], port: int,
                     single: bool, job_dir: str,
                     procs: List[subprocess.Popen]) -> None:
        spread, cotenancy = self._placement_context(spec.name, placements)
        for pid, (host, chips) in enumerate(placements):
            env = dict(os.environ)
            # Each process owns its host's chips as a local CPU platform;
            # jax.distributed joins them into the global mesh. A single-
            # entry placement needs no coordinator (plain local job).
            env["VODA_FORCE_CPU_DEVICES"] = str(chips)
            # Placement context for the epoch CSV (doc/learned-models.md):
            # rank 0's rows carry the incarnation's spread/co-tenancy.
            env["VODA_PLACEMENT_SPREAD"] = f"{spread:.4f}"
            env["VODA_PLACEMENT_COTENANCY"] = f"{cotenancy:.4f}"
            if self.topology is not None:
                env["VODA_TOPOLOGY"] = str(self.topology)
            if not single:
                env["VODA_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
                env["VODA_NUM_PROCESSES"] = str(len(placements))
                env["VODA_PROCESS_ID"] = str(pid)
            cmd = [sys.executable, "-m",
                   "vodascheduler_tpu_torch.runtime.supervisor",
                   "--workdir", job_dir, "--num-chips", str(num_chips),
                   "--metrics-dir", self.metrics_dir]
            log_path = os.path.join(job_dir, f"supervisor_p{pid}.log")
            with open(log_path, "a") as log_f:
                procs.append(subprocess.Popen(cmd, env=env, stdout=log_f,
                                              stderr=log_f,
                                              start_new_session=True))

    def _stop_set(self, name: str) -> None:
        with self._lock:
            pset = self._jobs.get(name)
            if pset is None:
                return
            pset.expected_stop = True
        # SIGTERM all processes together: the preemption checkpoint is a
        # collective save, so every process must get the request.
        for p in pset.procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + self.stop_grace_seconds
        for p in pset.procs:
            timeout = max(0.1, deadline - time.monotonic())
            try:
                p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        with self._lock:
            self._jobs.pop(name, None)

    def _ensure_monitor(self) -> None:
        with self._lock:
            if self._monitor is None or not self._monitor.is_alive():
                self._monitor = threading.Thread(
                    target=self._monitor_loop,
                    name="voda-monitor-multihost", daemon=True)
                self._monitor.start()

    def _monitor_loop(self) -> None:
        while not self._closed.is_set():
            completed: List[str] = []
            failed: List[Tuple[str, str]] = []
            with self._lock:
                for name, pset in list(self._jobs.items()):
                    if pset.expected_stop:
                        continue
                    codes = [p.poll() for p in pset.procs]
                    if any(c is None for c in codes):
                        # A dead peer stalls the others at their next
                        # collective; reap the set once anything exited
                        # abnormally — including a PREEMPTED exit the
                        # backend didn't request (external SIGTERM to one
                        # process), which would otherwise wedge the
                        # survivors forever. Exit 0 with peers still
                        # running is just completion stagger.
                        if any(c is not None and c != 0 for c in codes):
                            self._reap_locked(name, pset)
                            self._specs.pop(name, None)
                            failed.append(
                                (name, f"exit codes {codes}"))
                        continue
                    self._jobs.pop(name)
                    # Drop the spec while still under the lock —
                    # start_job writes _specs under it from scheduler
                    # threads, and an unlocked pop here would race.
                    self._specs.pop(name, None)
                    if all(c == 0 for c in codes):
                        completed.append(name)
                    elif all(c in (0, PREEMPTED_EXIT_CODE) for c in codes):
                        # Checkpointed exit the backend did not request —
                        # someone SIGTERMed the processes externally. Stay
                        # loud: the scheduler believes the job is running
                        # and a silent drop would strand it forever.
                        failed.append((name,
                                       f"preempted outside scheduler "
                                       f"control (exit codes {codes})"))
                    else:
                        failed.append((name, f"exit codes {codes}"))
            for name in completed:
                self.emit(ClusterEvent(ClusterEventKind.JOB_COMPLETED, name,
                                       timestamp=self.clock.now()))
            for name, detail in failed:
                self.emit(ClusterEvent(ClusterEventKind.JOB_FAILED, name,
                                       detail=detail, timestamp=self.clock.now()))
            with self._lock:
                if not self._jobs:
                    self._monitor = None
                    return
            # Interruptible pause: close() wakes the monitor
            # immediately instead of finishing a full interval.
            self._closed.wait(self.poll_interval_seconds)

    def _reap_locked(self, name: str, pset: _ProcSet) -> None:
        """Kill a job's remaining processes after one of them failed."""
        for p in pset.procs:
            if p.poll() is None:
                p.kill()
        for p in pset.procs:
            p.wait()
        self._jobs.pop(name, None)

    def close(self) -> None:
        self._closed.set()
        for name in list(self._jobs):
            self._stop_set(name)
