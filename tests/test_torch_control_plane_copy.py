"""The port's control plane is the JAX package's, text for text.

The control plane (the service and its CLI, the fleet, the scheduler,
durability, replay, the benchrunner and what they import) is pure Python
that imports no JAX, so the port takes each module as it is, changing only
the package name. This file holds each copy to its source:

- drift: every module of COPIED equals the JAX package's file with
  ``vodascheduler_tpu`` replaced by ``vodascheduler_tpu_torch``;
- DIVERGED names every control-plane file of the port that differs, and
  why; a file of the port's control plane in neither table fails;
- import resolution: every ``vodascheduler_tpu_torch.*`` import written in
  the port resolves to a file of the port (or a name its module defines),
  or is a module listed in NOT_PORTED with the ROADMAP item that brings it;
- in a subprocess whose meta-path hook refuses ``jax``, ``flax``, ``optax``
  and ``vodascheduler_tpu``, the scheduler, the GPU backend, admission and
  the metrics collector import, and a short fake-cluster run under each
  algorithm reaches the modules its passes import inside functions;
- the native library builds outside the package, and processes that
  build it at once into one directory all load it.
"""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "vodascheduler_tpu"
PORT = "vodascheduler_tpu_torch"

COPIED = (
    "common/__init__.py", "common/types.py", "common/clock.py",
    "common/events.py", "common/job.py", "common/metrics.py",
    "common/store.py", "common/lifecycle.py",
    "config.py",
    "obs/__init__.py", "obs/tracer.py", "obs/profile.py", "obs/audit.py",
    "native/voda_native.cc",
    "placement/__init__.py", "placement/state.py", "placement/topology.py",
    "placement/hungarian.py", "placement/comms.py", "placement/manager.py",
    "algorithms/__init__.py", "algorithms/base.py", "algorithms/fifo.py",
    "algorithms/elastic_fifo.py", "algorithms/srjf.py",
    "algorithms/elastic_srjf.py", "algorithms/tiresias.py",
    "algorithms/elastic_tiresias.py", "algorithms/ffdl_optimizer.py",
    "algorithms/afsl.py", "algorithms/fastpath.py",
    "allocator/__init__.py", "allocator/allocator.py",
    "durability/__init__.py", "durability/journal.py",
    "durability/leader.py", "durability/snapshot.py",
    "durability/recover.py", "durability/shipping.py",
    "durability/standby.py",
    "cluster/backend.py", "cluster/fake.py",
    "metricscollector/__init__.py", "metricscollector/learned.py",
    "metricscollector/collector.py", "metricscollector/csv_logger.py",
    "service/__init__.py", "service/__main__.py", "service/admission.py",
    "service/daemon.py", "service/rest.py",
    "scheduler/__init__.py", "scheduler/scheduler.py", "scheduler/fleet.py",
    "replay/__init__.py", "replay/trace.py",
    "replay/simulator.py", "replay/whatif.py", "replay/compare.py",
    "cli.py",
    "benchrunner/__init__.py", "benchrunner/points.py",
    "benchrunner/cache.py", "benchrunner/journal.py",
    "benchrunner/orchestrator.py", "benchrunner/dryrun.py",
)

DIVERGED = {
    "cluster/__init__.py": "trimmed: no gke backend (ROADMAP A21); "
                           "LocalBackend is the port's own",
    "cluster/multihost.py": "one docstring line: the reference's Go source "
                            "named by its path in that repository, not by a "
                            "path on one machine; the code is the "
                            "reference's",
    "native/__init__.py": "the loader builds into build/native/<source "
                          "hash>/ with a per-process temporary name, not "
                          "beside its source under one fixed name",
    "cluster/local.py": "written for the card: torch.cuda.device_count, "
                        "CUDA_VISIBLE_DEVICES per grant, no VODA_TOPOLOGY, "
                        "the port's supervisor",
    "replay/restart_costs.py": "MEASURED_PATH only: the card's own "
                               "artifact (doc/resize_measured_h100.json, "
                               "scripts/capture_gpu_resize.py), never the "
                               "JAX package's TPU file",
    "benchrunner/worker.py": "the port's own: each kind on the card through "
                             "the port's hwbench and resize bench, no retry "
                             "on the plain attention, ici raises (two "
                             "cards), the resize children's telemetry",
    "service/app.py": "the monitor lines only (the reference's :381-386 "
                      "and :394-410): the GPU monitor (runtime/"
                      "gpu_monitor.py, NVML) under the reference's gate, "
                      "sampling at min(30 s, the collector's interval), in "
                      "place of the jax pin and the TPU monitor",
}

# Modules the copies import inside functions that the port does not hold
# yet: module -> (what reaches it, the ROADMAP item that brings it).
NOT_PORTED = {
    "cluster.gke": ("VodaApp(backend=\"gke\"), voda-server --backend gke",
                    "A21"),
}

# The control plane's directories and files in the port: every file there
# is a copy or a named divergence. The rest of the port (models, ops,
# parallel, runtime, bridge, device) is the training plane, rewritten for
# torch and held by the parity tests.
CONTROL_PLANE = ("common", "config.py", "obs", "native", "placement",
                 "algorithms", "allocator", "durability", "cluster",
                 "metricscollector", "service", "scheduler", "replay",
                 "cli.py", "benchrunner")


def _read(*parts):
    with open(os.path.join(REPO, *parts)) as f:
        return f.read()


@pytest.mark.parametrize("rel", COPIED)
def test_copy_has_not_drifted(rel):
    assert _read(PORT, rel) == _read(REF, rel).replace(REF, PORT)


def _control_plane_files():
    out = []
    for top in CONTROL_PLANE:
        path = os.path.join(REPO, PORT, top)
        if os.path.isfile(path):
            out.append(top)
            continue
        for root, _, files in os.walk(path):
            for f in files:
                if f.endswith((".py", ".cc")):
                    out.append(os.path.relpath(os.path.join(root, f),
                                               os.path.join(REPO, PORT)))
    return sorted(out)


def test_every_control_plane_file_is_a_copy_or_a_named_divergence():
    files = set(_control_plane_files())
    assert not set(COPIED) & set(DIVERGED)
    assert files == set(COPIED) | set(DIVERGED), (
        f"in neither table: {sorted(files - set(COPIED) - set(DIVERGED))}; "
        f"listed but absent: {sorted(set(COPIED) | set(DIVERGED) - files)}")
    for rel in DIVERGED:
        assert _read(PORT, rel) != _read(REF, rel).replace(REF, PORT), rel


# ---- import resolution -----------------------------------------------------


def _module_file(module):
    base = os.path.join(REPO, *module.split("."))
    for candidate in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.exists(candidate):
            return candidate
    return None


def _top_level_names(path):
    names = set()
    for node in ast.parse(_read(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                names.update(n.id for n in ast.walk(t)
                             if isinstance(n, ast.Name))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return names


def _port_sources():
    out = []
    for root, _, files in os.walk(os.path.join(REPO, PORT)):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _unresolved_imports(path):
    """(module, line) of every port import in `path` that no port file
    satisfies."""
    bad = []
    for node in ast.walk(ast.parse(_read(path))):
        if isinstance(node, ast.Import):
            bad += [(a.name, node.lineno) for a in node.names
                    if a.name.split(".")[0] == PORT
                    and not _module_file(a.name)]
        elif (isinstance(node, ast.ImportFrom) and not node.level
              and node.module and node.module.split(".")[0] == PORT):
            target = _module_file(node.module)
            if target is None:
                bad.append((node.module, node.lineno))
                continue
            defined = _top_level_names(target)
            bad += [(f"{node.module}.{a.name}", node.lineno)
                    for a in node.names
                    if a.name not in defined
                    and not _module_file(f"{node.module}.{a.name}")]
    return bad


def test_every_port_import_resolves_or_is_not_ported_yet():
    seen = set()
    for path in _port_sources():
        for module, line in _unresolved_imports(path):
            rel = module[len(PORT) + 1:]
            where = f"{os.path.relpath(path, REPO)}:{line}"
            assert rel in NOT_PORTED, f"{where} imports {module}, not ported"
            seen.add(rel)
    # Every entry of the table is still imported somewhere, and none of
    # them exists in the port.
    assert seen == set(NOT_PORTED)
    assert all(_module_file(f"{PORT}.{m}") is None for m in NOT_PORTED)


BLOCKED_RUN = r'''
import importlib.abc
import sys

BLOCKED = ("jax", "flax", "optax", "vodascheduler_tpu")


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, Block())

import vodascheduler_tpu_torch.scheduler
import vodascheduler_tpu_torch.cluster.local
import vodascheduler_tpu_torch.service.admission
import vodascheduler_tpu_torch.metricscollector
from vodascheduler_tpu_torch.algorithms import ALGORITHM_NAMES
from vodascheduler_tpu_torch.allocator import ResourceAllocator
from vodascheduler_tpu_torch.cluster.fake import (FakeClusterBackend,
                                                  WorkloadProfile)
from vodascheduler_tpu_torch.common.clock import VirtualClock
from vodascheduler_tpu_torch.common.events import EventBus
from vodascheduler_tpu_torch.common.job import JobConfig, JobSpec
from vodascheduler_tpu_torch.common.store import JobStore
from vodascheduler_tpu_torch.metricscollector import (BackendRowSource,
                                                      MetricsCollector)
from vodascheduler_tpu_torch.placement import PlacementManager
from vodascheduler_tpu_torch.scheduler import Scheduler
from vodascheduler_tpu_torch.service import AdmissionService

for algorithm in ALGORITHM_NAMES:
    clock = VirtualClock(start=1753760000.0)
    store, bus = JobStore(), EventBus()
    backend = FakeClusterBackend(clock, restart_overhead_seconds=5.0)
    backend.add_host("host-0", 4, announce=False)
    sched = Scheduler("pool", backend, store, ResourceAllocator(store), clock,
                      bus=bus, placement_manager=PlacementManager("pool"),
                      algorithm=algorithm, rate_limit_seconds=1.0)
    collector = MetricsCollector(store, BackendRowSource(backend), clock)
    admission = AdmissionService(store, bus, clock)
    names = []
    for i in range(3):
        backend.register_profile(f"j{i}", WorkloadProfile(
            epoch_seconds_at_1=30.0))
        names.append(admission.create_training_job(JobSpec(
            name=f"j{i}", pool="pool",
            config=JobConfig(min_num_chips=1, max_num_chips=4, epochs=3))))
        clock.advance(5.0)
    for _ in range(200):
        clock.advance(10.0)
        collector.collect_all()
    sched.stop()
    done = [store.get_job(n).status.value for n in names]
    assert done == ["Completed"] * 3, (algorithm, done)
assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print("ok", len(ALGORITHM_NAMES))
'''


def test_control_plane_runs_with_jax_and_the_jax_package_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", BLOCKED_RUN], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.split() == ["ok", "8"]


NATIVE_BUILD = r"""
import sys
from vodascheduler_tpu_torch import native
native._BUILD_ROOT = sys.argv[1]
lib = native.get_lib()
assert lib is not None
print(native._so_path())
"""


def test_native_library_builds_outside_the_package_without_a_race(
        tmp_path, monkeypatch):
    monkeypatch.delenv("VODA_NO_NATIVE", raising=False)
    from vodascheduler_tpu_torch import native
    assert native._so_path().startswith(
        os.path.join(REPO, "build", "native") + os.sep)
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", NATIVE_BUILD,
                               str(tmp_path)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [e for _, e in outs]
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    (path,) = paths
    assert path.startswith(str(tmp_path)) and os.path.exists(path)
    assert os.listdir(os.path.dirname(path)) == ["_voda_native.so"]
    assert not [f for f in os.listdir(os.path.join(REPO, PORT, "native"))
                if f.endswith(".so")]
