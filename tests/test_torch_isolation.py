"""The PyTorch port stands alone: an AST scan of its sources.

- no module of the port, and neither chip_smoke.py nor
  scripts/torch_step_profile.py, imports jax, flax, optax or
  anything of vodascheduler_tpu;
- the port calls no library attention and compiles nothing with
  torch.compile: its attention is its own kernels;
- the CUDA path of flash attention has no try/except that could fall back
  to the plain version.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "vodascheduler_tpu_torch")
FORBIDDEN_IMPORTS = ("jax", "flax", "optax", "vodascheduler_tpu")
FORBIDDEN_NAMES = ("scaled_dot_product_attention", "flash_attn")


def _package_sources():
    out = []
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in sorted(files) if f.endswith(".py")]
    return sorted(out)


def _tree(path):
    with open(path) as f:
        return ast.parse(f.read(), filename=path)


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in FORBIDDEN_IMPORTS


@pytest.mark.parametrize(
    "path", _package_sources() + [
        os.path.join(REPO, "chip_smoke.py"),
        os.path.join(REPO, "scripts", "torch_step_profile.py")],
    ids=lambda p: os.path.relpath(p, REPO))
def test_imports_nothing_of_jax_or_the_jax_package(path):
    bad = [m for m in _imported_roots(_tree(path)) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_scan_sees_the_whole_package():
    names = {os.path.relpath(p, PKG) for p in _package_sources()}
    assert {"bridge.py", "device.py", "ops/flash_attention.py",
            "ops/_build.py", "ops/chunked_ce.py", "ops/moe_dispatch.py",
            "models/layers.py", "models/llama.py", "models/mixtral.py",
            "models/registry.py", "runtime/hwbench.py",
            "runtime/train.py", "runtime/optim.py", "runtime/checkpoint.py",
            "runtime/supervisor.py", "runtime/gpu_monitor.py",
            "common/job.py", "common/types.py",
            "metricscollector/csv_logger.py", "obs/tracer.py",
            # the control plane
            "config.py", "common/clock.py", "common/events.py",
            "common/lifecycle.py", "common/metrics.py", "common/store.py",
            "obs/audit.py", "obs/profile.py", "native/__init__.py",
            "placement/manager.py", "placement/comms.py",
            "placement/hungarian.py", "placement/topology.py",
            "placement/state.py", "algorithms/base.py",
            "algorithms/fastpath.py", "algorithms/elastic_tiresias.py",
            "allocator/allocator.py", "durability/journal.py",
            "cluster/backend.py", "cluster/fake.py", "cluster/local.py",
            "metricscollector/collector.py", "metricscollector/learned.py",
            "service/admission.py", "scheduler/scheduler.py"} <= names
    assert _forbidden("vodascheduler_tpu.models")
    assert not _forbidden("vodascheduler_tpu_torch.models")


@pytest.mark.parametrize("path", _package_sources(),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_no_library_attention_or_torch_compile(path):
    used = set()
    for node in ast.walk(_tree(path)):
        if isinstance(node, ast.Attribute):
            used.add(node.attr)
            if (node.attr == "compile" and isinstance(node.value, ast.Name)
                    and node.value.id == "torch"):
                used.add("torch.compile")
        elif isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.alias):
            used.update(node.name.split("."))
            if node.name == "compile":
                used.add("torch.compile")  # from torch import compile
    bad = sorted(used & {*FORBIDDEN_NAMES, "torch.compile"})
    assert not bad, f"{path} uses {bad}"


def test_cuda_path_has_no_fallback():
    """No try/except anywhere in the flash-attention module: a CUDA tensor
    reaches its kernel or raises."""
    path = os.path.join(PKG, "ops", "flash_attention.py")
    tries = [n.lineno for n in ast.walk(_tree(path)) if isinstance(n, ast.Try)]
    assert not tries, f"try blocks at lines {tries}"
