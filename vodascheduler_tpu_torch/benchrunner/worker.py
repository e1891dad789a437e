"""One benchmark point in one killable subprocess, on the card.

Counterpart of the JAX package's ``benchrunner/worker.py``. The
orchestrator spawns
    python -m vodascheduler_tpu_torch.benchrunner.worker '<point json>'
per point. The contract is one prefixed JSON result line on stdout:

    VODA_BENCHPOINT_RESULT {"point_id": ..., "data": {...}}        (success)
    VODA_BENCHPOINT_RESULT {"point_id": ..., "error": "..."}       (ran, failed)

A wedged point prints nothing: the parent's watchdog kills it and tags the
row `skipped:watchdog_timeout`. Running in a child is the design: a hung
kernel or build blocks where no in-process signal reaches, SIGKILL from
outside always works, and the blast radius is one point.

Heavy imports (torch, the model zoo) happen inside per-kind handlers, never
at module scope: debug points (test scaffolding and the dryrun) cost only
interpreter startup.

Divergences from the reference, on purpose:

- a point runs on CUDA, or raises; on the CPU only under
  ``VODA_HWBENCH_ON_CPU=1`` (the reference's switch). There is no platform
  to configure (its ``_configure_jax_platform``) and no compile cache (the
  kernels' build cache is ``ops/_build.py``'s);
- a failing ``model`` point is the point's error. The reference retries it
  on the XLA attention; a kernel's failure here is never hidden behind the
  plain attention;
- ``ici`` raises: its counterpart is an NVLink point, which needs two cards
  (ROADMAP A15b), so the orchestrator tags the row ``skipped:point_error``;
- a ``resize`` point measures in the resize bench's children, so its
  telemetry is theirs: each child's snapshot, keyed by its phase.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Mapping, Optional

from vodascheduler_tpu_torch.benchrunner.points import RESULT_PREFIX


def _require_accelerator() -> str:
    """The device a point measures on: CUDA, or the CPU under
    VODA_HWBENCH_ON_CPU=1. The hardware bench never silently 'measures' a
    CPU."""
    import torch
    if torch.cuda.is_available():
        return "cuda"
    if os.environ.get("VODA_HWBENCH_ON_CPU"):
        return "cpu"
    raise RuntimeError(
        "hardware bench point requires a CUDA device; set "
        "VODA_HWBENCH_ON_CPU=1 to smoke-test on CPU")


def _telemetry(data: Any) -> Optional[Dict[str, Any]]:
    """Per-point memory telemetry. Each point is its own process, so the
    allocator's peak here is the point's peak. A resize point's children
    report their own (`child_telemetry`), which replaces this process's."""
    children = (data.pop("child_telemetry", None)
                if isinstance(data, dict) else None)
    if os.environ.get("VODA_BENCH_TELEMETRY", "1") == "0":
        return None
    if children is not None:
        return {k: v for k, v in children.items() if v} or None
    try:
        from vodascheduler_tpu_torch.runtime.gpu_monitor import (
            telemetry_snapshot,
        )
        return telemetry_snapshot() or None
    except Exception:  # noqa: BLE001 - telemetry must never fail a point
        return None


def _run_meta(spec: Mapping[str, Any]) -> Dict[str, Any]:
    device = _require_accelerator()
    if device == "cpu":
        return {"device_kind": "cpu", "backend": "cpu",
                "peak_bf16_tflops_per_chip": None,
                "power_limit_watts": None}
    import torch
    from vodascheduler_tpu_torch.runtime.gpu_monitor import NvmlReader
    from vodascheduler_tpu_torch.runtime.hwbench import peak_flops_per_device
    name = torch.cuda.get_device_name(0)
    return {
        "device_kind": name,
        "backend": "gpu",
        "peak_bf16_tflops_per_chip": peak_flops_per_device(name) / 1e12,
        "power_limit_watts": NvmlReader().read(0).get("power_limit_watts"),
    }


def _run_model(spec: Mapping[str, Any]) -> Dict[str, Any]:
    device = _require_accelerator()
    from vodascheduler_tpu_torch.runtime.hwbench import bench_model_step
    return bench_model_step(**spec, device=device).as_dict()


def _run_attention(spec: Mapping[str, Any]) -> Dict[str, Any]:
    device = _require_accelerator()
    from vodascheduler_tpu_torch.runtime.hwbench import bench_attention_point
    return bench_attention_point(**spec, device=device)


def _run_moe(spec: Mapping[str, Any]) -> Dict[str, Any]:
    device = _require_accelerator()
    from vodascheduler_tpu_torch.runtime.hwbench import bench_moe_dispatch
    return bench_moe_dispatch(**spec, device=device)


def _run_ici(spec: Mapping[str, Any]) -> Dict[str, Any]:
    raise RuntimeError(
        "the ici point's counterpart is an NVLink collective point, which "
        "needs two cards (ROADMAP A15b); not ported")


def _run_resize(spec: Mapping[str, Any]) -> Dict[str, Any]:
    # resize_bench spawns its own measurement children (a restart IS a
    # fresh process); they enforce the device contract themselves.
    from vodascheduler_tpu_torch.runtime.resize_bench import bench_resize_cost
    return bench_resize_cost(**spec)


def _run_debug(spec: Mapping[str, Any]) -> Dict[str, Any]:
    """Test scaffolding: behaviors that exercise every orchestrator path
    without importing torch. `hang` emulates a wedged point: a sleep the
    watchdog must kill from outside."""
    behavior = spec.get("behavior", "ok")
    if behavior == "ok":
        return dict(spec.get("data", {"ok": True}))
    if behavior == "slow":
        time.sleep(float(spec.get("seconds", 1.0)))
        return dict(spec.get("data", {"ok": True}))
    if behavior == "hang":
        time.sleep(float(spec.get("seconds", 3600.0)))
        return {"unreachable": True}
    if behavior == "fail":
        raise RuntimeError(spec.get("message", "injected point failure"))
    raise ValueError(f"unknown debug behavior {behavior!r}")


_HANDLERS = {
    "meta": _run_meta,
    "model": _run_model,
    "attention": _run_attention,
    "moe": _run_moe,
    "resize": _run_resize,
    "ici": _run_ici,
    "debug": _run_debug,
}


def run_point(kind: str, spec: Mapping[str, Any]) -> Dict[str, Any]:
    handler = _HANDLERS.get(kind)
    if handler is None:
        raise ValueError(f"unknown point kind {kind!r}")
    return handler(spec)


def main(argv=None) -> None:
    args = list(sys.argv[1:] if argv is None else argv)
    if len(args) != 1:
        print("usage: python -m vodascheduler_tpu_torch.benchrunner.worker "
              "'<point json>'", file=sys.stderr)
        raise SystemExit(2)
    point = json.loads(args[0])
    out: Dict[str, Any] = {"point_id": point.get("point_id", "?")}
    try:
        out["data"] = run_point(point["kind"], point.get("spec", {}))
        if point["kind"] not in ("debug", "meta"):
            telem = _telemetry(out["data"])
            if telem:
                out["telemetry"] = telem
    except Exception as e:  # noqa: BLE001 - report, don't die silently
        out["error"] = f"{type(e).__name__}: {str(e)[:500]}"
    print(f"{RESULT_PREFIX}{json.dumps(out)}", flush=True)


if __name__ == "__main__":
    main()
