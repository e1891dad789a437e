"""Measured elastic-resize cost on one card: the number the scheduler's
restart pricing rides on.

Counterpart of the JAX package's ``runtime/resize_bench.py``. Every
ElasticTiresias lease, hysteresis and cooldown knob, the replay's
`restart_overhead_seconds` and the scheduler's migration price charge a
resize; on this design a resize is a checkpoint-restart, so its cost is
measured, not assumed (`replay/restart_costs.py` derives the per-family
costs from this module's rows).

Both paths, as the reference measures them, in sequential child processes
(the card changes hands as in a restart: each child exits before the next
initialises CUDA):

  prepare: a TrainSession at step 0, `warm_steps` steps, then the saves:
           ``save(wait=False)`` (the device→host copy: what the running job
           blocks on), ``finish_saves()`` (the write), one more step and a
           synced save; the size of the latest step's directory;
  restart: what the supervisor does on a restart (`TrainSession.resume`),
           with a mark between its stages:

      proc_start       the interpreter is up and this module imported
      torch_imported   ``import torch``
      cuda_ready       ``torch.cuda.init()`` and a synchronised tiny op
      kernels_loaded   the flash-attention kernels that the prepare
                       child's steps launched (the model's head width and
                       dtype) found in the ``ops/_build.py`` cache
                       (``build/torch_kernels/<source hash>/``) and loaded,
                       so that the first step holds no build and no load
      setup_built      the port's modules imported, then module, parameters
                       and optimizer (`TrainSession`), as the reference
                       imports its package in this segment
      restored         `TrainSession.restore`: the checkpoint read and set
      first_step_done  one step, synchronised
  fast:    the in-place path in one process: one rank of a process group
           of one (NCCL on the card, gloo under ``VODA_HWBENCH_ON_CPU=1``),
           the prepare child's steps up to its synced save, then
           `TrainSession.resize(1)` and the first step, timed together as
           ``fast_resize_ms``: everything the in-place path pays (the plan,
           the mesh and its groups, the module, its kernels and the
           optimizer built anew, every tensor of the state moved, the first
           step), nothing it does not (no save, no process exit, no
           restore). The card is one device, so it resizes 1 → 1, as the
           reference does on a one-chip host (it takes 1 → 2 where a second
           device exists). A failure of the fast child leaves the cold row
           standing, with ``fast_error``.

Segments are differences of `time.monotonic()` marks (CLOCK_MONOTONIC,
comparable across processes on one host) against the parent's spawn time.

Divergences from the reference, on purpose:

- ``runtime/compile_cache.py`` has no counterpart: nothing compiles at run
  time here but the kernels, which ``ops/_build.py`` already caches by
  source hash; the ``kernels_loaded`` segment is that cache's read;
- each child runs on CUDA, and raises where there is none; on the CPU only
  under ``VODA_HWBENCH_ON_CPU=1`` (the reference's switch, for tests);
- a check of the port's own: the restart child reports the losses of its
  first two steps, the prepare child the losses of the same two steps
  (batches are a function of (seed, step)) taken after its synced save has
  committed; the first reads the restored parameters, the second the
  restored optimizer state too. The fast child's first step after the
  resize is the same step as the first of those. Each child reports its
  kernel launches (the fast child those of that step alone) and its memory
  (`gpu_monitor.telemetry_snapshot`), the fast child also the peak of
  device memory across the resize (it holds the old and the new state
  together, `sharding.reshard_state`), and the restart child fails if its steps
  launched a kernel it had not loaded before, or did not launch one it
  had.

Run: python -m vodascheduler_tpu_torch.runtime.resize_bench '{"points": [["llama_350m", 8]]}'
(``"stream": true`` prints one ``{"kind": "resize", "data": ...}`` line a
point). The benchrunner's ``resize`` points call `bench_resize_cost`, one
killable worker a point.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

MARK_PREFIX = "VODA_RESIZE_MARK "
RESULT_PREFIX = "VODA_RESIZE_RESULT "

RESTART_MARKS = ("proc_start", "torch_imported", "cuda_ready",
                 "kernels_loaded", "setup_built", "restored",
                 "first_step_done")

# Steps the restart child takes (the first one timed) and the prepare child
# takes after its synced save, their losses compared.
AFTER_RESTORE_STEPS = 2

def _emit_mark(name: str) -> None:
    print(f"{MARK_PREFIX}{json.dumps({'mark': name, 't': time.monotonic()})}",
          flush=True)


def _run_child(phase: str, model: str, batch: int, ckpt_dir: str,
               steps: int, timeout: float,
               kernels: Sequence[str] = ()) -> Tuple[Dict[str, Any],
                                                     List[Dict[str, Any]],
                                                     float]:
    """Spawn one measurement child; returns (result, marks, spawn_t).

    The child inherits the caller's environment and decides its device
    itself (`_child_device`); it loads `kernels` before its session."""
    cmd = [sys.executable, "-m", "vodascheduler_tpu_torch.runtime.resize_bench",
           "--child", phase, model, str(batch), ckpt_dir, str(steps),
           ",".join(kernels)]
    spawn_t = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout,
                          cwd=os.path.dirname(os.path.dirname(
                              os.path.dirname(os.path.abspath(__file__)))))
    if proc.returncode != 0:
        raise RuntimeError(
            f"resize-bench child {phase} failed: {proc.stderr[-800:]}")
    marks, result = [], None
    for line in proc.stdout.splitlines():
        if line.startswith(MARK_PREFIX):
            marks.append(json.loads(line[len(MARK_PREFIX):]))
        elif line.startswith(RESULT_PREFIX):
            result = json.loads(line[len(RESULT_PREFIX):])
    if result is None:
        raise RuntimeError(
            f"resize-bench child {phase} produced no result line; "
            f"stdout tail: {proc.stdout[-400:]}")
    return result, marks, spawn_t


def bench_resize_cost(model_name: str, global_batch_size: int,
                      warm_steps: int = 3,
                      child_timeout: float = 900.0,
                      workdir: Optional[str] = None) -> Dict[str, Any]:
    """The resize cost of one model on one card, both paths.

    Three sequential children (the card changes hands as in a
    scheduler-driven restart):
      prepare: init -> warm steps -> timed saves -> exit
      restart: cold start -> restore -> first step  (the cold path)
      fast:    init -> warm steps -> live resize() -> first step
               (the in-place path, one process end to end)
    """
    import shutil
    import tempfile

    own_dir = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="voda-resize-bench-")
    ckpt_dir = os.path.join(workdir, "ckpt")
    try:
        prep, _, _ = _run_child("prepare", model_name, global_batch_size,
                                ckpt_dir, warm_steps, child_timeout)
        restart, marks, spawn_t = _run_child(
            "restart", model_name, global_batch_size, ckpt_dir, 1,
            child_timeout, kernels=sorted(prep["launches"]))
        # The fast child is additive evidence: its failure must not discard
        # the cold measurements above (the row ships with fast_resize_ms
        # None and the error noted). Its warm steps are the prepare
        # child's up to the synced save, so that its first step after the
        # resize is the restart child's first.
        fast_error = None
        try:
            fast, _, _ = _run_child("fast", model_name, global_batch_size,
                                    ckpt_dir, warm_steps + 1, child_timeout)
        except Exception as e:  # noqa: BLE001
            fast = {}
            fast_error = f"{type(e).__name__}: {str(e)[:300]}"
        t = {m["mark"]: m["t"] for m in marks}
        seg = {}
        prev = spawn_t
        for mark in RESTART_MARKS:
            if mark in t:
                seg[mark + "_ms"] = round((t[mark] - prev) * 1000.0, 1)
                prev = t[mark]
        total_ms = round((t["first_step_done"] - spawn_t) * 1000.0, 1) \
            if "first_step_done" in t else None
        cold_seconds = round(
            ((prep.get("save_sync_ms") or 0.0) + (total_ms or 0.0))
            / 1000.0, 2)
        fast_ms = fast.get("fast_resize_ms")
        fast_row = {"path": "fast",
                    # None (not 0.0) when unmeasured: a consumer must see
                    # a missing fast measurement, never a free resize.
                    "seconds": (round(fast_ms / 1000.0, 2)
                                if fast_ms else None),
                    "from_chips": fast.get("fast_from_chips"),
                    "to_chips": fast.get("fast_to_chips")}
        if fast_error:
            fast_row["error"] = fast_error
        resize_paths = [
            fast_row,
            {"path": "cold", "seconds": cold_seconds,
             "phases": "save_sync + cold restart + restore + first step"},
        ]
        return {
            "model": model_name,
            "batch": global_batch_size,
            "backend": restart.get("backend", prep.get("backend")),
            "checkpoint_bytes": prep.get("checkpoint_bytes"),
            "save_async_initiate_ms": prep.get("save_async_initiate_ms"),
            "save_async_drain_ms": prep.get("save_async_drain_ms"),
            "save_sync_ms": prep.get("save_sync_ms"),
            "warm_step_ms": prep.get("warm_step_ms"),
            "restart_segments_ms": seg,
            "restart_total_ms": total_ms,
            # The in-place path: the live resize and its first step, no
            # process exit.
            "fast_resize_ms": fast_ms,
            "fast_from_chips": fast.get("fast_from_chips"),
            "fast_to_chips": fast.get("fast_to_chips"),
            **({"fast_error": fast_error} if fast_error else {}),
            "resize_paths": resize_paths,
            # The number the replay charges a cold resize: the synced save
            # (what a preemption pays) + the whole restart.
            "resize_cost_seconds": cold_seconds,
            # The port's own: the synced save split into its host copy and
            # its write, the tensors' bytes, the first-step check, and each
            # child's launches and memory.
            "state_bytes": prep.get("state_bytes"),
            "save_sync_host_copy_ms": prep.get("save_sync_host_copy_ms"),
            "save_sync_write_ms": prep.get("save_sync_write_ms"),
            # The first step after the restore reads the parameters, the
            # second the optimizer state too.
            "prepare_next_step_loss": prep["next_step_losses"][0],
            "restart_first_step_loss": restart["step_losses"][0],
            "prepare_second_step_loss": prep["next_step_losses"][1],
            "restart_second_step_loss": restart["step_losses"][1],
            "kernel_cache_hit": restart.get("kernel_cache_hit"),
            # The fast child's first step after the resize (the same step
            # as the restart child's first), and device memory before the
            # resize and at its peak across it (None off the card).
            "fast_first_step_loss": fast.get("first_step_loss"),
            # resize()'s halves and the swap (TrainSession.last_resize_ms),
            # then the first step
            "fast_segments_ms": fast.get("segments_ms"),
            "fast_memory_before_bytes": fast.get("memory_before_bytes"),
            "fast_peak_bytes": fast.get("peak_bytes"),
            "launches": {"prepare": prep.get("launches"),
                         "restart": restart.get("launches"),
                         "fast": fast.get("launches")},
            "child_telemetry": {"prepare": prep.get("telemetry"),
                                "restart": restart.get("telemetry"),
                                "fast": fast.get("telemetry")},
        }
    finally:
        if own_dir:
            shutil.rmtree(workdir, ignore_errors=True)


def _child_device(torch):
    """CUDA, initialised and synchronised; the CPU only under
    VODA_HWBENCH_ON_CPU=1; otherwise raise."""
    if torch.cuda.is_available():
        torch.cuda.init()
        device = torch.device("cuda", torch.cuda.current_device())
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize(device)
        return device
    if os.environ.get("VODA_HWBENCH_ON_CPU"):
        return torch.device("cpu")
    raise RuntimeError(
        "resize bench requires a CUDA device; set VODA_HWBENCH_ON_CPU=1 to "
        "smoke-test on the CPU")


def _load_kernels(names: Sequence[str]) -> Optional[bool]:
    """Loads the kernels `names` (what the prepare child's steps launched),
    and returns whether each one's library was already in the build cache
    (None where there are none)."""
    from vodascheduler_tpu_torch.ops import _build
    from vodascheduler_tpu_torch.ops import flash_attention as fa

    if not names:
        return None
    hit = all((_build.build_dir() / f"lib{fa.source(n)}.so").exists()
              for n in names)
    fa.load_kernels(names)
    return hit


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _child_main(argv: Sequence[str]) -> None:
    phase, model, batch, ckpt_dir, steps = (
        argv[0], argv[1], int(argv[2]), argv[3], int(argv[4]))
    kernels = [n for n in (argv[5] if len(argv) > 5 else "").split(",") if n]
    _emit_mark("proc_start")
    import torch

    _emit_mark("torch_imported")
    device = _child_device(torch)
    _emit_mark("cuda_ready")
    cache_hit = _load_kernels(kernels)
    _emit_mark("kernels_loaded")
    from vodascheduler_tpu_torch.models import get_model
    from vodascheduler_tpu_torch.ops import flash_attention as fa
    from vodascheduler_tpu_torch.runtime import checkpoint as ckpt
    from vodascheduler_tpu_torch.runtime.gpu_monitor import telemetry_snapshot
    from vodascheduler_tpu_torch.runtime.train import TrainSession

    bundle = get_model(model)
    out: Dict[str, Any] = {"backend": "gpu" if device.type == "cuda"
                           else device.type,
                           "kernel_cache_hit": cache_hit}
    if phase == "prepare":
        session = TrainSession(bundle, 1, global_batch_size=batch,
                               device=device)
        t0 = time.monotonic()
        session.run_steps(steps)  # returns a float: synchronised
        out["warm_step_ms"] = round(
            (time.monotonic() - t0) / max(1, steps) * 1000.0, 1)
        # Async save: the initiate (the device→host copy, the running
        # job's stall) against the drain (the write).
        t0 = time.monotonic()
        session.save(ckpt_dir, wait=False)
        out["save_async_initiate_ms"] = round(
            (time.monotonic() - t0) * 1000.0, 1)
        t0 = time.monotonic()
        session.finish_saves()
        out["save_async_drain_ms"] = round(
            (time.monotonic() - t0) * 1000.0, 1)
        # Synced save (what a SIGTERM-driven preemption checkpoint pays).
        session.run_steps(1)  # dirty the state so the save is honest
        t0 = time.monotonic()
        session.save(ckpt_dir, wait=True)
        session.finish_saves()
        out["save_sync_ms"] = round((time.monotonic() - t0) * 1000.0, 1)
        _, nbytes, copy_s, write_s = session.last_save
        out["state_bytes"] = nbytes
        out["save_sync_host_copy_ms"] = round(copy_s * 1000.0, 1)
        out["save_sync_write_ms"] = round(write_s * 1000.0, 1)
        # Size of ONE checkpoint: retention keeps two steps here (the async
        # save and the synced one), so walk only the latest step's
        # directory.
        step_dir = ckpt._step_dir(ckpt_dir, ckpt.latest_step(ckpt_dir))
        total = 0
        for root, _, files in os.walk(step_dir):
            for f in files:
                total += os.path.getsize(os.path.join(root, f))
        out["checkpoint_bytes"] = total
        # The two steps the restart child takes from that checkpoint; it
        # has committed, so they change nothing on disk. The first one's
        # loss reads the restored parameters, the second's the restored
        # optimizer state too.
        out["next_step_losses"] = [session.run_steps(1)
                                   for _ in range(AFTER_RESTORE_STEPS)]
    elif phase == "restart":
        # TrainSession.resume's two halves, marked apart.
        session = TrainSession(bundle, 1, global_batch_size=batch,
                               device=device)
        _sync(torch, device)
        _emit_mark("setup_built")
        session.restore(ckpt_dir)
        _sync(torch, device)
        _emit_mark("restored")
        losses = [session.run_steps(1)]
        _sync(torch, device)
        _emit_mark("first_step_done")
        losses += [session.run_steps(1)
                   for _ in range(AFTER_RESTORE_STEPS - 1)]
        out["step_losses"] = losses
    elif phase == "fast":
        out.update(_fast(torch, device, bundle, batch, steps))
    else:
        raise ValueError(f"unknown phase {phase!r}")
    out["launches"] = {k: v for k, v in fa.launches.items() if v}
    if phase == "restart" and sorted(out["launches"]) != sorted(kernels):
        raise RuntimeError(
            f"kernels loaded before the steps {kernels} are not the kernels "
            f"the steps launched {sorted(out['launches'])}")
    out["telemetry"] = telemetry_snapshot()
    print(f"{RESULT_PREFIX}{json.dumps(out)}", flush=True)


def _fast(torch, device, bundle, batch: int, steps: int) -> Dict[str, Any]:
    """The fast child's body: one rank of a process group of one, `steps`
    steps, then `TrainSession.resize(1)` and the first step, timed."""
    import socket

    import torch.distributed as dist

    from vodascheduler_tpu_torch.ops import flash_attention as fa
    from vodascheduler_tpu_torch.runtime.train import TrainSession

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    kwargs = {"device_id": device} if device.type == "cuda" else {}
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1, **kwargs)
    try:
        session = TrainSession(bundle, 1, global_batch_size=batch,
                               device=device)
        session.run_steps(steps)  # returns a float: synchronised
        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        before = torch.cuda.memory_allocated(device) if cuda else None
        fa.reset_launches()
        t0 = time.monotonic()
        session.resize(1)
        t1 = time.monotonic()
        loss = session.run_steps(1)
        t2 = time.monotonic()
        return {"fast_resize_ms": round((t2 - t0) * 1000.0, 1),
                "fast_from_chips": 1, "fast_to_chips": 1,
                "segments_ms": {**session.last_resize_ms, "first_step": round(
                    (t2 - t1) * 1000.0, 1)},
                "first_step_loss": loss,
                "memory_before_bytes": before,
                "peak_bytes": (torch.cuda.max_memory_allocated(device)
                               if cuda else None)}
    finally:
        dist.destroy_process_group()


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = list(sys.argv[1:] if argv is None else argv)
    if args and args[0] == "--child":
        _child_main(args[1:])
        return
    kwargs = json.loads(args[0]) if args else {}
    points = [tuple(p) for p in kwargs.get(
        "points", [("llama_350m", 8), ("mixtral_small", 8)])]
    stream = kwargs.get("stream", False)
    results = []
    for model, batch in points:
        try:
            res = bench_resize_cost(model, batch)
        except Exception as e:  # noqa: BLE001 - per-point isolation
            res = {"model": model, "batch": batch,
                   "error": f"{type(e).__name__}: {e}"}
        results.append(res)
        if stream:
            print(json.dumps({"kind": "resize", "data": res}), flush=True)
    if not stream:
        print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
