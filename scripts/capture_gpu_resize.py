"""Measures what a resize costs on the card and writes the port's artifact.

    python3 scripts/capture_gpu_resize.py [--points llama_350m:8,mixtral_small:8]
        [--out doc/resize_measured_h100.json] [--session NAME]

Runs the port's benchrunner (``vodascheduler_tpu_torch/benchrunner``) over
a ``meta`` point and one ``resize`` point a model, each in its own killable
worker, with no cache: every row is measured in this run. It then writes
the resize rows in the schema of the JAX package's artifact (``{"note":
..., "points": [...]}``), each point tagged with ``"backend": "gpu"``, the
card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them
(``"device"``) and ``"session"``, and prints the per-family restart and
in-place costs that ``replay/restart_costs.py`` derives from them. It
writes nothing and exits 1 unless every point measured and is complete,
its fast (in-place) row included.

The default points are the models of the JAX package's artifact, both
AdamW (the 12 bytes a parameter that ``FAMILY_FOOTPRINT`` assumes). On the
CPU (``VODA_HWBENCH_ON_CPU=1``, tiny models, another ``--out``) it
rehearses the same path.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from vodascheduler_tpu_torch.benchrunner import (  # noqa: E402
    BenchOrchestrator,
    default_registry,
    validate_summary,
)
from vodascheduler_tpu_torch.replay import restart_costs  # noqa: E402

NOTE = ("Measured on one card by vodascheduler_tpu_torch/runtime/"
        "resize_bench.py through the port's benchrunner "
        "(scripts/capture_gpu_resize.py); consumed by the port's "
        "replay/restart_costs.py. The fast (in-place) row is one NCCL rank "
        "resized 1 -> 1 (TrainSession.resize and the first step): the card "
        "is one device.")


def device_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them; "cpu"
    where there is no card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return "cpu"
    return out.strip().splitlines()[0]


def capture(points, session: str, workdir: str):
    """(artifact, problems) from one orchestrated run over `points`; the
    checkpoints go under `workdir`."""
    registry = default_registry(attention_points=(), moe_batch=None,
                                resize_points=points, ici_points=())
    orch = BenchOrchestrator(
        registry, repo_dir=REPO,
        cache_path=os.path.join(workdir, "cache.json"),
        journal_path=os.path.join(workdir, "journal.jsonl"),
        env=dict(os.environ, TMPDIR=workdir))
    summary = orch.run()
    problems = validate_summary(summary, registry)
    device = device_line()
    rows = []
    for row in summary["rows"]:
        print(json.dumps({k: row.get(k) for k in (
            "point_id", "provenance", "error", "duration_seconds")}),
            flush=True)
        if row["provenance"] != "measured":
            problems.append(f"{row['point_id']}: {row['provenance']} "
                            f"{row.get('error', '')}")
            continue
        if row["kind"] != "resize":
            continue
        point = dict(row["data"])
        point.update({"device": device, "session": session})
        if row.get("telemetry"):
            point["telemetry"] = row["telemetry"]
        if not restart_costs._complete(point):
            problems.append(f"{row['point_id']}: incomplete point")
        if point.get("fast_error") or not point.get("fast_resize_ms"):
            problems.append(f"{row['point_id']}: no fast row "
                            f"({point.get('fast_error')})")
        rows.append(point)
    return {"note": NOTE, "points": rows}, problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", default="llama_350m:8,mixtral_small:8",
                    help="model:batch,...")
    ap.add_argument("--out", default=os.path.join(
        REPO, "doc", "resize_measured_h100.json"))
    ap.add_argument("--session", default=datetime.datetime.now(
        datetime.timezone.utc).strftime("%Y-%m-%dT%H:%MZ"))
    args = ap.parse_args(argv)
    points = [(m, int(b)) for m, b in
              (p.split(":") for p in args.points.split(",") if p)]
    print(device_line(), flush=True)
    workdir = os.path.join(REPO, "build", "capture_gpu_resize")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        artifact, problems = capture(points, args.session, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for p in artifact["points"]:
        print(json.dumps({k: p.get(k) for k in (
            "model", "batch", "checkpoint_bytes", "save_async_initiate_ms",
            "save_async_drain_ms", "save_sync_ms", "save_sync_host_copy_ms",
            "save_sync_write_ms", "warm_step_ms", "restart_segments_ms",
            "restart_total_ms", "resize_cost_seconds", "fast_resize_ms",
            "fast_segments_ms",
            "fast_memory_before_bytes", "fast_peak_bytes",
            "fast_first_step_loss", "fast_error",
            "prepare_next_step_loss", "restart_first_step_loss",
            "prepare_second_step_loss", "restart_second_step_loss",
            "launches", "device")}), flush=True)
    if problems:
        print("capture failed: " + "; ".join(problems), file=sys.stderr)
        return 1
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
        f.write("\n")
    for fam, cost in restart_costs.family_restart_costs(args.out).items():
        print(f"{fam}: restart {cost.restart_s} s ({cost.provenance}); "
              f"in place {cost.inplace_s} s ({cost.inplace_provenance})",
              flush=True)
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
