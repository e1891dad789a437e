"""End-to-end benchrunner dryrun on the fake (no-TPU) backend.

`make bench-dryrun` / `python -m vodascheduler_tpu_torch.benchrunner.dryrun`
runs the real orchestrator — real subprocess workers, real watchdog, real
journal and cache machinery — over debug points that need no accelerator
and no jax, including one deliberately wedged point (killed by the
watchdog) and one deliberately failing point. It then validates the
artifact the way the driver does and **fails on any untagged gap**: every
registered point must come back `measured`, `cached_from:<ts>`, or
`skipped:<reason>`, the wedge must have been killed (not stalled the
stream), and every healthy point must still have measured.

This is the fast tier-1 guard for the whole orchestration plane; the
hermetic tiny-model variant (real jax compiles on the CPU platform) lives
in the slow suite (tests/test_benchrunner.py).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
from typing import Any, Dict, List, Optional

from vodascheduler_tpu_torch.benchrunner.orchestrator import (
    BenchOrchestrator,
    to_hardware_section,
    validate_summary,
)
from vodascheduler_tpu_torch.benchrunner.points import BenchPoint

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def dryrun_registry(hang_seconds: float = 2.0) -> List[BenchPoint]:
    """Debug points emulating one of each production row, plus the two
    failure modes the plane exists to survive."""
    return [
        BenchPoint("meta", "debug",
                   {"behavior": "ok", "data": {"backend": "fake",
                                               "device_kind": "dryrun"}},
                   risk=-100, section="meta"),
        BenchPoint("model:fake_flagship:b8", "debug",
                   {"behavior": "ok",
                    "data": {"model": "fake_flagship", "batch": 8,
                             "step_time_ms": 1.0, "mfu": 0.42}},
                   risk=10, section="model"),
        BenchPoint("attention:b2:s128", "debug",
                   {"behavior": "ok",
                    "data": {"batch": 2, "seq": 128, "flash_ms": 0.5,
                             "xla_ms": 1.0, "flash_speedup": 2.0}},
                   risk=15, section="attention"),
        BenchPoint("moe:b8", "debug",
                   {"behavior": "fail",
                    "message": "injected dispatch failure"},
                   risk=40, section="moe"),
        # The wedged compile: sleeps far past its own watchdog budget. The
        # later resize point MUST still complete — that is the acceptance
        # scenario (a wedge skips the point, never the stream).
        BenchPoint("model:fake_wedge:b16", "debug",
                   {"behavior": "hang", "seconds": 600.0},
                   risk=45, timeout_seconds=hang_seconds, section="model"),
        BenchPoint("resize:fake_flagship:b8", "debug",
                   {"behavior": "ok",
                    "data": {"model": "fake_flagship", "batch": 8,
                             "resize_cost_seconds": 9.5}},
                   risk=60, section="resize"),
    ]


def run_dryrun(out_path: Optional[str] = None,
               workdir: Optional[str] = None) -> Dict[str, Any]:
    """Returns {"ok", "problems", "stats", "summary"}; ok=False means the
    evidence plane has a gap the driver would refuse to stamp."""
    import shutil

    own_dir = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="voda-bench-dryrun-")
    points = dryrun_registry()
    try:
        orch = BenchOrchestrator(
            points, repo_dir=_REPO,
            cache_path=os.path.join(workdir, "cache.json"),
            journal_path=os.path.join(workdir, "journal.jsonl"))
        summary = orch.run()
    finally:
        if own_dir:
            shutil.rmtree(workdir, ignore_errors=True)
    problems = validate_summary(summary, points)
    rows = {r["point_id"]: r for r in summary["rows"]}
    # Beyond tag completeness: the wedge must have been watchdog-killed,
    # the injected failure skipped with its reason, and every healthy
    # point measured despite its neighbors.
    wedge = rows.get("model:fake_wedge:b16", {})
    if not wedge.get("provenance", "").startswith("skipped:watchdog_timeout"):
        problems.append(f"wedged point not killed by the watchdog: "
                        f"{wedge.get('provenance')!r}")
    fail = rows.get("moe:b8", {})
    if not fail.get("provenance", "").startswith("skipped:point_error"):
        problems.append(f"failing point mis-tagged: "
                        f"{fail.get('provenance')!r}")
    for pid in ("meta", "model:fake_flagship:b8", "attention:b2:s128",
                "resize:fake_flagship:b8"):
        if rows.get(pid, {}).get("provenance") != "measured":
            problems.append(f"healthy point {pid} did not measure: "
                            f"{rows.get(pid, {}).get('provenance')!r}")
    # The consumable artifact shape: every section row tagged, and no
    # whole-stream stall error anywhere (the failure mode this plane
    # replaced).
    hw = to_hardware_section(summary)
    if "error" in hw:
        problems.append(f"whole-section error leaked: {hw['error']!r}")
    for section_rows in (hw.get("models", []), hw.get("attention", []),
                         [hw["moe"]] if "moe" in hw else [],
                         hw.get("resize", [])):
        for r in section_rows:
            if not str(r.get("provenance", "")).startswith(
                    ("measured", "cached_from:", "skipped:")):
                problems.append(f"untagged artifact row: {r}")
    if len(hw.get("models", [])) != 2 or len(hw.get("resize", [])) != 1:
        problems.append("artifact section shape wrong: "
                        f"models={len(hw.get('models', []))} "
                        f"resize={len(hw.get('resize', []))}")
    result = {"ok": not problems, "problems": problems,
              "stats": summary["stats"], "summary": summary,
              "hardware": hw}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None) -> None:
    args = list(sys.argv[1:] if argv is None else argv)
    out_path = args[0] if args else None
    result = run_dryrun(out_path=out_path)
    print(json.dumps({"ok": result["ok"], "stats": result["stats"],
                      "problems": result["problems"]}))
    raise SystemExit(0 if result["ok"] else 1)


if __name__ == "__main__":
    main()
