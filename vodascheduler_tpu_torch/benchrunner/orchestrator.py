"""The resilient benchmark orchestration plane.

Replaces the monolithic `hwbench --stream` child (bench.py r3–r5) with a
per-point execution model:

  * every point runs in its own killable subprocess (worker.py) under a
    per-point watchdog — a wedged XLA compile is killed and costs exactly
    that point, the stream continues;
  * points run cheapest-to-riskiest (points.ordered), so budget
    exhaustion eats the speculative tail, not the flagship rows;
  * cleanly measured points are written through to a persistent cache
    (cache.py) and a crash-safe JSONL journal (journal.py) — an
    interrupted run resumes without re-burning completed points, and a
    still-missing point back-fills from the last same-config measurement
    with an explicit per-row `cached_from` tag;
  * the summary tags EVERY registered point `measured`,
    `cached_from:<ts>`, or `skipped:<reason>` — no silent gaps, which is
    what lets the driver stamp a complete artifact even on a bad day.

bench.py consumes the summary via `to_hardware_section()` (the legacy
hardware-section shape, rows now provenance-tagged);
`__graft_entry__.bench_dryrun` consumes it via `validate_summary()`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

from vodascheduler_tpu_torch.benchrunner.points import (
    RESULT_PREFIX,
    BenchPoint,
    ordered,
)
from vodascheduler_tpu_torch.benchrunner.cache import ResultCache
from vodascheduler_tpu_torch.benchrunner.journal import RunJournal

SCHEMA = "voda-benchrunner-v1"

MEASURED = "measured"
CACHED = "cached_from"
SKIPPED = "skipped"


@dataclasses.dataclass
class PointResult:
    point: BenchPoint
    provenance: str                      # measured | cached_from:<ts> | skipped:<reason>
    data: Optional[Dict[str, Any]] = None
    error: Optional[str] = None          # the live failure, if any
    telemetry: Optional[Dict[str, Any]] = None
    duration_seconds: float = 0.0

    def as_row(self) -> Dict[str, Any]:
        row: Dict[str, Any] = {
            "point_id": self.point.point_id,
            "kind": self.point.kind,
            "section": self.point.effective_section,
            "spec": dict(self.point.spec),
            "provenance": self.provenance,
            "data": self.data,
        }
        if self.error:
            row["error"] = self.error
        if self.telemetry:
            row["telemetry"] = self.telemetry
        if self.duration_seconds:
            row["duration_seconds"] = round(self.duration_seconds, 2)
        return row


def run_key_for(points: Sequence[BenchPoint]) -> str:
    payload = json.dumps(sorted((p.point_id, p.config_hash())
                                for p in points))
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


class BenchOrchestrator:
    def __init__(self, points: Sequence[BenchPoint],
                 repo_dir: Optional[str] = None,
                 cache_path: Optional[str] = None,
                 journal_path: Optional[str] = None,
                 total_budget_seconds: Optional[float] = None,
                 env: Optional[Dict[str, str]] = None):
        self.points = ordered(points)
        self.repo_dir = repo_dir or os.getcwd()
        self.cache = ResultCache(cache_path)
        self.run_key = run_key_for(self.points)
        self.journal = RunJournal(journal_path, self.run_key)
        self.total_budget_seconds = total_budget_seconds
        self.env = env

    # ---- one point -------------------------------------------------------

    def _spawn(self, point: BenchPoint, timeout: float):
        """Run the point's worker under the watchdog.

        Returns (result_dict_or_None, timed_out, returncode, stderr_tail).
        communicate() after kill() is safe on POSIX — the child is dead,
        so the remaining pipe content drains without a second timeout.
        """
        cmd = [sys.executable, "-m", "vodascheduler_tpu_torch.benchrunner.worker",
               json.dumps({"point_id": point.point_id, "kind": point.kind,
                           "spec": dict(point.spec)})]
        # errors="replace": a SIGKILL can cut the child's output mid
        # multi-byte character; strict decoding would throw out of run()
        # and collapse the whole section — the failure mode this plane
        # exists to eliminate.
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                errors="replace",
                                cwd=self.repo_dir, env=self.env)
        timed_out = False
        try:
            stdout, stderr = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            timed_out = True
            proc.kill()
            stdout, stderr = proc.communicate()
        result = None
        for line in (stdout or "").splitlines():
            if line.startswith(RESULT_PREFIX):
                try:
                    result = json.loads(line[len(RESULT_PREFIX):])
                except ValueError:
                    pass  # torn line from the kill: treat as no result
        return result, timed_out, proc.returncode, (stderr or "").strip()[-400:]

    def _backfill(self, point: BenchPoint, reason: str,
                  error: Optional[str], duration: float) -> PointResult:
        """A point that produced no live measurement: cached row (tagged)
        if a same-config one exists, else an explicit skip."""
        self.journal.point_failed(point.point_id, reason)
        hit = self.cache.get(point.point_id, point.config_hash())
        if hit and hit.get("data") is not None:
            return PointResult(
                point, f"{CACHED}:{hit['captured_at']}", data=hit["data"],
                error=error, duration_seconds=duration)
        return PointResult(point, f"{SKIPPED}:{reason}", error=error,
                           duration_seconds=duration)

    # ---- the run ---------------------------------------------------------

    def run(self) -> Dict[str, Any]:
        resumable = self.journal.load_resumable()
        self.journal.open(resumed_count=len(resumable))
        deadline = (time.monotonic() + self.total_budget_seconds
                    if self.total_budget_seconds else None)
        results: List[PointResult] = []
        for point in self.points:
            prior = resumable.get(point.point_id)
            if prior is not None and prior.get("config_hash") == \
                    point.config_hash() and prior.get("data") is not None:
                # Measured by the interrupted run this journal records —
                # same config, same logical run, so it is `measured`.
                results.append(PointResult(point, MEASURED,
                                           data=prior["data"]))
                continue
            remaining = (deadline - time.monotonic()) if deadline else None
            if remaining is not None and remaining < 5.0:
                results.append(self._backfill(
                    point, "budget_exhausted", None, 0.0))
                continue
            timeout = point.timeout
            if remaining is not None:
                timeout = min(timeout, remaining)
            t0 = time.monotonic()
            try:
                result, timed_out, rc, stderr_tail = self._spawn(point,
                                                                 timeout)
            except OSError as e:
                results.append(self._backfill(
                    point, "spawn_failed", f"{type(e).__name__}: {e}", 0.0))
                continue
            duration = time.monotonic() - t0
            if timed_out:
                results.append(self._backfill(
                    point, f"watchdog_timeout({timeout:.0f}s)",
                    stderr_tail or None, duration))
                continue
            if result is None or rc != 0:
                results.append(self._backfill(
                    point, f"worker_exit(rc={rc})",
                    stderr_tail or "no result line", duration))
                continue
            if result.get("error"):
                results.append(self._backfill(
                    point, "point_error", result["error"], duration))
                continue
            data = result.get("data")
            if data is None:
                results.append(self._backfill(
                    point, "empty_result", stderr_tail or None, duration))
                continue
            self.cache.put(point.point_id, point.config_hash(), data)
            self.journal.point_done(point.point_id, point.config_hash(),
                                    data)
            results.append(PointResult(point, MEASURED, data=data,
                                       telemetry=result.get("telemetry"),
                                       duration_seconds=duration))
        summary = self._summarize(results)
        self.journal.end(summary["stats"])
        return summary

    def _summarize(self, results: List[PointResult]) -> Dict[str, Any]:
        stats = {"total": len(results), "measured": 0, "cached": 0,
                 "skipped": 0}
        for r in results:
            if r.provenance == MEASURED:
                stats["measured"] += 1
            elif r.provenance.startswith(CACHED):
                stats["cached"] += 1
            else:
                stats["skipped"] += 1
        return {
            "schema": SCHEMA,
            "run_key": self.run_key,
            "captured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                         time.gmtime()),
            "rows": [r.as_row() for r in results],
            "stats": stats,
        }


# ---- consumers -----------------------------------------------------------

def validate_summary(summary: Dict[str, Any],
                     points: Sequence[BenchPoint]) -> List[str]:
    """Every registered point present exactly once and tagged. Returns the
    list of problems ([] = a complete, gap-free artifact)."""
    problems: List[str] = []
    rows = {row.get("point_id"): row for row in summary.get("rows", [])}
    if len(rows) != len(summary.get("rows", [])):
        problems.append("duplicate point_id rows")
    for p in points:
        row = rows.get(p.point_id)
        if row is None:
            problems.append(f"missing row for {p.point_id}")
            continue
        prov = row.get("provenance", "")
        if prov != MEASURED and not prov.startswith(f"{CACHED}:") \
                and not prov.startswith(f"{SKIPPED}:"):
            problems.append(f"untagged row {p.point_id}: {prov!r}")
        if (prov == MEASURED or prov.startswith(f"{CACHED}:")) \
                and row.get("data") is None:
            problems.append(f"{p.point_id} tagged {prov} but has no data")
    for pid in rows:
        if pid not in {p.point_id for p in points}:
            problems.append(f"unregistered row {pid}")
    return problems


def to_hardware_section(summary: Dict[str, Any]) -> Dict[str, Any]:
    """The bench.py `detail.hardware` shape, per-row provenance-tagged.

    Skipped rows still appear (identified by their spec, carrying the
    skip reason) — absence must be distinguishable from not-configured.
    """
    out: Dict[str, Any] = {"models": [], "attention": []}

    def entry(row: Dict[str, Any], identity: Dict[str, Any]) -> Dict[str, Any]:
        base = row.get("data")
        if base is None:
            # A skipped row is identified by its spec; debug stand-ins
            # (whose spec has no model/batch fields) fall back to the
            # point id so the row is never anonymous.
            base = {k: v for k, v in identity.items() if v is not None}
            base.setdefault("point_id", row.get("point_id"))
        e = dict(base)
        e["provenance"] = row.get("provenance", f"{SKIPPED}:unknown")
        if row.get("error"):
            e["live_error" if e["provenance"].startswith(CACHED)
              else "error"] = row["error"]
        if row.get("telemetry"):
            e["telemetry"] = row["telemetry"]
        return e

    for row in summary.get("rows", []):
        section = row.get("section") or row.get("kind")
        spec = row.get("spec", {})
        if section == "meta":
            if row.get("data"):
                out.update(row["data"])
            out["meta_provenance"] = row.get("provenance")
        elif section == "model":
            out["models"].append(entry(row, {
                "model": spec.get("model_name"),
                "batch": spec.get("global_batch_size")}))
        elif section == "attention":
            out["attention"].append(entry(row, {
                "batch": spec.get("batch"), "seq": spec.get("seq")}))
        elif section == "moe":
            out["moe"] = entry(row, {"batch": spec.get("global_batch_size")})
        elif section == "resize":
            out.setdefault("resize", []).append(entry(row, {
                "model": spec.get("model_name"),
                "batch": spec.get("global_batch_size")}))
        elif section == "ici":
            out.setdefault("ici", []).append(entry(row, {
                "ring_size": spec.get("ring_size")}))
        else:
            out.setdefault("debug", []).append(entry(row, {
                "point_id": row.get("point_id")}))
    out["benchrunner"] = {"schema": summary.get("schema"),
                          "run_key": summary.get("run_key"),
                          "captured_at": summary.get("captured_at"),
                          "stats": summary.get("stats")}
    return out
