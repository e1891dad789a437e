"""Crash-safe JSONL run journal: any interrupted run is resumable.

One line per event, appended + flushed + fsynced, so the journal is
consistent up to the last completed point no matter how the orchestrator
dies (SIGKILL mid-run, machine reset, driver timeout). On the next run
with the *same* run key (the hash of the registered point set and their
config hashes), completed points replay from the journal instead of
re-burning chip time; a different run key — any change to the point set —
starts fresh.

Line shapes:
    {"event": "run_start",  "run_key": ..., "ts": ...}
    {"event": "run_resumed","run_key": ..., "ts": ..., "reused": N}
    {"event": "point_done", "point_id": ..., "config_hash": ..., "data": {...}}
    {"event": "point_failed", "point_id": ..., "reason": ...}
    {"event": "run_end",    "ts": ..., "stats": {...}}

Only `point_done` (a clean measurement) is reusable on resume; failed
points are retried — a flake should not become permanent.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class RunJournal:
    def __init__(self, path: Optional[str], run_key: str):
        self.path = path
        self.run_key = run_key
        self._fh = None

    # ---- resume ----------------------------------------------------------

    def load_resumable(self) -> Dict[str, Dict[str, Any]]:
        """{point_id: {"config_hash", "data"}} from an interrupted run
        with a matching run key; {} when the journal is absent, complete
        (run_end written), or from a different point set."""
        if not self.path or not os.path.exists(self.path):
            return {}
        lines = []
        try:
            with open(self.path) as f:
                for raw in f:
                    raw = raw.strip()
                    if not raw:
                        continue
                    try:
                        lines.append(json.loads(raw))
                    except ValueError:
                        continue  # torn final line from the crash: fine
        except OSError:
            return {}
        # Find the last run_start; the journal is one logical run.
        start_idx = None
        for i, line in enumerate(lines):
            if line.get("event") == "run_start":
                start_idx = i
        if start_idx is None:
            return {}
        start = lines[start_idx]
        tail = lines[start_idx + 1:]
        if start.get("run_key") != self.run_key:
            return {}
        if any(line.get("event") == "run_end" for line in tail):
            return {}  # prior run completed: measure fresh
        out: Dict[str, Dict[str, Any]] = {}
        for line in tail:
            if line.get("event") == "point_done" and line.get("point_id"):
                out[line["point_id"]] = {
                    "config_hash": line.get("config_hash"),
                    "data": line.get("data"),
                }
        return out

    # ---- writing ---------------------------------------------------------

    def open(self, resumed_count: int = 0) -> None:
        if not self.path:
            return
        try:
            d = os.path.dirname(self.path) or "."
            os.makedirs(d, exist_ok=True)
            if resumed_count:
                self._fh = open(self.path, "a")
                self._append({"event": "run_resumed", "run_key": self.run_key,
                              "ts": time.time(), "reused": resumed_count})
            else:
                self._fh = open(self.path, "w")
                self._append({"event": "run_start", "run_key": self.run_key,
                              "ts": time.time()})
        except OSError:
            self._fh = None  # read-only checkout: run without a journal

    def point_done(self, point_id: str, config_hash: str,
                   data: Dict[str, Any]) -> None:
        self._append({"event": "point_done", "point_id": point_id,
                      "config_hash": config_hash, "data": data})

    def point_failed(self, point_id: str, reason: str) -> None:
        self._append({"event": "point_failed", "point_id": point_id,
                      "reason": reason})

    def end(self, stats: Dict[str, Any]) -> None:
        self._append({"event": "run_end", "ts": time.time(), "stats": stats})
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None

    def _append(self, line: Dict[str, Any]) -> None:
        if self._fh is None:
            return
        try:
            self._fh.write(json.dumps(line) + "\n")
            self._fh.flush()
            os.fsync(self._fh.fileno())
        except (OSError, ValueError):
            pass
