"""Persistent per-point result cache with provenance.

The cache survives across rounds: every cleanly measured point is written
through immediately (atomic replace), so a crash — or a wedge that eats
the rest of the budget — still leaves earlier points available to
back-fill the *next* run's gaps. A back-filled row is never silent: the
orchestrator tags it `cached_from:<captured_at>` so driver-stamped
artifacts distinguish live evidence from replayed evidence per row (the
whole-section `cached_from` of the r4/r5 bench could only say "everything
here is stale", which is exactly wrong when one point wedged).

Keying is (point_id, config_hash): a cached row only back-fills a point
whose kind+spec serialize identically to when it was measured. A changed
batch size, model config, or point definition silently invalidates the
entry — stale-config replay is worse than an honest `skipped:` tag.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class ResultCache:
    def __init__(self, path: Optional[str]):
        self.path = path
        self._entries: Dict[str, Dict[str, Any]] = {}
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    raw = json.load(f)
                entries = raw.get("points", {})
                if isinstance(entries, dict):
                    self._entries = entries
            except (OSError, ValueError):
                # A torn/corrupt cache yields an empty one, never a crash:
                # the bench must run without fallback data rather than not
                # run at all.
                self._entries = {}

    def get(self, point_id: str, config_hash: str) -> Optional[Dict[str, Any]]:
        """{"captured_at", "data"} for a same-config hit, else None."""
        entry = self._entries.get(point_id)
        if not entry or entry.get("config_hash") != config_hash:
            return None
        return {"captured_at": entry.get("captured_at", "unknown"),
                "data": entry.get("data")}

    def put(self, point_id: str, config_hash: str,
            data: Dict[str, Any]) -> None:
        self._entries[point_id] = {
            "config_hash": config_hash,
            "captured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                         time.gmtime()),
            "data": data,
        }
        self._write()

    def _write(self) -> None:
        if not self.path:
            return
        payload = {
            "note": ("Benchrunner per-point result cache; measured rows "
                     "only. Back-fills still-missing points in later runs "
                     "with an explicit per-row cached_from tag."),
            "points": self._entries,
        }
        try:
            d = os.path.dirname(self.path) or "."
            os.makedirs(d, exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=1)
            os.replace(tmp, self.path)
        except OSError:
            pass  # read-only checkout: live results still flow
