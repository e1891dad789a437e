"""Per-epoch metrics CSV: the contract between training jobs and the
metrics collector.

Reference counterpart: examples/py/tensorflow2/callbacks.py
(MetricsCSVLogger) — one row per epoch with epoch number, epoch/step time,
and current worker count, appended to `<metrics_dir>/<job>.csv`. The CSV
doubles as the resume-epoch source on restart (callbacks.py:58-66): the
runtime replays it to find where training left off.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List

FIELDS = [
    "epoch", "epoch_time_sec", "step_time_sec", "workers",
    "global_batch_size", "local_batch_size", "start_time", "total_epochs",
    # Placement context (doc/learned-models.md): the normalized spread
    # of the incarnation's host set and the chip-weighted co-tenancy of
    # its hosts, stamped by the backend at spawn (VODA_PLACEMENT_SPREAD
    # / VODA_PLACEMENT_COTENANCY). Without them every real-mode row
    # reads as contiguous/exclusive and the collector's burden
    # deflation and fraction estimators stay silent.
    "spread", "cotenancy",
]


class EpochCsvLogger:
    """Appends one row per completed epoch; replays existing rows on
    construction so `next_epoch` survives restarts."""

    def __init__(self, metrics_dir: str, job_name: str, total_epochs: int,
                 global_batch_size: int = 0):
        self.path = os.path.join(metrics_dir, f"{job_name}.csv")
        self.job_name = job_name
        self.total_epochs = total_epochs
        self.global_batch_size = global_batch_size
        os.makedirs(metrics_dir, exist_ok=True)
        self.next_epoch = 0
        if os.path.exists(self.path):
            self._migrate_header()
            rows = read_epoch_csv(self.path)
            if rows:
                self.next_epoch = int(rows[-1]["epoch"]) + 1

    def _migrate_header(self) -> None:
        """Rewrite a pre-upgrade CSV whose header lacks columns FIELDS
        has since grown (spread/cotenancy): appending wider rows under
        the old header would push the new values into DictReader's
        restkey — silently lost — and read as ragged to strict parsers.
        Old rows get the missing columns empty (read back as 0.0)."""
        with open(self.path, newline="") as f:
            reader = csv.DictReader(f)
            header = reader.fieldnames
            if header is None or set(FIELDS) <= set(header):
                return
            rows = list(reader)
        tmp = self.path + ".tmp"
        with open(tmp, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=FIELDS, extrasaction="ignore")
            w.writeheader()
            for r in rows:
                w.writerow({k: r.get(k, "") for k in FIELDS})
        os.replace(tmp, self.path)

    def log_epoch(self, epoch_time_sec: float, step_time_sec: float,
                  workers: int, start_time: str = "",
                  spread: float = 0.0, cotenancy: float = 0.0) -> None:
        new_file = not os.path.exists(self.path) or os.path.getsize(self.path) == 0
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=FIELDS)
            if new_file:
                w.writeheader()
            local = (self.global_batch_size // workers
                     if workers > 0 and self.global_batch_size else 0)
            w.writerow({
                "epoch": self.next_epoch,
                "epoch_time_sec": f"{epoch_time_sec:.6f}",
                "step_time_sec": f"{step_time_sec:.6f}",
                "workers": workers,
                "global_batch_size": self.global_batch_size,
                "local_batch_size": local,
                "start_time": start_time,
                "total_epochs": self.total_epochs,
                "spread": f"{spread:.4f}",
                "cotenancy": f"{cotenancy:.4f}",
            })
        self.next_epoch += 1


def read_epoch_csv(path: str) -> List[Dict[str, str]]:
    if not os.path.exists(path):
        return []
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def resume_epoch(path: str) -> int:
    """First epoch still to run, per the CSV (0 if no history)."""
    rows = read_epoch_csv(path)
    return int(rows[-1]["epoch"]) + 1 if rows else 0
