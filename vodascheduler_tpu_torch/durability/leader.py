"""Lease-based leader election with fencing epochs
(doc/durability.md "Leadership").

One JSON lease file names the current leader: `{holder, epoch,
expires}`, written atomically (tmp + rename). A holder renews before
`expires`; a standby polls and takes over the moment the lease
expires, bumping the EPOCH — the fencing token every journal append
carries. A deposed leader (paused, partitioned, wedged mid-GC) that
wakes up and tries to write finds the epoch moved and gets
`FencedOut` (journal.py) instead of interleaving stale state: the
journal is fenced at the write, and recovery additionally drops any
stale-epoch record a buggy writer managed to land (recover.read_state)
— belt and braces, both model-checked.

`MemoryLease` is the same contract over a shared dict for the model
checker and hermetic tests (no filesystem, deterministic under a
VirtualClock).
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import os
import tempfile
import threading
from typing import Optional

from vodascheduler_tpu_torch.common.clock import Clock


class LeaseHeld(Exception):
    """try_acquire found a live, unexpired lease held by someone else."""


class MemoryLease:
    """In-process lease: the model checker's leadership substrate.
    `advance_epoch()` simulates a standby takeover (the fence action)."""

    def __init__(self, holder: str = "leader", epoch: int = 1) -> None:
        self.holder = holder
        self.epoch = int(epoch)
        self._lock = threading.Lock()

    def current_epoch(self) -> int:
        with self._lock:
            return self.epoch

    def advance_epoch(self, holder: str = "standby") -> int:
        """Takeover: a new holder at epoch+1 — every journal handle
        still carrying the old epoch is deposed from this instant."""
        with self._lock:
            self.epoch += 1
            self.holder = holder
            return self.epoch


class FileLease:
    """File-backed lease for real deployments (see module doc).

    All timestamps come from the injected Clock, so a VirtualClock test
    drives expiry deterministically. The lease file is tiny and
    re-read on every `current_epoch()` call — the fencing check is one
    stat+read, paid per journal append (or amortized by the journal's
    caller; the appends on the 10k decide path are measured by
    perf_scale's recovery column)."""

    def __init__(self, path: str, holder: str,
                 ttl_seconds: float = 15.0,
                 clock: Optional[Clock] = None) -> None:
        self.path = os.path.abspath(path)
        self.holder = holder
        self.ttl_seconds = float(ttl_seconds)
        self.clock = clock or Clock()
        self.epoch = 0
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)

    # ---- file plumbing ----------------------------------------------------

    def read(self) -> Optional[dict]:
        try:
            with open(self.path, encoding="utf-8") as f:
                return json.load(f)
        except (FileNotFoundError, ValueError):
            return None

    def _write(self, doc: dict) -> None:
        d = os.path.dirname(self.path) or "."
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".lease-")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    @contextlib.contextmanager
    def _claim(self):
        """Serialize the lease's read-modify-write across PROCESSES:
        an flock on a sibling `.lock` file (released automatically on
        process death — no stale claim token to garbage-collect). Two
        standbys racing an expired lease would otherwise both read
        epoch N and both write epoch N+1 — two live leaders with the
        SAME fencing token, the split brain the epoch exists to
        prevent."""
        fd = os.open(self.path + ".lock", os.O_WRONLY | os.O_CREAT, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            os.close(fd)  # closing releases the flock

    # ---- the lease protocol -----------------------------------------------

    def current_epoch(self) -> int:
        """The fencing token: the on-file epoch (0 = no lease yet).
        Journal handles compare their own epoch against this."""
        doc = self.read()
        return int(doc.get("epoch", 0)) if doc else 0

    def try_acquire(self) -> int:
        """Acquire if the lease is free, expired, or already ours.
        A takeover (expired lease, different holder) bumps the epoch;
        re-acquiring our own lease keeps it. Raises LeaseHeld when a
        live lease belongs to someone else. The whole
        read-check-bump-write runs under the cross-process claim
        lock (see _claim)."""
        with self._claim():
            now = self.clock.now()
            doc = self.read()
            if doc and doc.get("holder") != self.holder \
                    and float(doc.get("expires", 0)) > now:
                raise LeaseHeld(
                    f"lease held by {doc.get('holder')!r} until "
                    f"{doc.get('expires')} (epoch {doc.get('epoch')})")
            prev_epoch = int(doc.get("epoch", 0)) if doc else 0
            if doc and doc.get("holder") == self.holder:
                self.epoch = prev_epoch
            else:
                self.epoch = prev_epoch + 1
            self._write({"holder": self.holder, "epoch": self.epoch,
                         "expires": now + self.ttl_seconds})
            return self.epoch

    def renew(self) -> bool:
        """Extend our lease. Returns False — WITHOUT rewriting the
        file — if the lease is no longer ours (a standby took over);
        the caller is deposed and its journal will fence on the next
        append anyway."""
        with self._claim():
            doc = self.read()
            if not doc or doc.get("holder") != self.holder \
                    or int(doc.get("epoch", 0)) != self.epoch:
                return False
            self._write({"holder": self.holder, "epoch": self.epoch,
                         "expires": self.clock.now() + self.ttl_seconds})
            return True

    def release(self) -> None:
        """Drop our lease (clean shutdown): expire it immediately so a
        standby takes over without waiting out the TTL."""
        with self._claim():
            doc = self.read()
            if doc and doc.get("holder") == self.holder:
                self._write({"holder": self.holder, "epoch": self.epoch,
                             "expires": self.clock.now()})

    def announce(self, journal, op: str = "acquire") -> None:
        """Append the lease milestone to the journal (`jlease`): the
        durable audit of who led when, at which epoch."""
        doc = self.read() or {}
        journal.append("jlease", {"op": op, "holder": self.holder,
                                  "expires": doc.get("expires", 0.0)})
