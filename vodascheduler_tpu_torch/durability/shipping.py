"""Journal shipping: a streaming tailer that follows a LIVE write-ahead
journal and feeds its records to a consumer with bounded lag
(doc/durability.md "Hot standby").

The leader never cooperates: it appends frames (journal.py) and
occasionally rewrites the whole segment (compaction fold, torn-tail
trim at restart). The tailer handles both ends of that contract purely
from the byte stream:

- **steady tail**: each poll reads the bytes past its consumed offset
  and parses only COMPLETE frames (`parse_suffix`) — a half-arrived
  frame (the leader's append in flight, or a crash's torn tail) stays
  unconsumed and is retried on the next poll, never dropped and never
  mistaken for corruption;
- **framing-aware resync**: a segment that SHRANK (compaction truncated
  it, or a restarted leader trimmed a torn tail), or whose bytes at the
  consumed offset stop parsing (a rewrite landed mid-poll), forces a
  full re-read — reload the snapshot (a fold may have serialized
  records that never existed as frames, so the consumer must take the
  snapshot when it is AHEAD), then re-feed the segment; the consumer's
  seq dedup (recover.StandbyApplier) makes the overlap harmless. Only
  bytes that stay unparseable across a full re-read are real
  corruption, raised loudly;
- **bounded lag**: `records_behind` — how many records the last poll
  had to catch up — is the `voda_standby_apply_lag_records` gauge: a
  standby polling on its cadence holds it near zero, and the takeover
  budget's suffix drain is exactly one more poll.

Sources abstract WHERE the bytes come from: the leader's own filesystem
(`FileTailSource`, shared-disk standby), the model checker's in-memory
storage (`StorageTailSource`), or another host over the leader's REST
surface (`HttpTailSource` against `GET /journal/segment` +
`GET /journal/snapshot` — the shipped-segment fetch path that lets a
cross-host standby bootstrap from snapshot + suffix without a shared
filesystem).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Tuple

from vodascheduler_tpu_torch.durability.journal import (
    JournalCorrupt,
    parse_frames,
    parse_suffix,
)


class FileTailSource:
    """Tail a journal file on a filesystem this process can read (the
    shared-disk standby: same workdir, different process/host mount)."""

    def __init__(self, path: str) -> None:
        self.path = os.path.abspath(path)

    def size(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def read(self, offset: int = 0) -> bytes:
        try:
            with open(self.path, "rb") as f:
                if offset:
                    f.seek(offset)
                return f.read()
        except FileNotFoundError:
            return b""

    def snapshot(self) -> Optional[dict]:
        try:
            with open(self.path + ".snap", encoding="utf-8") as f:
                return json.load(f)
        except (FileNotFoundError, ValueError):
            return None


class StorageTailSource:
    """Tail a Journal storage object directly (MemoryStorage in the
    model checker and hermetic tests; any storage with read()/size())."""

    def __init__(self, storage) -> None:
        self.storage = storage

    def size(self) -> int:
        return self.storage.size()

    def read(self, offset: int = 0) -> bytes:
        return self.storage.read(offset)

    def snapshot(self) -> Optional[dict]:
        return getattr(self.storage, "snapshot", None)


class HttpTailSource:
    """Tail a remote leader's journal over its scheduler REST surface
    (`GET /journal/segment?pool=&offset=` + `GET /journal/snapshot?pool=`,
    rest.py) — the cross-host shipping path: a standby with no shared
    filesystem bootstraps from the fetched snapshot and follows the
    fetched suffix. Fetch errors surface as an empty read (the standby
    keeps its state and retries on its poll cadence; a DEAD leader is
    exactly when the standby stops needing it)."""

    def __init__(self, base_url: str, pool: str,
                 timeout: float = 10.0) -> None:
        self.base_url = base_url.rstrip("/")
        self.pool = pool
        self.timeout = timeout
        self._last_size = 0

    def _get(self, path: str) -> bytes:
        import urllib.request
        from urllib.parse import quote

        url = (f"{self.base_url}{path}"
               f"{'&' if '?' in path else '?'}pool="
               f"{quote(self.pool, safe='')}")
        with urllib.request.urlopen(url, timeout=self.timeout) as resp:
            return resp.read()

    def size(self) -> int:
        try:
            doc = json.loads(self._get("/journal/segment?stat=1"))
            self._last_size = int(doc.get("size_bytes", 0))
        except Exception:  # noqa: BLE001 - unreachable leader: hold position
            pass
        return self._last_size

    def read(self, offset: int = 0) -> bytes:
        try:
            return self._get(f"/journal/segment?offset={int(offset)}")
        except Exception:  # noqa: BLE001 - unreachable leader: hold position
            return b""

    def snapshot(self) -> Optional[dict]:
        try:
            data = self._get("/journal/snapshot")
            return json.loads(data) if data.strip() else None
        except Exception:  # noqa: BLE001 - unreachable leader: hold position
            return None


class JournalTailer:
    """Follow one live journal and feed a consumer (see module doc).

    `consumer(record)` is called for every parsed frame in stream
    order; `bootstrap(snapshot_dict)` is called on first poll and on
    every resync that surfaces a snapshot (the consumer decides whether
    it is ahead of its own state — recover.StandbyApplier.bootstrap).
    """

    def __init__(self, source, consumer: Callable[[dict], object],
                 bootstrap: Optional[Callable[[Optional[dict]], object]]
                 = None) -> None:
        self.source = source
        self.consumer = consumer
        self._bootstrap = bootstrap
        self.offset = 0
        self.records_fed = 0
        self.records_behind = 0
        self.resyncs = 0
        self.polls = 0
        self._bootstrapped = False
        # Seq continuity guard: the journal's single writer allocates
        # seqs monotonically +1, so the incremental tail must see a
        # contiguous run. A discontinuity at the consumed offset means
        # the segment was REWRITTEN under us without shrinking (a
        # compaction fold that regrew past our offset between polls) —
        # the byte-aliased frames would parse cleanly while silently
        # skipping the records in between, so a gap forces a resync.
        self._next_seq: Optional[int] = None

    def poll(self) -> int:
        """Parse and feed every complete frame past the consumed
        offset; returns how many records were fed (also retained as
        `records_behind` — the apply-lag sample)."""
        self.polls += 1
        if not self._bootstrapped:
            self._bootstrapped = True
            if self._bootstrap is not None:
                self._bootstrap(self.source.snapshot())
        size = self.source.size()
        if size < self.offset:
            # The segment shrank under us: compaction fold or a
            # torn-tail trim rewrote it — full framing resync.
            return self._resync()
        if size == self.offset:
            self.records_behind = 0
            return 0
        data = self.source.read(self.offset)
        records, consumed, corrupt = parse_suffix(data)
        if corrupt is not None:
            # Mid-suffix garbage: either a rewrite landed between our
            # size probe and the read, or real corruption. A full
            # re-read decides — resync parses the whole segment from
            # byte 0 and only raises if THAT is broken too.
            return self._resync()
        if records and self._next_seq is not None \
                and int(records[0].get("seq", 0)) != self._next_seq:
            # Clean parse but discontinuous seqs: a same-or-larger
            # rewrite aliased our offset onto a new generation's frame
            # boundary — the only safe continuation is a full resync
            # (seq dedup drops the overlap; the reloaded snapshot
            # covers anything the fold consumed).
            return self._resync()
        for rec in records:
            self.consumer(rec)
        if records:
            self._next_seq = int(records[-1].get("seq", 0)) + 1
        self.offset += consumed
        self.records_fed += len(records)
        self.records_behind = len(records)
        return len(records)

    def _resync(self) -> int:
        """Full re-read after a segment rewrite: reload the snapshot
        (a fold may carry records that never existed as frames), then
        re-feed the whole segment — the consumer's seq dedup drops
        everything it already applied. Raises JournalCorrupt only when
        the full segment itself is broken."""
        self.resyncs += 1
        if self._bootstrap is not None:
            self._bootstrap(self.source.snapshot())
        data = self.source.read(0)
        records, torn, corrupt = parse_frames(data)
        if corrupt is not None:
            raise JournalCorrupt(
                f"shipping resync found mid-file corruption: {corrupt}")
        fed = 0
        for rec in records:
            if self.consumer(rec):
                fed += 1
        # Consumed = the clean prefix; a torn tail stays unconsumed
        # (the leader's trim will shrink the file and resync again).
        self.offset = len(data) if not torn else _clean_length(data)
        # Re-anchor the continuity guard on what THIS generation holds
        # (gaps inside a full parse are legitimate — the snapshot
        # covers the records a fold consumed).
        self._next_seq = (int(records[-1].get("seq", 0)) + 1
                          if records else None)
        self.records_fed += fed
        self.records_behind = fed
        return fed

    def clean_offset(self) -> Tuple[int, bool]:
        """(bytes consumed, whether bytes beyond them exist) — what a
        takeover hands Journal(resume_hint=) so the warm open can trim
        the dead leader's torn tail without re-parsing the segment."""
        return self.offset, self.source.size() > self.offset


def _clean_length(data: bytes) -> int:
    """Byte length of the longest clean frame prefix."""
    _, consumed, _ = parse_suffix(data)
    return consumed
