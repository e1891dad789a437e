"""Crash-safe write-ahead journal (doc/durability.md).

One `Journal` is one pool's durable mutation log: every record is a
single framed line —

    <payload-length> <crc32-hex> <compact-json-payload>\\n

appended through an O_APPEND fd (POSIX short appends are atomic, the
same idiom as the obs JSONL sink), so concurrent writers interleave
whole frames and a torn tail (the write a crash cut short) is
*detectable*: the reader validates length and checksum and drops a
broken FINAL record; a broken record with valid records after it means
real corruption, not a crash, and fails loudly (`JournalCorrupt`) —
recovery restores a consistent prefix or refuses, never half-applies.

Write-ahead discipline: callers append BEFORE applying the mutation
(lifecycle.transition stores `job.status` only after its `jstatus`
record is framed; `BookingLedger` mutators append before touching the
table), so at every crash point the journal is a superset of the
applied state minus at most the in-flight action — the property the
model checker's crash profile verifies exhaustively.

Fencing: every record carries its writer's `epoch` (the leadership
lease's fencing token, leader.py). `append` re-reads the current epoch
through the `fence` callback and raises `FencedOut` — latching
`self.fenced` so the deposed scheduler stops itself — when a newer
leader holds the lease; replay (recover.read_state) additionally DROPS
any record whose epoch regressed, so even a journal written by a buggy
deposed leader can't interleave stale state into recovery.

Durability model: an O_APPEND write survives *process* death (kill -9)
via the page cache without fsync; surviving *host* death needs
`fsync=True` (VODA_JOURNAL_FSYNC=1), which pays a disk flush per
record. The default is process-crash durability — the failure mode a
scheduler restart actually is.

The record-kind vocabulary is CLOSED (obs.audit.JOURNAL_KINDS, checked
both ways by vodalint): `append` rejects unknown kinds at write time,
so the journal can never grow records recovery doesn't understand.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import zlib
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from vodascheduler_tpu_torch.common.clock import Clock
from vodascheduler_tpu_torch.obs import audit as obs_audit

# One decoder, reused: parse_frames decodes ~100k payloads on a 10k-job
# cold recovery, and json.loads on BYTES pays a detect_encoding probe
# per call — decoding the payload once and handing the str to a shared
# decoder measurably trims the replay tail (the recovery fastpath,
# doc/durability.md "Hot standby").
_DECODER = json.JSONDecoder()


class JournalCorrupt(Exception):
    """Mid-file corruption: a broken record with valid records after it.
    A torn TAIL is a crash artifact and is dropped; this is not — the
    journal cannot be trusted and recovery must refuse, loudly."""


class FencedOut(Exception):
    """An append by a deposed leader: the lease's fencing epoch moved
    past this journal handle's. The handle latches `fenced` so the
    scheduler can stop itself instead of retrying forever."""


class SimulatedCrash(BaseException):
    """Deterministic mid-append process death for the model checker's
    crash profile (MemoryStorage.crash_after). BaseException on
    purpose: the scheduler's per-job failure isolation catches
    Exception, and a simulated kill -9 must tear through it exactly
    like a real one."""


class MemoryStorage:
    """In-memory journal bytes for the model checker: same framing,
    same torn-tail semantics, no filesystem — thousands of prefix
    replays stay fast and hermetic. `crash_after(n)` arms a
    deterministic death at the n-th append from now: half the frame is
    written (the torn tail a real crash leaves) and `SimulatedCrash`
    is raised."""

    def __init__(self) -> None:
        self.data = bytearray()
        self._crash_in: Optional[int] = None
        self._dead = False

    def crash_after(self, appends: int) -> None:
        self._crash_in = max(0, int(appends))

    def disarm(self) -> bool:
        """Cancel an armed crash that never fired (the action made
        fewer appends than the trigger); returns whether it was still
        armed."""
        armed = self._crash_in is not None
        self._crash_in = None
        return armed

    def revive(self) -> None:
        """Recovery replaced the process: the storage takes appends
        again (the new leader's journal handle)."""
        self._dead = False

    def append(self, line: bytes) -> None:
        if self._dead:
            # The simulated process is dead: nothing that runs after
            # the crash (finally blocks, exception handlers) may land
            # bytes a real kill -9 would have lost.
            raise SimulatedCrash("append after simulated process death")
        if self._crash_in is not None:
            self._crash_in -= 1
            if self._crash_in <= 0:
                # Dies ON the n-th append from arming (crash_after(1)
                # = the very next append). Torn write: a crash
                # mid-append persists a prefix of the frame — exactly
                # what recovery must drop.
                self._crash_in = None
                self._dead = True
                self.data.extend(line[: max(1, len(line) // 2)])
                raise SimulatedCrash("journal append died mid-write")
        self.data.extend(line)

    def read(self, offset: int = 0) -> bytes:
        return bytes(self.data[offset:] if offset else self.data)

    def replace(self, data: bytes) -> None:
        self.data = bytearray(data)

    def size(self) -> int:
        return len(self.data)

    def sync(self) -> None:
        pass


class FileStorage:
    """O_APPEND file storage (production). The fd is opened once and
    kept; every append is one write() syscall of a whole frame."""

    def __init__(self, path: str, fsync: bool = False) -> None:
        self.path = os.path.abspath(path)
        self.fsync = fsync
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._fd: Optional[int] = None
        self._broken = False

    def _ensure_fd(self) -> int:
        if self._fd is None:
            self._fd = os.open(self.path,
                               os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        return self._fd

    def append(self, line: bytes) -> None:
        if self._broken:
            # A prior append landed only part of its frame (short
            # write / ENOSPC). Appending MORE would turn that torn
            # tail into mid-file corruption — the unrecoverable shape.
            # Stay loud until a reopen trims the tail.
            raise OSError(
                "journal storage broken by a prior short write; "
                "reopen the journal to trim the torn tail")
        fd = self._ensure_fd()
        written = 0
        try:
            while written < len(line):
                n = os.write(fd, line[written:])
                if n <= 0:
                    raise OSError(
                        f"short journal write ({written}/{len(line)} "
                        f"bytes)")
                written += n
        except OSError:
            if 0 < written < len(line):
                self._broken = True
            raise
        if self.fsync:
            os.fsync(fd)

    def read(self, offset: int = 0) -> bytes:
        try:
            with open(self.path, "rb") as f:
                if offset:
                    f.seek(offset)
                return f.read()
        except FileNotFoundError:
            return b""

    def replace(self, data: bytes) -> None:
        """Atomic whole-file rewrite (compaction): tmp + rename, then
        reopen the append fd so subsequent appends land in the new
        generation."""
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        # vodarace: ignore[unguarded-shared-write] replace() runs on the
        # journal owner's thread (compaction fold under the scheduler
        # lock, or single-threaded recovery); _broken/_fd are that
        # owner's file-handle state
        self._broken = False
        if self._fd is not None:
            os.close(self._fd)
            # vodarace: ignore[unguarded-shared-write] same owner-thread
            # file-handle state as _broken above
            self._fd = None

    def size(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def sync(self) -> None:
        if self._fd is not None:
            os.fsync(self._fd)

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None


class _BatchAppend:
    """One active Journal.batch(): the framed bytes awaiting their
    single flush, plus the payload dicts for a fold caller."""

    __slots__ = ("buffer", "records", "consumed", "fence_checked")

    def __init__(self) -> None:
        self.buffer = bytearray()
        self.records: List[dict] = []
        self.consumed = False
        self.fence_checked = False

    def consume(self) -> List[dict]:
        """Take the buffered records and suppress the flush — the
        caller is folding them into a snapshot instead (the records'
        seqs are covered by the snapshot's last_seq, so replay loses
        nothing)."""
        self.consumed = True
        return self.records


def frame(payload: bytes) -> bytes:
    """One framed journal line: length, crc32, payload."""
    return (b"%d %08x " % (len(payload), zlib.crc32(payload))
            + payload + b"\n")


def parse_frames(data: bytes) -> Tuple[List[dict], int, Optional[str]]:
    """Parse framed bytes into records.

    Returns (records, torn_tail_count, corrupt_reason): a broken final
    frame (short payload, bad checksum, truncated line) counts as torn
    tail and is dropped; a broken frame FOLLOWED by a valid one is
    mid-file corruption and sets `corrupt_reason` (the caller raises
    JournalCorrupt — never silently resynchronize).

    Decode strategy: frames are validated (length/terminator/crc32)
    one by one, but their payloads — compact JSON objects by
    construction — are decoded in ONE C-parser call as a joined JSON
    array. On a 10k-job journal the per-record json.loads loop was the
    single largest replay cost; the batch decode cuts it ~4x. A
    payload that passes its checksum but fails the array decode (never
    written by this journal) falls back to per-record decoding so the
    error is localized, not silently dropped."""
    payloads: List[bytes] = []
    torn = 0
    offset = 0
    n = len(data)
    while offset < n:
        bad: Optional[str] = None
        ok = False
        next_offset = n
        header_end = data.find(b" ", offset)
        if header_end < 0 or not data[offset:header_end].isdigit():
            bad = "unparseable frame header"
        else:
            try:
                length = int(data[offset:header_end])
                crc_end = header_end + 9
                crc = int(data[header_end + 1:crc_end], 16)
                payload = data[crc_end + 1:crc_end + 1 + length]
                next_offset = crc_end + 1 + length + 1
                if len(payload) < length:
                    bad = "truncated payload"
                elif next_offset > n or data[next_offset - 1:next_offset] != b"\n":
                    bad = "missing frame terminator"
                elif zlib.crc32(payload) != crc:
                    bad = "checksum mismatch"
                else:
                    ok = True
            except (ValueError, IndexError):
                bad = "unparseable frame"
        if not ok and bad is not None:
            # Torn tail only if NOTHING valid follows; scan forward for
            # a parseable frame — finding one means mid-file corruption.
            rest = data[offset:]
            nl = rest.find(b"\n")
            while nl >= 0:
                tail_recs, _, tail_bad = parse_frames(rest[nl + 1:])
                if tail_recs and tail_bad is None:
                    records, decode_bad = _decode_payloads(payloads)
                    return records, torn, decode_bad or (
                        f"{bad} at byte {offset} with valid records after "
                        f"it (mid-file corruption, not a torn tail)")
                nl = rest.find(b"\n", nl + 1)
            torn += 1
            records, decode_bad = _decode_payloads(payloads)
            return records, torn, decode_bad
        payloads.append(payload)
        offset = next_offset
    records, decode_bad = _decode_payloads(payloads)
    return records, torn, decode_bad


def _decode_payloads(payloads: List[bytes]
                     ) -> Tuple[List[dict], Optional[str]]:
    """Batch-decode checksum-valid frame payloads (see parse_frames).
    Returns (records, corrupt_reason): a payload that passes its crc32
    but is not valid JSON was never written by this journal — it is
    reported through the same corruption channel as a bad frame (the
    clean prefix before it is kept), never raised raw out of the
    parser."""
    if not payloads:
        return [], None
    try:
        return json.loads(b"[" + b",".join(payloads) + b"]"), None
    except ValueError:
        pass
    # Localize the bad payload: decode one by one, keep the clean
    # prefix, report the precise record that is broken.
    loads = _DECODER.decode
    records: List[dict] = []
    for i, p in enumerate(payloads):
        try:
            records.append(loads(p.decode()))
        except ValueError as e:
            return records, (
                f"record {i} passed its checksum but is not valid "
                f"JSON ({e}) — not a frame this journal writes")
    return records, None


def parse_suffix(data: bytes) -> Tuple[List[dict], int, Optional[str]]:
    """Incremental parse of a LIVE journal's byte suffix (the shipping
    tailer, shipping.py): returns (records, bytes_consumed,
    corrupt_reason).

    Unlike `parse_frames`, a broken FINAL frame is not dropped — it may
    be the leader's append still in flight (or a crash's torn tail that
    the restarted leader will trim), so the tailer leaves those bytes
    unconsumed and re-reads once more arrive; framing resync happens at
    the source (a shrink/trim forces a full re-read). A broken frame
    with a valid frame after it is real corruption and sets
    `corrupt_reason` — the tailer escalates to a full re-read and only
    then raises."""
    records: List[dict] = []
    offset = 0
    n = len(data)
    loads = _DECODER.decode
    while offset < n:
        bad: Optional[str] = None
        rec = None
        next_offset = n
        header_end = data.find(b" ", offset)
        if header_end < 0:
            if n - offset > _MAX_HEADER_BYTES:
                bad = "unparseable frame header"
            else:
                break  # header still arriving: wait
        elif not data[offset:header_end].isdigit():
            bad = "unparseable frame header"
        else:
            try:
                length = int(data[offset:header_end])
                crc_end = header_end + 9
                payload = data[crc_end + 1:crc_end + 1 + length]
                next_offset = crc_end + 1 + length + 1
                if len(payload) < length or next_offset > n:
                    break  # frame still arriving: wait
                crc = int(data[header_end + 1:crc_end], 16)
                if data[next_offset - 1:next_offset] != b"\n":
                    bad = "missing frame terminator"
                elif zlib.crc32(payload) != crc:
                    bad = "checksum mismatch"
                else:
                    rec = loads(payload.decode())
            except (ValueError, IndexError):
                bad = "unparseable frame"
        if bad is not None:
            # A later valid frame decides: corruption (loud) vs a torn
            # tail that only a leader restart will trim (wait there —
            # the trim shrinks the file and the tailer resyncs).
            rest = data[offset:]
            nl = rest.find(b"\n")
            while nl >= 0:
                tail_recs, _, tail_bad = parse_frames(rest[nl + 1:])
                if tail_recs and tail_bad is None:
                    return records, offset, (
                        f"{bad} at suffix byte {offset} with valid "
                        f"records after it")
                nl = rest.find(b"\n", nl + 1)
            break  # wait for the trim (or more bytes)
        records.append(rec)
        offset = next_offset
    return records, offset, None


# A frame header is "<digits> <8-hex-chars> " — anything this long with
# no space is not a header mid-write, it is garbage.
_MAX_HEADER_BYTES = 32


class Journal:
    """One pool's write-ahead journal (see module docstring).

    `path` selects FileStorage (snapshot lands at `path + ".snap"`);
    `storage` injects MemoryStorage for the model checker. `epoch` is
    the writer's fencing token; `fence` (a zero-arg callable returning
    the lease's current epoch, leader.py) is consulted on every append.
    """

    def __init__(self, path: Optional[str] = None,
                 storage: Optional[object] = None,
                 epoch: int = 1,
                 fence: Optional[Callable[[], int]] = None,
                 clock: Optional[Clock] = None,
                 fsync: bool = False,
                 compact_bytes: int = 8 * 1024 * 1024,
                 retire_retention_seconds: Optional[float] = None,
                 resume_hint: Optional[Dict[str, int]] = None) -> None:
        if storage is None:
            if path is None:
                storage = MemoryStorage()
            else:
                storage = FileStorage(path, fsync=fsync)
        self.storage = storage
        self.path = path
        self.epoch = int(epoch)
        self._fence = fence
        self.fenced = False
        self.clock = clock or Clock()
        self.compact_bytes = int(compact_bytes)
        # Tombstone retention horizon (doc/durability.md "Known
        # bounds"): snapshot folds prune `retired`/`granted` entries
        # older than this, so a long-lived journal's snapshot stops
        # growing with lifetime job count. None = config default.
        if retire_retention_seconds is None:
            from vodascheduler_tpu_torch import config as _config
            retire_retention_seconds = _config.JOURNAL_RETIRE_RETENTION_SECONDS
        self.retire_retention_seconds = float(retire_retention_seconds)
        self._lock = threading.RLock()
        self._appends = 0
        self._torn_tail_count = 0
        # Active batch buffer (see batch()): frames land here instead of
        # the storage until the batch flushes as ONE append.
        self._batch: Optional["_BatchAppend"] = None
        # How many torn final records THIS handle trimmed at open — a
        # restarted writer must truncate the crash's half-written frame
        # before appending, or its first append would turn the torn
        # tail into mid-file corruption. Mid-file corruption found at
        # open is NOT trimmed: it stays for recovery to refuse loudly.
        self.torn_trimmed = 0
        # One parse at open, cached and keyed on the storage's byte
        # size: recovery reads the journal several times (has_state,
        # read_state) and must not pay the full-segment decode per
        # call — but a DIFFERENT handle on the same storage (a deposed
        # leader still appending through its old Journal object) must
        # invalidate this handle's view, so the cache is only trusted
        # while the bytes haven't grown.
        self._records_cache: Optional[Tuple[int, List[dict]]] = None
        if resume_hint is not None:
            # Warm open (hot-standby takeover, standby.py): the caller —
            # a tailer that has already parsed every byte — vouches for
            # the segment's clean length and last seq, so the open-time
            # full-segment parse (the dominant cost of opening a big
            # journal) is skipped. Bytes past the clean length are the
            # dead leader's torn tail: trimmed, counted, exactly like a
            # parsed open would.
            clean = int(resume_hint.get("clean_bytes", self.storage.size()))
            if self.storage.size() > clean:
                self.storage.replace(self.storage.read()[:clean])
                self.torn_trimmed = 1
            self._seq = int(resume_hint.get("last_seq", 0))
            try:
                snap = self.load_snapshot()
            except Exception:  # noqa: BLE001 - bad snapshot fails recovery loudly later
                snap = None
            if snap is not None:
                self._seq = max(self._seq, int(snap.get("last_seq", 0)))
            return
        records, torn, corrupt = parse_frames(self.storage.read())
        if torn and not corrupt:
            keep = bytearray()
            for rec in records:
                keep.extend(frame(json.dumps(
                    rec, separators=(",", ":"), default=str).encode()))
            self.storage.replace(bytes(keep))
            self.torn_trimmed = torn
        if corrupt is None:
            self._records_cache = (self.storage.size(), records)
            self._torn_tail_count = torn if not self.torn_trimmed else 0
        # Resume the sequence from whatever the journal already holds —
        # INCLUDING the snapshot's fold point: a crash in compaction's
        # truncate window (snapshot written, segment emptied, jsnap
        # append lost or torn) must not restart numbering at 1, or
        # replay's seq dedup would silently drop every post-restart
        # record as a duplicate of the snapshot's range.
        self._seq = 0
        for rec in records:
            self._seq = max(self._seq, int(rec.get("seq", 0)))
        try:
            snap = self.load_snapshot()
        except Exception:  # noqa: BLE001 - a bad snapshot fails recovery loudly later
            snap = None
        if snap is not None:
            self._seq = max(self._seq, int(snap.get("last_seq", 0)))

    # ---- write path -------------------------------------------------------

    def _check_fence(self) -> None:
        if self._fence is None:
            return
        current = self._fence()
        if current != self.epoch:
            self.fenced = True
            raise FencedOut(
                f"journal epoch {self.epoch} deposed by epoch {current}: "
                f"append rejected (a newer leader holds the lease)")

    def probe_fence(self) -> bool:
        """Actively re-check the lease WITHOUT appending; returns (and
        latches) whether this handle is deposed. The scheduler probes
        at every pass start: append-time fencing alone leaves a hole —
        a deposed leader whose pass decides a NO-OP booking delta
        (delta-encoded commit_pass appends nothing) would sail through
        to its migration wave and actuate a stale re-binding on the
        shared backend before any append could fence it (found by the
        crash profile's standby interleavings)."""
        with self._lock:
            try:
                self._check_fence()
            except FencedOut:
                return True
            return self.fenced

    def append(self, kind: str, payload: Dict[str, object]) -> int:
        """Frame and append one record; returns its seq. Raises
        FencedOut for a deposed writer, ValueError for a kind outside
        the closed obs.audit.JOURNAL_KINDS vocabulary."""
        if kind not in obs_audit.JOURNAL_KINDS:
            raise ValueError(f"unknown journal record kind {kind!r} "
                             f"(closed vocabulary: obs.audit.JOURNAL_KINDS)")
        with self._lock:
            batch = self._batch
            if batch is None or not batch.fence_checked:
                # Inside a batch the fence is checked at the BOUNDARIES
                # (first append here, flush below) instead of per
                # record: a FileLease fence is a lease-file read, and a
                # 10k-record recovery batch paying one per append put
                # seconds of pure lease reads on the takeover critical
                # path. A deposition landing mid-batch is caught at the
                # flush check BEFORE any byte lands — batch granularity
                # append-before-apply.
                self._check_fence()
                if batch is not None:
                    batch.fence_checked = True
            self._seq += 1
            rec = {"k": kind, "seq": self._seq, "epoch": self.epoch,
                   "ts": self.clock.now()}
            rec.update(payload)
            line = frame(json.dumps(rec, separators=(",", ":"),
                                    default=str).encode())
            self._records_cache = None
            if batch is not None:
                batch.buffer.extend(line)
                batch.records.append(rec)
            else:
                self.storage.append(line)
            self._appends += 1
            return self._seq

    @contextlib.contextmanager
    def batch(self):
        """Buffer appends and flush them as ONE storage write.

        The recovery fastpath (doc/durability.md "Hot standby"): a 10k-
        job reconcile re-asserts ~10k statuses, and one storage append
        per record is ~10k write() syscalls on the takeover critical
        path. Inside a batch, every `append` still validates, checks the
        fence, and assigns its seq — only the storage write is deferred,
        and the flush (in a finally, so a raising caller still lands
        what it applied) is a single append of whole frames, which
        concurrent readers parse exactly like individually-appended
        ones.

        Durability window: a kill between an in-batch append and the
        flush loses the buffered records AND the in-memory state applied
        after them (process death takes both), so recovery — which is
        idempotent over its inputs — simply re-derives them; the
        append-before-apply property callers rely on is preserved at the
        batch boundary.

        The yielded handle exposes `records` (the payload dicts, in seq
        order) and `consume()` — a fold caller (recover_scheduler) that
        serializes the batch into a SNAPSHOT instead may consume the
        buffer so the frames are never written twice."""
        with self._lock:
            if self._batch is not None:
                raise RuntimeError("journal batch already active")
            handle = _BatchAppend()
            self._batch = handle
        try:
            yield handle
        finally:
            with self._lock:
                self._batch = None
                if handle.buffer and not handle.consumed:
                    # The boundary fence check (see append): a
                    # deposition during the batch drops the whole
                    # buffer here, before any byte lands.
                    self._check_fence()
                    self.storage.append(bytes(handle.buffer))

    # ---- read path --------------------------------------------------------

    def records(self) -> List[dict]:
        """Every intact record in the active segment, torn tail
        dropped. Raises JournalCorrupt on mid-file corruption. Served
        from the open-time parse until the first mutation."""
        with self._lock:
            cache = self._records_cache
            if cache is not None and cache[0] == self.storage.size():
                records = list(cache[1])
            else:
                records, torn, corrupt = parse_frames(self.storage.read())
                if corrupt:
                    raise JournalCorrupt(corrupt)
                self._torn_tail_count = torn
                self._records_cache = (self.storage.size(), records)
                records = list(records)
            if self._batch is not None and self._batch.records:
                # An active batch's records are appended-but-unflushed:
                # a reader inside the window still sees them (they have
                # seqs; dedup-by-seq keeps a later re-read consistent).
                records.extend(self._batch.records)
            return records

    def iter_records(self) -> Iterator[dict]:
        return iter(self.records())

    def snapshot_path(self) -> Optional[str]:
        return (self.path + ".snap") if self.path else None

    def load_snapshot(self) -> Optional[dict]:
        from vodascheduler_tpu_torch.durability import snapshot as snap_mod
        return snap_mod.load_snapshot(self)

    def has_state(self) -> bool:
        """Whether there is anything to recover from: a snapshot or at
        least one intact journal record."""
        if self.load_snapshot() is not None:
            return True
        try:
            return bool(self.records())
        except JournalCorrupt:
            return True  # something is there — recovery will fail loudly

    # ---- maintenance ------------------------------------------------------

    def maybe_compact(self, force: bool = False) -> bool:
        """Fold the journal into a snapshot when the active segment has
        outgrown `compact_bytes` (doc/durability.md "Compaction"): a
        pure journal-side fold (replay-to-state, snapshot atomically,
        truncate) — no scheduler lock, appends just block on the
        journal lock for the fold's duration."""
        from vodascheduler_tpu_torch.durability import snapshot as snap_mod
        with self._lock:
            if not force and self.storage.size() < self.compact_bytes:
                return False
            snap_mod.compact(self)
            return True

    def stats(self) -> Dict[str, object]:
        """The /debug/journal surface: size, last seq, epoch, snapshot
        age, torn-tail count (doc/durability.md)."""
        snap = None
        try:
            snap = self.load_snapshot()
        except Exception:  # noqa: BLE001 - stats must not raise on a bad snap
            pass
        try:
            records = self.records()
            corrupt = None
        except JournalCorrupt as e:
            records = []
            corrupt = str(e)
        out: Dict[str, object] = {
            "enabled": True,
            "size_bytes": self.storage.size(),
            "records": len(records),
            "appends": self._appends,
            "last_seq": self._seq,
            "epoch": self.epoch,
            "fenced": self.fenced,
            "torn_tail_count": self._torn_tail_count,
            "snapshot_seq": snap.get("last_seq") if snap else None,
            "snapshot_age_seconds": (
                round(self.clock.now() - snap["ts"], 3)
                if snap and "ts" in snap else None),
        }
        if corrupt:
            out["corrupt"] = corrupt
        return out

    def size_bytes(self) -> int:
        return self.storage.size()

    def close(self) -> None:
        close = getattr(self.storage, "close", None)
        if close is not None:
            close()


def fsck(path: str) -> Dict[str, object]:
    """Offline journal check (`voda fsck`, `make journal-fsck`): parse
    every frame, validate the closed kind vocabulary and seq/epoch
    monotonicity, report torn tails, and fail on mid-file corruption.
    Returns a report dict; `problems` non-empty means unhealthy."""
    problems: List[str] = []
    # Read-only on purpose: fsck must never create directories or fds
    # as a side effect (a typo'd path reports "no such journal", not a
    # freshly minted empty-and-healthy one).
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return {"path": os.path.abspath(path), "records": 0,
                "last_seq": 0, "epoch": 0, "torn_tail_count": 0,
                "duplicate_seq_count": 0, "stale_epoch_count": 0,
                "snapshot_seq": None,
                "problems": [f"no such journal: {path}"]}
    records, torn, corrupt = parse_frames(data)
    if corrupt:
        problems.append(f"corrupt: {corrupt}")
    last_seq = 0
    max_epoch = 0
    stale = 0
    dupes = 0
    for rec in records:
        kind = rec.get("k")
        if kind not in obs_audit.JOURNAL_KINDS:
            problems.append(f"seq {rec.get('seq')}: unknown kind {kind!r}")
        seq = int(rec.get("seq", 0))
        epoch = int(rec.get("epoch", 0))
        if seq <= last_seq:
            dupes += 1
            problems.append(
                f"seq {seq}: regressed/duplicated after {last_seq} "
                f"(replay would drop this record as a duplicate)")
        last_seq = max(last_seq, seq)
        if epoch < max_epoch:
            stale += 1
            problems.append(
                f"seq {seq}: epoch regressed {epoch} < {max_epoch} "
                f"(a deposed leader's write was accepted)")
        max_epoch = max(max_epoch, epoch)
    snap = None
    snap_path = path + ".snap"
    if os.path.exists(snap_path):
        try:
            with open(snap_path, encoding="utf-8") as f:
                snap = json.load(f)
        except ValueError as e:
            problems.append(f"snapshot unreadable: {e}")
    return {
        "path": os.path.abspath(path),
        "records": len(records),
        "last_seq": last_seq,
        "epoch": max_epoch,
        "torn_tail_count": torn,
        "duplicate_seq_count": dupes,
        "stale_epoch_count": stale,
        "snapshot_seq": (snap or {}).get("last_seq"),
        "problems": problems,
    }


def _selftest() -> int:
    """`make journal-fsck` teeth: build a journal with a torn tail and
    a mid-file corruption, prove fsck reports both correctly."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "selftest.wal")
        j = Journal(path=path)
        for i in range(5):
            j.append("jbook", {"op": "commit", "job": f"j{i}", "chips": i})
        j.close()
        clean = fsck(path)
        assert not clean["problems"] and clean["records"] == 5, clean
        # Torn tail: truncate mid-final-record — dropped, not a problem.
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 7)
        torn = fsck(path)
        assert torn["records"] == 4 and torn["torn_tail_count"] == 1, torn
        assert not torn["problems"], torn
        # Mid-file corruption: flip a checksum byte in record 2 — loud.
        data = bytearray(open(path, "rb").read())
        second = data.index(b"\n", data.index(b"\n") + 1)
        header = data.rindex(b" ", 0, second)
        data[header - 1] = ord("0") if data[header - 1] != ord("0") \
            else ord("1")
        open(path, "wb").write(bytes(data))
        bad = fsck(path)
        assert any("corrupt" in p for p in bad["problems"]), bad
    print("journal fsck selftest OK (torn tail dropped, mid-file "
          "corruption loud)")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="voda-journal",
        description="Offline journal fsck (doc/durability.md)")
    parser.add_argument("path", nargs="?", default=None,
                        help="journal file (<workdir>/journal/<pool>.wal)")
    parser.add_argument("--selftest", action="store_true",
                        help="prove fsck catches torn tails and mid-file "
                             "corruption on a synthetic journal")
    args = parser.parse_args(argv)
    if args.selftest:
        return _selftest()
    if not args.path:
        parser.error("path required (or --selftest)")
    report = fsck(args.path)
    print(json.dumps(report, indent=1, default=str))
    return 1 if report["problems"] else 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
