"""Journal snapshot + compaction (doc/durability.md "Compaction").

A snapshot is the journal's replayed `JournalState` serialized to one
JSON file beside the active segment (`<path>.snap`), written atomically
(tmp + fsync + rename). Compaction folds the journal into a fresh
snapshot and truncates the active segment to records AFTER the
snapshot's `last_seq`, so recovery replays O(live jobs) instead of
O(history).

Crash windows are all safe, by construction:

- crash before the snapshot rename: old snapshot + full journal —
  recovery replays more, loses nothing;
- crash after the rename, before the segment truncate: new snapshot +
  full journal — replay skips records with seq <= last_seq (seq-based
  dedup), loses nothing;
- crash mid-truncate: the rewrite is itself tmp + rename.

Tombstones survive compaction (the PR's regression class): a retired
job (`jretire` — delete/complete) is carried in the snapshot's
`retired` map, never silently dropped, so a crash-recover-compact-
crash-recover cycle cannot resurrect a deleted job. The `granted` set
(every job the journal EVER booked chips for) is carried too — the
model checker's write-ahead invariant (`recovery_unjournaled_grant`)
needs grant history across compactions.
"""

from __future__ import annotations

import json
import os
from typing import Optional

SNAPSHOT_SCHEMA = 1


def load_snapshot(journal) -> Optional[dict]:
    """The journal's latest snapshot dict, or None. Memory journals
    keep theirs on the storage object (the model checker's world)."""
    path = journal.snapshot_path()
    if path is None:
        return getattr(journal.storage, "snapshot", None)
    try:
        with open(path, encoding="utf-8") as f:
            snap = json.load(f)
    except FileNotFoundError:
        return None
    if snap.get("schema") != SNAPSHOT_SCHEMA:
        raise ValueError(
            f"snapshot schema {snap.get('schema')!r} != {SNAPSHOT_SCHEMA} "
            f"({path}): refusing to guess (recovery fails loudly)")
    return snap


def _prune_retired(state, now: float, retention: float) -> int:
    """Drop tombstones older than the retention horizon (and their
    `granted` history) at fold time — the lifetime-growth bound of
    doc/durability.md "Known bounds". A tombstone only prevents
    resurrection while a stale record of its job could still surface
    (a re-delivered event, a straggler pod the reap missed); past the
    horizon it is dead weight carried through every snapshot. Entries
    written before `retired_at` existed carry ts 0.0 and age out with
    everything else. retention <= 0 disables pruning."""
    if retention <= 0 or not state.retired:
        return 0
    horizon = now - retention
    expired = [j for j in state.retired
               if state.retired_at.get(j, 0.0) < horizon]
    for job in expired:
        del state.retired[job]
        state.retired_at.pop(job, None)
        # The granted history exists for the write-ahead invariant
        # (live jobs must have a journaled grant) and for tombstoned
        # jobs the backend might still run; a pruned tombstone's job is
        # long gone either way.
        state.granted.discard(job)
    return len(expired)


def write_snapshot(journal, state) -> dict:
    """Serialize a JournalState atomically as the journal's snapshot.

    Compact direct encoding (the recovery-fastpath profile showed
    `dataclasses.asdict` deep-copying a 10k-job state costs more than
    the serialization itself), with tombstones outside the retention
    horizon pruned at the fold (doc/durability.md "Known bounds")."""
    now = journal.clock.now()
    _prune_retired(state, now,
                   getattr(journal, "retire_retention_seconds", 0.0))
    snap = {
        "statuses": state.statuses,
        "booked": state.booked,
        # Non-JSON-native containers -> canonical JSON shapes.
        "placements": {j: [list(p) for p in pairs]
                       for j, pairs in state.placements.items()},
        "resize_at": state.resize_at,
        "retired": state.retired,
        "retired_at": state.retired_at,
        "granted": sorted(state.granted),
        "routes": state.routes,
        "models": state.models,
        "last_seq": state.last_seq,
        "epoch": state.epoch,
        "records": state.records,
        "torn_tail": state.torn_tail,
        "stale_records": state.stale_records,
        "duplicate_records": state.duplicate_records,
        "schema": SNAPSHOT_SCHEMA,
        "ts": now,
    }
    path = journal.snapshot_path()
    if path is None:
        journal.storage.snapshot = snap
        return snap
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        # One C-accelerated dumps + one write: json.dump streams
        # through the pure-Python iterencode chunk loop, which costs
        # ~3x on a 10k-job state (the recovery-fastpath profile).
        f.write(json.dumps(snap, separators=(",", ":"), default=str))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return snap


def compact(journal) -> dict:
    """Fold the journal into a snapshot and truncate the active
    segment to records after it. Caller holds the journal lock
    (Journal.maybe_compact)."""
    from vodascheduler_tpu_torch.durability.recover import read_state
    from vodascheduler_tpu_torch.durability.journal import frame

    state = read_state(journal)
    snap = write_snapshot(journal, state)
    keep = bytearray()
    for rec in journal.records():
        if int(rec.get("seq", 0)) > state.last_seq:
            keep.extend(frame(json.dumps(
                rec, separators=(",", ":"), default=str).encode()))
    # vodarace: ignore[guarded-read-unguarded-write] atomically-swapped
    # snapshot cache: a single store of None; readers rebuild on miss
    journal._records_cache = None
    journal.storage.replace(bytes(keep))
    journal.append("jsnap", {"snapshot_seq": state.last_seq})
    return snap
