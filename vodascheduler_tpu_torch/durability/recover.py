"""Crash recovery: journal replay + backend reconciliation
(doc/durability.md "Recovery").

Two phases, deliberately separated:

1. **Replay** (`read_state`): fold the snapshot + the journal's intact
   record suffix into a `JournalState` — the exact committed prefix of
   the pre-crash scheduler: per-job status, ledger bookings, placement
   intent, resize (hysteresis/cooldown) clocks, retirement tombstones,
   and the `granted` history the write-ahead invariant needs. Replay is
   pure (no scheduler, no backend): duplicates are dropped by seq,
   records whose epoch regressed are DROPPED and counted (a deposed
   leader's stale writes are rejected, never interleaved), and a torn
   tail is dropped while mid-file corruption raises (journal.py).

2. **Reconcile** (`recover_scheduler`): rebuild the scheduler's tables
   from the store + the replayed state, then compare against the
   backend's live view. Every divergence becomes an AUDITED corrective
   step — a `recovery_report` record (closed RECOVERY_REASONS
   vocabulary, obs/audit.py) naming the job and why — and the
   scheduler arms a `resume` resched so the PR 6 `recovery_pending`
   contract owns the repair. At a quiescent crash point (nothing in
   flight) the correct implementation produces ZERO booking/status
   divergences — the exact property the model checker's crash profile
   asserts exhaustively.
"""

from __future__ import annotations

import dataclasses
import time as _walltime
from typing import Dict, List, Set, Tuple

from vodascheduler_tpu_torch.common import lifecycle
from vodascheduler_tpu_torch.common.types import JobStatus
from vodascheduler_tpu_torch.obs import audit as obs_audit

# Divergence codes that can NEVER legitimately appear when recovering
# from a quiescent crash point (nothing in flight): the journal fully
# covers bookings and statuses there, so any of these means a
# journaling gap. placement_diverged is excluded on purpose —
# payback-deferred migrations legally leave placement intent diverging
# from the backend's live binding even at quiescence (doc/placement.md).
QUIESCENT_CLEAN_REASONS = frozenset({
    "backend_lost_job",
    "backend_running_unbooked",
    "chips_diverged",
    "unjournaled_job",
})


@dataclasses.dataclass
class JournalState:
    """The journal's committed prefix, replayed to a logical state."""

    statuses: Dict[str, str] = dataclasses.field(default_factory=dict)
    booked: Dict[str, int] = dataclasses.field(default_factory=dict)
    placements: Dict[str, List[Tuple[str, int]]] = \
        dataclasses.field(default_factory=dict)
    resize_at: Dict[str, float] = dataclasses.field(default_factory=dict)
    retired: Dict[str, str] = dataclasses.field(default_factory=dict)
    # When each tombstone was laid (the jretire record's envelope ts):
    # what the snapshot fold's retention pruning keys on
    # (doc/durability.md "Known bounds").
    retired_at: Dict[str, float] = dataclasses.field(default_factory=dict)
    granted: Set[str] = dataclasses.field(default_factory=set)
    routes: Dict[str, str] = dataclasses.field(default_factory=dict)
    # Learned-model state (doc/learned-models.md): newest jmodel payload
    # per job. Kept across retirement on purpose — learned curves
    # outlive the run (the store's category-fallback seeding inherits
    # them for repeat submissions), so recovery must not drop them.
    models: Dict[str, dict] = dataclasses.field(default_factory=dict)
    last_seq: int = 0
    epoch: int = 0
    records: int = 0
    torn_tail: int = 0
    stale_records: int = 0
    duplicate_records: int = 0


class StandbyApplier:
    """The incremental replay engine (doc/durability.md "Hot standby").

    One applier maintains one fully-materialized `JournalState`
    record-by-record: `bootstrap()` loads a shipped snapshot, `apply()`
    folds in one journal record with the same seq-dedup and stale-epoch
    fencing the batch replay performs — `read_state` IS this class run
    over the whole journal, and a warm standby is this class run
    continuously behind a shipping tailer, so takeover replays only the
    suffix the tailer hadn't fed yet."""

    def __init__(self, state: Optional[JournalState] = None) -> None:
        self.state = state if state is not None else JournalState()

    def bootstrap(self, snap: Optional[dict]) -> bool:
        """Load a snapshot into the state. A snapshot older than what
        the applier has already applied is ignored (False) — replayed
        records are a superset of what the fold serialized; a NEWER one
        replaces the state wholesale (a compaction/recovery fold on the
        leader covered records this applier never saw as frames)."""
        if snap is None:
            return False
        state = self.state
        if int(snap.get("last_seq", 0)) <= state.last_seq:
            return False
        state.statuses = dict(snap.get("statuses", {}))
        state.booked = {j: int(n)
                       for j, n in snap.get("booked", {}).items()}
        state.placements = {
            j: [(h, int(n)) for h, n in pairs]
            for j, pairs in snap.get("placements", {}).items()}
        state.resize_at = {j: float(t)
                           for j, t in snap.get("resize_at", {}).items()}
        state.retired = dict(snap.get("retired", {}))
        state.retired_at = {j: float(t) for j, t in
                            snap.get("retired_at", {}).items()}
        state.granted = set(snap.get("granted", ()))
        state.routes = dict(snap.get("routes", {}))
        state.models = dict(snap.get("models", {}))
        state.last_seq = int(snap.get("last_seq", 0))
        state.epoch = max(state.epoch, int(snap.get("epoch", 0)))
        return True

    def apply(self, rec: dict) -> bool:
        """Fold one record; returns whether it applied (False = dropped
        as a duplicate or a deposed leader's stale-epoch write)."""
        state = self.state
        state.records += 1
        seq = int(rec.get("seq", 0))
        epoch = int(rec.get("epoch", 0))
        if epoch < state.epoch:
            # Fencing on replay: a stale-epoch record after a newer
            # leader's writes is a deposed leader's interleaved append;
            # it is rejected, counted, and surfaced — never applied.
            # Checked BEFORE seq dedup: a deposed leader continues its
            # own seq counter, so its stale appends usually alias old
            # seqs — they are stale writes, not duplicates.
            state.stale_records += 1
            return False
        if seq <= state.last_seq:
            state.duplicate_records += 1
            return False
        state.last_seq = seq
        state.epoch = max(state.epoch, epoch)
        _apply_record(state, rec)
        return True

    @property
    def last_seq(self) -> int:
        return self.state.last_seq


def read_state(journal) -> JournalState:
    """Snapshot + journal suffix -> JournalState: the batch form of
    StandbyApplier (see module doc)."""
    from vodascheduler_tpu_torch.durability import snapshot as snap_mod

    applier = StandbyApplier()
    applier.bootstrap(snap_mod.load_snapshot(journal))
    state = applier.state
    for rec in journal.records():
        applier.apply(rec)
    state.torn_tail = journal._torn_tail_count + journal.torn_trimmed
    return state


def read_states_parallel(journals: Dict[str, object],
                         workers: int = 8) -> Dict[str, JournalState]:
    """Replay N pools' journals concurrently (the fleet cold-recovery
    fastpath, doc/durability.md "Hot standby"): each pool's
    snapshot-load + suffix replay runs on a bounded executor — the
    fleet restart pays the slowest pool's replay plus the (GIL-bound)
    shared decode, not the serial sum of N file reads."""
    if not journals:
        return {}
    if len(journals) == 1:
        name = next(iter(journals))
        return {name: read_state(journals[name])}
    from concurrent.futures import ThreadPoolExecutor

    from vodascheduler_tpu_torch.obs import tracer as obs_tracer

    parent = obs_tracer.current_context()

    def _replay(jnl) -> JournalState:
        # Ambient context propagated explicitly (thread-local): any
        # span a caller opened around the fleet restart stays the
        # parent of per-pool replay work.
        with obs_tracer.use_context(parent):
            return read_state(jnl)

    out: Dict[str, JournalState] = {}
    with ThreadPoolExecutor(
            max_workers=min(workers, len(journals)),
            thread_name_prefix="voda-recover") as pool:
        futures = {name: pool.submit(_replay, jnl)
                   for name, jnl in journals.items()}
        for name, fut in futures.items():
            out[name] = fut.result()
    return out


def _apply_record(state: JournalState, rec: dict) -> None:
    kind = rec.get("k")
    if kind == "jstatus":
        job = rec["job"]
        state.statuses[job] = rec["to"]
        if int(rec.get("chips") or 0) > 0:
            state.granted.add(job)
    elif kind == "jbook":
        job = rec["job"]
        if rec.get("op") == "release":
            state.booked.pop(job, None)
        else:
            chips = int(rec.get("chips", 0))
            state.booked[job] = chips
            if chips > 0:
                state.granted.add(job)
    elif kind == "jpass":
        for job, chips in (rec.get("set") or {}).items():
            state.booked[job] = int(chips)
            if int(chips) > 0:
                state.granted.add(job)
        for job in rec.get("del") or ():
            state.booked.pop(job, None)
    elif kind == "jplace":
        for job, pairs in (rec.get("set") or {}).items():
            state.placements[job] = [(h, int(n)) for h, n in pairs]
        for job in rec.get("del") or ():
            state.placements.pop(job, None)
    elif kind == "jclock":
        state.resize_at[rec["job"]] = float(rec["at"])
    elif kind == "jretire":
        job = rec["job"]
        state.retired[job] = rec.get("status", "")
        state.retired_at[job] = float(rec.get("ts", 0.0) or 0.0)
        state.statuses.pop(job, None)
        state.booked.pop(job, None)
        state.placements.pop(job, None)
        state.resize_at.pop(job, None)
    elif kind == "jroute":
        state.routes[rec["job"]] = rec.get("pool", "")
    elif kind == "jmodel":
        # Newest-per-job wins (each record carries the full learned
        # state, not a delta — see MetricsCollector._model_payload).
        state.models[rec["job"]] = {k: v for k, v in rec.items()
                                    if k not in ("k", "seq", "epoch", "ts")}
    # jlease / jsnap / jrecover carry no replayable scheduler state.


def _add_divergence(divergences: List[dict], reason: str,
                    job: str) -> None:
    """One audited corrective step (RECOVERY_REASONS, closed — the
    vodalint vocab rule checks these literals forward)."""
    divergences.append({"job": job, "reason": reason})


def _finish_retirement(sched, job, target: JobStatus, journal) -> None:
    """Complete an interrupted retirement with the journal's terminal
    verdict. Explicit literal edges (not a dict lookup) so vodacheck's
    transition-literal audit can verify each against TRANSITIONS."""
    if target == JobStatus.COMPLETED:
        lifecycle.transition(job, JobStatus.COMPLETED, reason="completed",
                             tracer=sched.tracer, pool=sched.pool_id,
                             journal=journal)
    elif target == JobStatus.FAILED:
        lifecycle.transition(job, JobStatus.FAILED, reason="failed",
                             tracer=sched.tracer, pool=sched.pool_id,
                             journal=journal)
    else:
        lifecycle.transition(job, JobStatus.CANCELED, reason="user_delete",
                             tracer=sched.tracer, pool=sched.pool_id,
                             journal=journal)
    job.finish_time = sched.clock.now()
    sched.store.update_job(job)


def recover_scheduler(sched, state: Optional[JournalState] = None,
                      fastpath: Optional[bool] = None) -> dict:
    """Rebuild a crashed scheduler from its journal and reconcile
    against the backend's live view (see module doc). Called by the
    Scheduler constructor on `resume=True` when the journal has state.
    Returns (and retains on the scheduler) the recovery_report record.

    `state`: a pre-materialized JournalState (a hot standby's applier,
    standby.py) — replay is skipped and takeover work is only the
    reconcile + the first pass. NOTE: the state is consumed (the fold
    below applies the reconcile records into it).

    `fastpath` (default on; VODA_RECOVERY_FASTPATH=0 forces the
    reference path — the A/B perf_scale's failover section measures):
    the reconcile's ~2 journal appends per job are batched into one
    storage write, bookings land as ONE delta-encoded `jpass`, and when
    the segment has outgrown the compaction bound the whole recovered
    state folds into a fresh snapshot instead of appending the resume
    records as frames at all (the compaction that would otherwise fire
    mid-resume-pass is subsumed). The reference path retains the
    original per-record behavior as the equivalence oracle — both paths
    must rebuild identical logical tables (pinned by
    tests/test_failover.py)."""
    t0 = _walltime.monotonic()
    journal = sched.journal
    if fastpath is None:
        from vodascheduler_tpu_torch import config as _config
        fastpath = _config.RECOVERY_FASTPATH
    warm = state is not None
    if state is None:
        state = read_state(journal)
    if fastpath:
        with journal.batch() as batch:
            rec = _reconcile(sched, journal, state, t0, batched=True)
            # Latency vs throughput: a WARM takeover (pre-materialized
            # standby state) is budget-bounded — always flush (one
            # write) and let the next pass's compaction fold off the
            # critical path; a COLD recovery folds when the segment
            # warrants it (the recovery IS the compaction).
            folded = _fold_or_flush(sched, journal, state, batch,
                                    allow_fold=not warm)
        if folded:
            # The compaction marker, appended AFTER the batch closed —
            # inside it the record would land in the consumed buffer
            # and never reach the fresh segment.
            journal.append("jsnap", {"snapshot_seq": state.last_seq})
        # The fold/flush is recovery work too: re-stamp the duration so
        # the report (and the takeover budget) covers it.
        rec["duration_ms"] = round((_walltime.monotonic() - t0) * 1000.0, 3)
    else:
        rec = _reconcile(sched, journal, state, t0, batched=False)
    journal.append("jrecover", {"divergences": len(rec["divergences"]),
                                "torn_tail": state.torn_tail})
    sched.tracer.emit(dict(rec))
    sched._last_recovery_report = rec
    # The recovered tables AS REBUILT, before the resume pass below
    # rebalances anything — what the model checker compares against the
    # pre-crash state at a quiescent crash point.
    sched._recovered_tables = logical_tables(sched)
    if sched.m_recovery_seconds is not None:
        sched.m_recovery_seconds.set(rec["duration_ms"] / 1000.0)
    sched.trigger_resched("resume")
    return rec


def _fold_or_flush(sched, journal, state: JournalState, batch,
                   allow_fold: bool = True) -> bool:
    """End-of-recovery durability commit (the fastpath's second half):
    when the active segment plus the buffered resume records would
    outgrow the compaction bound, fold — apply the buffered records
    into the already-materialized state and write it as a fresh
    snapshot, truncating the segment (the recovery IS the compaction:
    no re-parse, no separate fold at the resume pass's commit point).
    Below the bound the batch simply flushes as one storage write on
    exit. Every crash window stays safe: the snapshot rename is atomic
    and replay dedups by seq, so losing the race anywhere only costs
    extra replay."""
    from vodascheduler_tpu_torch.durability import snapshot as snap_mod

    if not allow_fold or (journal.size_bytes() + len(batch.buffer)
                          < journal.compact_bytes // 2):
        return False  # flush on batch exit (warm takeover / small segment)
    # The fold is the recovery's one DESTRUCTIVE write (snapshot
    # install + segment truncate): fence it like the flush branch
    # fences its storage append. A recovery that outlived the lease
    # (a standby took over mid-reconcile) must raise here, not
    # overwrite the new leader's committed records with a stale fold.
    journal._check_fence()
    applier = StandbyApplier(state)
    for rec in batch.consume():
        applier.apply(rec)
    snap_mod.write_snapshot(journal, state)
    journal._records_cache = None
    journal.storage.replace(b"")
    return True  # the caller appends the jsnap marker post-batch


def _reconcile(sched, journal, state: JournalState, t0: float,
               batched: bool) -> dict:
    """The reconcile phase shared by both recovery paths: rebuild the
    scheduler's tables from store + replayed state, audit every
    divergence vs the backend's live view (see module doc)."""
    divergences: List[dict] = []
    if state.torn_tail:
        _add_divergence(divergences, "journal_torn_tail", "")
    if state.stale_records:
        _add_divergence(divergences, "stale_epoch_dropped", "")
    running = sched.backend.running_jobs()
    booked_out: Dict[str, int] = {}
    for job in sched.store.list_jobs(pool=sched.pool_id):
        name = job.name
        jstat = state.statuses.get(name)
        retired = state.retired.get(name)
        if retired or job.status.is_terminal or (
                jstat is not None and JobStatus(jstat).is_terminal):
            # Finish an interrupted retirement: the journal's terminal
            # verdict wins over a store record the crash beat to disk.
            if not job.status.is_terminal:
                _finish_retirement(sched, job, JobStatus(retired or jstat),
                                   journal)
            sched.done_jobs[name] = job
            continue
        handle = running.get(name)
        live = handle.num_workers if handle else 0
        known = jstat is not None or name in state.booked
        booked = state.booked.get(name, 0)
        if not known:
            # Admitted to the store, never accepted pre-crash (the
            # CREATE event died with the process): re-accept — an
            # admitted job is never lost.
            _add_divergence(divergences, "unjournaled_job", name)
            n = live
            if live:
                _add_divergence(divergences, "backend_running_unbooked",
                                name)
        elif live > 0 and booked == 0:
            _add_divergence(divergences, "backend_running_unbooked", name)
            n = live
        elif live > 0 and booked != live:
            _add_divergence(divergences, "chips_diverged", name)
            n = live
        elif live == 0 and (booked > 0 or jstat == JobStatus.RUNNING.value):
            _add_divergence(divergences, "backend_lost_job", name)
            n = 0
        else:
            n = booked
        if job.status == JobStatus.SUBMITTED and n > 0:
            # Two declared edges: accept, then adopt the live run.
            lifecycle.transition(job, JobStatus.WAITING, reason="resume",
                                 chips=0, tracer=sched.tracer,
                                 pool=sched.pool_id, journal=journal)
        lifecycle.transition(
            job, JobStatus.RUNNING if n > 0 else JobStatus.WAITING,
            reason="resume", chips=n, tracer=sched.tracer,
            pool=sched.pool_id, journal=journal)
        job.metrics.last_update_time = sched.clock.now()
        sched.ready_jobs[name] = job
        if batched:
            booked_out[name] = n
        else:
            sched.job_num_chips.commit(name, n)
    if batched:
        # One delta-encoded jpass + one table swap for the whole fleet
        # instead of a journaled ledger commit per job.
        sched.job_num_chips.commit_pass(booked_out)
    # Hysteresis/cooldown clocks: exactly the pre-crash values.
    sched._last_resize_at.update(
        {j: t for j, t in state.resize_at.items()
         if j in sched.ready_jobs})
    # Placement occupancy: the backend's live bindings are ground truth
    # (they're what physically occupies chips); journal intent that
    # differs is audited — the resume pass re-places from scratch.
    # Restores are capacity-checked: a crash mid-fault can leave the
    # backend itself briefly overlapped (the recovery_pending window),
    # and the recovered manager must never mirror an oversubscription —
    # the overflowing job's binding is left unrestored (audited), and
    # the armed resume pass re-places it.
    if sched.placement_manager is not None:
        pm = sched.placement_manager
        free = {h: hs.total_slots for h, hs in pm.host_states.items()}
        restore_map = {}
        for name in sorted(running):
            handle = running[name]
            if name not in sched.ready_jobs or not handle.placements:
                continue
            pairs = [(h, int(n)) for h, n in handle.placements]
            if all(free.get(h, 0) >= n for h, n in pairs):
                for h, n in pairs:
                    free[h] -= n
                restore_map[name] = pairs
                intent = state.placements.get(name)
                if intent is not None and sorted(intent) != sorted(pairs):
                    _add_divergence(divergences, "placement_diverged",
                                    name)
            else:
                _add_divergence(divergences, "placement_diverged", name)
        pm.restore(restore_map)
    sched._placement_dirty = True
    sched._bump_state_version()
    # A retired (deleted/completed) job the backend still runs: the
    # crash beat the backend stop. Reap it best-effort — leaving it
    # would strand its chips outside every table (the tombstone keeps
    # it out of the ready queue, so nothing else will ever stop it).
    for name in sorted(running):
        if name in state.retired or name in sched.done_jobs:
            try:
                sched.backend.stop_job(name)
            except Exception:  # noqa: BLE001 - reap is best-effort; the
                pass           # backend's own monitor collects stragglers
    _restore_models(sched, state)
    duration = _walltime.monotonic() - t0
    return {
        "kind": "recovery_report",
        "schema": obs_audit.SCHEMA_VERSION,
        "ts": sched.clock.now(),
        "pool": sched.pool_id,
        "epoch": journal.epoch,
        "last_seq": state.last_seq,
        "records": state.records,
        "torn_tail": state.torn_tail,
        "stale_records": state.stale_records,
        "jobs": len(sched.ready_jobs),
        "divergences": divergences,
        "duration_ms": round(duration * 1000.0, 3),
    }


def _restore_models(sched, state: JournalState) -> None:
    """Fold the journal's learned-model state (`jmodel`,
    doc/learned-models.md) back into the store's job-info docs. The
    journal was appended AHEAD of each store write (append-before-
    apply), so the journal can only be fresher-or-equal — but the store
    is itself persistent, so a doc whose model_version already matches
    (or passed) the journal's is left alone rather than clobbered with
    an equal copy."""
    from vodascheduler_tpu_torch.common.job import base_job_info

    restored = 0
    for job, payload in state.models.items():
        version = int(payload.get("version", 0))
        info = sched.store.get_job_info(job)
        if info is not None and info.model_version >= version:
            continue
        if info is None:
            info = base_job_info(job, payload.get("category", job),
                                 payload.get("pool", sched.pool_id))
        info.comms_fraction_est = float(payload.get("cf_est", 0.0))
        info.comms_fraction_weight = float(payload.get("cf_w", 0.0))
        info.interference_fraction_est = float(payload.get("if_est", 0.0))
        info.interference_fraction_weight = float(payload.get("if_w", 0.0))
        info.model_drift_ratio = float(payload.get("drift", 1.0))
        info.model_drift_weight = float(payload.get("drift_w", 0.0))
        info.model_stamp = float(payload.get("stamp", 0.0))
        info.model_version = version
        measured = {int(n): float(t) for n, t in
                    (payload.get("epoch_seconds") or {}).items()}
        if measured:
            info.epoch_seconds = {**info.epoch_seconds, **measured}
            info.step_seconds = {
                **info.step_seconds,
                **{int(n): float(t) for n, t in
                   (payload.get("step_seconds") or {}).items()}}
            from vodascheduler_tpu_torch.metricscollector import learned
            fit = learned.fit_serial_seconds(info.epoch_seconds)
            if fit is not None:
                info.speedup = dict(info.speedup)
                info.efficiency = dict(info.efficiency)
                for n, t in measured.items():
                    if t > 0:
                        info.speedup[n] = fit[0] / t
                        info.efficiency[n] = info.speedup[n] / n
        if "current_epoch" in payload:
            info.current_epoch = max(info.current_epoch,
                                     int(payload["current_epoch"]))
        sched.store.upsert_job_info(info)
        restored += 1
    if restored:
        sched.store.bump_model_version()


def logical_tables(sched) -> Tuple:
    """The scheduler state recovery promises to reproduce at a
    quiescent crash point: statuses, bookings, done set, and live
    jobs' resize clocks — hashable, order-canonical."""
    ready = {n: j.status.value for n, j in sched.ready_jobs.items()}
    return (tuple(sorted(sched.job_num_chips.snapshot().items())),
            tuple(sorted(ready.items())),
            tuple(sorted((n, j.status.value)
                         for n, j in sched.done_jobs.items())),
            tuple(sorted((n, round(sched._last_resize_at.get(n, 0.0), 9))
                         for n in ready)))
