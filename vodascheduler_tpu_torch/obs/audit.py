"""Decision-audit records: the machine-readable "why" of each resched.

One record per rescheduling pass captures the trigger, the queue
snapshot, the algorithm, every per-job before→after chip delta, and a
*reason code* for each delta drawn from the closed vocabulary below —
the state → decision → (priced) action tuples that placement-learning
work (Placeto, arxiv 1906.08879; NEST, arxiv 2603.06798) consumes as
training/evaluation input, and that `voda explain <job>` renders for a
human.

The vocabulary is deliberately frozen: a new scheduler behavior must add
its code HERE (and to doc/observability.md) before it can emit, and
`make trace-dryrun` + the schema validator fail on unknown codes — the
audit stream can never silently grow untyped reasons.

The replay simulator emits the same schema through the same scheduler
code path, so a replay audit stream and a live audit stream of the same
workload are directly diffable.
"""

from __future__ import annotations

from typing import Any, Dict, List

SCHEMA_VERSION = 1

# Why a resched pass ran (the coalesced set of triggers since the last
# pass — several events inside one rate-limit window share one pass).
TRIGGERS = frozenset({
    "job_created",       # admission announced a new job
    "job_deleted",       # user cancel
    "job_completed",
    "job_failed",
    "host_added",        # fleet grew (spot return / scale-up)
    "host_removed",      # fleet shrank (spot preemption / drain)
    "priority_change",   # Tiresias promote/demote flipped a priority
    "algorithm_changed",  # PUT /algorithm
    "metrics_update",    # collector learned fresh speedup curves
    "model_drift_detected",  # measured step time diverged from the
                             # learned/prior model beyond the drift band
                             # (doc/learned-models.md) — re-plan on the
                             # refreshed curves
    "retry",             # a failed apply scheduled this retry pass
    "resume",            # crash-resume reconstruction
    "manual",            # untagged trigger_resched caller
})

# Why a job's chip count changed (or pointedly didn't). A delta may carry
# several codes: a scale_out that bypassed hysteresis carries both.
REASON_CODES = frozenset({
    "started",                   # 0 -> n: job got its first/next allocation
    "halted",                    # n -> 0: preempted back to the queue
    "released_terminal",         # n -> 0: job completed/failed/canceled
    "scale_out",                 # n -> m, m > n
    "scale_in",                  # n -> m, 0 < m < n
    "migrated",                  # same size, host binding changed
    "migration_deferred_unpaid",  # re-binding priced: modeled step-time win
                                  # does not repay the resharding cost
                                  # within the payback window
    "resize_inplace",            # the backend took the Tier-A live reshard
    "resize_cold",               # checkpoint-restart resize
    "hysteresis_suppressed",     # small grow clipped back to the old size
    "hysteresis_bypassed_grow_fits_host",  # grow passed the gate: fits own host
    "hysteresis_bypassed_fractional_fit",  # fractional tenant's grow stays a
                                           # sub-host partition of its own
                                           # host block (doc/fractional-
                                           # sharing.md) — never adds a host
    "start_failed",              # backend raised; allocation reverted
    "scale_failed",              # backend raised; re-booked from live state
    "halt_failed",               # backend raised; halt kept booked for retry
    "migrate_failed",            # backend raised during migration
    "reverted_release_failure",  # pass aborted: booking reverted wholesale
})

# Why a job's STATUS changed (the lifecycle plane, common/lifecycle.py):
# every `transition()` call names one of these, the edge it takes must
# allow it (lifecycle.TRANSITIONS), and every `status_transition` record
# carries it. Closed both ways like the other vocabularies: an unknown
# code fails validation and vodalint's vocab rule; an unused code fails
# the reverse sweep (usage is counted OUTSIDE audit.py and lifecycle.py,
# where the vocabulary is merely declared).
STATUS_REASONS = frozenset({
    "accepted",      # Submitted -> Waiting: scheduler took the job
    "scheduled",     # Waiting -> Running: pass granted chips, backend started
    "preempted",     # Running -> Waiting: halted back to the queue by a pass
    "backend_lost",  # Running -> Waiting: backend failed/lost the job; reverted
    "resume",        # crash resume re-asserted status from store+backend truth
    "completed",     # -> Completed
    "failed",        # -> Failed
    "user_delete",   # -> Canceled
})

# Why the cross-pool admission router placed a job where it did
# (doc/observability.md "Fleet decide"): every `fleet_route` record
# carries one or more of these, closed both ways like REASON_CODES —
# vodalint's vocab rule checks `_add_route_reason` literals forward and
# sweeps usage in reverse, so the router can never grow an untyped
# placement rationale.
ROUTE_REASONS = frozenset({
    "explicit_pool",     # the spec named a configured pool; router passthrough
    "single_pool",       # one-pool fleet: the route is trivial
    "best_score",        # fleet-wide score winner (free chips - backlog)
    "affinity_preferred",  # comms-weighted job steered to the densest
                           # feasible topology (family<->topology affinity)
    "router_disabled",   # VODA_FLEET_ROUTER=0: static default-pool path
})

# The durability plane's write-ahead journal record kinds
# (doc/durability.md "Record catalog"): `Journal.append` REJECTS a kind
# outside this set at write time, recover.read_state understands
# exactly these, and vodalint's vocab rule checks journal-append
# literals forward and sweeps usage in reverse — the journal can never
# grow records recovery doesn't know how to replay.
JOURNAL_KINDS = frozenset({
    "jstatus",   # one lifecycle transition (job, from, to, reason, chips)
    "jbook",     # one BookingLedger commit/release (op, job, chips)
    "jpass",     # one decide-phase commit_pass, as a delta (set, del)
    "jplace",    # placement-intent delta after a placed pass (set, del)
    "jclock",    # resize (hysteresis/cooldown) clock re-arm (job, at)
    "jretire",   # terminal tombstone: delete/complete survives compaction
    "jroute",    # one fleet-router placement decision (job, pool)
    "jmodel",    # one learned-model update (fractions, drift, measured
                 # curves — doc/learned-models.md); newest-per-job wins
    "jlease",    # leadership milestone (op, holder; epoch in envelope)
    "jrecover",  # recovery completed (divergence count, torn tail)
    "jsnap",     # compaction marker (snapshot_seq)
})

# Why crash recovery took a corrective step (the audited divergence
# classes of recover.recover_scheduler — doc/durability.md "Recovery").
# Closed both ways like the other vocabularies: `_add_divergence`
# literals are checked forward by vodalint, usage swept in reverse, and
# a recovery_report naming an unknown code fails validation.
RECOVERY_REASONS = frozenset({
    "backend_lost_job",          # journal says running, backend lost it
    "backend_running_unbooked",  # backend runs it, journal booked nothing
    "chips_diverged",            # booked size != live size (crash mid-scale)
    "placement_diverged",        # journal intent != live binding (mid-
                                 # migration crash or a deferred re-binding)
    "unjournaled_job",           # admitted to the store, never accepted
                                 # pre-crash: re-accepted, never lost
    "journal_torn_tail",         # a torn final record was dropped
    "stale_epoch_dropped",       # a deposed leader's stale-epoch records
                                 # were rejected at replay
})

# The decide/actuate sub-stages the performance observatory times
# (obs/profile.py; doc/observability.md "Performance observatory").
# Closed both ways like the other vocabularies: every literal
# `phase("...")` / `PhaseTimer.phase("...")` name must be declared here
# (vodalint's vocab rule), every entry must be timed somewhere, and a
# perf_report record naming an unknown phase fails validation — so the
# phase breakdown ROADMAP item 2's vectorization work is judged against
# can never silently grow untyped stages.
PHASE_NAMES = frozenset({
    "snapshot",          # decide: ready-queue + reservation snapshot under the lock
    "allocate",          # decide: the allocator.allocate call (incl. job-info fetch)
    "algorithm",         # decide: the pure scheduling algorithm + feasibility rounding (nested in allocate)
    "hysteresis",        # decide: scale-out suppression gate
    "comms",             # decide: per-job comms-weight refresh + migration payback pricing
    "placement",         # decide: placement.place/defragment
    "hungarian",         # decide: the cold Hungarian assignment solve (nested in placement)
    "hungarian_warm",    # decide: warm-started incremental Hungarian re-solve (nested in placement)
    "diff",              # decide: old-vs-new allocation diff + reason tagging
    "commit",            # decide: BookingLedger.commit_pass
    "actuate_release",   # actuate: wave 1 — halts + scale-ins
    "actuate_claim",     # actuate: wave 2 — starts + scale-outs
    "actuate_migrate",   # actuate: trailing wave — re-bindings
    "fleet_decide",      # fleet: the concurrent per-pool decide fan-out
                         # (one entry per fleet pass, fleet coordinator)
    "route",             # fleet: cross-pool admission routing (score +
                         # pick, per routed burst)
})

# Every span name the package may emit (the trace file's third closed
# vocabulary, alongside TRIGGERS and REASON_CODES). Enforced statically
# by vodalint's `vocab` rule — NOT by validate_record, because tests
# legitimately build throwaway spans with scratch names; what must stay
# closed is what *shipped code* emits. A new boundary adds its span name
# HERE (and to doc/observability.md) before it can ship.
SPAN_NAMES = frozenset({
    "resched",               # scheduler: one pass's root span
    "fleet",                 # fleet coordinator: one concurrent multi-pool
                             # decide fan-out (doc/observability.md
                             # "Fleet decide")
    "admission.batch",       # service: one bulk-admission commit+publish
    "allocator.allocate",
    "placement.place",
    "job.start", "job.scale", "job.halt", "job.migrate",
    "backend.start", "backend.scale", "backend.stop",
    "supervisor.start", "supervisor.resize",
})

_REQUIRED_AUDIT_FIELDS = ("kind", "schema", "ts", "pool", "seq", "trace_id",
                          "triggers", "algorithm", "total_chips", "queue",
                          "deltas", "duration_ms")
# The optional per-delta fractional block (doc/fractional-sharing.md):
# closed keys, like the reason vocabulary — a delta naming a fractional
# grant must carry exactly this shape.
_REQUIRED_FRACTIONAL_FIELDS = ("partition", "hosts", "co_tenants",
                               "interference_price")
_REQUIRED_SPAN_FIELDS = ("kind", "trace_id", "span_id", "name", "component",
                         "start", "end", "duration_ms", "status")
_REQUIRED_ACCESS_FIELDS = ("kind", "ts", "method", "path", "status",
                           "duration_ms")
_REQUIRED_STATUS_FIELDS = ("kind", "schema", "ts", "pool", "job", "from",
                           "to", "reason")
_REQUIRED_COUNTEREXAMPLE_FIELDS = ("kind", "schema", "ts", "violation",
                                   "step", "path", "config")
_REQUIRED_PERF_FIELDS = ("kind", "schema", "ts", "pool", "seq", "trace_id",
                         "outcome", "duration_ms", "cpu_ms", "decide_ms",
                         "actuate_ms", "num_jobs", "phases")
_REQUIRED_ROUTE_FIELDS = ("kind", "schema", "ts", "job", "pool", "reasons",
                          "scores")
_REQUIRED_RECOVERY_FIELDS = ("kind", "schema", "ts", "pool", "epoch",
                             "last_seq", "records", "torn_tail",
                             "divergences", "duration_ms")
# One hot-standby takeover (doc/durability.md "Hot standby"): the
# end-to-end budget (lease-loss -> first committed decide), the suffix
# the final drain fed, and the reconcile's recovery_report summary.
_REQUIRED_TAKEOVER_FIELDS = ("kind", "schema", "ts", "pool", "epoch",
                             "suffix_records", "applied_seq",
                             "duration_ms", "recovery_ms", "divergences")
# The what-if shadow planner's record (doc/learned-models.md "What-if
# planner"): a read-only shadow decide scored off the decide critical
# path — the allocator's would-be grant plus a candidate table modeled
# under both the learned and the prior cost model.
_REQUIRED_WHATIF_FIELDS = ("kind", "schema", "ts", "pool", "job",
                           "algorithm", "current_chips", "would_grant",
                           "model", "candidates", "duration_ms")
_REQUIRED_WHATIF_CANDIDATE_FIELDS = ("chips", "spread",
                                     "modeled_step_ratio",
                                     "modeled_remaining_s",
                                     "prior_remaining_s")


def validate_record(rec: Dict[str, Any]) -> List[str]:
    """Schema-check one emitted JSONL record; returns human-readable
    problems (empty = valid). Unknown kinds are invalid — the trace file
    is a closed format, same posture as the reason vocabulary."""
    if not isinstance(rec, dict):
        return ["record is not an object"]
    kind = rec.get("kind")
    if kind == "resched_audit":
        return _validate_audit(rec)
    if kind == "span":
        return _check_fields(rec, _REQUIRED_SPAN_FIELDS)
    if kind == "http_access":
        return _check_fields(rec, _REQUIRED_ACCESS_FIELDS)
    if kind == "status_transition":
        return _validate_status_transition(rec)
    if kind == "modelcheck_counterexample":
        return _check_fields(rec, _REQUIRED_COUNTEREXAMPLE_FIELDS)
    if kind == "perf_report":
        return _validate_perf(rec)
    if kind == "fleet_route":
        return _validate_route(rec)
    if kind == "recovery_report":
        return _validate_recovery(rec)
    if kind == "takeover_report":
        return _check_fields(rec, _REQUIRED_TAKEOVER_FIELDS)
    if kind == "whatif_report":
        return _validate_whatif(rec)
    return [f"unknown record kind {kind!r}"]


def _validate_whatif(rec: Dict[str, Any]) -> List[str]:
    """One what-if shadow plan (doc/learned-models.md): candidate chip
    counts for a job scored on the placement-sensitive step-time model
    — closed candidate shape, like the fractional delta block."""
    problems = _check_fields(rec, _REQUIRED_WHATIF_FIELDS)
    if rec.get("model") not in ("learned", "prior"):
        problems.append(f"unknown whatif model {rec.get('model')!r}")
    candidates = rec.get("candidates", ())
    if not isinstance(candidates, list):
        problems.append("candidates is not a list")
        return problems
    for c in candidates:
        if not isinstance(c, dict):
            problems.append(f"candidate is not an object: {c!r}")
            continue
        for f in _REQUIRED_WHATIF_CANDIDATE_FIELDS:
            if f not in c:
                problems.append(
                    f"candidate {c.get('chips')!r}: missing {f!r}")
    return problems


def _validate_recovery(rec: Dict[str, Any]) -> List[str]:
    """One crash recovery (doc/durability.md): the journal's committed
    prefix that was replayed and every audited corrective step the
    backend reconciliation took — with its reason code drawn from the
    closed RECOVERY_REASONS vocabulary."""
    problems = _check_fields(rec, _REQUIRED_RECOVERY_FIELDS)
    divergences = rec.get("divergences", ())
    if not isinstance(divergences, list):
        problems.append("divergences is not a list")
        return problems
    for d in divergences:
        if not isinstance(d, dict) or "job" not in d or "reason" not in d:
            problems.append(f"malformed divergence {d!r}")
            continue
        if d["reason"] not in RECOVERY_REASONS:
            problems.append(f"unknown recovery reason {d['reason']!r} "
                            f"(job {d.get('job')!r})")
    return problems


def _validate_route(rec: Dict[str, Any]) -> List[str]:
    """One cross-pool admission routing decision (doc/observability.md
    "Fleet decide"): which pool got the job and why, with the per-pool
    scores the router compared — the audit trail that makes a surprising
    placement explainable after the fact."""
    problems = _check_fields(rec, _REQUIRED_ROUTE_FIELDS)
    reasons = rec.get("reasons", ())
    if not reasons:
        problems.append("fleet_route has no reasons")
    for code in reasons:
        if code not in ROUTE_REASONS:
            problems.append(f"unknown route reason {code!r}")
    if not isinstance(rec.get("scores", {}), dict):
        problems.append("scores is not an object")
    return problems


def _validate_perf(rec: Dict[str, Any]) -> List[str]:
    problems = _check_fields(rec, _REQUIRED_PERF_FIELDS)
    phases = rec.get("phases")
    if not isinstance(phases, dict):
        problems.append("phases is not an object")
        return problems
    for name, stats in phases.items():
        if name not in PHASE_NAMES:
            problems.append(f"unknown phase {name!r}")
        if not isinstance(stats, dict):
            problems.append(f"phase {name!r} stats is not an object")
            continue
        for f in ("wall_ms", "cpu_ms", "count"):
            if f not in stats:
                problems.append(f"phase {name!r}: missing {f!r}")
    return problems


def _validate_status_transition(rec: Dict[str, Any]) -> List[str]:
    problems = _check_fields(rec, _REQUIRED_STATUS_FIELDS)
    if rec.get("reason") not in STATUS_REASONS:
        problems.append(f"unknown status reason {rec.get('reason')!r}")
    # The edge itself must be declared. Lazy import: lifecycle imports
    # this module for the vocabulary, so the dependency inverts here at
    # call time (no import cycle at module load).
    from vodascheduler_tpu_torch.common.lifecycle import TRANSITIONS
    from vodascheduler_tpu_torch.common.types import JobStatus
    try:
        edge = (JobStatus(rec.get("from")), JobStatus(rec.get("to")))
    except ValueError:
        problems.append(f"invalid status in {rec.get('from')!r} -> "
                        f"{rec.get('to')!r}")
        return problems
    spec = TRANSITIONS.get(edge)
    if spec is None:
        problems.append(f"undeclared transition {rec['from']!r} -> "
                        f"{rec['to']!r}")
    elif rec.get("reason") in STATUS_REASONS \
            and rec["reason"] not in spec.reasons:
        problems.append(f"reason {rec['reason']!r} not allowed for "
                        f"{rec['from']!r} -> {rec['to']!r}")
    return problems


def _check_fields(rec: Dict[str, Any], required) -> List[str]:
    return [f"{rec.get('kind')}: missing field {f!r}"
            for f in required if f not in rec]


def _validate_audit(rec: Dict[str, Any]) -> List[str]:
    problems = _check_fields(rec, _REQUIRED_AUDIT_FIELDS)
    for trig in rec.get("triggers", ()):
        if trig not in TRIGGERS:
            problems.append(f"unknown trigger {trig!r}")
    if not isinstance(rec.get("queue", []), list):
        problems.append("queue is not a list")
    for delta in rec.get("deltas", ()):
        if not isinstance(delta, dict):
            problems.append(f"delta is not an object: {delta!r}")
            continue
        for f in ("job", "before", "after", "reasons"):
            if f not in delta:
                problems.append(f"delta for {delta.get('job')!r}: "
                                f"missing {f!r}")
        for code in delta.get("reasons", ()):
            if code not in REASON_CODES:
                problems.append(f"unknown reason code {code!r} "
                                f"(job {delta.get('job')!r})")
        if not delta.get("reasons"):
            problems.append(f"delta for {delta.get('job')!r} has no reasons")
        frac = delta.get("fractional")
        if frac is not None:
            if not isinstance(frac, dict):
                problems.append(f"delta for {delta.get('job')!r}: "
                                f"fractional block is not an object")
            else:
                for f in _REQUIRED_FRACTIONAL_FIELDS:
                    if f not in frac:
                        problems.append(
                            f"delta for {delta.get('job')!r}: fractional "
                            f"block missing {f!r}")
                for f in frac:
                    if f not in _REQUIRED_FRACTIONAL_FIELDS:
                        problems.append(
                            f"delta for {delta.get('job')!r}: unknown "
                            f"fractional field {f!r}")
    return problems


def validate_jsonl(path: str) -> List[str]:
    """Validate every line of a trace file; returns problems prefixed
    with their line number."""
    import json

    problems: List[str] = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError as e:
                problems.append(f"line {i}: not JSON ({e})")
                continue
            problems.extend(f"line {i}: {p}" for p in validate_record(rec))
    return problems


def summarize_deltas(record: Dict[str, Any]) -> List[str]:
    """Human-readable one-liners for `voda explain` output."""
    out = []
    for d in record.get("deltas", ()):
        reasons = ",".join(d.get("reasons", ()))
        out.append(f"{d.get('job')}: {d.get('before')} -> {d.get('after')} "
                   f"chips [{reasons}]")
    return out
