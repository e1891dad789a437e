"""The reified job lifecycle: one declared transition relation, one
`transition()` API, and the chip-booking ledger.

Before this module the job state machine existed only as a convention:
`job.status = ...` at eight scattered scheduler sites, each trusted to
respect orderings nothing machine-checked (the class of drift PR 5's
vodalint closed for clocks and locks). Now the relation itself is data —
`TRANSITIONS` maps every legal `(from, to)` edge to a `TransitionSpec`
carrying its allowed audit reason codes and its booking contract — and
`transition()` is the single place in the tree allowed to store
`job.status` (enforced statically by vodalint's `status-store` rule and
`analysis/vodacheck.py`; exercised dynamically by
`analysis/modelcheck.py`).

Self-loop policy is explicit, not an accident of a `==` guard: a
declared self-loop (re-asserting WAITING/RUNNING on crash resume) EMITS
its audit record like any other edge — the silent same-status no-op that
used to drop the audit trail is gone — and an undeclared one raises
`InvalidTransition`.

Every transition emits a `status_transition` record (obs/audit.py's
closed `STATUS_REASONS` vocabulary) through the tracer, so `voda
explain` and replay diffs see status changes with the same fidelity as
chip-count deltas. Emission is a leaf operation (tracer ring append +
optional O_APPEND line) with no path back into scheduler or backend
locks, so call sites may hold the scheduler lock.

Chip bookings move through `BookingLedger` — a read-only mapping to
every consumer, mutated only via `commit`/`release`/`commit_pass`. The
release-on-failure contract: any code path that claims chips against a
backend (`start_job`/`scale_job`/`migrate_workers`) must release or
re-book on its exception edge; vodacheck's `booking-release` rule
verifies a dominating ledger write on every such path.

Upcoming resource classes (fractional sub-slice grants à la Flex-MIG,
ROADMAP item 4) extend this vocabulary — new edges and reason codes are
declared here first, and the static audit forces call sites and docs to
follow.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, FrozenSet, Iterator, Optional, Tuple

from vodascheduler_tpu_torch.common.types import JobStatus
from vodascheduler_tpu_torch.obs import audit as obs_audit
from vodascheduler_tpu_torch.obs import tracer as obs_tracer


class InvalidTransition(Exception):
    """A status change outside the declared relation (including an
    undeclared self-loop, or a declared edge with a reason code the edge
    does not allow)."""


class BookingContractViolation(Exception):
    """A transition whose booking pre/postcondition does not hold — e.g.
    entering RUNNING with zero chips booked."""


@dataclasses.dataclass(frozen=True)
class TransitionSpec:
    """One edge of the job state machine.

    `reasons`: the closed set of `STATUS_REASONS` codes a caller may
    give for taking this edge (the audit record's `reason` field).
    `chips`: the booking contract checked when the caller supplies the
    job's booked chip count — "zero" / "nonzero" / None (no contract).
    The target state's meaning IS its booking invariant (RUNNING ⇔
    booked > 0, WAITING ⇔ booked == 0), which is exactly what the model
    checker re-verifies dynamically after every step.
    """

    reasons: FrozenSet[str]
    chips: Optional[str] = None  # None | "zero" | "nonzero"
    doc: str = ""


def _spec(reasons: Tuple[str, ...], chips: Optional[str] = None,
          doc: str = "") -> TransitionSpec:
    return TransitionSpec(reasons=frozenset(reasons), chips=chips, doc=doc)


# The full transition relation. Every edge is claimed by a literal
# `transition()` call site somewhere in the package (vodacheck's
# `transition-unused` rule fails on a dead edge, mirroring SPAN_NAMES),
# and every call site's (to, reason) literals must match an edge here
# (`transition-literal`). Self-loops present in this table are ALLOWED
# and emit; absent ones raise.
TRANSITIONS: Dict[Tuple[JobStatus, JobStatus], TransitionSpec] = {
    (JobStatus.SUBMITTED, JobStatus.WAITING): _spec(
        ("accepted", "resume"), chips="zero",
        doc="scheduler accepted the admission-announced job into its "
            "ready queue (or rebuilt it there on crash resume)"),
    (JobStatus.WAITING, JobStatus.RUNNING): _spec(
        ("scheduled", "resume"), chips="nonzero",
        doc="a resched pass granted chips and the backend realized the "
            "start (or resume found the backend already running it)"),
    (JobStatus.RUNNING, JobStatus.WAITING): _spec(
        ("preempted", "backend_lost", "resume"), chips="zero",
        doc="halted back to the queue: preempted by a pass, reverted "
            "because the backend lost/failed the job, or resume found "
            "no live workers"),
    (JobStatus.WAITING, JobStatus.WAITING): _spec(
        ("resume",), chips="zero",
        doc="allowed self-loop: crash resume re-asserts WAITING; emits "
            "so the audit trail shows the re-assertion"),
    (JobStatus.RUNNING, JobStatus.RUNNING): _spec(
        ("resume",), chips="nonzero",
        doc="allowed self-loop: crash resume re-asserts RUNNING from "
            "the backend's live view; emits"),
    (JobStatus.RUNNING, JobStatus.COMPLETED): _spec(
        ("completed",),
        doc="backend reported the final epoch done"),
    (JobStatus.WAITING, JobStatus.COMPLETED): _spec(
        ("completed",),
        doc="completion event raced a halt (job finished mid-pass, the "
            "event was deferred past the preempting actuation)"),
    (JobStatus.RUNNING, JobStatus.FAILED): _spec(
        ("failed",),
        doc="backend reported job failure"),
    (JobStatus.WAITING, JobStatus.FAILED): _spec(
        ("failed",),
        doc="failure event arrived for a job a pass had already halted"),
    (JobStatus.RUNNING, JobStatus.CANCELED): _spec(
        ("user_delete",),
        doc="user cancel of a running job; its backend stop drains "
            "outside the scheduler lock with the chips held reserved"),
    (JobStatus.WAITING, JobStatus.CANCELED): _spec(
        ("user_delete",),
        doc="user cancel of a queued job"),
}

# Import-time closure check: an edge reason outside the closed audit
# vocabulary is a programming error in THIS module, caught at import —
# not a runtime surprise in a transition call.
_undeclared = {
    r for spec in TRANSITIONS.values() for r in spec.reasons
    if r not in obs_audit.STATUS_REASONS
}
if _undeclared:  # pragma: no cover - import-time guard
    raise AssertionError(
        f"TRANSITIONS reasons missing from obs.audit.STATUS_REASONS: "
        f"{sorted(_undeclared)}")


def transition(job, to: JobStatus, *, reason: str,
               chips: Optional[int] = None,
               tracer: Optional["obs_tracer.Tracer"] = None,
               pool: str = "",
               journal=None) -> bool:
    """Take one edge of the state machine: validate it, journal it,
    store `job.status` (the single blessed store in the tree), and emit
    the `status_transition` audit record.

    `chips` is the job's currently booked chip count when the caller
    knows it — the edge's booking contract is enforced against it
    (RUNNING requires nonzero, WAITING requires zero); omit it on paths
    where the booking is not yet settled (terminal edges, where the
    ledger release rides the same lock hold).

    `journal` is the durability plane's write-ahead seam
    (doc/durability.md): when given, a `jstatus` record is appended
    AFTER validation but BEFORE the status store — write-ahead, so a
    crash (or a fenced deposed leader, whose append raises) can never
    leave an applied-but-unjournaled edge. Scheduler call sites must
    pass it (vodalint's `journal-seam` rule).

    Returns True when the status actually changed, False for an allowed
    (and emitted) self-loop. Raises `InvalidTransition` for an
    undeclared edge or reason, `BookingContractViolation` for a broken
    chips contract.
    """
    frm = job.status
    spec = TRANSITIONS.get((frm, to))
    if spec is None:
        raise InvalidTransition(
            f"job {job.name!r}: {frm.value} -> {to.value} is not a "
            f"declared transition"
            + (" (undeclared self-loop)" if frm == to else ""))
    if reason not in spec.reasons:
        raise InvalidTransition(
            f"job {job.name!r}: reason {reason!r} not allowed for "
            f"{frm.value} -> {to.value} (allowed: {sorted(spec.reasons)})")
    if chips is not None and spec.chips is not None:
        if spec.chips == "zero" and chips != 0:
            raise BookingContractViolation(
                f"job {job.name!r}: {frm.value} -> {to.value} requires "
                f"zero booked chips, has {chips}")
        if spec.chips == "nonzero" and chips <= 0:
            raise BookingContractViolation(
                f"job {job.name!r}: {frm.value} -> {to.value} requires "
                f"a nonzero booking, has {chips}")
    if journal is not None:
        payload = {"job": job.name, "from": frm.value, "to": to.value,
                   "reason": reason}
        if chips is not None:
            payload["chips"] = int(chips)
        journal.append("jstatus", payload)
    job.status = to
    tracer = tracer or obs_tracer.active_tracer()
    rec = {
        "kind": "status_transition",
        "schema": obs_audit.SCHEMA_VERSION,
        "pool": pool,
        "job": job.name,
        "from": frm.value,
        "to": to.value,
        "reason": reason,
    }
    if chips is not None:
        rec["chips"] = int(chips)
    tracer.emit(rec)
    return frm != to


class BookingLedger:
    """The scheduler's chip-booking table: job name -> booked chips.

    Reads look like a plain mapping (the whole tree — gauges, diffing,
    REST, tests — consumes it that way); writes go through three named
    mutators so the booking discipline is auditable, statically (the
    `booking-release` rule keys on these names) and at review:

    - `commit(job, chips)` — book (or re-book) one job's grant.
    - `release(job)` — drop the booking, returning the freed chips.
    - `commit_pass(result)` — the decide-phase wholesale commit of one
      resched pass's allocation.

    The release-on-failure contract: a commit made ahead of a backend
    claim (start/scale/migrate) must be paired with a release or
    re-book on the claim's exception edge — an unreleased booking
    strands chips (phantom-running, found live in r5) and an unbooked
    claim double-books the next pass.

    Thread-safety: mutators and snapshot reads take an internal lock;
    the scheduler additionally serializes mutation under its own lock
    (wave workers re-book concurrently with reader threads).

    Durability seam (doc/durability.md): with a `journal` attached,
    every mutator appends its write-ahead record (`jbook` /
    delta-encoded `jpass`) BEFORE touching the table — a crash between
    append and apply loses only the in-memory half, which recovery
    rebuilds from the journal anyway, and a fenced append (deposed
    leader) raises before any state moves.
    """

    def __init__(self, initial: Optional[Dict[str, int]] = None,
                 journal=None) -> None:
        self._lock = threading.RLock()
        self._booked: Dict[str, int] = dict(initial or {})
        self.journal = journal

    # -- mapping reads ------------------------------------------------------

    def __getitem__(self, job: str) -> int:
        with self._lock:
            return self._booked[job]

    def get(self, job: str, default: int = 0) -> int:
        with self._lock:
            return self._booked.get(job, default)

    def __contains__(self, job: str) -> bool:
        with self._lock:
            return job in self._booked

    def __iter__(self) -> Iterator[str]:
        return iter(self.snapshot())

    def __len__(self) -> int:
        with self._lock:
            return len(self._booked)

    def keys(self):
        return self.snapshot().keys()

    def values(self):
        return self.snapshot().values()

    def items(self):
        return self.snapshot().items()

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._booked)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, BookingLedger):
            return self.snapshot() == other.snapshot()
        if isinstance(other, dict):
            return self.snapshot() == other
        return NotImplemented

    def __ne__(self, other: object) -> bool:
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __repr__(self) -> str:
        return f"BookingLedger({self.snapshot()!r})"

    # -- the three mutators -------------------------------------------------

    def commit(self, job: str, chips: int) -> None:
        """Book (or re-book) `job` at `chips` (>= 0)."""
        if chips < 0:
            raise ValueError(f"negative booking for {job!r}: {chips}")
        with self._lock:
            if self.journal is not None \
                    and self._booked.get(job) != int(chips):
                self.journal.append("jbook", {"op": "commit", "job": job,
                                              "chips": int(chips)})
            self._booked[job] = int(chips)

    def release(self, job: str) -> int:
        """Drop `job`'s booking entirely; returns the chips it held
        (0 if it held none) so failure paths can re-book or reserve."""
        with self._lock:
            if self.journal is not None and job in self._booked:
                self.journal.append("jbook", {"op": "release", "job": job})
            return self._booked.pop(job, 0)

    def commit_pass(self, result: Dict[str, int]) -> None:
        """Wholesale replace with one pass's decided allocation — the
        decide-phase booking commit (jobs absent from `result` are
        released implicitly; the pass's diff emits their deltas).

        Journaled as a DELTA (`jpass` set/del vs the previous table):
        a steady-state 10k-job pass that changes a handful of bookings
        appends a handful of entries, not the whole fleet — the
        journal-append overhead perf_scale's recovery column bounds."""
        if any(n < 0 for n in result.values()):
            raise ValueError(f"negative booking in pass result: {result}")
        with self._lock:
            if self.journal is not None:
                old = self._booked
                old_get = old.get
                changed = {j: int(n) for j, n in result.items()
                           if old_get(j) != n}
                # A removal implies a size divergence or a net-zero
                # swap (which surfaces in `changed` as a new key) —
                # only then pay the O(n) membership sweep.
                removed: list = []
                if changed or len(old) > len(result):
                    removed = [j for j in old if j not in result]
                if changed or removed:
                    self.journal.append(
                        "jpass", {"set": changed, "del": removed})
            self._booked = {j: int(n) for j, n in result.items()}
