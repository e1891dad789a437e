"""Decision-audit tracing plane (observability subsystem).

- `tracer`: spans/events with clock-derived (replay-deterministic) ids, a
  crash-safe size-bounded JSONL sink, an in-memory ring buffer, and
  thread-local context propagation; `TraceContext` serializes to HTTP
  headers and to the supervisor control-channel files.
- `audit`: the per-resched decision record schema — closed trigger and
  reason-code vocabularies with a validator (`make trace-dryrun` gates
  on it).
- `profile`: the phase-level decide/actuate profiler (`PhaseTimer`) —
  per-pass `perf_report` records over the closed `PHASE_NAMES`
  vocabulary (the performance observatory, doc/observability.md).
- `dryrun`: fake-backend scenario that exercises the whole plane and
  validates every emitted record.

See doc/observability.md.
"""

from vodascheduler_tpu_torch.obs.audit import (  # noqa: F401
    JOURNAL_KINDS,
    PHASE_NAMES,
    REASON_CODES,
    RECOVERY_REASONS,
    ROUTE_REASONS,
    SPAN_NAMES,
    STATUS_REASONS,
    TRIGGERS,
    validate_jsonl,
    validate_record,
)
from vodascheduler_tpu_torch.obs.profile import (  # noqa: F401
    PhaseTimer,
    current_timer,
    use_timer,
)
from vodascheduler_tpu_torch.obs.tracer import (  # noqa: F401
    PARENT_SPAN_HEADER,
    TRACE_ID_HEADER,
    Span,
    TraceContext,
    Tracer,
    active_tracer,
    current_context,
    current_tracer,
    get_tracer,
    set_tracer,
    use_context,
)
