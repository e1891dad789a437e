"""The durability plane: write-ahead journal, crash-resume, and
lease-based leader handover (doc/durability.md).

The reference gets control-plane durability for free from MongoDB +
RabbitMQ (PAPER.md §1); this package provides it natively: every
lifecycle transition, booking mutation, placement delta, lease change
and fleet route appends a crash-safe framed record to a `Journal`
(journal.py), snapshots + compaction keep recovery O(live jobs)
(snapshot.py), a restarted scheduler replays to the exact pre-crash
state and reconciles against the backend's live view (recover.py), and
a standby takes over via a file lease with fencing epochs (leader.py).

Crash-consistency is model-checked, not just tested: the `crash`
profile of analysis/modelcheck.py kills the real scheduler at any
action prefix (including mid-pass, at any journal append), recovers
from the journal, and re-checks every invariant over the recovered
state — with seeded durability bugs each caught in
`make modelcheck-selftest`.
"""

from vodascheduler_tpu_torch.durability.journal import (  # noqa: F401
    FencedOut,
    Journal,
    JournalCorrupt,
    MemoryStorage,
    SimulatedCrash,
)
from vodascheduler_tpu_torch.durability.leader import (  # noqa: F401
    FileLease,
    MemoryLease,
)
from vodascheduler_tpu_torch.durability.recover import (  # noqa: F401
    JournalState,
    StandbyApplier,
    read_state,
    read_states_parallel,
    recover_scheduler,
)
from vodascheduler_tpu_torch.durability.shipping import (  # noqa: F401
    FileTailSource,
    HttpTailSource,
    JournalTailer,
    StorageTailSource,
)
from vodascheduler_tpu_torch.durability.standby import (  # noqa: F401
    HotStandby,
    PoolStandby,
    finish_takeover,
)
