"""The durability plane: the write-ahead journal (doc/durability.md).

Every lifecycle transition, booking mutation, placement delta and lease
change appends a crash-safe framed record to a `Journal` (journal.py).

The port holds the journal, which the scheduler imports; snapshots,
recovery, the leader lease, shipping and the hot standby are not ported
yet.
"""

from vodascheduler_tpu_torch.durability.journal import (  # noqa: F401
    FencedOut,
    Journal,
    JournalCorrupt,
    MemoryStorage,
    SimulatedCrash,
)
