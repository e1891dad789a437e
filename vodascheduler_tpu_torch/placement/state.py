"""Placement state: per-host and per-job views of the same binding.

Reference counterpart: pkg/placement/types.go — nodeState{totalSlots,
freeSlots, jobNumWorkers} and jobState{numWorkers, nodeNumSlotsList} where
the *order* of nodeNumSlotsList matters: scale-down releases slots from the
tail (types.go:25-28), matching worker processes being torn down from the
highest rank first.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class HostState:
    """One TPU host (the reference's nodeState, types.go:9-23). Slots are
    chips; a host belongs to jobs via job_num_workers."""

    name: str
    total_slots: int
    free_slots: int = -1  # default: all free
    job_num_workers: Dict[str, int] = dataclasses.field(default_factory=dict)
    coord: Optional[Tuple[int, ...]] = None  # position in the pool's host grid

    def __post_init__(self) -> None:
        if self.free_slots < 0:
            self.free_slots = self.total_slots


@dataclasses.dataclass
class HostSlots:
    """(host, chips) element of a job's ordered placement list (the
    reference's nodeNumSlots, types.go:31-34)."""

    host: str
    num_slots: int


@dataclasses.dataclass
class JobPlacement:
    """A job's placement across hosts (the reference's jobState,
    types.go:37-45). host_slots order is the release order contract:
    scale-down trims from the tail."""

    name: str
    num_workers: int = 0
    host_slots: List[HostSlots] = dataclasses.field(default_factory=list)

    def as_dict(self) -> Dict[str, int]:
        d: Dict[str, int] = {}
        for hs in self.host_slots:
            d[hs.host] = d.get(hs.host, 0) + hs.num_slots
        return d
