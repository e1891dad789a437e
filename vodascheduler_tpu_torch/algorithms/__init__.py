"""The scheduling-algorithm library: 8 pluggable allocation policies.

Reference counterpart: pkg/algorithm. Each algorithm maps
(ready jobs, total chips) -> {job: chips}. Pure functions of their inputs —
no I/O — so they are exhaustively unit-testable (the reference had zero
algorithm tests, SURVEY.md §4).

Factory names match the reference (pkg/algorithm/types.go:26-46) so runtime
`PUT /algorithm` requests are drop-in compatible.
"""

from vodascheduler_tpu_torch.algorithms.base import (
    SchedulerAlgorithm,
    InvalidAllocationError,
    validate_result,
)
from vodascheduler_tpu_torch.algorithms.fifo import FIFO
from vodascheduler_tpu_torch.algorithms.elastic_fifo import ElasticFIFO
from vodascheduler_tpu_torch.algorithms.srjf import SRJF
from vodascheduler_tpu_torch.algorithms.elastic_srjf import ElasticSRJF
from vodascheduler_tpu_torch.algorithms.tiresias import (
    Tiresias,
    TIRESIAS_QUEUE_NUM,
    TIRESIAS_THRESHOLDS_SEC,
    TIRESIAS_PROMOTE_KNOB,
    tiresias_demote_priority,
    tiresias_promote_priority,
)
from vodascheduler_tpu_torch.algorithms.elastic_tiresias import ElasticTiresias
from vodascheduler_tpu_torch.algorithms.ffdl_optimizer import FfDLOptimizer
from vodascheduler_tpu_torch.algorithms.afsl import AFSL

_REGISTRY = {
    "FIFO": FIFO,
    "ElasticFIFO": ElasticFIFO,
    "SRJF": SRJF,
    "ElasticSRJF": ElasticSRJF,
    "Tiresias": Tiresias,
    "ElasticTiresias": ElasticTiresias,
    "FfDLOptimizer": FfDLOptimizer,
    "AFS-L": AFSL,
}

ALGORITHM_NAMES = tuple(_REGISTRY)


def new_algorithm(name: str, scheduler_id: str = "") -> SchedulerAlgorithm:
    """Reference: NewAlgorithmFactory (pkg/algorithm/types.go:26-46)."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown algorithm {name!r}; known: {ALGORITHM_NAMES}")
    return cls(scheduler_id)
