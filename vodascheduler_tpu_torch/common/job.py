"""The job spec the backend writes to ``<workdir>/spec.json``.

Copied from the JAX package's ``common/job.py`` (`JobConfig`, `JobSpec`):
a spec written by either package reads back field for field in the other.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from vodascheduler_tpu_torch.common.types import JobKind

RESOURCE_CLASS_AUTO = "auto"


@dataclasses.dataclass(slots=True)
class JobConfig:
    """User-requested elasticity bounds, in chips."""

    num_chips: int = 0       # requested; 0 = unset, defaults to min_num_chips
    min_num_chips: int = 1   # floor for elastic allocation
    max_num_chips: int = 1   # ceiling for elastic allocation
    epochs: int = 1

    def __post_init__(self) -> None:
        if self.num_chips == 0:
            self.num_chips = self.min_num_chips
        if not (0 < self.min_num_chips <= self.max_num_chips):
            raise ValueError(
                f"invalid chip bounds: min={self.min_num_chips} max={self.max_num_chips}"
            )
        if not (self.min_num_chips <= self.num_chips <= self.max_num_chips):
            raise ValueError(
                f"num_chips={self.num_chips} outside [{self.min_num_chips}, {self.max_num_chips}]"
            )


@dataclasses.dataclass
class JobSpec:
    """Native job specification: the model to train, its batch and epoch
    budget, and its elasticity bounds."""

    name: str                      # base name; admission appends a timestamp
    pool: str = "default"
    kind: JobKind = JobKind.JAX_JOB
    config: JobConfig = dataclasses.field(default_factory=JobConfig)
    priority: int = 0
    user: str = ""
    model: str = "mnist_mlp"       # key into models.registry
    dataset: str = "synthetic"
    global_batch_size: int = 128
    steps_per_epoch: int = 100
    workdir: str = ""              # checkpoints + metrics CSVs live here
    # Collective-traffic descriptor the scheduler's placement reads; the
    # supervisor carries it through untouched.
    collectives: Optional[Dict[str, float]] = None
    resource_class: str = RESOURCE_CLASS_AUTO
    extra: Dict[str, str] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["kind"] = self.kind.value
        return d

    @staticmethod
    def from_dict(d: dict) -> "JobSpec":
        d = dict(d)
        if "kind" in d:
            d["kind"] = JobKind(d["kind"])
        if "config" in d and isinstance(d["config"], dict):
            d["config"] = JobConfig(**d["config"])
        return JobSpec(**d)
