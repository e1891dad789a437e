"""Device meshes for elastic jobs.

Counterpart of the JAX package's ``parallel/mesh.py``. The axes are the
reference's:

- ``dp``   pure data parallelism (parameters replicated, gradients
           all-reduced);
- ``fsdp`` data parallelism with parameter and optimizer sharding (FSDP2:
           parameters all-gathered per block, gradients reduce-scattered);
- ``ep``   expert parallelism (each rank holds E/ep of an MoE layer's
           experts; the ranks of an ep group take the same rows of the
           batch, and the experts' partial outputs are summed over the
           group, ops/moe_dispatch.py);
- ``tp``   tensor parallelism (attention heads and the MLP's hidden width,
           activations all-reduced inside each block);
- ``sp``, ``pp``: sequence and pipeline parallelism, which the port plans
           but does not run yet (`check_runnable`).

`plan_mesh` chooses the axis sizes for a chip count and a model's scale
with the reference's heuristics, and gives the same plan for the same
arguments: tp up to the host's card count for models of 1B parameters and
more, fsdp over the rest, dp outermost. `remesh_plan` is the planning half
of the reference's `remesh` (the granted slice of a topology).
`build_mesh` turns a plan into a torch `DeviceMesh` over the process
group's first ranks, in the reference's axis order with tp innermost, so
that tp spans consecutive ranks, which the supervisor gives to the cards of
one host, and rank r holds the coordinate of the reference's device r.
An elastic resize is the plan at the new count and the live state moved
onto its mesh (`sharding.reshard_state`), or a resharding restore
(runtime/checkpoint.py).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Tuple

if TYPE_CHECKING:  # placement stays out of the import graph at run time
    from torch.distributed.device_mesh import DeviceMesh

    from vodascheduler_tpu_torch.placement.topology import (
        PoolTopology,
        SliceShape,
    )

AXES = ("dp", "fsdp", "tp", "sp", "ep", "pp")

# The axes a mesh of the port holds, outermost first: the reference's
# order (dp, pp, fsdp, sp, ep, tp) without the axes the port does not run.
MESH_AXES = ("dp", "fsdp", "ep", "tp")

# The ROADMAP item that brings each axis the port does not run yet.
_NOT_RUN = {"sp": "A13 (sequence parallelism, ring attention)",
            "pp": "A13 (pipeline parallelism)"}


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Chosen axis sizes; their product is the chip count."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1

    @property
    def num_chips(self) -> int:
        return self.dp * self.fsdp * self.tp * self.sp * self.ep * self.pp

    @property
    def data_size(self) -> int:
        """Ranks that take different rows of a batch: dp · fsdp."""
        return self.dp * self.fsdp

    def active_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in AXES if getattr(self, a) > 1)


def _largest_pow2_divisor(n: int, cap: int) -> int:
    d = 1
    while d * 2 <= cap and n % (d * 2) == 0:
        d *= 2
    return d


def plan_mesh(num_chips: int,
              model_params_b: float = 0.0,
              seq_len: int = 0,
              num_experts: int = 0,
              max_tp: int = 4,
              chips_per_host: int = 4,
              topology: Optional["PoolTopology"] = None,
              slice_shape: Optional["SliceShape"] = None) -> MeshPlan:
    """Pick axis sizes for a chip count and model scale (the reference's
    heuristics):

    - models under ~1B parameters: pure dp;
    - bigger models: tp up to min(max_tp, chips_per_host), so that tp's
      collectives stay within a host, and fsdp over the rest;
    - sequences of 32k and more: a factor for sp;
    - MoE: ep divides the expert count.

    `topology` gives the pool's real host size in place of
    `chips_per_host`; `slice_shape`, the granted slice, overrides
    `num_chips` so that the mesh matches the grant exactly.
    """
    if slice_shape is not None:
        num_chips = slice_shape.num_chips
    if topology is not None:
        chips_per_host = topology.chips_per_host
    if num_chips <= 0:
        raise ValueError("num_chips must be positive")
    remaining = num_chips
    tp = 1
    if model_params_b >= 1.0:
        tp = _largest_pow2_divisor(remaining, min(max_tp, chips_per_host))
        remaining //= tp
    sp = 1
    if seq_len >= 32768 and remaining > 1:
        sp = _largest_pow2_divisor(remaining, 4)
        remaining //= sp
    ep = 1
    if num_experts > 1 and remaining > 1:
        ep = _largest_pow2_divisor(remaining, min(num_experts, remaining))
        remaining //= ep
    fsdp = 1
    if model_params_b >= 1.0:
        fsdp = remaining
        remaining = 1
    dp = remaining
    return MeshPlan(dp=dp, fsdp=fsdp, tp=tp, sp=sp, ep=ep)


def remesh_plan(num_chips: int, model_params_b: float = 0.0,
                seq_len: int = 0, num_experts: int = 0,
                topology: Optional["PoolTopology"] = None,
                plan: Optional[MeshPlan] = None) -> MeshPlan:
    """The plan a (re)start at `num_chips` uses: `plan` if given, else
    `plan_mesh` with the topology's feasibility-rounded slice, as the
    reference's `remesh` plans."""
    if plan is not None:
        return plan
    slice_shape = (topology.slice_for(num_chips)
                   if topology is not None else None)
    return plan_mesh(num_chips, model_params_b=model_params_b,
                     seq_len=seq_len, num_experts=num_experts,
                     topology=topology, slice_shape=slice_shape)


def check_runnable(plan: MeshPlan) -> None:
    """Raise NotImplementedError, naming its ROADMAP item, for an axis the
    port plans but does not run. Callers check before any process group
    forms."""
    for axis, item in _NOT_RUN.items():
        size = getattr(plan, axis)
        if size > 1:
            raise NotImplementedError(
                f"mesh plan {plan}: {axis}={size} is not ported to PyTorch "
                f"yet (ROADMAP {item})")


def build_mesh(plan: MeshPlan, device_type: str) -> "DeviceMesh":
    """The plan as a DeviceMesh over the ranks [0, plan.num_chips) of the
    process group: axes MESH_AXES, tp innermost, every axis present even at
    size 1 (so that one code path serves every plan). Every rank of the
    process group calls it (building the mesh's groups is collective); a
    rank beyond the mesh gets no coordinate. Over the whole group it is
    the mesh `init_device_mesh` gives."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    check_runnable(plan)
    world = dist.get_world_size()
    if plan.num_chips > world:
        raise ValueError(f"mesh plan {plan} needs {plan.num_chips} ranks, "
                         f"the process group has {world}")
    ranks = torch.arange(plan.num_chips).reshape(plan.dp, plan.fsdp, plan.ep,
                                                 plan.tp)
    return DeviceMesh(device_type, ranks, mesh_dim_names=MESH_AXES)
