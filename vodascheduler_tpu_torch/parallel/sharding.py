"""Sharding rules: map parameters and batches onto the mesh.

Counterpart of the JAX package's ``parallel/sharding.py``. The rules are
the reference's, path regex -> spec, first match wins, over the
reference's parameter paths (the bridge names each parameter of the port
by its reference leaf, `reference_leaves`): the same model reshapes onto
any mesh, the property elastic resize depends on. A spec is a tuple of
axis names (or None) per dimension of the reference leaf, as a
`PartitionSpec` lists them; `_fit_spec` drops an axis that does not divide
its dimension, as the reference does.

`apply_rules` turns the fitted specs into torch's mechanisms:

- ``tp``: `parallelize_module`. A q/k/v, gate/up or fc1 projection split
  over tp is `ColwiseParallel` and its o, down or fc2 partner
  `RowwiseParallel`, with local outputs (`use_local_output=True`), so the
  attention and the MLP run on this rank's heads and hidden columns and
  one all-reduce closes each block. The rules split no other Dense of the
  registry's bundles over tp; one that they did would raise.
- ``ep`` (and ``tp`` on the experts' hidden width): `_shard_experts`
  makes each MoE block's stacked expert kernels DTensors of the (ep, tp)
  sub-mesh, cut on the dimensions the rules name (E over ep; H over tp,
  dimension 2 of gate/up [E, D, H] and 1 of down [E, H, D]), and gives
  the block its `ExpertLayout`: the rank's E/ep experts and the groups its
  dispatch sums over (ops/moe_dispatch.py). The router stays whole.
- ``dp`` × ``fsdp``: `fully_shard` of each layer and of the root over the
  (dp, fsdp) sub-mesh: HSDP, replicated over dp and sharded over fsdp,
  also when both are 1, so one code path serves every plan and every
  parameter is a DTensor. An expert kernel is a DTensor of the whole mesh:
  FSDP2 shards its local block over (dp, fsdp), and reduces its gradient
  there only, as every other parameter's: ep replicas are not data ranks.

Where torch's layout differs from the reference's, no result changes:

- a Dense weight is [out, in] (the reference's kernel is [in, out]) and
  q/k/v weights are [H·hd, D] (the reference's [D, H, hd]): tp splits the
  same heads and columns, on torch's axis (`reference_leaves` maps each
  reference dimension to torch's);
- FSDP2 shards every parameter on its dimension 0 over fsdp, padding an
  uneven one, where the reference shards the rule's dimension and
  replicates norms, biases and dimensions fsdp does not divide;
- the token embedding and the Llama head (``embed/embedding``,
  ``lm_head_kernel``, `UNSPLIT_OVER_TP`) stay whole over tp: the model
  reads them as tensors (`F.embedding`, the chunked loss), not through a
  module that a tp style could split. The reference splits the embedding's
  model dimension and the head's vocabulary over tp;
- a plan whose tp divides the heads but not the kv heads splits q and o
  and keeps k and v whole, as the reference's `_fit_spec` does; each rank
  then takes its heads of the expanded k/v (`Attention.head_offset`);
- FSDP2 takes a parameter that is already a DTensor on at most two axes
  (here ep and tp), and shards dimension 0 unless told otherwise, which
  for an expert kernel is the E that ep already splits. So an expert
  kernel goes over fsdp on the rule's dimension, D (`shard_placement_fn`),
  as the reference has it; D must then divide evenly over fsdp, or the
  rule drops fsdp there and FSDP2 takes dimension 0. An axis of size 1
  splits no expert kernel, so on one rank (the card's plan) the experts
  are FSDP2's alone, as in every plan before the ep axis.
  torch.distributed.checkpoint and `reshard_state` see the global
  [E, D, H] whatever the layout, so a checkpoint or a live state moves
  across ep sizes.

Batches: the batch dimension over the data axes (dp, fsdp), as
`batch_sharding` says; each data rank takes its contiguous rows
(`local_rows`), and the ep and tp ranks of a data group take the same
rows.

`reshard_state` moves a live module's and optimizer's state from one mesh
to another: the data half of the in-place resize.
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

Spec = Tuple[Optional[str], ...]


def P(*axes: Optional[str]) -> Spec:
    """A spec: one mesh axis name (or None) per dimension."""
    return tuple(axes)


@dataclasses.dataclass
class ShardingRules:
    """Ordered (path-regex, spec) rules; first match wins. `default`
    applies when nothing matches (replicate)."""

    rules: List[Tuple[str, Spec]]
    default: Spec = ()

    def spec_for(self, path: str) -> Spec:
        for pattern, spec in self.rules:
            if re.search(pattern, path):
                return spec
        return self.default


# The reference's per-layer transformer rules: tp splits the attention
# heads and the MLP's hidden width, fsdp the other big axis, the experts
# go over ep. The scanned rules are derived from this list.
_LAYER_RULES = [
    (r"(q_proj|k_proj|v_proj).*kernel$", P("fsdp", "tp")),
    (r"o_proj.*kernel$", P("tp", "fsdp")),
    (r"(up_proj|gate_proj|fc1).*kernel$", P("fsdp", "tp")),
    (r"(down_proj|fc2).*kernel$", P("tp", "fsdp")),
    (r"experts.*(up|gate).*kernel$", P("ep", "fsdp", "tp")),
    (r"experts.*down.*kernel$", P("ep", "tp", "fsdp")),
    (r"router.*kernel$", P("fsdp", None)),
]

TRANSFORMER_RULES = ShardingRules(rules=(
    [(r"layers_scan.*" + pattern, P("pp", *spec))
     for pattern, spec in _LAYER_RULES]
    + [(r"embed.*embedding$", P("fsdp", "tp"))]
    + _LAYER_RULES
    + [(r"lm_head.*kernel$", P("fsdp", "tp")),
       (r"(norm|scale|bias|ln)", P())]))

CONV_RULES = ShardingRules(rules=[
    (r"conv.*kernel$", P(None, None, None, "fsdp")),
    (r"dense.*kernel$", P("fsdp", "tp")),
    (r"(bn|norm|scale|bias)", P()),
])

# Reference leaves the port keeps whole over tp (module docstring).
UNSPLIT_OVER_TP = (r"embed.*embedding$", r"lm_head.*kernel$")


def _fit_spec(spec: Spec, shape: Sequence[int],
              mesh_shape: Dict[str, int]) -> Spec:
    """Trim a spec to the array's rank and drop the axes that are absent,
    of size 1 or do not divide their dimension (that dimension is then
    replicated)."""
    out = []
    for i, dim in enumerate(shape):
        axis = spec[i] if i < len(spec) else None
        size = mesh_shape.get(axis, 1) if axis is not None else 1
        out.append(axis if size > 1 and dim % size == 0 else None)
    return tuple(out)


def batch_sharding(mesh_shape: Dict[str, int],
                   seq_axis: Optional[str] = None) -> Spec:
    """The batch's spec: its dimension 0 over the data axes of size above
    1 (dp, fsdp), and optionally the sequence over `seq_axis`."""
    data = tuple(a for a in ("dp", "fsdp") if mesh_shape.get(a, 1) > 1)
    # one axis is named alone, as a PartitionSpec normalises it
    batch = data[0] if len(data) == 1 else (data or None)
    if seq_axis and mesh_shape.get(seq_axis, 1) > 1:
        return (batch, seq_axis)
    return (batch,)


def local_rows(batch: Any, data_size: int, data_rank: int) -> Any:
    """This data rank's contiguous rows of every tensor of `batch` (a
    tensor or nested dicts/lists of them), the global batch cut in
    `data_size` equal parts along dimension 0."""
    if data_size == 1:
        return batch
    if isinstance(batch, torch.Tensor):
        if batch.shape[0] % data_size:
            raise ValueError(
                f"global batch {batch.shape[0]} does not divide over "
                f"{data_size} data ranks (dp · fsdp)")
        rows = batch.shape[0] // data_size
        return batch[data_rank * rows:(data_rank + 1) * rows]
    if isinstance(batch, dict):
        return {k: local_rows(v, data_size, data_rank)
                for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(local_rows(v, data_size, data_rank)
                           for v in batch)
    return batch


# ---------------------------------------------------------------------------
# the port's parameters as the reference's leaves
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Leaf:
    """A parameter of the port seen as (its slice of) a reference leaf:
    the leaf's path and shape, and for each of the leaf's dimensions the
    torch dimension that holds it (None: the stacked layer axis, which a
    parameter of one layer does not have)."""

    path: str
    shape: Tuple[int, ...]
    torch_dims: Tuple[Optional[int], ...]


def _owner(module: nn.Module, name: str) -> Tuple[nn.Module, str]:
    parent, _, leaf = name.rpartition(".")
    return (module.get_submodule(parent) if parent else module), leaf


def reference_leaves(module: nn.Module) -> Dict[str, Leaf]:
    """Every parameter of `module` by name -> its reference Leaf. Llama
    and Mixtral go through the bridge's leaf groups (their layers are
    named apart, bridge.py); the other families name every submodule as
    flax does, and only the layouts change."""
    from vodascheduler_tpu_torch import bridge
    from vodascheduler_tpu_torch.models.layers import Attention, Conv, Dense
    from vodascheduler_tpu_torch.models.llama import Llama
    from vodascheduler_tpu_torch.models.mixtral import Mixtral

    out: Dict[str, Leaf] = {}
    named = list(module.named_parameters())
    if isinstance(module, (Llama, Mixtral)):
        by_param = {}
        for g in bridge.reference_param_groups(named, module.cfg):
            for p in g["params"]:
                by_param[id(p)] = g
        for name, p in named:
            g = by_param[id(p)]
            slice_shape = g["shape"][1:] if g["stacked"] else g["shape"]
            if not g["transposed"]:
                dims = tuple(range(len(slice_shape)))
            elif len(slice_shape) == 3:  # q/k/v [D, H, hd] of [H*hd, D]
                dims = (1, 0, 0)
            else:  # Dense [in, out] of [out, in]
                dims = (1, 0)
            if g["stacked"]:
                dims = (None,) + dims
            out[name] = Leaf(g["leaf"], tuple(g["shape"]), dims)
        return out
    for name, p in named:
        owner, attr = _owner(module, name)
        parts = name.split(".")
        shape = tuple(p.shape)
        dims: Tuple[Optional[int], ...] = tuple(range(p.dim()))
        if isinstance(owner, nn.Embedding):
            parts[-1] = "embedding"
        elif isinstance(owner, Conv) and attr == "weight":  # HWIO of OIHW
            parts[-1] = "kernel"
            shape = (shape[2], shape[3], shape[1], shape[0])
            dims = (2, 3, 1, 0)
        elif isinstance(owner, Dense) and attr == "weight":
            parts[-1] = "kernel"
            parent, _ = _owner(module, name.rpartition(".")[0])
            if isinstance(parent, Attention) and parts[-2] in (
                    "q_proj", "k_proj", "v_proj"):
                hd = parent.cfg.head_dim
                shape = (shape[1], shape[0] // hd, hd)
                dims = (1, 0, 0)
            else:
                shape = (shape[1], shape[0])
                dims = (1, 0)
        out[name] = Leaf("/".join(parts), shape, dims)
    return out


def param_placements(module: nn.Module, rules: ShardingRules,
                     mesh_shape: Dict[str, int]) -> Dict[str, Dict[str, Any]]:
    """For each parameter: its reference leaf, the rules' spec fitted to
    the leaf and `mesh_shape`, and the torch dimension each mesh axis
    splits ({axis: dim}). tp is as `apply_rules` realises it (without the
    leaves of UNSPLIT_OVER_TP); fsdp is the reference's rule (FSDP2 itself
    splits dimension 0, module docstring)."""
    out = {}
    for name, leaf in reference_leaves(module).items():
        spec = _fit_spec(rules.spec_for(leaf.path), leaf.shape, mesh_shape)
        split = {}
        for i, axis in enumerate(spec):
            if axis is not None and leaf.torch_dims[i] is not None:
                split[axis] = leaf.torch_dims[i]
        if "tp" in split and any(re.search(p, leaf.path)
                                 for p in UNSPLIT_OVER_TP):
            del split["tp"]
        out[name] = {"leaf": leaf, "spec": spec, "split": split}
    return out


# ---------------------------------------------------------------------------
# the rules as torch's mechanisms
# ---------------------------------------------------------------------------

# (module class name, the projections that split their output, the one
# that takes the split input): the pairs whose activations stay split
# between two products.
_PAIRS = {"Attention": (("q_proj", "k_proj", "v_proj"), "o_proj"),
          "SwiGLU": (("gate_proj", "up_proj"), "down_proj"),
          "EncoderBlock": (("fc1",), "fc2")}


class _SumGradOverGroup(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over `group`."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        torch.distributed.all_reduce(grad, group=ctx.group)
        return grad, None


class _SumOverGroup(torch.autograd.Function):
    """The forward sums x over `group`; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_grad_over(x: torch.Tensor, group) -> torch.Tensor:
    """x, whose gradient is summed over `group` in the backward."""
    return _SumGradOverGroup.apply(x, group)


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over `group`, the gradient passed through unchanged."""
    return _SumOverGroup.apply(x, group)


def _sum_grad_hook(group, module, inputs, output):
    return sum_grad_over(output, group)


def _tp_plan(module: nn.Module, placements: Dict[str, Dict[str, Any]],
             tp_rank: int, tp_size: int, tp_group=None) -> Dict[str, Any]:
    """parallelize_module's plan: FQN of a Dense -> its style."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.parallel import (
        ColwiseParallel,
        RowwiseParallel,
    )

    from vodascheduler_tpu_torch.models.layers import Dense

    def tp_dim(fqn: str) -> Optional[int]:
        entry = placements.get(f"{fqn}.weight")
        return None if entry is None else entry["split"].get("tp")

    plan: Dict[str, Any] = {}
    paired = set()
    for fqn, sub in module.named_modules():
        pair = _PAIRS.get(type(sub).__name__)
        if pair is None:
            continue
        producers, consumer = pair
        prefix = f"{fqn}." if fqn else ""
        split_in = False
        for name in producers:
            paired.add(prefix + name)
            if tp_dim(prefix + name) == 0:
                plan[prefix + name] = ColwiseParallel()
                split_in = split_in or name == producers[0]
        paired.add(prefix + consumer)
        if tp_dim(prefix + consumer) == 1:
            plan[prefix + consumer] = RowwiseParallel(
                input_layouts=Shard(-1) if split_in else Replicate())
        if type(sub).__name__ == "Attention":
            if prefix + "o_proj" not in plan and split_in:
                raise ValueError(f"{fqn}: q split over tp but not o_proj")
            kv_split = tp_dim(prefix + "k_proj") == 0
            if split_in and not kv_split:
                sub.head_offset = tp_rank * (sub.cfg.num_heads // tp_size)
                # Each rank reads its heads of the whole k/v: their
                # gradients are the sum over the tp ranks.
                for name in ("k_proj", "v_proj"):
                    getattr(sub, name).register_forward_hook(
                        functools.partial(_sum_grad_hook, tp_group))
    for fqn, sub in module.named_modules():
        if fqn not in paired and isinstance(sub, Dense) and \
                tp_dim(fqn) is not None:
            raise NotImplementedError(
                f"{fqn}: the rules split it over tp, and the port splits "
                "only the attention's and the MLP's projections")
    return plan


EXPERT_PARAMS = ("experts_gate_kernel", "experts_up_kernel",
                 "experts_down_kernel")


def _shard_experts(module: nn.Module, mesh,
                   rules: ShardingRules) -> Dict[nn.Parameter, Any]:
    """Each MoE block's experts cut over the axes that the rules split them
    on (ep on E, tp on the hidden width) as DTensors of the (ep, tp)
    sub-mesh, and the block's `ExpertLayout`: the data axes' groups, the
    expert axes' groups (each axis that splits the experts, and one of size
    1, a sum over one rank) and its first expert. Returns FSDP2's
    placement of each expert kernel that the rules split over fsdp: the
    rule's dimension (D)."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from vodascheduler_tpu_torch.models.mixtral import MoEBlock
    from vodascheduler_tpu_torch.ops.moe_dispatch import ExpertLayout

    blocks = [(fqn, m) for fqn, m in module.named_modules()
              if isinstance(m, MoEBlock)]
    fsdp_dims: Dict[nn.Parameter, Any] = {}
    if not blocks:
        return fsdp_dims
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    placements = param_placements(module, rules, sizes)
    data_groups = tuple(mesh.get_group(a) for a in ("dp", "fsdp"))
    for fqn, block in blocks:
        splits = [placements[f"{fqn}.{name}" if fqn else name]["split"]
                  for name in EXPERT_PARAMS]
        axes = tuple(a for a in ("ep", "tp") if a in splits[0])
        if any(tuple(a for a in ("ep", "tp") if a in s) != axes
               for s in splits):
            raise ValueError(f"{fqn}: the rules split the experts' "
                             f"kernels over different axes: {splits}")
        summed = tuple(a for a in ("ep", "tp")
                       if a in axes or sizes[a] == 1)
        local = block.cfg.num_experts // (sizes["ep"] if "ep" in axes else 1)
        offset = (mesh.get_local_rank("ep") * local if "ep" in axes else 0)
        block.layout = ExpertLayout(
            data_groups=data_groups,
            expert_groups=tuple(mesh.get_group(a) for a in summed),
            expert_offset=offset)
        sub = (None if not axes else
               mesh[axes] if len(axes) > 1 else mesh[axes[0]])
        for name, split in zip(EXPERT_PARAMS, splits):
            if sub is not None:
                setattr(block, name, nn.Parameter(distribute_tensor(
                    getattr(block, name).detach(), sub,
                    [Shard(split[a]) for a in axes], src_data_rank=None)))
            if "fsdp" in split:
                fsdp_dims[getattr(block, name)] = Shard(split["fsdp"])
    return fsdp_dims


def _fsdp_units(module: nn.Module) -> List[nn.Module]:
    """The submodules FSDP2 gathers one at a time: each layer of a
    `layers` list (the decoder families), before the root."""
    layers = getattr(module, "layers", None)
    return list(layers) if isinstance(layers, nn.ModuleList) else []


def apply_rules(module: nn.Module, mesh, rules: ShardingRules) -> nn.Module:
    """Shard `module` in place over `mesh` (axes dp, fsdp, ep, tp) by
    `rules` (module docstring); returns it. Every parameter becomes a
    DTensor."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor.parallel import parallelize_module

    mesh_shape = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    tp_size = mesh_shape.get("tp", 1)
    if tp_size > 1:
        placements = param_placements(module, rules, mesh_shape)
        tp_mesh = mesh["tp"]
        plan = _tp_plan(module, placements, tp_mesh.get_local_rank(),
                        tp_size, tp_mesh.get_group())
        if plan:
            parallelize_module(module, tp_mesh, plan)
    fsdp_dims = _shard_experts(module, mesh, rules)
    data_mesh = mesh["dp", "fsdp"]
    for unit in _fsdp_units(module) + [module]:
        fully_shard(unit, mesh=data_mesh, shard_placement_fn=fsdp_dims.get)
    return module


# ---------------------------------------------------------------------------
# the live state from one mesh to another
# ---------------------------------------------------------------------------


def _leaves(tree: Any, path: Tuple = ()):
    """(path, leaf) of every leaf of nested dicts."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, path + (key,))
    else:
        yield path, tree


def _state_dicts(pair, optimizer: bool):
    """The (module, optimizer) pair's state dicts, as torch's checkpoint
    tools give them (keyed by parameter names), and their leaves by path;
    without `optimizer`, the module's alone."""
    from torch.distributed.checkpoint.state_dict import (
        get_model_state_dict,
        get_state_dict,
    )

    module, optim = pair
    if optimizer:
        model_sd, optim_sd = get_state_dict(module, optim)
    else:
        model_sd, optim_sd = get_model_state_dict(module), None
    tree = {"model": model_sd,
            "optim": optim_sd["state"] if optim_sd is not None else {}}
    return model_sd, optim_sd, tree, dict(_leaves(tree))


def _sent(tensor: torch.Tensor, group, device) -> torch.Tensor:
    """`tensor` as the group's rank 0 holds it, on every rank of `group`
    (as is without one), on `device` for the collective."""
    if group is None:
        return tensor
    moved = tensor.to(device, copy=True).contiguous()
    torch.distributed.broadcast(moved, src=0, group=group)
    return moved


def reshard_state(old, new, group, optimizer: bool = True) -> None:
    """Move the live state of a module and its optimizer from the old
    mesh's layout to the new one's: the data half of the in-place resize
    (the reference's `reshard_state`).

    `old` and `new` are (module, optimizer) pairs, None on a rank outside
    that mesh, and `group` the new mesh's ranks (None without a process
    group): every rank of either mesh calls this. One tensor at a time, in
    the order of the state's sorted keys, so that every rank takes the same
    collectives in the same order: a DTensor is gathered whole on the old
    mesh (`full_tensor`), sent from the new mesh's rank 0 to its other
    ranks, where a rank new to the mesh passes an empty tensor of the
    right shape, and cut there to the new layout (`distribute_tensor`
    without a source rank). A scatter along each of the mesh's dimensions
    would start from that dimension's first rank, which a rank new to the
    mesh can be. A tensor that every rank holds whole (AdamW's `step`,
    Adafactor's moments, a BatchNorm's buffers) and a number (Adafactor's
    step) go from rank 0 likewise. Every tensor of the module and of the
    optimizer moves, AdamW's per-parameter `step`, which sets the bias
    correction, and Adafactor's factored leaves included; the new module
    and optimizer then load the moved state (`set_state_dict`). Pure data
    movement: the values arrive bitwise. The collectives run on the old
    mesh's groups and on `group`, never on the default group.
    `optimizer=False` moves the module's state alone (before the first
    step, when torch's optimizers hold none).

    Divergence: the reference's donated `device_put` keeps device memory
    near one copy of the state. Here a rank holds the old and the new state
    together until the caller drops the old one.
    """
    from torch.distributed.checkpoint.state_dict import (
        set_model_state_dict,
        set_state_dict,
    )
    from torch.distributed.tensor import DTensor, distribute_tensor

    if old is None and new is None:
        return
    src = _state_dicts(old, optimizer)[3] if old is not None else None
    dst_tree = dst = None
    if new is not None:
        model_sd, optim_sd, dst_tree, dst = _state_dicts(new, optimizer)
    if src is not None and dst is not None and set(src) != set(dst):
        raise ValueError(
            f"the old and the new state differ: "
            f"{sorted(set(src) ^ set(dst), key=str)[:5]}")
    device = (next(new[0].parameters()).device if new is not None
              else None)
    with torch.no_grad():
        for path in sorted(src if src is not None else dst,
                           key=lambda p: tuple(map(str, p))):
            value = src[path] if src is not None else None
            if isinstance(value, DTensor):
                value = value.full_tensor()
            if dst is None:
                continue
            target = dst[path]
            if isinstance(target, DTensor):
                local = target.to_local()
                whole = (value if value is not None else torch.empty(
                    target.shape, dtype=target.dtype, device=local.device))
                whole = _sent(whole, group, device)
                local.copy_(distribute_tensor(
                    whole, target.device_mesh, target.placements,
                    src_data_rank=None).to_local())
            elif isinstance(target, torch.Tensor):
                whole = value if value is not None else target
                target.copy_(_sent(whole, group, device))
            else:  # a number
                number = torch.tensor(value if value is not None else target,
                                      dtype=torch.float64)
                parent = dst_tree
                for key in path[:-1]:
                    parent = parent[key]
                parent[path[-1]] = type(target)(
                    _sent(number, group, device).item())
        if new is None:
            return
        if optimizer:
            set_state_dict(new[0], new[1], model_state_dict=model_sd,
                           optim_state_dict=optim_sd)
        else:
            set_model_state_dict(new[0], model_sd)
