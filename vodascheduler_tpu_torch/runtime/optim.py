"""Adafactor as `optax.adafactor(learning_rate=lr)` computes it.

`torch.optim.Adafactor` is another algorithm. This is optax's chain with
its defaults, in its order: the factored RMS scaling
(`scale_by_factored_rms`: decay 0.8, offset 0, factoring only axes of at
least 128, eps 1e-30), `clip_by_block_rms(1.0)`, × lr,
`scale_by_param_block_rms` (min 1e-3), × −1. No momentum, no weight decay.

optax decides two things from each *leaf* of the reference's param tree:
whether to factor the second moment and over which two axes (the two
largest, if the second largest is at least 128), and the block over which
both RMS values are taken (the whole leaf). The port's parameters are not
the reference's leaves: a scanned config stacks every layer on a leading
axis, q/k/v kernels are ``[D, H, hd]`` and Dense kernels ``[in, out]``,
where the port keeps one ``[out, in]`` weight per layer. So each param
group here is one reference leaf (`bridge.reference_param_groups`):

    {"params": [p_layer0, p_layer1, ...], "leaf": "<reference path>",
     "shape": <leaf shape>, "stacked": <params stacked on a leading axis>,
     "transposed": <each param is the transpose of its slice>}

Each step gathers the group's gradients into the leaf's shape, runs optax's
arithmetic on the leaf, and scatters the update back. The state is optax's,
in the leaf's shape, kept on the group's first parameter (the others hold
an empty entry). Parameters given without groups are each a leaf of their
own shape.

On sharded parameters (DTensors: FSDP2, tensor and expert parallelism,
parallel/sharding.py) the row, column and whole-leaf means must be the
whole leaf's, as optax takes them under GSPMD. So each rank gathers the
group's gradients whole, runs the same arithmetic on the whole leaf as
every other rank (the state is whole and identical on every rank), and
adds its own shard of the update; the parameters' RMS is a sum over the
shards.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

DECAY_RATE = 0.8
DECAY_OFFSET = 0
MIN_DIM_SIZE_TO_FACTOR = 128
EPS = 1e-30
CLIPPING_THRESHOLD = 1.0
MIN_PARAM_SCALE = 1e-3


def factored_dims(shape: Sequence[int]) -> Optional[Tuple[int, int]]:
    """optax's `_factored_dims` with the defaults: (d1, d0), the second
    largest and the largest axis, or None when the second largest is under
    MIN_DIM_SIZE_TO_FACTOR."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


def to_leaf(group: dict, tensors: List[torch.Tensor]) -> torch.Tensor:
    """The group's tensors (gradients or parameters, one per parameter) as
    one tensor of the reference leaf's shape."""
    shape = tuple(group["shape"])
    slice_shape = shape[1:] if group["stacked"] else shape
    parts = [(t.T if group["transposed"] else t).reshape(slice_shape)
             for t in tensors]
    return torch.stack(parts) if group["stacked"] else parts[0]


def from_leaf(group: dict, leaf: torch.Tensor, i: int) -> torch.Tensor:
    """The slice of `leaf` that belongs to the group's i-th parameter, in
    that parameter's layout."""
    p = group["params"][i]
    part = leaf[i] if group["stacked"] else leaf
    if group["transposed"]:
        return part.reshape(p.shape[::-1]).T
    return part.reshape(p.shape)


def _leaf_groups(params) -> List[dict]:
    """Leaf groups as given, or each of the given parameters a leaf of its
    own shape."""
    params = list(params)
    if params and isinstance(params[0], dict):
        return params
    return [{"params": [p], "leaf": "", "shape": tuple(p.shape),
             "stacked": False, "transposed": False} for p in params]


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole (a plain tensor as is)."""
    full = getattr(t, "full_tensor", None)
    return t if full is None else full()


def _like(p: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
    """`whole`, a tensor of p's global shape, laid out as `p`: for a
    DTensor, this rank's shard of it, cut locally (every rank holds the
    same `whole`)."""
    if getattr(p, "device_mesh", None) is None:
        return whole
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(whole, p.device_mesh, p.placements,
                             src_data_rank=None)


class Adafactor(torch.optim.Optimizer):
    """`optax.adafactor(learning_rate=lr)` over reference leaves (module
    docstring)."""

    def __init__(self, params, lr: float):
        super().__init__(_leaf_groups(params), {"lr": lr})
        for group in self.param_groups:
            p = group["params"][0]
            shape = tuple(group["shape"])
            state = {"step": 0}
            dims = factored_dims(shape)
            if dims is None:
                state["v"] = torch.zeros(shape, dtype=p.dtype, device=p.device)
            else:
                d1, d0 = dims
                state["v_row"] = torch.zeros(np.delete(shape, d0).tolist(),
                                             dtype=p.dtype, device=p.device)
                state["v_col"] = torch.zeros(np.delete(shape, d1).tolist(),
                                             dtype=p.dtype, device=p.device)
            self.state[p] = state
            # torch's state-dict tools (torch.distributed.checkpoint's
            # set_state_dict) want an entry for every parameter that trains.
            for q in group["params"][1:]:
                self.state[q] = {}

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = group["params"]
            if all(p.grad is None for p in params):
                continue
            grad = to_leaf(group, [_whole(torch.zeros_like(p) if p.grad is None
                                          else p.grad) for p in params])
            state = self.state[params[0]]
            update = self._factored_rms(group, state, grad)
            # clip_by_block_rms: the RMS of the whole leaf's update
            update = update / torch.clamp(
                update.square().mean().sqrt() / CLIPPING_THRESHOLD, min=1.0)
            update = update * group["lr"]
            # scale_by_param_block_rms: the RMS of the whole leaf's values
            numel = sum(p.numel() for p in params)
            rms = (sum(_whole(p.square().sum()) for p in params)
                   / numel).sqrt()
            update = update * torch.clamp(rms, min=MIN_PARAM_SCALE)
            update = update * -1
            for i, p in enumerate(params):
                p.add_(_like(p, from_leaf(group, update, i)))
            state["step"] += 1
        return loss

    @staticmethod
    def _factored_rms(group: dict, state: dict,
                      grad: torch.Tensor) -> torch.Tensor:
        """optax's `scale_by_factored_rms` on one leaf; updates `state`."""
        t = torch.tensor(state["step"] - DECAY_OFFSET + 1, dtype=torch.float32)
        decay = float(1.0 - t ** -DECAY_RATE)
        grad_sqr = grad * grad + EPS
        dims = factored_dims(tuple(group["shape"]))
        if dims is None:
            state["v"] = decay * state["v"] + (1.0 - decay) * grad_sqr
            return grad * state["v"] ** -0.5
        d1, d0 = dims
        v_row = decay * state["v_row"] + (1.0 - decay) * grad_sqr.mean(d0)
        v_col = decay * state["v_col"] + (1.0 - decay) * grad_sqr.mean(d1)
        state["v_row"], state["v_col"] = v_row, v_col
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_col_mean = v_row.mean(reduced_d1, keepdim=True)
        row_factor = (v_row / row_col_mean) ** -0.5
        col_factor = v_col ** -0.5
        return grad * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
