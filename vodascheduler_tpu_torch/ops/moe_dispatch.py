"""Token-routed MoE dispatch: capacity-bounded, every shape static.

Counterpart of the JAX package's ``ops/moe_dispatch.py``, with its routing
semantics:

- `top_k_gating` keeps exactly each token's k largest probabilities, ties
  going to the lower expert index (`lax.top_k`'s rule; here a stable
  descending sort, since `torch.topk` promises no order among equals), and
  renormalises them to sum to 1;
- `expert_capacity` gives each expert ceil(T·k/E·factor) slots, rounded up
  to a multiple of 8, at least 8 and at most T;
- tokens claim an expert's slots in token order over the flattened
  T = B·S of the global batch (`_slot_positions`); a token that finds its
  expert full is dropped for that expert and rides the residual.

Three dispatches compute the same function (`models/mixtral.py` picks one):

- `routed_ffn`: the GShard formulation, one-hot dispatch and combine
  tensors [T, E, C] applied as matrix products;
- `gathered_ffn`: the same routing, tokens moved by an index_add into the
  [E·C + 1, D] expert buffer (row E·C collects the dropped tokens and is
  discarded) and gathered back;
- `dense_ffn`: every expert on every token.

Across ranks (`ExpertLayout`) each dispatch has the reference's layout: the
batch's rows split over the data axes (dp, fsdp) only, so the ranks of an
ep group hold the same tokens, and the experts split over ep (and their
hidden width over tp). T and the capacity are the global batch's, and a
token's slot is its place in the global token order: its data rank's own
count plus an exclusive prefix of the per-expert counts of the data ranks
before it (an all-gather of E integers over each data axis; `local_rows`
cuts contiguous rows, so data-rank order is token order). A rank then
computes its own experts on the slots its own tokens hold, at most
min(C, T_local) a expert, and the experts' partial outputs are summed over
the expert axes. That sum is what GSPMD makes of the reference's combine
with E split over ep; no token travels. In the backward the gradients of
the experts' input and of the gates are partial on each rank (its experts
only) and are summed over the same axes, so that the router and everything
before it take the whole gradient, equal on every rank of the group. One
device is the layout of one data rank and no expert axis: no collective,
a prefix of zero, the same code.

Divergence: the reference's docstring has its einsums lower to an
all_to_all pair, which holds where tokens split on the axis that splits
the experts. Its layout does not do that, and the port follows the layout.

Expert compute is bf16 whatever the model's dtype, routing and the combine
are fp32. No op here has a shape that depends on the data (no `nonzero`,
mask indexing or `unique`, no `.item()`): the host never waits on the card,
and a recompute under `torch.utils.checkpoint` sees the shapes of the
forward and runs the same collectives in the same order on every rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from vodascheduler_tpu_torch.parallel.sharding import sum_grad_over, sum_over


@dataclasses.dataclass(frozen=True)
class ExpertLayout:
    """Where a rank's tokens and experts sit among the ranks: the process
    groups of the data axes that split the batch's rows (outermost first,
    dp then fsdp), those of the axes that split the experts (ep, and tp
    where it splits their hidden width), and the index of this rank's
    first expert. The default is one device."""

    data_groups: Tuple = ()
    expert_groups: Tuple = ()
    expert_offset: int = 0

    @property
    def data_size(self) -> int:
        size = 1
        for g in self.data_groups:
            size *= dist.get_world_size(g)
        return size

    @property
    def data_rank(self) -> int:
        """This rank's place in the data axes, dp-major (`local_rows`)."""
        rank = 0
        for g in self.data_groups:
            rank = rank * dist.get_world_size(g) + dist.get_rank(g)
        return rank


ONE_DEVICE = ExpertLayout()


def top_k_indices(x: torch.Tensor, top_k: int) -> torch.Tensor:
    """The indices of the k largest entries of the last axis, largest
    first, the lower index first among equals (`lax.top_k`)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :top_k]


def top_k_gating(probs: torch.Tensor, top_k: int,
                 eps: float = 1e-9) -> torch.Tensor:
    """[..., E] probabilities -> [..., E] gates: exactly the k largest
    survive, rescaled to sum to 1. Index-based, not a threshold: tied
    probabilities never keep more than k experts."""
    return gates_at(probs, top_k_indices(probs, top_k), eps)


def gates_at(probs: torch.Tensor, indices: torch.Tensor,
             eps: float = 1e-9) -> torch.Tensor:
    """probs [..., E] kept at `indices` [..., k], zero elsewhere, rescaled
    to sum to 1."""
    gate = probs * torch.zeros_like(probs).scatter(-1, indices, 1.0)
    return gate / torch.clamp(gate.sum(-1, keepdim=True), min=eps)


def expert_capacity(num_tokens: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Slots per expert: ceil(T·k/E·factor), rounded up to a multiple of 8,
    at least 8, at most T."""
    c = math.ceil(num_tokens * top_k / num_experts * capacity_factor)
    return min(num_tokens, max(8, -(-c // 8) * 8))


def _slot_positions(gates: torch.Tensor, capacity: int,
                    prefix: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos [T,E] int32, kept [T,E] bool): each token's slot in its
    expert's queue among this rank's tokens, claimed in token order, and
    whether it fits: whether `prefix` [E] (the slots the tokens of the
    data ranks before this one claim, default none) plus `pos` is within
    `capacity`."""
    routed = gates > 0.0
    T, E = routed.shape
    # One scan over the experts' columns laid end to end: a 1-D scan is
    # one fast library pass on the card, where a scan down the T axis of a
    # [T, 8] tensor runs 8 sequential columns. Each column then subtracts
    # the count of the columns before it.
    flat = routed.t().reshape(-1).to(torch.int32).cumsum(0, dtype=torch.int32)
    per = flat.view(E, T)
    before = torch.cat([per.new_zeros(1), per[:-1, -1]])
    pos = (per - before[:, None] - 1).t()
    kept = routed & ((pos if prefix is None else pos + prefix) < capacity)
    return pos, kept


def _prefix(gates: torch.Tensor, layout: ExpertLayout) -> torch.Tensor:
    """[E] int32: for each expert of gates [T, E], the tokens routed to it
    on the data ranks before this one. One all-gather of the per-expert
    counts over each data axis, innermost first, so that the rows come out
    in data-rank order; on the card the counts never leave it."""
    counts = (gates > 0.0).sum(0, dtype=torch.int32)
    every = counts[None]
    for group in reversed(layout.data_groups):
        every = every.contiguous()
        gathered = every.new_empty((dist.get_world_size(group)
                                    * every.shape[0], every.shape[1]))
        dist.all_gather_into_tensor(gathered, every, group=group)
        every = gathered
    return every[:layout.data_rank].sum(0, dtype=torch.int32)


def _local_routing(gates: torch.Tensor, num_experts: int, top_k: int,
                   capacity_factor: float, layout: ExpertLayout
                   ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(pos, kept, slots) for gates [T, E_local] of this rank's experts
    over its T tokens: the global batch's capacity and slot order, `pos`
    the slot among this rank's tokens (the global slot less the prefix),
    `slots` = min(capacity, T) the rows a local expert buffer needs."""
    T = gates.shape[0]
    capacity = expert_capacity(T * layout.data_size, num_experts, top_k,
                               capacity_factor)
    pos, kept = _slot_positions(gates, capacity, _prefix(gates, layout))
    return pos, kept, min(capacity, T)


def route(gates: torch.Tensor, capacity: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch and combine tensors from gates [T, E] (0 where not routed):
    (dispatch [T,E,C] one-hot in the gates' dtype, combine [T,E,C])."""
    pos, kept = _slot_positions(gates, capacity)
    return _one_hot(gates, pos, kept, capacity)


def _one_hot(gates: torch.Tensor, pos: torch.Tensor, kept: torch.Tensor,
             slots: int) -> Tuple[torch.Tensor, torch.Tensor]:
    # A dropped token's slot is `slots`, which matches no column: a zero
    # row.
    slot = torch.where(kept, pos, slots)
    cols = torch.arange(slots, device=gates.device)
    dispatch = (slot[..., None] == cols).to(gates.dtype)
    combine = dispatch * gates[..., None]
    return dispatch, combine


def _expert_mlps(expert_in: torch.Tensor, w_gate: torch.Tensor,
                 w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU over [E, C, D] bf16 expert inputs -> [E, C, D] bf16."""
    h = torch.bmm(expert_in, w_gate.to(torch.bfloat16))
    u = torch.bmm(expert_in, w_up.to(torch.bfloat16))
    return torch.bmm(F.silu(h) * u, w_down.to(torch.bfloat16))


def _enter(x: torch.Tensor, gates: torch.Tensor, layout: ExpertLayout
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x and gates as this rank's experts take them: their gradients,
    partial on each rank of the expert axes, summed over those axes."""
    for group in layout.expert_groups:
        x, gates = sum_grad_over(x, group), sum_grad_over(gates, group)
    return x, gates


def _leave(out: torch.Tensor, layout: ExpertLayout) -> torch.Tensor:
    """This rank's experts' partial output summed over the expert axes
    (the gradient passes through unchanged)."""
    for group in layout.expert_groups:
        out = sum_over(out, group)
    return out


def _local_gates(gates: torch.Tensor, num_local: int,
                 layout: ExpertLayout) -> torch.Tensor:
    """The columns of gates [..., E] of this rank's experts."""
    return gates[..., layout.expert_offset:layout.expert_offset + num_local]


def routed_ffn(x: torch.Tensor, gates: torch.Tensor, w_gate: torch.Tensor,
               w_up: torch.Tensor, w_down: torch.Tensor,
               capacity_factor: float = 1.25, top_k: int = 2,
               layout: ExpertLayout = ONE_DEVICE) -> torch.Tensor:
    """Top-k routed SwiGLU experts over x [B, S, D], the dispatch and the
    combine as products with the one-hot [T, E, C] tensors.

    gates [B, S, E] over every expert; w_gate/w_up [E_l, D, H_l], w_down
    [E_l, H_l, D], this rank's experts (all of them on one device). Each of
    the two products costs 2·T·E·C·D operations, more than the experts
    themselves on one card; `gathered_ffn` moves the same tokens by
    index."""
    B, S, D = x.shape
    E, E_l = gates.shape[-1], w_gate.shape[0]
    T = B * S
    x, gates = _enter(x, gates, layout)
    gates_l = _local_gates(gates.reshape(T, E).float(), E_l, layout)
    pos, kept, slots = _local_routing(gates_l, E, top_k, capacity_factor,
                                      layout)
    dispatch, combine = _one_hot(gates_l, pos, kept, slots)
    xb = x.reshape(T, D).to(torch.bfloat16)
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(torch.bfloat16), xb)
    y = _expert_mlps(expert_in, w_gate, w_up, w_down)
    out = _leave(torch.einsum("tec,ecd->td", combine, y.float()), layout)
    return out.reshape(B, S, D).to(x.dtype)


def gathered_ffn(x: torch.Tensor, gates: torch.Tensor, w_gate: torch.Tensor,
                 w_up: torch.Tensor, w_down: torch.Tensor,
                 capacity_factor: float = 1.25, top_k: int = 2,
                 layout: ExpertLayout = ONE_DEVICE) -> torch.Tensor:
    """Top-k routed SwiGLU experts over x [B, S, D], tokens moved by index:
    the routing of `routed_ffn` (same slots, same drops) at the cost of
    moving T·k rows of D instead of the one-hot products. The arguments
    are `routed_ffn`'s."""
    B, S, D = x.shape
    E, E_l = gates.shape[-1], w_gate.shape[0]
    T = B * S
    x, gates = _enter(x, gates, layout)
    gates_f = gates.reshape(T, E).float()
    pos, kept, slots = _local_routing(_local_gates(gates_f, E_l, layout), E,
                                      top_k, capacity_factor, layout)
    # top_k_gating leaves exactly k nonzero gates, so the k largest (with
    # the same tie rule) are the experts routed_ffn dispatches to; a
    # choice of another rank's expert goes to the discarded row.
    top_e = top_k_indices(gates_f, top_k)                       # [T,k]
    top_w = gates_f.gather(1, top_e)
    local_e = top_e - layout.expert_offset
    mine = (local_e >= 0) & (local_e < E_l)
    local_e = local_e.clamp(0, E_l - 1)
    pos_k = pos.gather(1, local_e)
    kept_k = kept.gather(1, local_e) & mine
    slot = torch.where(kept_k, local_e * slots + pos_k, E_l * slots)
    slot_flat = slot.reshape(T * top_k)

    xb = x.reshape(T, D).to(torch.bfloat16)
    src = xb.repeat_interleave(top_k, dim=0)                    # [T*k,D]
    # At most one token per slot, so the add is a copy; out of place, so
    # a recompute under checkpoint sees fresh tensors.
    expert_in = torch.zeros(E_l * slots + 1, D, dtype=torch.bfloat16,
                            device=x.device).index_add(0, slot_flat, src)
    y = _expert_mlps(expert_in[:-1].reshape(E_l, slots, D),
                     w_gate, w_up, w_down)
    y_flat = torch.cat([y.reshape(E_l * slots, D),
                        y.new_zeros(1, D)], dim=0)
    # index_select, not y_flat[slot_flat]: its backward is an index_add,
    # while the backward of advanced indexing sorts the indices first.
    y_tok = torch.index_select(y_flat, 0, slot_flat).reshape(
        T, top_k, D).float()
    weights = torch.where(kept_k, top_w, torch.zeros_like(top_w))
    out = _leave((y_tok * weights[..., None]).sum(1), layout)
    return out.reshape(B, S, D).to(x.dtype)


def dense_ffn(x: torch.Tensor, gates: torch.Tensor, w_gate: torch.Tensor,
              w_up: torch.Tensor, w_down: torch.Tensor,
              layout: ExpertLayout = ONE_DEVICE) -> torch.Tensor:
    """Every expert on every token, weighted by the gates [B, S, E]: E/k
    times the expert compute of the routed paths, no routing at all. The
    weights are this rank's experts, as in `routed_ffn`."""
    x, gates = _enter(x, gates, layout)
    gates_l = _local_gates(gates, w_gate.shape[0], layout)
    xb = x.to(torch.bfloat16)
    h = torch.einsum("bsd,edh->besh", xb, w_gate.to(torch.bfloat16))
    u = torch.einsum("bsd,edh->besh", xb, w_up.to(torch.bfloat16))
    y = torch.einsum("besh,ehd->besd", F.silu(h) * u,
                     w_down.to(torch.bfloat16))
    out = _leave(torch.einsum("besd,bse->bsd", y.float(), gates_l), layout)
    return out.to(x.dtype)


def dropped_share(gates: torch.Tensor, capacity_factor: float,
                  top_k: int) -> float:
    """The share of token-expert choices in gates [B, S, E] that find their
    expert full (synchronises with the card: for reporting only)."""
    T, E = gates.shape[0] * gates.shape[1], gates.shape[-1]
    g = gates.reshape(T, E).float()
    _, kept = _slot_positions(g, expert_capacity(T, E, top_k,
                                                 capacity_factor))
    routed = (g > 0).sum()
    return float(1.0 - kept.sum() / routed.clamp_min(1))
