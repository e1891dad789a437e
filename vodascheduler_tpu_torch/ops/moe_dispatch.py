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
  T = B·S (`_slot_positions`); a token that finds its expert full is
  dropped for that expert and rides the residual.

Three dispatches compute the same function (`models/mixtral.py` picks one):

- `routed_ffn`: the GShard formulation, one-hot dispatch and combine
  tensors [T, E, C] applied as matrix products;
- `gathered_ffn`: the same routing, tokens moved by an index_add into the
  [E·C + 1, D] expert buffer (row E·C collects the dropped tokens and is
  discarded) and gathered back;
- the dense path (in `MoEBlock`): every expert on every token.

Expert compute is bf16 whatever the model's dtype, routing and the combine
are fp32. No op here has a shape that depends on the data (no `nonzero`,
mask indexing or `unique`): the host never waits on the card, and a
recompute under `torch.utils.checkpoint` sees the shapes of the forward.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


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


def _slot_positions(gates: torch.Tensor, capacity: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos [T,E] int32, kept [T,E] bool): each token's slot in its
    expert's queue, claimed in token order, and whether it fits."""
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
    kept = routed & (pos < capacity)
    return pos, kept


def route(gates: torch.Tensor, capacity: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch and combine tensors from gates [T, E] (0 where not routed):
    (dispatch [T,E,C] one-hot in the gates' dtype, combine [T,E,C])."""
    pos, kept = _slot_positions(gates, capacity)
    # A dropped token's slot is C, which matches no column: a zero row.
    slot = torch.where(kept, pos, capacity)
    cols = torch.arange(capacity, device=gates.device)
    dispatch = (slot[..., None] == cols).to(gates.dtype)
    combine = dispatch * gates[..., None]
    return dispatch, combine


def _expert_mlps(expert_in: torch.Tensor, w_gate: torch.Tensor,
                 w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU over [E, C, D] bf16 expert inputs -> [E, C, D] bf16."""
    h = torch.bmm(expert_in, w_gate.to(torch.bfloat16))
    u = torch.bmm(expert_in, w_up.to(torch.bfloat16))
    return torch.bmm(F.silu(h) * u, w_down.to(torch.bfloat16))


def routed_ffn(x: torch.Tensor, gates: torch.Tensor, w_gate: torch.Tensor,
               w_up: torch.Tensor, w_down: torch.Tensor,
               capacity_factor: float = 1.25, top_k: int = 2) -> torch.Tensor:
    """Top-k routed SwiGLU experts over x [B, S, D], the dispatch and the
    combine as products with the one-hot [T, E, C] tensors.

    w_gate/w_up [E, D, H], w_down [E, H, D]. Each of the two products costs
    2·T·E·C·D operations, more than the experts themselves on one card;
    `gathered_ffn` moves the same tokens by index."""
    B, S, D = x.shape
    E = w_gate.shape[0]
    T = B * S
    gates_f = gates.reshape(T, E).float()
    capacity = expert_capacity(T, E, top_k, capacity_factor)
    dispatch, combine = route(gates_f, capacity)
    xb = x.reshape(T, D).to(torch.bfloat16)
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(torch.bfloat16), xb)
    y = _expert_mlps(expert_in, w_gate, w_up, w_down)
    out = torch.einsum("tec,ecd->td", combine, y.float())
    return out.reshape(B, S, D).to(x.dtype)


def gathered_ffn(x: torch.Tensor, gates: torch.Tensor, w_gate: torch.Tensor,
                 w_up: torch.Tensor, w_down: torch.Tensor,
                 capacity_factor: float = 1.25,
                 top_k: int = 2) -> torch.Tensor:
    """Top-k routed SwiGLU experts over x [B, S, D], tokens moved by index:
    the routing of `routed_ffn` (same slots, same drops) at the cost of
    moving T·k rows of D instead of the one-hot products."""
    B, S, D = x.shape
    E = w_gate.shape[0]
    T = B * S
    gates_f = gates.reshape(T, E).float()
    capacity = expert_capacity(T, E, top_k, capacity_factor)
    pos, kept = _slot_positions(gates_f, capacity)
    # top_k_gating leaves exactly k nonzero gates, so the k largest (with
    # the same tie rule) are the experts routed_ffn dispatches to.
    top_e = top_k_indices(gates_f, top_k)                       # [T,k]
    top_w = gates_f.gather(1, top_e)
    pos_k = pos.gather(1, top_e)
    kept_k = kept.gather(1, top_e)
    slot = torch.where(kept_k, top_e * capacity + pos_k, E * capacity)
    slot_flat = slot.reshape(T * top_k)

    xb = x.reshape(T, D).to(torch.bfloat16)
    src = xb.repeat_interleave(top_k, dim=0)                    # [T*k,D]
    # At most one token per slot, so the add is a copy; out of place, so
    # a recompute under checkpoint sees fresh tensors.
    expert_in = torch.zeros(E * capacity + 1, D, dtype=torch.bfloat16,
                            device=x.device).index_add(0, slot_flat, src)
    y = _expert_mlps(expert_in[:-1].reshape(E, capacity, D),
                     w_gate, w_up, w_down)
    y_flat = torch.cat([y.reshape(E * capacity, D),
                        y.new_zeros(1, D)], dim=0)
    # index_select, not y_flat[slot_flat]: its backward is an index_add,
    # while the backward of advanced indexing sorts the indices first.
    y_tok = torch.index_select(y_flat, 0, slot_flat).reshape(
        T, top_k, D).float()
    weights = torch.where(kept_k, top_w, torch.zeros_like(top_w))
    out = (y_tok * weights[..., None]).sum(1)
    return out.reshape(B, S, D).to(x.dtype)


def dense_ffn(x: torch.Tensor, gates: torch.Tensor, w_gate: torch.Tensor,
              w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """Every expert on every token, weighted by the gates [B, S, E]: E/k
    times the expert compute of the routed paths, no routing at all."""
    xb = x.to(torch.bfloat16)
    h = torch.einsum("bsd,edh->besh", xb, w_gate.to(torch.bfloat16))
    u = torch.einsum("bsd,edh->besh", xb, w_up.to(torch.bfloat16))
    y = torch.einsum("besh,ehd->besd", F.silu(h) * u,
                     w_down.to(torch.bfloat16))
    out = torch.einsum("besd,bse->bsd", y.float(), gates)
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
