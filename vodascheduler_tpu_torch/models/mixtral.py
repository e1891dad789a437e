"""Mixtral-style sparse MoE decoder.

Counterpart of the JAX package's ``models/mixtral.py``: the Llama block
with its MLP replaced by top-k routed SwiGLU experts (`MoEBlock`), behind
one of three dispatches (`ops/moe_dispatch.py`): "gather" (tokens moved by
index, the one-card dispatch), "routed" (one-hot products) and "dense"
(every expert on every token). Every preset is here, MIXTRAL_8X7B_LIKE
among them (the registry's mixtral_8x7b, which several ranks train over
dp × fsdp × ep × tp).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from vodascheduler_tpu_torch.models.layers import (
    Attention,
    AttnConfig,
    Dense,
    RMSNorm,
    lecun_normal_,
    remat_context,
    remat_stack,
    reset_parameters,
)
from vodascheduler_tpu_torch.ops import moe_dispatch
from vodascheduler_tpu_torch.ops.chunked_ce import chunked_softmax_ce

DISPATCHES = ("routed", "gather", "dense")


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32000
    dim: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    mlp_hidden: int = 14336
    num_experts: int = 8
    top_k: int = 2
    rope_base: float = 1000000.0
    dtype: str = "bfloat16"
    dispatch: str = "routed"          # one of DISPATCHES
    capacity_factor: float = 1.25     # slots per expert against even load
    # As in llama.py: the reference's stacked `layers_scan` naming (bridge)
    scan_layers: bool = False
    remat_layers: bool = False        # per-layer remat
    remat_policy: Optional[str] = None  # layers.REMAT_POLICIES

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


MIXTRAL_8X7B_LIKE = MixtralConfig(scan_layers=True, remat_layers=True)
# About 386M parameters, 138M of them active per token: the MoE flagship
# of the hardware bench, sized as LLAMA_350M is for the dense family.
MIXTRAL_SMALL = MixtralConfig(dim=640, num_layers=12, num_heads=10,
                              num_kv_heads=5, mlp_hidden=1792,
                              num_experts=8, top_k=2, dispatch="gather",
                              scan_layers=True, remat_layers=True)
# Adafactor (registry "mixtral_small_af") and the dots_attn policy.
MIXTRAL_SMALL_AF = dataclasses.replace(MIXTRAL_SMALL,
                                       remat_policy="dots_attn")
MIXTRAL_TINY = MixtralConfig(vocab_size=256, dim=64, num_layers=2,
                             num_heads=4, num_kv_heads=2, mlp_hidden=128,
                             num_experts=4, top_k=2, rope_base=10000.0)


class MoEBlock(nn.Module):
    """Top-k routed SwiGLU experts. The router runs in fp32 on an fp32
    copy of x; the experts are stacked on a leading E axis in the
    reference's layout ([E,D,H], [E,D,H], [E,H,D]).

    On a mesh, `sharding.apply_rules` makes each expert kernel a DTensor
    whose local block is this rank's E/ep experts (and H/tp of their
    hidden width) and sets `layout` (`moe_dispatch.ExpertLayout`: the data
    and expert axes' groups, the first expert), as `_tp_plan` sets
    `Attention.head_offset`. The block then always runs the
    expert-parallel form of its dispatch, also on a mesh of one rank."""

    def __init__(self, cfg: MixtralConfig, device=None):
        super().__init__()
        if cfg.dispatch not in DISPATCHES:
            # A typo must not silently train another dispatch.
            raise ValueError(f"unknown MixtralConfig.dispatch "
                             f"{cfg.dispatch!r}; one of {DISPATCHES}")
        self.cfg = cfg
        E, D, H = cfg.num_experts, cfg.dim, cfg.mlp_hidden
        self.router = Dense(D, E, device)
        self.experts_gate_kernel = nn.Parameter(torch.empty(E, D, H,
                                                            device=device))
        self.experts_up_kernel = nn.Parameter(torch.empty(E, D, H,
                                                          device=device))
        self.experts_down_kernel = nn.Parameter(torch.empty(E, H, D,
                                                            device=device))
        self.reset_experts()
        self.layout = moe_dispatch.ONE_DEVICE

    def reset_experts(self, generator=None) -> None:
        """flax's lecun_normal on a [E, in, out] kernel: the fan-in is
        E·in, the product of every axis but the output's."""
        for w in (self.experts_gate_kernel, self.experts_up_kernel,
                  self.experts_down_kernel):
            lecun_normal_(w, w.shape[0] * w.shape[1], generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        probs = F.softmax(self.router(x.float()), dim=-1)      # [B,S,E]
        gate = moe_dispatch.top_k_gating(probs, cfg.top_k)
        # this rank's block of each DTensor kernel (class docstring)
        weights = [w.to_local() if isinstance(w, DTensor) else w
                   for w in (self.experts_gate_kernel,
                             self.experts_up_kernel,
                             self.experts_down_kernel)]
        if cfg.dispatch == "dense":
            return moe_dispatch.dense_ffn(x, gate, *weights,
                                          layout=self.layout)
        ffn = (moe_dispatch.routed_ffn if cfg.dispatch == "routed"
               else moe_dispatch.gathered_ffn)
        return ffn(x, gate, *weights, capacity_factor=cfg.capacity_factor,
                   top_k=cfg.top_k, layout=self.layout)


class MixtralBlock(nn.Module):
    """Pre-norm decoder block with an MoE in place of the MLP."""

    def __init__(self, cfg: MixtralConfig, attn_fn: Optional[Callable] = None,
                 device=None):
        super().__init__()
        attn_cfg = AttnConfig(num_heads=cfg.num_heads,
                              num_kv_heads=cfg.num_kv_heads,
                              head_dim=cfg.head_dim, causal=True,
                              rope_base=cfg.rope_base)
        self.attn_norm = RMSNorm(cfg.dim, device=device)
        self.attn = Attention(attn_cfg, cfg.dim, attn_fn, device)
        self.moe_norm = RMSNorm(cfg.dim, device=device)
        self.moe = MoEBlock(cfg, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x))
        return x + self.moe(self.moe_norm(x))


class Mixtral(nn.Module):
    # Decoder LM: the runtime may inject a causal kernel as attn_fn.
    causal_attention = True

    def __init__(self, cfg: MixtralConfig, attn_fn: Optional[Callable] = None,
                 device=None):
        super().__init__()
        remat_context(cfg.remat_policy)  # refuses an unknown policy
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.dim, device=device)
        self.layers = nn.ModuleList(MixtralBlock(cfg, attn_fn, device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.dim, device=device)
        # [D, V], the reference's layout, as in llama.py
        self.lm_head_kernel = nn.Parameter(
            torch.empty(cfg.dim, cfg.vocab_size, device=device))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's initializers: Embed a normal of std 1/√D, Dense kernels,
        experts and the head lecun_normal, norms ones."""
        with torch.no_grad():
            self.embed.weight.normal_(0.0, 1.0 / math.sqrt(self.cfg.dim),
                                      generator=generator)
        reset_parameters(self, generator)
        for layer in self.layers:
            layer.moe.reset_experts(generator)
        lecun_normal_(self.lm_head_kernel, self.cfg.dim, generator)

    @property
    def attn_fn(self) -> Optional[Callable]:
        return self.layers[0].attn.attn_fn

    @attn_fn.setter
    def attn_fn(self, fn: Optional[Callable]) -> None:
        for layer in self.layers:
            layer.attn.attn_fn = fn

    def forward(self, tokens: torch.Tensor,
                targets: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens [B, S] -> logits [B, S, vocab], or — with `targets` — the
        mean token cross-entropy through the chunked loss."""
        dtype = getattr(torch, self.cfg.dtype)
        x = F.embedding(tokens, self.embed.weight).to(dtype)
        x = remat_stack(self.layers, x, self.cfg.remat_layers,
                        self.cfg.remat_policy)
        x = self.final_norm(x)
        if targets is None:
            return x @ self.lm_head_kernel.to(dtype)
        return chunked_softmax_ce(x, self.lm_head_kernel, targets)
