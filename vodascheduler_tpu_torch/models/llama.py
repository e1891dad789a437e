"""Llama-style decoder-only LM — the flagship model family.

Counterpart of the JAX package's ``models/llama.py``: RMSNorm pre-norm,
RoPE, GQA, SwiGLU, untied LM head. Every preset is here; the registry
builds the ones that fit one card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vodascheduler_tpu_torch.models.layers import (
    AttnConfig,
    DecoderBlock,
    RMSNorm,
    lecun_normal_,
    remat_context,
    remat_stack,
    reset_parameters,
)
from vodascheduler_tpu_torch.ops.chunked_ce import chunked_softmax_ce


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    mlp_hidden: int = 14336
    max_seq_len: int = 8192
    rope_base: float = 500000.0
    dtype: str = "bfloat16"
    # The reference stacks its layer parameters on a leading axis under
    # `layers_scan` when this is on; here it changes only the bridge's
    # parameter naming (bridge.py), the layers are a ModuleList either way.
    scan_layers: bool = False
    # Per-layer remat: the backward recomputes each layer from its input.
    remat_layers: bool = False
    # What the recompute may keep (layers.REMAT_POLICIES); None is full
    # remat.
    remat_policy: Optional[str] = None

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def param_count(self) -> int:
        embed = self.vocab_size * self.dim * 2  # embed + head
        per_layer = (self.dim * self.head_dim
                     * (self.num_heads * 2 + self.num_kv_heads * 2)
                     + 3 * self.dim * self.mlp_hidden + 2 * self.dim)
        return embed + self.num_layers * per_layer + self.dim


LLAMA3_8B = LlamaConfig(scan_layers=True, remat_layers=True)
LLAMA_350M = LlamaConfig(dim=1024, num_layers=24, num_heads=16,
                         num_kv_heads=8, mlp_hidden=2816, max_seq_len=2048,
                         scan_layers=True, remat_layers=True)
LLAMA_350M_BYTES = dataclasses.replace(LLAMA_350M, vocab_size=256)
LLAMA_350M_8K = dataclasses.replace(LLAMA_350M, max_seq_len=8192)
LLAMA_350M_AF = dataclasses.replace(LLAMA_350M, remat_policy="dots_attn")
LLAMA_350M_8K_AF = dataclasses.replace(LLAMA_350M_AF, max_seq_len=8192)
LLAMA_1B = LlamaConfig(dim=2048, num_layers=16, num_heads=32,
                       num_kv_heads=8, mlp_hidden=7168, max_seq_len=2048,
                       scan_layers=True, remat_layers=True)
LLAMA_TINY = LlamaConfig(vocab_size=256, dim=64, num_layers=2, num_heads=4,
                         num_kv_heads=2, mlp_hidden=128, max_seq_len=128,
                         rope_base=10000.0)
LLAMA_TINY_SCAN = dataclasses.replace(LLAMA_TINY, scan_layers=True)


class Llama(nn.Module):
    # Decoder LM: the runtime may inject a causal kernel as attn_fn.
    causal_attention = True

    def __init__(self, cfg: LlamaConfig, attn_fn: Optional[Callable] = None,
                 device=None):
        super().__init__()
        remat_context(cfg.remat_policy)  # refuses an unknown policy
        self.cfg = cfg
        attn_cfg = AttnConfig(num_heads=cfg.num_heads,
                              num_kv_heads=cfg.num_kv_heads,
                              head_dim=cfg.head_dim, causal=True,
                              rope_base=cfg.rope_base)
        self.embed = nn.Embedding(cfg.vocab_size, cfg.dim, device=device)
        self.layers = nn.ModuleList(
            DecoderBlock(attn_cfg, cfg.dim, cfg.mlp_hidden, attn_fn, device)
            for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.dim, device=device)
        # [D, V], the reference's layout, so the chunked loss slices it as-is
        self.lm_head_kernel = nn.Parameter(
            torch.empty(cfg.dim, cfg.vocab_size, device=device))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's initializers: Embed a normal of std 1/√D, Dense kernels
        and the head lecun_normal, norms ones."""
        with torch.no_grad():
            self.embed.weight.normal_(0.0, 1.0 / math.sqrt(self.cfg.dim),
                                      generator=generator)
        reset_parameters(self, generator)
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
        mean token cross-entropy through the chunked loss, without
        full-vocab logits."""
        dtype = getattr(torch, self.cfg.dtype)
        x = F.embedding(tokens, self.embed.weight).to(dtype)
        x = remat_stack(self.layers, x, self.cfg.remat_layers,
                        self.cfg.remat_policy)
        x = self.final_norm(x)
        if targets is None:
            return x @ self.lm_head_kernel.to(dtype)
        return chunked_softmax_ce(x, self.lm_head_kernel, targets)
