"""Seq2seq transformer (encoder-decoder) — the NMT model family.

Counterpart of the JAX package's ``models/nmt.py``: pre-norm RMSNorm
blocks, RoPE on every attention (cross-attention's keys rotate by the
encoder's positions), SwiGLU, bf16 activations with fp32 norms, one
embedding shared by source and target, a bias-free LM head. The module
takes ``{"src": [B, S_src], "tgt": [B, S_tgt]}`` and returns next-token
logits over the target. Its attention is the O(S²) reference (no
`attn_fn`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vodascheduler_tpu_torch.models.layers import (
    Attention,
    AttnConfig,
    Dense,
    RMSNorm,
    SwiGLU,
    reset_parameters,
)


@dataclasses.dataclass(frozen=True)
class NmtConfig:
    vocab_size: int = 32000
    dim: int = 512
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    num_heads: int = 8
    mlp_hidden: int = 2048
    max_seq_len: int = 256
    rope_base: float = 10000.0
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


NMT_BASE = NmtConfig()
NMT_TINY = NmtConfig(vocab_size=256, dim=64, num_encoder_layers=2,
                     num_decoder_layers=2, num_heads=4, mlp_hidden=128,
                     max_seq_len=64)


def _attn_cfg(cfg: NmtConfig, causal: bool) -> AttnConfig:
    return AttnConfig(num_heads=cfg.num_heads, num_kv_heads=cfg.num_heads,
                      head_dim=cfg.head_dim, causal=causal,
                      rope_base=cfg.rope_base)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: NmtConfig, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.dim, device=device)
        self.attn = Attention(_attn_cfg(cfg, False), cfg.dim, device=device)
        self.mlp_norm = RMSNorm(cfg.dim, device=device)
        self.mlp = SwiGLU(cfg.dim, cfg.mlp_hidden, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x))
        return x + self.mlp(self.mlp_norm(x))


class DecoderLayer(nn.Module):
    """Causal self-attention, cross-attention over the encoder memory,
    then the gated MLP — all pre-norm."""

    def __init__(self, cfg: NmtConfig, device=None):
        super().__init__()
        self.self_norm = RMSNorm(cfg.dim, device=device)
        self.self_attn = Attention(_attn_cfg(cfg, True), cfg.dim,
                                   device=device)
        self.cross_norm = RMSNorm(cfg.dim, device=device)
        self.cross_attn = Attention(_attn_cfg(cfg, False), cfg.dim,
                                    device=device)
        self.mlp_norm = RMSNorm(cfg.dim, device=device)
        self.mlp = SwiGLU(cfg.dim, cfg.mlp_hidden, device)

    def forward(self, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.self_norm(x))
        x = x + self.cross_attn(self.cross_norm(x), context=memory)
        return x + self.mlp(self.mlp_norm(x))


class Seq2SeqTransformer(nn.Module):
    def __init__(self, cfg: NmtConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.dim, device=device)
        self.enc_names = [f"enc_{i}" for i in range(cfg.num_encoder_layers)]
        for name in self.enc_names:
            self.add_module(name, EncoderLayer(cfg, device))
        self.enc_norm = RMSNorm(cfg.dim, device=device)
        self.dec_names = [f"dec_{i}" for i in range(cfg.num_decoder_layers)]
        for name in self.dec_names:
            self.add_module(name, DecoderLayer(cfg, device))
        self.dec_norm = RMSNorm(cfg.dim, device=device)
        self.lm_head = Dense(cfg.dim, cfg.vocab_size, device)
        self.reset_parameters()

    def reset_parameters(self,
                         generator: Optional[torch.Generator] = None) -> None:
        """flax's initializers: Embed a normal of std 1/√dim, Dense kernels
        lecun_normal, norms ones."""
        with torch.no_grad():
            self.embed.weight.normal_(0.0, 1.0 / math.sqrt(self.cfg.dim),
                                      generator=generator)
        reset_parameters(self, generator)

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """{"src": [B, S_src], "tgt": [B, S_tgt]} -> logits
        [B, S_tgt, vocab]."""
        dtype = getattr(torch, self.cfg.dtype)
        src = F.embedding(batch["src"], self.embed.weight).to(dtype)
        for name in self.enc_names:
            src = getattr(self, name)(src)
        memory = self.enc_norm(src)
        tgt = F.embedding(batch["tgt"], self.embed.weight).to(dtype)
        for name in self.dec_names:
            tgt = getattr(self, name)(tgt, memory)
        return self.lm_head(self.dec_norm(tgt))
