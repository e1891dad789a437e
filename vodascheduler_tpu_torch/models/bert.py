"""BERT-base encoder for masked-LM training.

Counterpart of the JAX package's ``models/bert.py``: token and position
embeddings, pre-norm EncoderBlocks with plain (non-causal) attention, an
fp32 final LayerNorm and an LM head with bias. Its attention is the O(S²)
reference on every device, as in the reference: the module exposes no
`attn_fn`, so no kernel is installed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vodascheduler_tpu_torch.models.layers import (
    AttnConfig,
    Dense,
    EncoderBlock,
    LayerNorm,
    reset_parameters,
)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_hidden: int = 3072
    max_seq_len: int = 512
    dtype: str = "bfloat16"


BERT_BASE = BertConfig()
BERT_TINY = BertConfig(vocab_size=256, dim=64, num_layers=2, num_heads=4,
                       mlp_hidden=128, max_seq_len=128)


class Bert(nn.Module):
    def __init__(self, cfg: BertConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.dim, device=device)
        self.pos_embed = nn.Embedding(cfg.max_seq_len, cfg.dim, device=device)
        attn_cfg = AttnConfig(num_heads=cfg.num_heads,
                              num_kv_heads=cfg.num_heads,
                              head_dim=cfg.dim // cfg.num_heads,
                              causal=False, rope_base=0.0)
        self.layer_names = [f"layer_{i}" for i in range(cfg.num_layers)]
        for name in self.layer_names:
            self.add_module(name, EncoderBlock(attn_cfg, cfg.dim,
                                               cfg.mlp_hidden, device))
        self.final_ln = LayerNorm(cfg.dim, device=device)
        self.lm_head = Dense(cfg.dim, cfg.vocab_size, device, bias=True)
        self.reset_parameters()

    def reset_parameters(self,
                         generator: Optional[torch.Generator] = None) -> None:
        """flax's initializers: Embed a normal of std 1/√dim, Dense kernels
        lecun_normal, biases zeros, LayerNorms ones and zeros."""
        with torch.no_grad():
            for emb in (self.embed, self.pos_embed):
                emb.weight.normal_(0.0, 1.0 / math.sqrt(self.cfg.dim),
                                   generator=generator)
        reset_parameters(self, generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] -> MLM logits [B, S, vocab]."""
        dtype = getattr(torch, self.cfg.dtype)
        S = tokens.shape[1]
        x = F.embedding(tokens, self.embed.weight).to(dtype)
        pos = self.pos_embed.weight[:S].to(dtype)
        x = x + pos[None]
        for name in self.layer_names:
            x = getattr(self, name)(x)
        return self.lm_head(self.final_ln(x).to(dtype))
