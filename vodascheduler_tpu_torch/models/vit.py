"""ViT-L image classifier — the vision transformer family.

Counterpart of the JAX package's ``models/vit.py``: a patch convolution
(with bias) whose [B, h, w, d] output is read row-major over (h, w) into
h·w tokens, a zero-initialised ``cls_token`` in front, a learned
``pos_embed``, pre-norm EncoderBlocks, and an fp32 ``final_ln`` and head
on token 0. Its attention is the O(S²) reference (no `attn_fn`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from vodascheduler_tpu_torch.models.layers import (
    AttnConfig,
    Conv,
    Dense,
    EncoderBlock,
    LayerNorm,
    reset_parameters,
)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    dim: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_hidden: int = 4096
    num_classes: int = 1000
    dtype: str = "bfloat16"


VIT_L16 = ViTConfig()
VIT_TINY = ViTConfig(image_size=32, patch_size=8, dim=64, num_layers=2,
                     num_heads=4, mlp_hidden=128, num_classes=10)


class ViT(nn.Module):
    def __init__(self, cfg: ViTConfig, in_channels: int = 3, device=None):
        super().__init__()
        self.cfg = cfg
        p = cfg.patch_size
        self.patch_embed = Conv(in_channels, cfg.dim, (p, p), (p, p),
                                bias=True, device=device)
        side = -(-cfg.image_size // p)  # SAME: ceil(size / stride)
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.dim,
                                                  device=device))
        self.pos_embed = nn.Parameter(torch.empty(1, side * side + 1,
                                                  cfg.dim, device=device))
        attn_cfg = AttnConfig(num_heads=cfg.num_heads,
                              num_kv_heads=cfg.num_heads,
                              head_dim=cfg.dim // cfg.num_heads,
                              causal=False, rope_base=0.0)
        self.layer_names = [f"layer_{i}" for i in range(cfg.num_layers)]
        for name in self.layer_names:
            self.add_module(name, EncoderBlock(attn_cfg, cfg.dim,
                                               cfg.mlp_hidden, device))
        self.final_ln = LayerNorm(cfg.dim, device=device)
        self.head = Dense(cfg.dim, cfg.num_classes, device, bias=True)
        self.reset_parameters()

    def reset_parameters(self,
                         generator: Optional[torch.Generator] = None) -> None:
        """flax's initializers: cls_token zeros, pos_embed a normal of std
        0.02, Conv and Dense kernels lecun_normal, biases zeros."""
        with torch.no_grad():
            self.cls_token.zero_()
            self.pos_embed.normal_(0.0, 0.02, generator=generator)
        reset_parameters(self, generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, C] -> logits [B, num_classes] (fp32)."""
        dtype = getattr(torch, self.cfg.dtype)
        x = self.patch_embed(images.to(dtype).permute(0, 3, 1, 2))
        B, d = x.shape[:2]
        x = x.permute(0, 2, 3, 1).reshape(B, -1, d)  # row-major over (h, w)
        cls = self.cls_token.to(dtype).expand(B, 1, d)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dtype)
        for name in self.layer_names:
            x = getattr(self, name)(x)
        return self.head(self.final_ln(x[:, 0]).float())
