"""ResNet-50 — the vision workhorse.

Counterpart of the JAX package's ``models/resnet.py``: bottleneck-v1.5
ResNet, convolutions in bf16, BatchNorm in fp32. The batch is NHWC
``[B, H, W, C]`` at the module's boundary, as in the reference, and NCHW
inside. Convolutions and the max pool pad as flax's ``SAME`` does, with the
odd pixel after (`layers.same_pads`).

BatchNorm normalises by its running statistics (buffers ``mean`` and
``var``, zeros and ones at init), as the reference's runtime applies the
model (``train=False``): no step changes them. The batch-statistics mode
of flax's BatchNorm is not ported, since the reference never trains in it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vodascheduler_tpu_torch.models.layers import (
    Conv,
    Dense,
    pad_same,
    reset_parameters,
)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)  # ResNet-50
    num_classes: int = 1000
    width: int = 64
    dtype: str = "bfloat16"


RESNET50 = ResNetConfig()
RESNET_TINY = ResNetConfig(stage_sizes=(1, 1, 1, 1), num_classes=10, width=16)


class BatchNorm(nn.Module):
    """flax's nn.BatchNorm(use_running_average=True, dtype=float32) on
    NCHW: (x - mean)·rsqrt(var + 1e-5)·scale + bias in fp32, from the
    running statistics, which stay as they are."""

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))
        self.register_buffer("mean", torch.empty(channels, device=device))
        self.register_buffer("var", torch.empty(channels, device=device))
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x.float(), self.mean, self.var, self.scale,
                            self.bias, training=False, eps=self.eps)


class Bottleneck(nn.Module):
    def __init__(self, in_channels: int, features: int,
                 strides: Tuple[int, int], dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv(in_channels, features, (1, 1), device=device)
        self.bn1 = BatchNorm(features, device=device)
        self.conv2 = Conv(features, features, (3, 3), strides, device=device)
        self.bn2 = BatchNorm(features, device=device)
        self.conv3 = Conv(features, features * 4, (1, 1), device=device)
        self.bn3 = BatchNorm(features * 4, device=device)
        # The reference projects the residual where its shape differs from
        # the block's output: another width, or a stride.
        self.project = in_channels != features * 4 or tuple(strides) != (1, 1)
        if self.project:
            self.conv_proj = Conv(in_channels, features * 4, (1, 1), strides,
                                  device=device)
            self.bn_proj = BatchNorm(features * 4, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.relu(self.bn1(self.conv1(x)).to(dt))
        y = F.relu(self.bn2(self.conv2(y)).to(dt))
        y = self.bn3(self.conv3(y)).to(dt)
        residual = x
        if self.project:
            residual = self.bn_proj(self.conv_proj(x)).to(dt)
        return F.relu(y + residual)


class ResNet(nn.Module):
    def __init__(self, cfg: ResNetConfig, in_channels: int = 3, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.conv_init = Conv(in_channels, cfg.width, (7, 7), (2, 2),
                              device=device)
        self.bn_init = BatchNorm(cfg.width, device=device)
        self.blocks = []
        channels = cfg.width
        for i, num_blocks in enumerate(cfg.stage_sizes):
            for j in range(num_blocks):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                name = f"stage{i}_block{j}"
                self.add_module(name, Bottleneck(channels, cfg.width * 2 ** i,
                                                 strides, self.dtype, device))
                self.blocks.append(name)
                channels = cfg.width * 2 ** i * 4
        self.head = Dense(channels, cfg.num_classes, device, bias=True)

    def reset_parameters(self,
                         generator: Optional[torch.Generator] = None) -> None:
        """flax's initializers: Conv and Dense kernels lecun_normal, biases
        zeros, BatchNorm scale ones and bias zeros, statistics 0 and 1."""
        reset_parameters(self, generator)
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.reset_parameters()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, C] -> logits [B, num_classes] (fp32)."""
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.bn_init(self.conv_init(x)).to(self.dtype))
        x = F.max_pool2d(pad_same(x, (3, 3), (2, 2), float("-inf")), 3, 2)
        for name in self.blocks:
            x = getattr(self, name)(x)
        # the mean sums in fp32 and rounds to the compute dtype, as jnp.mean
        # of a bf16 array does
        x = x.float().mean((2, 3)).to(self.dtype)
        return self.head(x.float())
