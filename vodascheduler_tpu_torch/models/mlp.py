"""Tiny MLP classifier — the minimum end-to-end workload.

Counterpart of the JAX package's ``models/mlp.py``: fp32 throughout, Dense
layers with biases and ReLU, a linear head.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vodascheduler_tpu_torch.models.layers import Dense, reset_parameters


@dataclasses.dataclass(frozen=True)
class MlpConfig:
    input_dim: int = 784
    hidden: int = 256
    num_classes: int = 10
    num_layers: int = 2


MNIST_MLP = MlpConfig()
# Sized for the bundled UCI digits data (data/real.py): 8x8 real images.
DIGITS_MLP = MlpConfig(input_dim=64, hidden=128)


class Mlp(nn.Module):
    def __init__(self, cfg: MlpConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dims = [cfg.input_dim] + [cfg.hidden] * cfg.num_layers
        self.hidden_layers = [f"dense_{i}" for i in range(cfg.num_layers)]
        for i, name in enumerate(self.hidden_layers):
            self.add_module(name, Dense(dims[i], cfg.hidden, device,
                                        bias=True))
        self.head = Dense(cfg.hidden, cfg.num_classes, device, bias=True)

    def reset_parameters(self,
                         generator: Optional[torch.Generator] = None) -> None:
        reset_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, ...] (flattened) -> logits [B, num_classes], fp32."""
        x = x.reshape(x.shape[0], -1).float()
        for name in self.hidden_layers:
            x = F.relu(getattr(self, name)(x))
        return self.head(x)
