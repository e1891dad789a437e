"""Bring-your-own-model script: a custom CNN the port's scheduler can run.

Counterpart of examples/jax/custom_cnn_script.py. Define `get_model(spec)
-> ModelBundle` here, point a job spec's `extra.script` at this file
(examples/torch/custom-cnn.yaml), and the supervisor runs its elastic loop
(checkpoint, resume, metrics CSV) around your model, data and loss.
`spec.extra` is free-form: this script reads `width` from it.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from vodascheduler_tpu_torch.models.layers import Conv, Dense, reset_parameters
from vodascheduler_tpu_torch.models.registry import ModelBundle


class SmallCnn(nn.Module):
    """Two conv blocks (3x3 SAME, ReLU, 2x2 average pool) and a dense
    head, bf16 compute with fp32 masters and fp32 logits."""

    def __init__(self, width: int = 32, classes: int = 10, device=None):
        super().__init__()
        self.conv0 = Conv(1, width, (3, 3), bias=True, device=device)
        self.conv1 = Conv(width, 2 * width, (3, 3), bias=True, device=device)
        self.dense = Dense(7 * 7 * 2 * width, 128, device, bias=True)
        self.head = Dense(128, classes, device, bias=True)

    def reset_parameters(self, generator=None) -> None:
        reset_parameters(self, generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, 28, 28, 1] -> logits [B, classes]."""
        x = images.to(torch.bfloat16).permute(0, 3, 1, 2)
        for conv in (self.conv0, self.conv1):
            x = F.avg_pool2d(F.relu(conv(x)), 2)
        # flatten in (h, w, c) order, as the reference's NHWC reshape does
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.dense(x))
        return self.head(x.float())


def get_model(spec=None):
    width = int(spec.extra.get("width", "32") if spec is not None else "32")

    def build_module(device, generator):
        module = SmallCnn(width=width, device=device)
        module.reset_parameters(generator)
        return module

    def make_batch(batch_size: int, generator: torch.Generator):
        dev = generator.device
        return {
            "images": torch.randn((batch_size, 28, 28, 1),
                                  generator=generator, device=dev),
            "labels": torch.randint(0, 10, (batch_size,),
                                    generator=generator, device=dev),
        }

    def loss_fn(module, batch):
        return F.cross_entropy(module(batch["images"]).float(),
                               batch["labels"])

    return ModelBundle(name="custom_cnn", cfg=width,
                       build_module=build_module, make_batch=make_batch,
                       loss_fn=loss_fn)
