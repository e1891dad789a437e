"""Single-card training core.

Counterpart of the JAX package's ``runtime/train.py`` for one device: build
the bundle's model on the device, install the flash-attention kernels as
`attn_fn` on CUDA, and step AdamW. Multi-card plans (the mesh, sharding,
resize, checkpoints) come with later slices.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import torch

from vodascheduler_tpu_torch.device import DeviceLike, resolve_device
from vodascheduler_tpu_torch.models.registry import ModelBundle
from vodascheduler_tpu_torch.ops.flash_attention import flash_attention


def make_optimizer(name: str, learning_rate: float):
    """Bundle-selected optimizer as a factory: params -> torch.optim.

    adamw matches optax.adamw's defaults, whose weight decay (1e-4) is not
    torch's (1e-2)."""
    if name == "adamw":
        return functools.partial(torch.optim.AdamW, lr=learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-4)
    if name == "adafactor":
        raise NotImplementedError(
            "adafactor is not ported yet (ROADMAP queue A, item 5)")
    raise ValueError(f"unknown optimizer {name!r} (adamw | adafactor)")


class TrainSession:
    """A live training session on one device."""

    def __init__(self, bundle: ModelBundle, num_chips: int = 1,
                 global_batch_size: int = 8, seed: int = 0,
                 device: DeviceLike = None, learning_rate: float = 1e-3):
        if num_chips != 1:
            raise NotImplementedError(
                f"num_chips={num_chips}: multi-GPU training is not ported "
                "yet (ROADMAP queue A, item 10)")
        self.bundle = bundle
        self.num_chips = num_chips
        self.global_batch_size = global_batch_size
        self.learning_rate = learning_rate
        self.device = resolve_device(device)
        init_gen = torch.Generator(self.device).manual_seed(seed)
        self.module = bundle.build_module(self.device, init_gen)
        if self.device.type == "cuda":
            # The injected kernel replaces the layers' own masking, so the
            # module has to declare it.
            causal = getattr(type(self.module), "causal_attention", None)
            if causal is None:
                raise TypeError(
                    f"{type(self.module).__name__} has attn_fn but no "
                    "`causal_attention`; declare it so kernel injection "
                    "cannot silently change masking")
            self.module.attn_fn = functools.partial(flash_attention,
                                                    causal=causal)
        self.optimizer = make_optimizer(bundle.optimizer, learning_rate)(
            self.module.parameters())
        # Batches are drawn from their own stream, so that they do not
        # depend on how many draws the initialisation took.
        self.data_gen = torch.Generator(self.device).manual_seed(seed + 1)
        self.state = {"step": 0}

    @property
    def step(self) -> int:
        return self.state["step"]

    def make_batch(self) -> Any:
        return self.bundle.make_batch(self.global_batch_size, self.data_gen)

    def train_step(self, batch) -> torch.Tensor:
        """One AdamW step on `batch`; returns the loss (a 0-d tensor)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.bundle.loss_fn(self.module, batch)
        loss.backward()
        self.optimizer.step()
        self.state["step"] += 1
        return loss.detach()

    def run_steps(self, n: int) -> float:
        """Run n steps on fresh batches; returns the last loss."""
        loss = torch.zeros(())
        for _ in range(n):
            loss = self.train_step(self.make_batch())
        return float(loss)
