"""Single-card training core.

Counterpart of the JAX package's ``runtime/train.py`` for one device: build
the bundle's model on the device, install the flash-attention kernels as
`attn_fn` on CUDA in a module that exposes `attn_fn` (as the reference
does: Llama and Mixtral, in whatever dtype they compute, as the JAX kernels
compute in q's; the other families keep their plain attention),
step AdamW or Adafactor, and save, resume and resize the session for the
supervisor. A BatchNorm model's running statistics are module buffers:
the optimizer never sees them, no step changes them (the reference applies
such a model with ``train=False``), and they ride in the checkpoint. A
batch is a function of (seed, step), so the step counter in a checkpoint
is the data position: a resumed run sees the batches an uninterrupted run
would have seen. Multi-card plans (the mesh, sharding, a resize to another
size) come with ROADMAP A10.
"""

from __future__ import annotations

import functools
import os
from typing import Any, Optional

import numpy as np
import torch
from torch.distributed.checkpoint.state_dict import get_state_dict, set_state_dict

from vodascheduler_tpu_torch import bridge
from vodascheduler_tpu_torch.device import DeviceLike, resolve_device
from vodascheduler_tpu_torch.models.registry import ModelBundle
from vodascheduler_tpu_torch.ops.flash_attention import flash_attention
from vodascheduler_tpu_torch.runtime import checkpoint as ckpt
from vodascheduler_tpu_torch.runtime.optim import Adafactor


def make_optimizer(name: str, learning_rate: float):
    """Bundle-selected optimizer as a factory: params -> torch.optim.

    adamw matches optax.adamw's defaults, whose weight decay (1e-4) is not
    torch's (1e-2). adafactor is optax.adafactor's update (runtime/optim.py);
    give it `bridge.reference_param_groups` so that it sees the reference's
    leaves."""
    if name == "adamw":
        return functools.partial(torch.optim.AdamW, lr=learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-4)
    if name == "adafactor":
        return functools.partial(Adafactor, lr=learning_rate)
    raise ValueError(f"unknown optimizer {name!r} (adamw | adafactor)")


def _flash_attention_enabled(device: torch.device) -> bool:
    """VODA_FLASH_ATTENTION: 0 forces the plain attention, 1 forces the
    kernels (and raises off CUDA, where there are none); unset or anything
    else means the kernels on CUDA."""
    flag = os.environ.get("VODA_FLASH_ATTENTION", "auto")
    if flag == "0":
        return False
    if flag == "1" and device.type != "cuda":
        raise RuntimeError(
            f"VODA_FLASH_ATTENTION=1 forces the CUDA flash-attention "
            f"kernels, but the session runs on {device}")
    return device.type == "cuda"


def batch_seed(seed: int, step: int) -> int:
    """The seed of step `step`'s batch: a pure function of (seed, step)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0])


class ResizeStateInvalid(RuntimeError):
    """An in-place resize failed after the live state may have been
    consumed: the session must not keep training on it, and the caller
    falls back to checkpoint-restart. A resize failure raised as anything
    else happened before any mutation, and the session may keep training
    at its old size."""


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
        self.seed = seed
        self.learning_rate = learning_rate
        self.device = resolve_device(device)
        init_gen = torch.Generator(self.device).manual_seed(seed)
        self.module = bundle.build_module(self.device, init_gen)
        if (_flash_attention_enabled(self.device)
                and hasattr(self.module, "attn_fn")):
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
        params = self.module.parameters()
        if bundle.optimizer == "adafactor":
            params = bridge.reference_param_groups(
                self.module.named_parameters(), getattr(self.module, "cfg",
                                                        None))
        self.optimizer = make_optimizer(bundle.optimizer, learning_rate)(
            params)
        self.state = {"step": 0}
        self._saver: Optional[ckpt.AsyncCheckpointSaver] = None
        self._last_save = None  # (abspath ckpt_dir, step) of latest save

    @property
    def step(self) -> int:
        return self.state["step"]

    def make_batch(self, step: Optional[int] = None) -> Any:
        """The batch of `step` (default: the next step to run)."""
        step = self.step if step is None else step
        gen = torch.Generator(self.device).manual_seed(
            batch_seed(self.seed, step))
        return self.bundle.make_batch(self.global_batch_size, gen)

    def train_step(self, batch) -> torch.Tensor:
        """One optimizer step on `batch`; returns the loss (a 0-d tensor)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.bundle.loss_fn(self.module, batch)
        loss.backward()
        self.optimizer.step()
        self.state["step"] += 1
        return loss.detach()

    def run_steps(self, n: int) -> float:
        """Run n steps, each on its own (seed, step) batch; returns the
        last loss."""
        loss = torch.zeros(())
        for _ in range(n):
            loss = self.train_step(self.make_batch())
        return float(loss)

    def resize(self, new_num_chips: int) -> "TrainSession":
        """In-place resize. On one card the only size is the current one:
        a resize to it changes nothing, and any other raises before the
        state is touched, so the caller keeps training and falls back to
        checkpoint-restart."""
        if new_num_chips != self.num_chips:
            raise ValueError(
                f"in-place resize from {self.num_chips} to {new_num_chips} "
                "chips: a session holds one card until multi-GPU training "
                "(ROADMAP A10); this resize requires a checkpoint-restart")
        return self

    def checkpoint_state(self) -> dict:
        """The checkpoint payload: the module's and the optimizer's state
        (live tensors), the step and the seed."""
        model, optim = get_state_dict(self.module, self.optimizer)
        return {"model": model, "optim": optim, "step": self.step,
                "seed": self.seed}

    def save(self, ckpt_dir: str, keep_last: int = 2,
             wait: bool = True) -> int:
        """Checkpoint the session; returns the saved step.

        `wait=False` overlaps the write with the steps that follow (the
        device→host copy still happens before returning); call
        `finish_saves()` before the process exits."""
        if self.step == 0:
            # torch's optimizers make their state at the first step, and
            # get_state_dict would make it by running one at lr 0, which
            # counts as a step for AdamW's bias correction.
            raise ValueError("no step has run: the first checkpoint comes "
                             "after step 1")
        key = (os.path.abspath(ckpt_dir), self.step)
        if self._last_save == key:
            # No step ran since that state was saved (or restored): the
            # bytes on disk or in flight are this state. Drain instead of
            # copying it again — the preemption save often lands right
            # after an epoch's save.
            if self._saver is not None:
                self._saver.wait()
            if ckpt.latest_step(ckpt_dir) == key[1]:
                return key[1]
            # The drained save never committed: save again.
        if self._saver is None:
            self._saver = ckpt.AsyncCheckpointSaver()
        step = self._saver.save(ckpt_dir, self.checkpoint_state(),
                                keep_last=keep_last, wait=wait)
        self._last_save = key
        return step

    @property
    def last_save(self):
        """(step, bytes, host-copy s, write s) of the latest committed
        save of this session, or None."""
        return self._saver.last_save if self._saver is not None else None

    def finish_saves(self) -> None:
        """Block until any in-flight save has committed."""
        if self._saver is not None:
            self._saver.wait()

    @classmethod
    def resume(cls, bundle: ModelBundle, num_chips: int, ckpt_dir: str,
               global_batch_size: int = 8, device: DeviceLike = None,
               step: Optional[int] = None,
               learning_rate: float = 1e-3) -> "TrainSession":
        """A session rebuilt from the checkpoint of `step` (default: the
        latest), with its seed and data position. `learning_rate` may
        differ from the saved run's.

        Two halves, which the resize bench times apart: the session built
        as at step 0 (module, parameters, optimizer), then `restore`."""
        session = cls(bundle, num_chips, global_batch_size=global_batch_size,
                      device=device, learning_rate=learning_rate)
        return session.restore(ckpt_dir, step=step)

    def restore(self, ckpt_dir: str,
                step: Optional[int] = None) -> "TrainSession":
        """Load the checkpoint of `step` (default: the latest) into this
        session: the module's and the optimizer's state (at this session's
        learning rate), the step and the seed. Returns the session."""
        state = ckpt.restore_checkpoint(ckpt_dir, self.checkpoint_state(),
                                        step=step)
        set_state_dict(self.module, self.optimizer,
                       model_state_dict=state["model"],
                       optim_state_dict=state["optim"])
        for group in self.optimizer.param_groups:
            group["lr"] = self.learning_rate
        self.state["step"] = int(state["step"])
        self.seed = int(state["seed"])
        # The restored state is the checkpoint on disk: a save before any
        # step runs can dedupe against it.
        self._last_save = (os.path.abspath(ckpt_dir), self.step)
        return self
