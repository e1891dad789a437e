"""Training core: one device, or one rank of a process group.

Counterpart of the JAX package's ``runtime/train.py``. A session builds the
bundle's model on its device, installs the flash-attention kernels as
`attn_fn` on CUDA in a module that exposes `attn_fn` (as the reference
does: Llama and Mixtral, in whatever dtype they compute, as the JAX kernels
compute in q's; the other families keep their plain attention), steps
AdamW or Adafactor, and saves, resumes and resizes for the supervisor. A
BatchNorm model's running statistics are module buffers: the optimizer
never sees them, no step changes them (the reference applies such a model
with ``train=False``), and they ride in the checkpoint. A batch is a
function of (seed, step), so the step counter in a checkpoint is the data
position: a resumed run sees the batches an uninterrupted run would have
seen.

Without a process group a session holds one device. Under one
(runtime/supervisor.py forms it, one rank a device) a session of N chips
is one of N ranks: it plans the mesh (`plan_for`, parallel/mesh.py), builds
the whole module from the seed on its device, shards it by the bundle's
rules (parallel/sharding.py) and takes its data rank's rows of every
global batch, so that N ranks take the step that one device takes on the
same global batch. A checkpoint written at one world size restores at any
other (runtime/checkpoint.py): the resize is a restart with reshard.
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
from vodascheduler_tpu_torch.ops.flash_attention import make_flash_attention
from vodascheduler_tpu_torch.parallel import mesh as mesh_lib
from vodascheduler_tpu_torch.parallel import sharding
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


def distributed() -> bool:
    """Whether this process is a rank of a process group."""
    return (torch.distributed.is_available()
            and torch.distributed.is_initialized())


def plan_for(bundle: ModelBundle, num_chips: int, global_batch_size: int,
             topology: Any = None,
             plan: Optional[mesh_lib.MeshPlan] = None) -> mesh_lib.MeshPlan:
    """The mesh plan of `bundle` at `num_chips` (the reference's
    `remesh` planning), refused with the reason before any process group
    forms: an axis the port does not run, a global batch that the data
    axes do not divide, or an MoE bundle split over data or tp (its
    capacity and slot order are computed over the global token order, so
    routing each rank's rows apart would change which tokens drop)."""
    plan = mesh_lib.remesh_plan(num_chips, model_params_b=bundle.params_b,
                                seq_len=bundle.seq_len,
                                num_experts=bundle.num_experts,
                                topology=topology, plan=plan)
    if plan.num_chips != num_chips:
        raise ValueError(f"mesh plan {plan} covers {plan.num_chips} chips, "
                         f"the job has {num_chips}")
    mesh_lib.check_runnable(plan)
    if bundle.num_experts and (plan.data_size > 1 or plan.tp > 1):
        raise NotImplementedError(
            f"{bundle.name} at {plan}: an MoE bundle on more than one rank "
            "needs the expert all_to_all over the global token order "
            "(ROADMAP: the ep item after A11)")
    if global_batch_size % plan.data_size:
        raise ValueError(
            f"global batch {global_batch_size} does not divide over "
            f"{plan.data_size} data ranks (dp · fsdp of {plan})")
    return plan


class TrainSession:
    """A live training session on one device, or on one rank of a process
    group of `num_chips` ranks."""

    def __init__(self, bundle: ModelBundle, num_chips: int = 1,
                 global_batch_size: int = 8, seed: int = 0,
                 device: DeviceLike = None, learning_rate: float = 1e-3,
                 plan: Optional[mesh_lib.MeshPlan] = None,
                 topology: Any = None):
        self.bundle = bundle
        self.num_chips = num_chips
        self.global_batch_size = global_batch_size
        self.seed = seed
        self.learning_rate = learning_rate
        self.device = resolve_device(device)
        self.plan: Optional[mesh_lib.MeshPlan] = None
        self.mesh = None
        self.data_rank, self.data_size = 0, 1
        self.ckpt_group = None
        if distributed():
            self.plan = plan_for(bundle, num_chips, global_batch_size,
                                 topology=topology, plan=plan)
            self.mesh = mesh_lib.build_mesh(self.plan, self.device.type)
            dp, fsdp, _ = self.mesh.get_coordinate()
            self.data_rank = dp * self.plan.fsdp + fsdp
            self.data_size = self.plan.data_size
            # Checkpoints run their collectives on a group of their own,
            # on the host, so that a background write never meets a step's
            # collectives on the training group (runtime/checkpoint.py).
            self.ckpt_group = torch.distributed.new_group(backend="gloo")
        elif num_chips != 1 or (plan is not None and plan.num_chips != 1):
            raise ValueError(
                f"num_chips={num_chips}: a session of several chips is one "
                "rank of a process group of as many ranks (the supervisor "
                "forms it); without one a session holds one device")
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
            self.module.attn_fn = make_flash_attention(self.mesh,
                                                       causal=causal)
        if self.mesh is not None:
            sharding.apply_rules(self.module, self.mesh, bundle.rules)
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
        """One optimizer step on the global `batch`, of which this rank
        takes its data rank's rows; returns the global batch's loss (a 0-d
        tensor)."""
        self.optimizer.zero_grad(set_to_none=True)
        local = sharding.local_rows(batch, self.data_size, self.data_rank)
        loss = self.bundle.loss_fn(self.module, local)
        loss.backward()
        self.optimizer.step()
        self.state["step"] += 1
        loss = loss.detach()
        if self.mesh is not None:
            # The mean over the data ranks' equal parts (a data group's tp
            # ranks hold the same value).
            loss = loss.clone()
            torch.distributed.all_reduce(loss)
            loss /= self.plan.num_chips
        return loss

    def run_steps(self, n: int) -> float:
        """Run n steps, each on its own (seed, step) batch; returns the
        last loss."""
        loss = torch.zeros(())
        for _ in range(n):
            loss = self.train_step(self.make_batch())
        return float(loss)

    def resize(self, new_num_chips: int) -> "TrainSession":
        """In-place resize. The only size is the current one: a resize to
        it changes nothing, and any other raises before the state is
        touched, so the caller keeps training and falls back to
        checkpoint-restart (a resize within the process group is ROADMAP
        A11)."""
        if new_num_chips != self.num_chips:
            raise ValueError(
                f"in-place resize from {self.num_chips} to {new_num_chips} "
                "chips is not ported (ROADMAP A11); this resize requires a "
                "checkpoint-restart")
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
            # A collective verdict: rank 0 reads the directory (its rename
            # commits a save) and every rank follows it, since the save
            # below is collective.
            if ckpt.latest_step(ckpt_dir, self.ckpt_group) == key[1]:
                return key[1]
            # The drained save never committed: save again.
        if self._saver is None:
            self._saver = ckpt.AsyncCheckpointSaver(self.ckpt_group)
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
               learning_rate: float = 1e-3,
               plan: Optional[mesh_lib.MeshPlan] = None,
               topology: Any = None) -> "TrainSession":
        """A session rebuilt from the checkpoint of `step` (default: the
        latest), with its seed and data position, at any world size: the
        restore reshards. `learning_rate` may differ from the saved run's.

        Two halves, which the resize bench times apart: the session built
        as at step 0 (module, parameters, optimizer), then `restore`."""
        session = cls(bundle, num_chips, global_batch_size=global_batch_size,
                      device=device, learning_rate=learning_rate, plan=plan,
                      topology=topology)
        return session.restore(ckpt_dir, step=step)

    def restore(self, ckpt_dir: str,
                step: Optional[int] = None) -> "TrainSession":
        """Load the checkpoint of `step` (default: the latest) into this
        session: the module's and the optimizer's state (at this session's
        learning rate), the step and the seed. Returns the session."""
        state = ckpt.restore_checkpoint(ckpt_dir, self.checkpoint_state(),
                                        step=step, group=self.ckpt_group)
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
