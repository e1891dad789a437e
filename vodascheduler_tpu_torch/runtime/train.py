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
holds the job's ranks [0, R) of which the first N form the mesh: it plans
the mesh (`plan_for`, parallel/mesh.py), builds the whole module from the
seed on each of the mesh's ranks, shards it by the bundle's rules
(parallel/sharding.py) and takes its data rank's rows of every global
batch, so that N ranks take the step that one device takes on the same
global batch. An MoE bundle's experts split over ep (and tp), its tokens
routed in the global batch's order (ops/moe_dispatch.py). A rank beyond
the mesh holds no module (`active` is False) until a resize takes it in.
A checkpoint written at one world size restores at any other
(runtime/checkpoint.py).

`resize` is the reference's tier-A resize (its ``TrainSession.resize``):
the running ranks change the mesh within the ranks they hold and move the
live state onto it rank to rank, with no checkpoint and no process exit.
The checkpoint-restart path serves every resize the supervisor nacks.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import os
import time
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
    """An in-place resize failed while the state moved: the ranks may
    stand at different points of the move, so the session must not keep
    training, and the caller falls back to checkpoint-restart. A resize
    failure raised as anything else happened before anything moved, and
    the session may keep training at its old size."""


def distributed() -> bool:
    """Whether this process is a rank of a process group."""
    return (torch.distributed.is_available()
            and torch.distributed.is_initialized())


def plan_for(bundle: ModelBundle, num_chips: int, global_batch_size: int,
             topology: Any = None,
             plan: Optional[mesh_lib.MeshPlan] = None) -> mesh_lib.MeshPlan:
    """The mesh plan of `bundle` at `num_chips` (the reference's
    `remesh` planning), refused with the reason before any process group
    forms: an axis the port does not run, or a global batch that the data
    axes (dp · fsdp, as the reference admits it: ep and tp ranks take the
    same rows) do not divide."""
    plan = mesh_lib.remesh_plan(num_chips, model_params_b=bundle.params_b,
                                seq_len=bundle.seq_len,
                                num_experts=bundle.num_experts,
                                topology=topology, plan=plan)
    if plan.num_chips != num_chips:
        raise ValueError(f"mesh plan {plan} covers {plan.num_chips} chips, "
                         f"the job has {num_chips}")
    mesh_lib.check_runnable(plan)
    if global_batch_size % plan.data_size:
        raise ValueError(
            f"global batch {global_batch_size} does not divide over "
            f"{plan.data_size} data ranks (dp · fsdp of {plan})")
    return plan


@dataclasses.dataclass
class _Layout:
    """What a session builds for one size: the plan and the mesh, this
    rank's data rank and groups, and on the mesh's ranks the module and
    the optimizer (None on a rank beyond the mesh)."""

    num_chips: int
    plan: Optional[mesh_lib.MeshPlan] = None
    mesh: Any = None
    # the mesh's ranks as one group (the loss), and on gloo (checkpoints)
    group: Any = None
    ckpt_group: Any = None
    data_rank: int = 0
    data_size: int = 1
    module: Any = None
    optimizer: Any = None


class TrainSession:
    """A live training session on one device, or on one rank of a process
    group whose first `num_chips` ranks form the mesh."""

    def __init__(self, bundle: ModelBundle, num_chips: int = 1,
                 global_batch_size: int = 8, seed: int = 0,
                 device: DeviceLike = None, learning_rate: float = 1e-3,
                 plan: Optional[mesh_lib.MeshPlan] = None,
                 topology: Any = None):
        self.bundle = bundle
        self.global_batch_size = global_batch_size
        self.seed = seed
        self.learning_rate = learning_rate
        self.topology = topology
        self.device = resolve_device(device)
        # The job's live ranks are [0, ranks) of the process group. Its
        # collectives that are not the mesh's run on `job_group`: the
        # default group (None) while every rank of it is live.
        self.ranks = (torch.distributed.get_world_size() if distributed()
                      else 1)
        self.job_group = None
        self._saver: Optional[ckpt.AsyncCheckpointSaver] = None
        self._last_save = None  # (abspath ckpt_dir, step) of latest save
        if not distributed() and (num_chips != 1 or (
                plan is not None and plan.num_chips != 1)):
            raise ValueError(
                f"num_chips={num_chips}: a session of several chips is one "
                "rank of a process group of as many ranks (the supervisor "
                "forms it); without one a session holds one device")
        self._install(self._lay_out(num_chips, plan, learning_rate))
        self.state = {"step": 0}

    def _lay_out(self, num_chips: int, plan: Optional[mesh_lib.MeshPlan],
                 learning_rate: float) -> _Layout:
        """The plan, the mesh and its groups at `num_chips`, and on the
        mesh's ranks the module (the kernels as its `attn_fn`) and the
        optimizer. Under a process group every rank of it calls this: the
        mesh and the groups are collective. Every refusal comes first and
        is the same on every rank: a plan the port does not run, a batch
        the data axes do not divide, a size beyond the job's ranks."""
        layout = _Layout(num_chips)
        if distributed():
            layout.plan = plan_for(self.bundle, num_chips,
                                   self.global_batch_size,
                                   topology=self.topology, plan=plan)
            world = torch.distributed.get_world_size()
            if num_chips > self.ranks:
                raise ValueError(
                    f"{num_chips} chips: the job holds {self.ranks} ranks, "
                    "and a resize beyond them requires a checkpoint-restart")
            if self.ranks < world:
                raise ValueError(
                    f"{world - self.ranks} ranks of the process group have "
                    "left the job, and a mesh is built by every rank of it: "
                    "a resize requires a checkpoint-restart")
            mesh = mesh_lib.build_mesh(layout.plan, self.device.type)
            # The job's first `num_chips` ranks: the loss's mean, and the
            # checkpoints' collectives on the host, so that a background
            # write never meets a step's collectives (runtime/checkpoint.py).
            ranks = list(range(num_chips))
            group = torch.distributed.new_group(ranks)
            ckpt_group = torch.distributed.new_group(ranks, backend="gloo")
            coordinate = mesh.get_coordinate()
            if coordinate is None:  # beyond the mesh: no module
                return layout
            layout.mesh, layout.group, layout.ckpt_group = (mesh, group,
                                                            ckpt_group)
            dp, fsdp, _, _ = coordinate
            layout.data_rank = dp * layout.plan.fsdp + fsdp
            layout.data_size = layout.plan.data_size
        init_gen = torch.Generator(self.device).manual_seed(self.seed)
        module = self.bundle.build_module(self.device, init_gen)
        if (_flash_attention_enabled(self.device)
                and hasattr(module, "attn_fn")):
            # The injected kernel replaces the layers' own masking, so the
            # module has to declare it.
            causal = getattr(type(module), "causal_attention", None)
            if causal is None:
                raise TypeError(
                    f"{type(module).__name__} has attn_fn but no "
                    "`causal_attention`; declare it so kernel injection "
                    "cannot silently change masking")
            module.attn_fn = make_flash_attention(layout.mesh, causal=causal)
        if layout.mesh is not None:
            sharding.apply_rules(module, layout.mesh, self.bundle.rules)
        params = module.parameters()
        if self.bundle.optimizer == "adafactor":
            params = bridge.reference_param_groups(
                module.named_parameters(), getattr(module, "cfg", None))
        layout.module = module
        layout.optimizer = make_optimizer(self.bundle.optimizer,
                                          learning_rate)(params)
        return layout

    def _install(self, layout: _Layout) -> None:
        self.num_chips = layout.num_chips
        self.plan = layout.plan
        self.mesh = layout.mesh
        self.group = layout.group
        self.ckpt_group = layout.ckpt_group
        self.data_rank, self.data_size = layout.data_rank, layout.data_size
        self.module = layout.module
        self.optimizer = layout.optimizer

    @property
    def active(self) -> bool:
        """Whether this rank holds the model: one device, or a rank of the
        mesh."""
        return self.module is not None

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
        if not self.active:
            raise RuntimeError(f"this rank is beyond the job's mesh of "
                               f"{self.num_chips} ranks and holds no model")
        self.optimizer.zero_grad(set_to_none=True)
        local = sharding.local_rows(batch, self.data_size, self.data_rank)
        loss = self.bundle.loss_fn(self.module, local)
        loss.backward()
        self.optimizer.step()
        self.state["step"] += 1
        loss = loss.detach()
        if self.mesh is not None:
            # The mean over the data ranks' equal parts (a data group's ep
            # and tp ranks hold the same value).
            loss = loss.clone()
            torch.distributed.all_reduce(loss, group=self.group)
            loss /= self.plan.num_chips
        return loss

    def run_steps(self, n: int) -> float:
        """Run n steps, each on its own (seed, step) batch; returns the
        last loss."""
        loss = torch.zeros(())
        for _ in range(n):
            loss = self.train_step(self.make_batch())
        return float(loss)

    def resize(self, new_num_chips: int,
               plan: Optional[mesh_lib.MeshPlan] = None,
               learning_rate: Optional[float] = None) -> "TrainSession":
        """The in-place resize (the reference's ``TrainSession.resize``):
        the session rebuilt at `new_num_chips` and its live state moved
        onto the new layout, with no checkpoint and no process exit. Under
        a process group every rank of the job calls it, and the mesh
        covers the job's first `new_num_chips` ranks; at the same size it
        rebuilds, as the reference's `make_train_setup` does. A session
        without one resizes to 1 only: it rebuilds on its device.

        Two halves. The set-up (`_lay_out`): plan, mesh, groups, module
        with its kernels, optimizer. A refusal there (a plan the port does
        not run, a batch the data axes do not divide, a size beyond the
        job's ranks) raises a plain error before anything moves, and the
        session keeps training at its old size. The move: step, seed and
        the latest save's key from rank 0 to the new mesh's ranks, then
        `sharding.reshard_state` from the old module and optimizer to the
        new ones, then the swap; a failure there raises
        ResizeStateInvalid. Batches are a function of (seed, step), so the
        next batch is the one an uninterrupted run would see.

        `learning_rate` defaults to the session's; pass the rescaled value
        for linear-LR-scaling policies, as on the cold path's restore."""
        if learning_rate is None:
            learning_rate = self.learning_rate
        if not distributed() and (new_num_chips != 1 or (
                plan is not None and plan.num_chips != 1)):
            raise ValueError(
                f"in-place resize from {self.num_chips} to {new_num_chips} "
                "chips needs a process group of as many ranks; without one "
                "a session holds one device, and this resize requires a "
                "checkpoint-restart")
        t0 = time.monotonic()
        # An in-flight save writes on the old checkpoint group: let it
        # commit before the groups change.
        self.finish_saves()
        if self.active:
            # The last step's gradients: no state (every step sets them
            # anew), and one copy of the parameters less at the peak.
            self.optimizer.zero_grad(set_to_none=True)
        new = self._lay_out(new_num_chips, plan, learning_rate)
        t1 = time.monotonic()
        try:
            self._move(new)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        except Exception as e:  # noqa: BLE001
            raise ResizeStateInvalid(
                f"live reshard to {new_num_chips} chips failed: "
                f"{type(e).__name__}: {e}") from e
        t2 = time.monotonic()
        # The swap releases the old module and optimizer.
        self._install(new)
        self.learning_rate = learning_rate
        self._saver = None  # its group is the old mesh's
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        # Where the resize's time went (the resize bench reports it).
        self.last_resize_ms = {
            "set_up": round((t1 - t0) * 1000.0, 1),
            "move": round((t2 - t1) * 1000.0, 1),
            "release": round((time.monotonic() - t2) * 1000.0, 1)}
        return self

    def _move(self, new: _Layout) -> None:
        """The move half of `resize`: rank 0's step, seed and latest save
        to the new mesh's ranks (a rank new to it holds none of them),
        then every tensor of the state."""
        carry = [(self.step, self.seed, self._last_save)]
        if new.ckpt_group is not None:
            torch.distributed.broadcast_object_list(carry, src=0,
                                                    group=new.ckpt_group)
        step, seed, last_save = carry[0]
        sharding.reshard_state(
            (self.module, self.optimizer) if self.active else None,
            (new.module, new.optimizer) if new.module is not None else None,
            new.group,
            # torch's optimizers make their state at the first step
            optimizer=step > 0)
        self.state["step"], self.seed, self._last_save = (step, seed,
                                                          last_save)

    def leave_idle_ranks(self) -> None:
        """The ranks beyond the mesh leave the job (they exit and hand back
        their devices): from now on the job's collectives run on the
        mesh's group, and a resize to another size requires a
        checkpoint-restart, since a new mesh is built by every rank of the
        process group."""
        self.ranks = self.num_chips
        self.job_group = self.group

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
