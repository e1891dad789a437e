"""Rank processes for the port's multi-rank CPU tests, without JAX.

`run_ranks(fn, world, tmp, **kwargs)` starts `world` processes of

    python -m tests.torch_dist_workers <fn> <rank> <world> <port> <out> <json>

each of which joins a gloo process group of `world` ranks on the CPU
(`torch.set_num_threads(1)`), runs `fn(rank, world, **kwargs)` from this
module and saves what it returns to ``<out>/rank<r>.pt``: `train`, or
`resize_story(ies)`, a session's steps and in-place resizes. Every process is
waited for with one deadline and all are killed when it passes, so a hang
fails the test at once. The module imports no JAX, so the ranks start
without it; the tests compare what rank 0 returns with the JAX package in
their own process.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import socket
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 90.0


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(fn: str, world: int, tmp: str, deadline: float = DEADLINE_S,
              **kwargs) -> List[Any]:
    """Run `fn` on `world` gloo ranks; returns each rank's result."""
    out = os.path.join(str(tmp), f"{fn}_{world}_{time.monotonic_ns()}")
    os.makedirs(out)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
               TORCH_CPP_LOG_LEVEL="ERROR")
    env.pop("VODA_FORCE_CPU_DEVICES", None)
    logs = [open(os.path.join(out, f"rank{r}.log"), "w")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_dist_workers", fn, str(r),
         str(world), str(port), out, json.dumps(kwargs)],
        cwd=REPO, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    end = time.monotonic() + deadline
    try:
        for p in procs:
            p.wait(timeout=max(0.1, end - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        tails = []
        for r in range(world):
            with open(os.path.join(out, f"rank{r}.log")) as f:
                tails.append(f"--- rank {r} (exit {codes[r]}) ---\n"
                             + f.read()[-3000:])
        raise AssertionError(f"{fn} on {world} ranks failed "
                             f"(deadline {deadline} s):\n" + "\n".join(tails))
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# what the ranks run
# ---------------------------------------------------------------------------

SEQ = 16


def bundle_for(model: str = "llama_tiny", dtype: str = "float32",
               optimizer: str = "adamw", cfg: Optional[Dict] = None,
               seq: int = SEQ):
    """A llama bundle of LLAMA_TINY's family (or with `model`
    "mixtral_tiny", MIXTRAL_TINY's) in `dtype` at `seq`, with `cfg`'s
    fields replaced; any other `model` from the registry."""
    from vodascheduler_tpu_torch.models import llama, mixtral
    from vodascheduler_tpu_torch.models.registry import (
        get_model,
        llama_bundle,
        mixtral_bundle,
    )
    if model == "mixtral_tiny":
        c = dataclasses.replace(mixtral.MIXTRAL_TINY, dtype=dtype,
                                **(cfg or {}))
        return mixtral_bundle(model, c, seq, optimizer)
    if model != "llama_tiny":
        return get_model(model)
    c = dataclasses.replace(llama.LLAMA_TINY, dtype=dtype, **(cfg or {}))
    return llama_bundle("llama_tiny", c, seq, optimizer)


def lm_batches(vocab: int, steps: int, batch: int, seq: int = SEQ,
               seed: int = 0) -> List[Dict[str, np.ndarray]]:
    """`steps` token batches of [batch, seq], from `seed` with numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        tokens = rng.integers(0, vocab, (batch, seq + 1))
        out.append({"inputs": tokens[:, :-1], "targets": tokens[:, 1:]})
    return out


def full_params(module) -> Dict[str, torch.Tensor]:
    """The module's whole parameters (and buffers), on every rank."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return {k: v.detach().clone() for k, v in module.state_dict().items()}
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions,
        get_model_state_dict,
    )
    sd = get_model_state_dict(module, options=StateDictOptions(
        full_state_dict=True))
    return {k: v.detach().clone() for k, v in sd.items()}


def full_grads(module) -> Dict[str, torch.Tensor]:
    """The last step's gradient of every parameter, whole, by name (after
    the step: FSDP2's reduced gradient, the mean over the data ranks)."""
    out = {}
    for name, p in module.named_parameters():
        g = p.grad
        if g is not None:
            g = g.full_tensor() if hasattr(g, "full_tensor") else g
            out[name] = g.detach().clone()
    return out


def realised_placements(module) -> Dict[str, Dict[str, int]]:
    """Each parameter's DTensor placements as {mesh axis: torch dim} of the
    axes (of size above 1) that split it."""
    from torch.distributed.tensor import DTensor

    out = {}
    for name, p in module.named_parameters():
        split = {}
        if isinstance(p, DTensor):
            names = p.device_mesh.mesh_dim_names
            sizes = p.device_mesh.mesh.shape
            for axis, size, placement in zip(names, sizes, p.placements):
                # Shard, or the _StridedShard of fsdp over a tp split
                if size > 1 and not (placement.is_replicate()
                                     or placement.is_partial()):
                    split[axis] = placement.dim
        out[name] = split
    return out


def _record_routing_gaps() -> List[float]:
    """Records, for every later call of top_k_gating in this process, the
    smallest gap between a token's k-th and (k+1)-th probability."""
    from vodascheduler_tpu_torch.ops import moe_dispatch
    gaps: List[float] = []
    gating = moe_dispatch.top_k_gating

    def recording(probs, top_k, eps=1e-9):
        p = torch.sort(probs.detach(), dim=-1, descending=True)[0]
        gaps.append((p[..., top_k - 1] - p[..., top_k]).min().item())
        return gating(probs, top_k, eps)
    moe_dispatch.top_k_gating = recording
    return gaps


def train(rank: int, world: int, plan: Optional[Dict] = None,
          steps: int = 1, batch: int = 8, params: Optional[str] = None,
          model: str = "llama_tiny", dtype: str = "float32",
          optimizer: str = "adamw", cfg: Optional[Dict] = None,
          seq: int = SEQ, save_to: Optional[str] = None,
          save_after: Optional[int] = None,
          resume_from: Optional[str] = None,
          gaps: bool = False) -> Dict[str, Any]:
    """Build (or resume) a session of `world` chips at `plan`, optionally
    from the full state_dict saved at `params`, run `steps` steps on
    `lm_batches` (the batches after a resumed step when resuming), save to
    `save_to` after `save_after` of them (default: all); return the
    losses, the whole parameters before and after, the last step's whole
    gradients, this rank's local block of every parameter, the parameters'
    placements, the whole state at the save (and, resumed, at the restore)
    and with `gaps` the routing gaps (`_record_routing_gaps`)."""
    from vodascheduler_tpu_torch import bridge
    from vodascheduler_tpu_torch.parallel.mesh import MeshPlan
    from vodascheduler_tpu_torch.runtime.train import TrainSession

    routing_gaps = _record_routing_gaps() if gaps else None
    bundle = bundle_for(model, dtype, optimizer, cfg, seq)
    mesh_plan = MeshPlan(**plan) if plan else None
    if resume_from:
        session = TrainSession.resume(bundle, world, resume_from,
                                      global_batch_size=batch, device="cpu",
                                      plan=mesh_plan)
    else:
        session = TrainSession(bundle, world, global_batch_size=batch,
                               device="cpu", plan=mesh_plan)
    if params:
        sd = torch.load(params) if rank == 0 else {}
        bridge.load_reference_params(session.module, sd)
    start = session.step
    restored = whole_state(session) if resume_from else None
    before = full_params(session.module)
    batches = lm_batches(bundle.cfg.vocab_size, start + steps, batch, seq)
    losses, saved = [], None
    for i, b in enumerate(batches[start:]):
        tb = {k: torch.tensor(v) for k, v in b.items()}
        losses.append(float(session.train_step(tb)))
        if save_to and i + 1 == (save_after or steps):
            session.save(save_to)
            session.finish_saves()
            saved = whole_state(session)
    return {"losses": losses, "before": before,
            "after": full_params(session.module),
            "grads": full_grads(session.module),
            "local": {k: (v.to_local() if hasattr(v, "to_local") else v)
                      .detach().clone()
                      for k, v in session.module.named_parameters()},
            "step": session.step,
            "placements": realised_placements(session.module),
            "saved": saved, "restored": restored, "gaps": routing_gaps,
            "plan": dataclasses.asdict(session.plan) if session.plan
            else None}


def whole_state(session) -> Dict[str, torch.Tensor]:
    """Every tensor of the session's module and optimizer state, whole
    (`full_tensor()` of a DTensor), keyed by its path; a number as a 0-d
    tensor. Empty on a rank beyond the mesh."""
    from torch.distributed.tensor import DTensor

    from vodascheduler_tpu_torch.parallel import sharding
    if not session.active:
        return {}
    leaves = sharding._state_dicts((session.module, session.optimizer),
                                   True)[3]
    out = {}
    for path, v in leaves.items():
        if isinstance(v, DTensor):
            v = v.full_tensor()
        out["/".join(map(str, path))] = (
            v.detach().clone() if isinstance(v, torch.Tensor)
            else torch.tensor(v))
    return out


def load_whole(module, state_dict) -> None:
    """A full state_dict (numpy or torch) into `module`, each rank cutting
    its own shards, without a collective."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    with torch.no_grad():
        for key, v in module.state_dict().items():
            w = torch.as_tensor(state_dict[key]).to(v.dtype).contiguous()
            if isinstance(v, DTensor):
                v.to_local().copy_(distribute_tensor(
                    w, v.device_mesh, v.placements,
                    src_data_rank=None).to_local())
            else:
                v.copy_(w)


def resize_story(rank: int, world: int, chips: int,
                 actions: List[List[Any]], plan: Optional[Dict] = None,
                 batch: int = 8, params: Optional[str] = None,
                 model: str = "llama_tiny", dtype: str = "float32",
                 optimizer: str = "adamw", cfg: Optional[Dict] = None,
                 seq: int = SEQ) -> List[Dict[str, Any]]:
    """A session of `chips` of the `world` ranks at `plan`, optionally from
    the full state_dict at `params`, then `actions` in order, each giving
    one record:

    - ["steps", n]: n steps on `lm_batches` (the batch of each step by its
      number); the losses;
    - ["resize", n, plan or None]: `TrainSession.resize`; the chips, the
      plan and whether this rank is in the mesh;
    - ["refuse", n, plan or None]: a resize that must raise before
      anything moves; the error's type and message;
    - ["state"]: `whole_state`.
    """
    from vodascheduler_tpu_torch.parallel.mesh import MeshPlan
    from vodascheduler_tpu_torch.runtime.train import TrainSession

    bundle = bundle_for(model, dtype, optimizer, cfg, seq)
    session = TrainSession(bundle, chips, global_batch_size=batch,
                           device="cpu",
                           plan=MeshPlan(**plan) if plan else None)
    if params and session.active:
        load_whole(session.module, torch.load(params))
    total = sum(a[1] for a in actions if a[0] == "steps")
    batches = lm_batches(bundle.cfg.vocab_size, total, batch, seq)
    records = []
    for action in actions:
        kind = action[0]
        if kind == "steps":
            losses = []
            for _ in range(action[1]):
                b = batches[session.step]
                tb = {k: torch.tensor(v) for k, v in b.items()}
                if session.active:
                    losses.append(float(session.train_step(tb)))
            records.append({"losses": losses, "step": session.step})
        elif kind in ("resize", "refuse"):
            new_plan = MeshPlan(**action[2]) if action[2] else None
            try:
                session.resize(action[1], plan=new_plan)
            except Exception as e:  # noqa: BLE001
                if kind == "resize":
                    raise
                records.append({"error": type(e).__name__,
                                "message": str(e)})
                continue
            if kind == "refuse":
                raise AssertionError(f"resize to {action[1]} did not raise")
            records.append({"chips": session.num_chips,
                            "active": session.active,
                            "plan": dataclasses.asdict(session.plan),
                            "attn_fn": getattr(session.module, "attn_fn",
                                               None) is not None})
        elif kind == "state":
            records.append(whole_state(session))
        else:
            raise ValueError(kind)
    return records


def resize_stories(rank: int, world: int,
                   stories: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Several `resize_story`s in turn on one process group, by name."""
    return {name: resize_story(rank, world, **kwargs)
            for name, kwargs in stories.items()}


def routing(rank: int, world: int, data_shape: List[int], tokens: int,
            experts: int, top_k: int, capacity_factor: float,
            seed: int) -> Dict[str, Any]:
    """This rank's routing of its rows of a global [tokens, experts] gates
    tensor (`routing_gates`) over the data axes `data_shape` (dp, fsdp) of
    the `world` ranks: the global capacity and slot order through the
    ranks' prefix (pos + prefix is the global slot), and, as the planted
    fault, the same rows routed apart with their own capacity and order."""
    from torch.distributed.device_mesh import DeviceMesh

    from vodascheduler_tpu_torch.ops import moe_dispatch as moe

    mesh = DeviceMesh("cpu", torch.arange(world).reshape(data_shape),
                      mesh_dim_names=("dp", "fsdp"))
    layout = moe.ExpertLayout(data_groups=(mesh.get_group("dp"),
                                           mesh.get_group("fsdp")))
    rows = tokens // world
    gates = routing_gates(tokens, experts, top_k, seed)[
        layout.data_rank * rows:(layout.data_rank + 1) * rows]
    pos, kept, slots = moe._local_routing(gates, experts, top_k,
                                          capacity_factor, layout)
    _, apart, _ = moe._local_routing(gates, experts, top_k,
                                     capacity_factor, moe.ONE_DEVICE)
    return {"data_rank": layout.data_rank, "pos": pos,
            "prefix": moe._prefix(gates, layout), "kept": kept,
            "slots": slots, "apart": apart}


def routing_gates(tokens: int, experts: int, top_k: int,
                  seed: int) -> torch.Tensor:
    """[tokens, experts] gates from numpy logits on a coarse grid (0, 0.5,
    1), so that many tokens tie among their experts' probabilities."""
    from vodascheduler_tpu_torch.ops import moe_dispatch as moe
    rng = np.random.default_rng(seed)
    logits = rng.integers(0, 3, (tokens, experts)) / 2.0
    probs = torch.softmax(torch.tensor(logits, dtype=torch.float32), -1)
    return moe.top_k_gating(probs, top_k)


def jobs(rank: int, world: int,
         todo: List[List[Any]]) -> Dict[str, Any]:
    """Several jobs in turn on one process group: each [name, fn, kwargs]
    with `fn` one of this module's rank functions; their results by
    name."""
    return {name: globals()[fn](rank, world, **kwargs)
            for name, fn, kwargs in todo}


def main(argv: List[str]) -> None:
    fn, rank, world, port, out, kwargs = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=DEADLINE_S))
    try:
        result = globals()[fn](rank, world, **json.loads(kwargs))
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
