"""Checkpoints of a training session, through torch.distributed.checkpoint.

Counterpart of the JAX package's ``runtime/checkpoint.py``. A checkpoint is
the directory ``<ckpt_dir>/step_<%010d>`` holding the payload a session
gives it: the module's state, the optimizer's state, the step and the seed
(the step is the data position: batches are a function of (seed, step)).
`torch.distributed.checkpoint` (DCP) writes it.

One device saves and loads without a process group. The ranks of a
process group pass a group of their own (`group`, a gloo group over every
rank, which the session makes): the save is collective, each rank writing
its shards of the DTensor state into one temporary directory, and after a
barrier rank 0 alone renames it to its final name, as the reference's
coordinator commits a save. Every decision read from the directory (the
latest step, whether a step exists) is rank 0's, broadcast, so that no
rank takes another branch of a collective. A load at any world size
reshards: DCP reads each rank's slices of the saved tensors, whatever
world size wrote them, a one-device checkpoint included. The collectives
run on the host group and never on the training group, so a background
write cannot meet a step's collectives there.

Crash safety: a save writes beside its final name and renames into it, and
no temporary name matches STEP_DIR_RE, so `list_steps` and a restore never
see a half-written checkpoint.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
import time
import warnings
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

STEP_DIR_RE = re.compile(r"^step_(\d{10})$")

# Saving and loading without a process group is this module's design
# (no_dist=True), not a fault to warn about at every save.
warnings.filterwarnings("ignore", message="torch.distributed is disabled")


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step:010d}")


def list_steps(ckpt_dir: str) -> list:
    """All checkpointed steps in ascending order."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        m = STEP_DIR_RE.match(name)
        if m and os.path.isdir(os.path.join(ckpt_dir, name)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(ckpt_dir: str, group=None) -> Optional[int]:
    """The newest checkpointed step, or None; under `group`, rank 0's
    reading, broadcast."""
    if group is not None and not _is_coordinator(group):
        return _agreed(None, group)
    steps = list_steps(ckpt_dir)
    return _agreed(steps[-1] if steps else None, group)


def _is_coordinator(group) -> bool:
    return group is None or dist.get_rank(group) == 0


def _agreed(value: Any, group) -> Any:
    """Rank 0's `value` on every rank of `group` (as is without one)."""
    if group is None:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0, group=group)
    return box[0]


def _barrier(group) -> None:
    if group is not None:
        dist.barrier(group=group)


def _to_host(tree: Any) -> Any:
    """A copy of `tree` whose tensors live on the host and share no memory
    with the live state, which later steps update in place. A DTensor
    stays a DTensor of the same placements, its local shard on the host."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _write(state: Dict[str, Any], path: str) -> None:
    dcp.save(state, checkpoint_id=path, no_dist=True)


def _write_shards(state: Dict[str, Any], path: str, group) -> None:
    """Every rank of `group` writes its shards of `state` under `path`."""
    dcp.save(state, checkpoint_id=path, process_group=group)


class AsyncCheckpointSaver:
    """Checkpoint saver that overlaps the disk writes with training.

    `save` copies the state to the host before it returns, so the steps
    that follow may update the live tensors; the write then runs in a
    background thread. One save is in flight at a time; pruning the steps
    beyond `keep_last` waits until the write that supersedes them has
    committed. `wait()` must run before the process exits: it also raises
    what a failed write raised. Under a process group every rank saves
    together, passing the same `group` (module docstring).
    """

    def __init__(self, group=None) -> None:
        self.group = group
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending_retention: Optional[Tuple[str, int]] = None
        # (step, bytes, seconds of the host copy, seconds of the write) of
        # the latest committed save
        self.last_save: Optional[Tuple[int, int, float, float]] = None

    def save(self, ckpt_dir: str, state: Dict[str, Any], keep_last: int = 2,
             wait: bool = False) -> int:
        """Save `state` (with an int "step") under ckpt_dir/step_<n>;
        returns the step."""
        self.wait()
        step = int(state["step"])
        path = _step_dir(ckpt_dir, step)
        lead = _is_coordinator(self.group)
        if lead:
            os.makedirs(os.path.abspath(ckpt_dir), exist_ok=True)
        t0 = time.monotonic()
        host = _to_host(state)
        copy_s = time.monotonic() - t0
        if _agreed(lead and os.path.exists(path), self.group):
            # Re-save of an existing step (a preemption save right after a
            # restore): write beside it, then swap, so the old checkpoint
            # survives a crash mid-save.
            tmp, old = path + ".new", path + ".old"
            if lead:
                shutil.rmtree(tmp, ignore_errors=True)
                shutil.rmtree(old, ignore_errors=True)
            self._commit(host, tmp, step, copy_s)
            if lead:
                os.rename(path, old)
                os.rename(tmp, path)
                shutil.rmtree(old)
                self._prune(ckpt_dir, keep_last)
            _barrier(self.group)
        else:
            self._pending_retention = (ckpt_dir, keep_last)
            self._thread = threading.Thread(
                target=self._commit_in_background,
                args=(host, path, step, copy_s), name="voda-ckpt-writer")
            self._thread.start()
            if wait:
                self.wait()
        return step

    def _commit(self, host: Dict[str, Any], path: str, step: int,
                copy_s: float) -> None:
        """Writes under a temporary name and renames it to `path` (rank 0,
        after every rank has written)."""
        tmp = path + ".tmp"
        lead = _is_coordinator(self.group)
        if lead:
            shutil.rmtree(tmp, ignore_errors=True)
        _barrier(self.group)
        t0 = time.monotonic()
        if self.group is None:
            _write(host, tmp)
        else:
            _write_shards(host, tmp, self.group)
        _barrier(self.group)
        if lead:
            os.rename(tmp, path)
        _barrier(self.group)
        self.last_save = (step, checkpoint_nbytes(host), copy_s,
                          time.monotonic() - t0)

    def _commit_in_background(self, *args) -> None:
        try:
            self._commit(*args)
        except Exception as e:  # noqa: BLE001 - raised again by wait()
            self._error = e

    def _prune(self, ckpt_dir: str, keep_last: int) -> None:
        if not _is_coordinator(self.group):
            return
        steps = list_steps(ckpt_dir)
        for old in steps[:-keep_last] if keep_last > 0 else []:
            shutil.rmtree(_step_dir(ckpt_dir, old), ignore_errors=True)

    def wait(self) -> None:
        """Block until the in-flight save (if any) has committed; raise
        what its write raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            self._pending_retention = None
            raise err
        if self._pending_retention is not None:
            ckpt_dir, keep_last = self._pending_retention
            self._pending_retention = None
            self._prune(ckpt_dir, keep_last)

    def __enter__(self) -> "AsyncCheckpointSaver":
        return self

    def __exit__(self, *exc) -> None:
        self.wait()


def save_checkpoint(ckpt_dir: str, state: Dict[str, Any],
                    keep_last: int = 2) -> int:
    """Synchronous one-shot save (AsyncCheckpointSaver is the overlapped
    path the supervisor uses)."""
    with AsyncCheckpointSaver() as saver:
        return saver.save(ckpt_dir, state, keep_last=keep_last, wait=True)


def restore_checkpoint(ckpt_dir: str, state: Dict[str, Any],
                       step: Optional[int] = None,
                       group=None) -> Dict[str, Any]:
    """Load the checkpoint of `step` (default: the latest) into `state`, a
    payload of the same structure whose tensors are overwritten in place
    (a DTensor's local shard: the load reshards); returns `state`."""
    if step is None:
        step = latest_step(ckpt_dir, group)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir!r}")
    if group is None:
        dcp.load(state, checkpoint_id=_step_dir(ckpt_dir, step),
                 no_dist=True)
    else:
        dcp.load(state, checkpoint_id=_step_dir(ckpt_dir, step),
                 process_group=group)
    return state


def checkpoint_nbytes(state: Any) -> int:
    """Bytes of the tensors in a payload (of a DTensor, this rank's
    shard): what a restart moves."""
    if isinstance(state, torch.Tensor):
        local = getattr(state, "to_local", None)
        if local is not None:
            state = local()
        return state.numel() * state.element_size()
    if isinstance(state, dict):
        return sum(checkpoint_nbytes(v) for v in state.values())
    if isinstance(state, (list, tuple)):
        return sum(checkpoint_nbytes(v) for v in state)
    return 0
