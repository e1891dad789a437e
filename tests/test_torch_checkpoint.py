"""The port's checkpoints and the session's save/resume, on the CPU.

- A save and a restore give back the module's parameters, the optimizer's
  state (AdamW and Adafactor), the step and the seed exactly.
- A resumed session trains on as an uninterrupted one does: 4 steps, save,
  resume in a fresh session, 4 more steps is bit-equal to 8 straight
  steps, with AdamW and with Adafactor (batches are a function of
  (seed, step)).
- `keep_last`, the re-save swap, the same-step dedupe, temporary names
  that `list_steps` never sees (and the JAX package's `list_steps` and
  `latest_step` reading the same directory alike), and a restore of
  nothing raising FileNotFoundError.
"""

import os

import pytest
import torch

from vodascheduler_tpu.runtime import checkpoint as jax_ckpt
from vodascheduler_tpu_torch.models import llama as tllama
from vodascheduler_tpu_torch.models.registry import llama_bundle
from vodascheduler_tpu_torch.runtime import TrainSession
from vodascheduler_tpu_torch.runtime import checkpoint as ckpt
from vodascheduler_tpu_torch.runtime.train import batch_seed

OPTIMIZERS = ["adamw", "adafactor"]


def _bundle(optimizer):
    return llama_bundle(f"llama_tiny_{optimizer}", tllama.LLAMA_TINY, 16,
                        optimizer)


def _session(optimizer, seed=0):
    return TrainSession(_bundle(optimizer), global_batch_size=2, seed=seed,
                        device="cpu")


def _flat(tree, prefix=""):
    """{path: leaf} of a nested state dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix: tree}


def _assert_same_state(a, b):
    fa, fb = _flat(a.checkpoint_state()), _flat(b.checkpoint_state())
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_round_trip_is_exact(tmp_path, optimizer):
    session = _session(optimizer, seed=7)
    session.run_steps(3)
    assert session.save(str(tmp_path)) == 3
    back = TrainSession.resume(_bundle(optimizer), 1, str(tmp_path),
                               global_batch_size=2, device="cpu")
    assert (back.step, back.seed) == (3, 7)
    _assert_same_state(session, back)
    state = session.checkpoint_state()
    nbytes = sum(t.numel() * t.element_size()
                 for t in _flat(state).values() if isinstance(t, torch.Tensor))
    assert ckpt.checkpoint_nbytes(state) == nbytes > 0


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_resume_then_steps_equal_straight_steps(tmp_path, optimizer):
    straight = _session(optimizer)
    losses = [straight.train_step(straight.make_batch()).item()
              for _ in range(8)]
    first = _session(optimizer)
    got = [first.train_step(first.make_batch()).item() for _ in range(4)]
    first.save(str(tmp_path), wait=False)
    first.finish_saves()
    second = TrainSession.resume(_bundle(optimizer), 1, str(tmp_path),
                                 global_batch_size=2, device="cpu")
    got += [second.train_step(second.make_batch()).item() for _ in range(4)]
    assert got == losses
    assert second.step == straight.step == 8
    _assert_same_state(straight, second)


def test_batches_are_a_function_of_seed_and_step():
    a, b = _session("adamw", seed=3), _session("adamw", seed=3)
    a.run_steps(2)
    for key in ("inputs", "targets"):
        assert torch.equal(a.make_batch()[key], b.make_batch(2)[key])
        assert not torch.equal(a.make_batch()[key], b.make_batch(1)[key])
    assert batch_seed(3, 2) != batch_seed(2, 3)
    # the model's initialisation does not move the data
    c = _session("adafactor", seed=3)
    c.module.reset_parameters(torch.Generator().manual_seed(5))
    assert torch.equal(c.make_batch(2)["inputs"], b.make_batch(2)["inputs"])


def test_keep_last_prunes_after_the_next_commit(tmp_path):
    session = _session("adamw")
    for _ in range(4):
        session.run_steps(1)
        session.save(str(tmp_path), keep_last=2, wait=False)
    session.finish_saves()
    assert ckpt.list_steps(str(tmp_path)) == [3, 4]


def test_resave_of_a_step_swaps_in_the_new_state(tmp_path):
    session = _session("adamw")
    session.run_steps(2)
    state = session.checkpoint_state()
    ckpt.save_checkpoint(str(tmp_path), state)
    with torch.no_grad():
        session.module.final_norm.scale.add_(1.0)
    ckpt.save_checkpoint(str(tmp_path), session.checkpoint_state())
    assert sorted(os.listdir(tmp_path)) == ["step_0000000002"]
    back = TrainSession.resume(_bundle("adamw"), 1, str(tmp_path),
                               global_batch_size=2, device="cpu")
    assert torch.equal(back.module.final_norm.scale,
                       session.module.final_norm.scale)


def test_same_step_save_is_deduped(tmp_path, monkeypatch):
    session = _session("adafactor")
    session.run_steps(1)
    # Counted before the first save: the background writer may call
    # _write at any time after save(wait=False) returns.
    writes = []
    real_write = ckpt._write

    def counting_write(state, path):
        writes.append(path)
        real_write(state, path)

    monkeypatch.setattr(ckpt, "_write", counting_write)
    session.save(str(tmp_path), wait=False)
    assert session.save(str(tmp_path), wait=True) == 1
    assert len(writes) == 1
    # a resumed session's first save is the checkpoint it came from
    back = TrainSession.resume(_bundle("adafactor"), 1, str(tmp_path),
                               global_batch_size=2, device="cpu")
    assert back.save(str(tmp_path)) == 1 and len(writes) == 1
    with pytest.raises(ValueError, match="no step has run"):
        _session("adamw").save(str(tmp_path))


def test_temporary_names_are_invisible_to_both_packages(tmp_path):
    session = _session("adamw")
    session.run_steps(2)
    session.save(str(tmp_path))
    for junk in ("step_0000000007.tmp", "step_0000000008.new",
                 "step_0000000009.old", "step_12", "notes"):
        (tmp_path / junk).mkdir()
    (tmp_path / "step_0000000011").write_text("a file, not a checkpoint")
    assert ckpt.list_steps(str(tmp_path)) == [2]
    assert ckpt.list_steps(str(tmp_path)) == jax_ckpt.list_steps(str(tmp_path))
    assert ckpt.latest_step(str(tmp_path)) == jax_ckpt.latest_step(
        str(tmp_path)) == 2


def test_restore_of_nothing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"), {"step": 0})
    with pytest.raises(FileNotFoundError):
        TrainSession.resume(_bundle("adamw"), 1, str(tmp_path), device="cpu")
    assert ckpt.latest_step(str(tmp_path / "none")) is None


def test_failed_write_surfaces_on_wait(tmp_path, monkeypatch):
    def fail(state, path):
        raise OSError("disk full")
    monkeypatch.setattr(ckpt, "_write", fail)
    saver = ckpt.AsyncCheckpointSaver()
    saver.save(str(tmp_path), {"step": 1, "x": torch.ones(2)})
    with pytest.raises(OSError, match="disk full"):
        saver.wait()
    assert ckpt.list_steps(str(tmp_path)) == []
