"""Checkpoints across world sizes: restart with reshard, on gloo ranks on
the CPU (tests/torch_dist_workers.py).

- 2 ranks at fsdp=2 take 2 AdamW steps and save (a collective DCP save,
  rank 0 commits); the checkpoint restores on one device (no process
  group) and on 4 ranks at fsdp=2 × tp=2. The whole parameters restored
  are bitwise the saved ones, and the next step's loss is within 1e-5
  (relative) of an uninterrupted run's third step on one device.
- A one-device checkpoint (no process group) restores on 2 ranks at
  fsdp=2, bitwise, and the next step agrees likewise.
"""

import os

import torch

from tests import torch_dist_workers as workers
from tests.torch_parity import assert_close
from vodascheduler_tpu_torch.runtime import checkpoint as ckpt

BATCH = 8


def _bitwise(got, want, what):
    assert set(got) == set(want), what
    for key in want:
        assert torch.equal(got[key], want[key]), f"{what}: {key}"


def test_two_ranks_checkpoint_restores_at_one_and_four(tmp_path):
    ckpt_dir = os.fspath(tmp_path / "ckpt")
    whole = workers.train(0, 1, steps=3, batch=BATCH)
    saved = workers.run_ranks("train", 2, tmp_path, plan={"fsdp": 2},
                              steps=2, batch=BATCH, save_to=ckpt_dir)[0]
    assert ckpt.list_steps(ckpt_dir) == [2]
    assert not [n for n in os.listdir(ckpt_dir) if not n.startswith("step_")]

    one = workers.train(0, 1, steps=1, batch=BATCH, resume_from=ckpt_dir)
    four = workers.run_ranks("train", 4, tmp_path, plan={"fsdp": 2, "tp": 2},
                             steps=1, batch=BATCH, resume_from=ckpt_dir)[0]
    for name, got in (("1 device", one), ("4 ranks", four)):
        _bitwise(got["before"], saved["after"], f"2 ranks -> {name}")
        assert got["step"] == 3
        assert_close(f"2 ranks -> {name} next-step loss", got["losses"][0],
                     whole["losses"][2], atol=0, rtol=1e-5)


def test_one_device_checkpoint_restores_on_two_ranks(tmp_path):
    ckpt_dir = os.fspath(tmp_path / "ckpt")
    whole = workers.train(0, 1, steps=3, batch=BATCH)
    saved = workers.train(0, 1, steps=2, batch=BATCH, save_to=ckpt_dir)
    two = workers.run_ranks("train", 2, tmp_path, plan={"fsdp": 2}, steps=1,
                            batch=BATCH, resume_from=ckpt_dir)[0]
    _bitwise(two["before"], saved["after"], "1 device -> 2 ranks")
    assert_close("1 device -> 2 ranks next-step loss", two["losses"][0],
                 whole["losses"][2], atol=0, rtol=1e-5)
