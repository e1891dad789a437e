"""The port's resize bench (runtime/resize_bench.py) on the CPU.

Mirrors `tests/test_resize_bench.py`: the measurement means something only
on the card, so these hold its machinery under ``VODA_HWBENCH_ON_CPU=1``
with tiny models: three sequential children, the restart's marks
stitched across processes into segments that sum to its total, the
checkpoint's size, the fast row measured (a rank of a gloo group of one
resized 1 -> 1 in place, its first step after the resize the prepare
child's same step), the first two steps after the restart against the same
steps before it (equal at 1e-6 relative; the second reads the restored
optimizer state), and
`main`'s stream mode. Unlike the reference's, they run in tier-1: a torch
child starts in seconds. Without the switch and without CUDA a child
raises: nothing measures the CPU unless asked.
"""

import json
import os
import subprocess
import sys

import pytest

from vodascheduler_tpu_torch.replay import restart_costs
from vodascheduler_tpu_torch.runtime import checkpoint as ckpt
from vodascheduler_tpu_torch.runtime import resize_bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEGMENTS = [m + "_ms" for m in resize_bench.RESTART_MARKS]


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def _state_bytes(model, batch):
    """The tensor bytes of a session's checkpoint payload after a step."""
    from vodascheduler_tpu_torch.models import get_model
    from vodascheduler_tpu_torch.runtime.train import TrainSession
    session = TrainSession(get_model(model), global_batch_size=batch,
                           device="cpu")
    session.run_steps(1)
    return ckpt.checkpoint_nbytes(session.checkpoint_state())


@pytest.mark.parametrize("model,batch", [("mnist_mlp", 8),
                                         ("llama_tiny", 2)])
def test_resize_cost_breakdown_tiny(model, batch, monkeypatch, tmp_path):
    monkeypatch.setenv("VODA_HWBENCH_ON_CPU", "1")
    out = resize_bench.bench_resize_cost(model, batch, warm_steps=2,
                                         workdir=os.fspath(tmp_path))
    assert out["model"] == model and out["batch"] == batch
    assert out["backend"] == "cpu"
    # Every segment, each >= 0, summing to the total (one clock).
    seg = out["restart_segments_ms"]
    assert list(seg) == SEGMENTS
    assert all(v >= 0 for v in seg.values()), seg
    assert abs(sum(seg.values()) - out["restart_total_ms"]) < 1.0
    # One checkpoint: the latest step's directory, not both retained
    # steps; it holds the state's tensor bytes plus the format's headers
    # and metadata.
    ckpt_dir = os.fspath(tmp_path / "ckpt")
    assert ckpt.list_steps(ckpt_dir) == [2, 3]
    assert out["checkpoint_bytes"] == _dir_bytes(ckpt._step_dir(ckpt_dir, 3))
    assert out["state_bytes"] == _state_bytes(model, batch)
    assert out["state_bytes"] < out["checkpoint_bytes"]
    assert out["save_async_initiate_ms"] > 0
    assert out["save_async_drain_ms"] > 0
    assert 0 < (out["save_sync_host_copy_ms"] + out["save_sync_write_ms"]
                <= out["save_sync_ms"])
    # The cold row is what the replay charges a restart; the fast row is
    # measured: one rank resized 1 -> 1 in place, and its first step.
    paths = {p["path"]: p for p in out["resize_paths"]}
    assert set(paths) == {"fast", "cold"}
    assert paths["cold"]["seconds"] == out["resize_cost_seconds"] == round(
        (out["save_sync_ms"] + out["restart_total_ms"]) / 1000.0, 2)
    assert out["fast_resize_ms"] > 0 and "fast_error" not in out
    assert paths["fast"] == {"path": "fast", "seconds": round(
        out["fast_resize_ms"] / 1000.0, 2), "from_chips": 1, "to_chips": 1}
    assert (out["fast_from_chips"], out["fast_to_chips"]) == (1, 1)
    seg = out["fast_segments_ms"]
    assert list(seg) == ["set_up", "move", "release", "first_step"]
    assert all(v >= 0 for v in seg.values())
    assert sum(seg.values()) <= out["fast_resize_ms"] + 1.0
    # The restart's first two steps are the prepare child's same steps: the
    # second reads the restored optimizer state. The fast child's first
    # step after its resize is the first of them.
    for a, b in ((out["prepare_next_step_loss"],
                  out["restart_first_step_loss"]),
                 (out["prepare_second_step_loss"],
                  out["restart_second_step_loss"]),
                 (out["prepare_next_step_loss"],
                  out["fast_first_step_loss"])):
        assert abs(a - b) <= 1e-6 * abs(a)
    # No kernel and no device memory on the CPU; the row prices restarts
    # and in-place resizes.
    assert out["launches"] == {"prepare": {}, "restart": {}, "fast": {}}
    assert out["fast_peak_bytes"] is None
    assert out["kernel_cache_hit"] is None
    assert restart_costs._complete(out)
    costs = restart_costs.derive_costs([out])
    assert all(f"measured on {model})" in c.provenance
               and c.inplace_provenance.startswith("scaled:")
               and f"measured on {model})" in c.inplace_provenance
               for c in costs.values())


def test_a_child_without_cuda_or_the_switch_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("VODA_HWBENCH_ON_CPU", raising=False)
    with pytest.raises(RuntimeError, match="requires a CUDA device"):
        resize_bench.bench_resize_cost("mnist_mlp", 8, warm_steps=1,
                                       workdir=os.fspath(tmp_path))


def test_stream_mode_emits_resize_lines(tmp_path):
    env = dict(os.environ, VODA_HWBENCH_ON_CPU="1", TMPDIR=os.fspath(tmp_path))
    r = subprocess.run(
        [sys.executable, "-m", "vodascheduler_tpu_torch.runtime.resize_bench",
         json.dumps({"stream": True, "points": [["mnist_mlp", 2]]})],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-500:]
    lines = [json.loads(line) for line in r.stdout.splitlines()
             if line.startswith("{")]
    assert [x["kind"] for x in lines] == ["resize"]
    data = lines[0]["data"]
    assert data["model"] == "mnist_mlp"
    assert data["restart_total_ms"] > 0
    # its own workdir, removed
    assert not [d for d in os.listdir(tmp_path)
                if d.startswith("voda-resize-bench-")]


def test_resume_is_the_session_then_restore(tmp_path):
    """`TrainSession.resume` is its two halves, which the restart child
    calls in turn: the same parameters, step and seed either way."""
    import torch

    from vodascheduler_tpu_torch.models import get_model
    from vodascheduler_tpu_torch.runtime.train import TrainSession
    bundle = get_model("mnist_mlp")
    first = TrainSession(bundle, global_batch_size=4, seed=3, device="cpu")
    first.run_steps(2)
    first.save(os.fspath(tmp_path))
    a = TrainSession.resume(bundle, 1, os.fspath(tmp_path),
                            global_batch_size=4, device="cpu")
    b = TrainSession(bundle, global_batch_size=4, device="cpu").restore(
        os.fspath(tmp_path))
    for s in (a, b):
        assert (s.step, s.seed) == (2, 3)
        for (n, p), q in zip(s.module.named_parameters(),
                             first.module.parameters()):
            assert torch.equal(p, q), n
    assert a.run_steps(1) == b.run_steps(1) == first.run_steps(1)
