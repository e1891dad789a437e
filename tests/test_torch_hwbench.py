"""The port's hardware bench on the CPU: its arithmetic against the JAX
package's, its peak table, its timing, and each entry point at a tiny size.

- `count_params`, `count_params_active` and `transformer_step_flops` give
  the JAX functions' numbers, exactly, on the same models (mixtral_tiny,
  llama_tiny, and MIXTRAL_SMALL: 386,084,480 parameters, 138,358,400
  active, by the reference's convention);
- the peak table maps the H100's names to their dense bf16 peaks, and an
  unknown card raises unless the caller gives a peak;
- `bench_model_step`, `bench_moe_dispatch` and `bench_attention_point` run
  on the CPU when asked (finite numbers), and raise without CUDA when not.
"""

import json
import time

import jax
import jax.numpy as jnp
import pytest
import torch

from vodascheduler_tpu.models import registry as jregistry
from vodascheduler_tpu.runtime import hwbench as jhw
from vodascheduler_tpu_torch.models import get_model
from vodascheduler_tpu_torch.models import mixtral as tmixtral
from vodascheduler_tpu_torch.runtime import hwbench


def _jax_params(name):
    bundle = jregistry.get_model(name)
    return jax.eval_shape(lambda: bundle.module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]


@pytest.mark.parametrize("name", ["mixtral_tiny", "llama_tiny",
                                  "mixtral_small"])
def test_parameter_counts_and_flops_match_jax(name):
    bundle = get_model(name)
    module = bundle.build_module(torch.device("meta"), None)
    ref = _jax_params(name)
    cfg = bundle.cfg
    assert hwbench.count_params(module) == jhw.count_params(ref)
    if bundle.num_experts:
        got = hwbench.count_params_active(module, cfg.top_k, cfg.num_experts)
        want = jhw.count_params_active(ref, cfg.top_k, cfg.num_experts)
    else:
        got = hwbench.count_params_active(module, 2, 8)
        want = jhw.count_params(ref)
    assert got == want
    for batch, seq in ((8, bundle.seq_len), (2, 16)):
        assert hwbench.transformer_step_flops(
            got, cfg.num_layers, cfg.dim, batch, seq) == \
            jhw.transformer_step_flops(want, cfg.num_layers, cfg.dim,
                                       batch, seq)
    if name == "mixtral_small":
        assert (hwbench.count_params(module), got) == (386_084_480,
                                                       138_358_400)


def test_peak_table_maps_the_h100s():
    assert hwbench.peak_flops_per_device("NVIDIA H100 80GB HBM3") == 989e12
    assert hwbench.peak_flops_per_device("NVIDIA H100 SXM5 80GB") == 989e12
    assert hwbench.peak_flops_per_device("NVIDIA H100 PCIe") == 756e12
    assert hwbench.peak_flops_per_device("NVIDIA H100 NVL") == 835e12
    with pytest.raises(ValueError, match="pass peak_flops"):
        hwbench.peak_flops_per_device("NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="pass peak_flops"):
        hwbench.bench_model_step("mixtral_tiny", 2, device="cpu")


def test_two_point_differencing_cancels_the_fixed_cost(monkeypatch):
    """Steps of 20 ms, and 100 ms at every synchronisation: a timed run of
    k steps reads k·20 + 100 ms, and the fixed part cancels."""
    calls = []

    def step():
        calls.append(1)
        time.sleep(0.02)

    monkeypatch.setattr(hwbench, "_sync", lambda device: time.sleep(0.1))
    s = hwbench.time_per_iteration(step, torch.device("cpu"), 3, 6, 1)
    assert 0.015 < s < 0.03, s
    assert len(calls) == 1 + 3 + 6


def test_model_step_on_the_cpu():
    res = hwbench.bench_model_step("mixtral_tiny", 2, k_small=1, k_big=2,
                                   reps=1, device="cpu", peak_flops=1e12)
    d = res.as_dict()
    assert d["device_kind"] == "cpu" and (d["batch"], d["seq"]) == (2, 64)
    assert d["num_params_active"] < d["num_params"]
    for key in ("step_time_ms", "tokens_per_sec", "mfu", "achieved_tflops"):
        assert 0 < d[key] < float("inf"), key
    # against a peak of 1 TFLOP/s, MFU is the achieved TFLOP/s
    assert d["mfu"] == pytest.approx(d["achieved_tflops"])


def test_moe_dispatch_and_attention_point_on_the_cpu():
    out = hwbench.bench_moe_dispatch(2, "mixtral_tiny", device="cpu",
                                     k_small=1, k_big=2, reps=1,
                                     peak_flops=1e12)
    assert set(out) == {"gather", "routed_step_ms", "dense_step_ms",
                        "gather_af", "gather_speedup_vs_dense"}
    assert out["gather"]["model"] == "mixtral_tiny"
    assert all(out[k] > 0 for k in ("routed_step_ms", "dense_step_ms"))
    assert out["gather_af"]["step_time_ms"] > 0
    point = hwbench.bench_attention_point(1, 64, heads=2, device="cpu",
                                          k_small=1, k_big=2, reps=1)
    assert point["flash_ms"] > 0 and point["plain_ms"] > 0


def test_entry_points_need_cuda_unless_asked(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hwbench.bench_model_step("mixtral_tiny", 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hwbench.bench_moe_dispatch(2, "mixtral_tiny",
                                   base_cfg=tmixtral.MIXTRAL_TINY)
    hwbench.main(["--device", "cpu", "--models", "mixtral_tiny:2",
                  "--attention", "1x32", "--moe-batch", "0", "--k-small",
                  "1", "--k-big", "2", "--reps", "1", "--peak-flops",
                  "1e12"])
    out = json.loads(capsys.readouterr().out)
    assert [m["model"] for m in out["models"]] == ["mixtral_tiny"]
    assert out["attention"][0]["seq"] == 32 and "moe" not in out
