"""Hardware benchmarks: step time, tokens/s and MFU measured on one card.

Counterpart of the one-card part of the JAX package's
``runtime/hwbench.py``. Everything is measured on the device the caller
names (CUDA by default), never simulated:

- `bench_model_step`: the full train step (forward, backward, optimizer)
  of a registry model: step ms, tokens/s, peak memory and MFU;
- `bench_attention_point`: the flash-attention kernels, forward and
  backward, against the plain attention at one shape;
- `bench_moe_dispatch`: one Mixtral train step under each dispatch
  (gather, routed, dense; only the dispatch differs), and the shipped
  Adafactor/dots_attn variant.

Timing is two-point differencing: k_small and k_big steps each run between
two `torch.cuda.synchronize()` calls, the median of `reps` runs each, and
one step takes (t_big - t_small) / (k_big - k_small): the fixed cost of a
run (the launch of the first kernel, the last synchronisation) appears in
both and cancels.

MFU counts model operations by the PaLM convention (appendix B):
6·params·tokens + 12·layers·d_model·B·S² (the full S² score matrix, causal
or not), against the card's dense bf16 peak. An MoE model counts its
expert parameters at top_k/E: the operations a token's routing runs.

    python -m vodascheduler_tpu_torch.runtime.hwbench [--models llama_350m:8,mixtral_small:8]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import statistics
import subprocess
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from vodascheduler_tpu_torch.device import DeviceLike, resolve_device

# Dense bf16 peak operations per second by the card's name (NVIDIA's data
# sheets, without sparsity), looked up by substring, first match.
PEAK_FLOPS: Tuple[Tuple[str, float], ...] = (
    ("H100 NVL", 835e12),
    ("H100 PCIe", 756e12),
    ("H100 80GB HBM3", 989e12),  # the SXM card's name
    ("H100 SXM", 989e12),
)


# The benchrunner's attention sweep, (batch, seq) at 16 heads of 64: the
# reference's, so the point registries of both packages are one.
DEFAULT_ATTENTION_POINTS: Sequence[Tuple[int, int]] = (
    (8, 1024), (4, 2048), (2, 4096), (1, 8192))


def peak_flops_per_device(device_name: Optional[str] = None) -> float:
    """The dense bf16 peak of the card named `device_name` (default: CUDA
    device 0). A card not in PEAK_FLOPS raises: pass its peak instead."""
    name = (torch.cuda.get_device_name(0) if device_name is None
            else device_name)
    for key, peak in PEAK_FLOPS:
        if key in name:
            return peak
    raise ValueError(f"no dense bf16 peak known for {name!r}; pass "
                     "peak_flops")


def count_params(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def count_params_active(module: torch.nn.Module, top_k: int,
                        num_experts: int) -> int:
    """Parameters a token runs through: those named `experts_` (MoEBlock's
    expert weights) count at top_k/E. Equals count_params for a dense
    model."""
    total = expert = 0
    for name, p in module.named_parameters():
        total += p.numel()
        if "experts_" in name:
            expert += p.numel()
    return int(total - expert + expert * top_k / num_experts)


def transformer_step_flops(num_params: int, num_layers: int, d_model: int,
                           batch: int, seq: int) -> float:
    """Forward and backward operations of one LM step (PaLM appendix B)."""
    tokens = batch * seq
    return (6.0 * num_params * tokens
            + 12.0 * num_layers * d_model * batch * seq ** 2)


def model_step_flops(bundle: Any, module: torch.nn.Module,
                     global_batch_size: int) -> Tuple[int, int, float]:
    """(parameters, active parameters, operations of one step) of a
    bundle's model: an MoE bundle counts its experts at top_k/E."""
    cfg = bundle.cfg
    n_params = count_params(module)
    n_active = (count_params_active(module, cfg.top_k, cfg.num_experts)
                if bundle.num_experts else n_params)
    return n_params, n_active, transformer_step_flops(
        n_active, cfg.num_layers, cfg.dim, global_batch_size, bundle.seq_len)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_per_iteration(step: Callable[[], Any], device: torch.device,
                       k_small: int = 2, k_big: int = 10,
                       reps: int = 3) -> float:
    """Seconds per call of `step`, by two-point differencing (module
    docstring). One untimed call first builds and warms what it needs."""
    step()
    _sync(device)
    medians = {}
    for k in (k_small, k_big):
        samples = []
        for _ in range(reps):
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(k):
                step()
            _sync(device)
            samples.append(time.perf_counter() - t0)
        medians[k] = statistics.median(samples)
    return max((medians[k_big] - medians[k_small]) / (k_big - k_small), 1e-9)


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def _peak(device: torch.device, peak_flops: Optional[float]) -> float:
    if peak_flops is not None:
        return peak_flops
    if device.type != "cuda":
        raise ValueError(f"no peak known for {device}; pass peak_flops")
    return peak_flops_per_device(_device_name(device))


@dataclasses.dataclass
class StepBenchResult:
    model: str
    batch: int
    seq: int
    step_time_ms: float
    tokens_per_sec: float
    model_tflops_per_step: float
    achieved_tflops: float
    mfu: float
    num_params: int
    device_kind: str
    num_params_active: int = 0  # < num_params only for MoE models
    peak_memory_bytes: int = 0  # on CUDA: the largest allocation in the run

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def bench_model_step(model_name: str, global_batch_size: int = 8,
                     k_small: int = 2, k_big: int = 10, reps: int = 3,
                     device: DeviceLike = None, bundle: Any = None,
                     peak_flops: Optional[float] = None) -> StepBenchResult:
    """Time the full train step of `model_name` (or of `bundle`, which
    overrides the registry) on one fixed batch: a TrainSession's own
    `train_step`, whose state carries from step to step."""
    from vodascheduler_tpu_torch.models import get_model
    from vodascheduler_tpu_torch.runtime.train import TrainSession

    device = resolve_device(device)
    peak = _peak(device, peak_flops)
    bundle = bundle if bundle is not None else get_model(model_name)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    session = TrainSession(bundle, 1, global_batch_size=global_batch_size,
                           device=device)
    batch = session.make_batch()
    step_s = time_per_iteration(lambda: session.train_step(batch), device,
                                k_small, k_big, reps)
    n_params, n_active, flops = model_step_flops(bundle, session.module,
                                                 global_batch_size)
    peak_mem = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
    del session, batch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    seq = bundle.seq_len
    return StepBenchResult(
        model=model_name, batch=global_batch_size, seq=seq,
        step_time_ms=step_s * 1e3,
        tokens_per_sec=global_batch_size * seq / step_s,
        model_tflops_per_step=flops / 1e12,
        achieved_tflops=flops / step_s / 1e12,
        mfu=flops / step_s / peak, num_params=n_params,
        device_kind=_device_name(device), num_params_active=n_active,
        peak_memory_bytes=peak_mem)


def bench_attention_point(batch: int, seq: int, heads: int = 16,
                          head_dim: int = 64, causal: bool = True,
                          device: DeviceLike = None, k_small: int = 2,
                          k_big: int = 8, reps: int = 3) -> Dict[str, Any]:
    """The flash-attention kernels (forward, then dQ and dK/dV) against the
    plain O(S²) attention, forward and backward, bf16, at one shape."""
    from vodascheduler_tpu_torch.ops.flash_attention import flash_attention
    from vodascheduler_tpu_torch.parallel.ring_attention import (
        reference_attention,
    )

    device = resolve_device(device)
    g = torch.Generator(device).manual_seed(0)
    q, k, v = (torch.randn(batch, seq, heads, head_dim, generator=g,
                           device=device).bfloat16().requires_grad_()
               for _ in range(3))
    out: Dict[str, Any] = {"batch": batch, "seq": seq, "heads": heads,
                           "head_dim": head_dim, "causal": causal}
    for name, attn in (("flash", flash_attention),
                       ("plain", reference_attention)):
        def step(attn=attn):
            attn(q, k, v, causal=causal).float().sum().backward()
            q.grad = k.grad = v.grad = None
        out[f"{name}_ms"] = 1e3 * time_per_iteration(step, device, k_small,
                                                     k_big, reps)
    out["flash_speedup"] = out["plain_ms"] / out["flash_ms"]
    return out


def bench_moe_dispatch(global_batch_size: int = 8,
                       model_name: str = "mixtral_small",
                       base_cfg: Any = None, device: DeviceLike = None,
                       k_small: int = 2, k_big: int = 10, reps: int = 3,
                       peak_flops: Optional[float] = None) -> Dict[str, Any]:
    """One Mixtral train step under each dispatch, only
    `MixtralConfig.dispatch` differing: the full record for "gather" (the
    one-card dispatch), step ms for "routed" and "dense"; then "gather_af",
    the shipped mixtral_small_af knobs (its dispatch, remat policy and
    optimizer) on the same base config."""
    from vodascheduler_tpu_torch.models import get_model
    from vodascheduler_tpu_torch.models.registry import mixtral_bundle

    ship = get_model(model_name)
    ship_af = get_model("mixtral_small_af")
    base = base_cfg if base_cfg is not None else ship.cfg
    bench = functools.partial(bench_model_step, model_name,
                              global_batch_size, k_small, k_big, reps,
                              device, peak_flops=peak_flops)
    out: Dict[str, Any] = {}
    for dispatch in ("gather", "routed", "dense"):
        bundle = mixtral_bundle(model_name,
                                dataclasses.replace(base, dispatch=dispatch),
                                ship.seq_len, ship.optimizer)
        res = bench(bundle=bundle)
        if dispatch == "gather":
            out["gather"] = res.as_dict()
        else:
            out[f"{dispatch}_step_ms"] = res.step_time_ms
    af_cfg = dataclasses.replace(base, dispatch=ship_af.cfg.dispatch,
                                 remat_policy=ship_af.cfg.remat_policy)
    out["gather_af"] = bench(bundle=mixtral_bundle(
        model_name, af_cfg, ship.seq_len, ship_af.optimizer)).as_dict()
    out["gather_speedup_vs_dense"] = (out["dense_step_ms"]
                                      / out["gather"]["step_time_ms"])
    return out


def run_hardware_bench(model_points: Sequence[Tuple[str, int]] = (
        ("llama_350m", 8), ("mixtral_small", 8)),
        attention_points: Sequence[Tuple[int, int]] = ((8, 2048),),
        moe_batch: Optional[int] = 8, device: DeviceLike = None,
        k_small: int = 2, k_big: int = 10, reps: int = 3,
        peak_flops: Optional[float] = None) -> Dict[str, Any]:
    """Every point in one process. A point that fails raises: nothing is
    retried on another path."""
    device = resolve_device(device)
    out: Dict[str, Any] = {
        "device_kind": _device_name(device),
        "peak_bf16_tflops": _peak(device, peak_flops) / 1e12,
        "models": [bench_model_step(name, bsz, k_small, k_big, reps, device,
                                    peak_flops=peak_flops).as_dict()
                   for name, bsz in model_points],
        "attention": [bench_attention_point(bsz, seq, device=device,
                                            reps=reps)
                      for bsz, seq in attention_points],
    }
    if moe_batch:
        out["moe"] = bench_moe_dispatch(moe_batch, device=device,
                                        k_small=k_small, k_big=k_big,
                                        reps=reps, peak_flops=peak_flops)
    return out


def _points(text: str, sep: str) -> list:
    return [tuple(int(x) if x.isdigit() else x for x in p.split(sep))
            for p in text.split(",") if p]


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--models", default="llama_350m:8,mixtral_small:8",
                    help="name:batch,...")
    ap.add_argument("--attention", default="8x2048", help="batch x seq,...")
    ap.add_argument("--moe-batch", type=int, default=8, help="0: no MoE")
    ap.add_argument("--k-small", type=int, default=2)
    ap.add_argument("--k-big", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default=None, help="default: CUDA")
    ap.add_argument("--peak-flops", type=float, default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0], flush=True)
    print(json.dumps(run_hardware_bench(
        _points(args.models, ":"), _points(args.attention, "x"),
        args.moe_batch, device, args.k_small, args.k_big, args.reps,
        args.peak_flops), indent=2))


if __name__ == "__main__":
    main()
