"""Where one training step of the PyTorch port spends its time on the card.

    python3 scripts/torch_step_profile.py [--steps 3] [--model llama_350m]
        [--heads N]

Builds the port's TrainSession on CUDA for a bundle at its full width (B=8;
llama_350m, llama_350m_af, mixtral_small and mixtral_small_af run S=2048), runs `--steps` steps three times on one batch (warm-up, timed by
the host clock, traced by torch.profiler) and prints the card's name and
power limit, the untraced step time, the device's busy time per step and
its idle share of the untraced step, the device time of each group of
kernels (the port's flash-attention kernels, matrix products, index work —
the MoE dispatch's sort, scan, scatter and gather and the embedding's —
and the rest) and the twenty kernels that take the most device time.
`--heads N` gives a Llama bundle N query heads and N/2 key/value heads at
the same width (`--model llama_350m --heads 4`: phase 9's llama with heads
of 256, on the wide kernels). Fails when there is
no CUDA device or the trace shows no device time.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Substrings of the kernel names of cuBLAS/CUTLASS matrix products.
GEMM_MARKS = ("gemm", "cutlass", "xmma", "nvjet", "sm90_")
# ... and of PyTorch's indexing, sorting and scan kernels.
INDEX_MARKS = ("index", "gather", "scatter", "sort", "scan")


def group_of(name: str) -> str:
    for k in ("flash_fwd", "flash_dq", "flash_dkv", "flash_fwd_wide",
              "flash_dq_wide", "flash_dkv_wide"):
        if f"{k}_kernel" in name:
            return k
    low = name.lower()
    if any(m in low for m in GEMM_MARKS):
        return "matmul"
    return "index" if any(m in low for m in INDEX_MARKS) else "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--model", default="llama_350m")
    ap.add_argument("--heads", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_step_profile: CUDA is not available", file=sys.stderr)
        return 1
    from vodascheduler_tpu_torch.models import get_model
    from vodascheduler_tpu_torch.runtime import TrainSession

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0])
    bundle = get_model(args.model)
    if args.heads:
        from vodascheduler_tpu_torch.models.registry import llama_bundle
        cfg = dataclasses.replace(bundle.cfg, num_heads=args.heads,
                                  num_kv_heads=args.heads // 2)
        bundle = llama_bundle(f"{args.model}_h{args.heads}", cfg,
                              bundle.seq_len, bundle.optimizer)
    session = TrainSession(bundle, 1, global_batch_size=8)
    print(f"model={session.bundle.name} "
          f"optimizer={session.bundle.optimizer} "
          f"remat_policy={session.bundle.cfg.remat_policy} "
          f"dispatch={getattr(session.bundle.cfg, 'dispatch', None)}")
    batch = session.make_batch()
    n = args.steps

    def run() -> float:
        """Wall microseconds of n steps, ended by a synchronise."""
        t0 = time.perf_counter()
        for _ in range(n):
            session.train_step(batch)
        torch.cuda.synchronize()
        return 1e6 * (time.perf_counter() - t0)

    run()  # warm-up
    wall_us = run()  # the profiler slows the host: the step time is untraced
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_us = run()

    # Device events are kernels, copies and sets, and the user annotations
    # (such as the optimizer step) that span kernels: those are left out.
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.time_range.elapsed_us() > 0
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith(("Optimizer.", "ProfilerStep"))]
    if not kernels:
        print("torch_step_profile: the trace holds no device time",
              file=sys.stderr)
        return 1
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for s, e in spans:  # union of the kernels' intervals
        if e > end:
            busy += e - max(s, end)
            end = e
    by_name, by_group = defaultdict(lambda: [0, 0.0]), defaultdict(float)
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name][0] += 1
        by_name[e.name][1] += us
        by_group[group_of(e.name)] += us
    total = sum(by_group.values())
    print(f"steps={n} step_ms={wall_us / n / 1e3:.3f} "
          f"traced_step_ms={traced_us / n / 1e3:.3f} "
          f"device_busy_ms_per_step={busy / n / 1e3:.3f} "
          f"idle_share={1 - busy / wall_us:.4f}")
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"group {g}: {us / n / 1e3:.3f} ms/step "
              f"({us / total:.4f} of kernel time)")
    for name, (cnt, us) in sorted(by_name.items(),
                                  key=lambda kv: -kv[1][1])[:20]:
        print(f"kernel {us / n / 1e3:8.3f} ms/step {cnt // n:5d}/step "
              f"[{group_of(name)}] {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
