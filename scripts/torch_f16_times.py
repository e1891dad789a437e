"""Times the kernels that the wrappers take for fp16 tensors at one shape,
beside their plain versions, PyTorch's own attention in fp16 and their
bounds at the card's fp16 peak.

    python3 scripts/torch_f16_times.py [--shape d256|main] [--turns]

First each kernel is held against its plain version under chip_smoke.py's
fp16 bars (`SIMT_LIMITS`), then timed by chip_smoke.py's `time_kernels`
(CUDA events, medians; the backward, K2 then K3, beside the library's).
`--turns` also times fp16's K1, K2 and K3 in turns against the CUDA-core
kernels (`time_turns`: tensor, CUDA, CUDA, tensor cores, twice). The
card's name and power limit come first. Needs CUDA and nvcc.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (B, H, Sq, Sk, D, causal, q_off), as chip_smoke.py's phase 3 names them
SHAPES = {"main": (8, 16, 2048, 2048, 64, True, 0),
          "d256": (8, 4, 2048, 2048, 256, True, 0)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", choices=sorted(SHAPES), default="d256")
    ap.add_argument("--turns", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_f16_times: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke
    from vodascheduler_tpu_torch.ops import flash_attention as fa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0],
          flush=True)
    shape = SHAPES[args.shape]
    errs = chip_smoke.check_kernels(fa, {"main": shape}, torch.float16,
                                    chip_smoke.SIMT_LIMITS[torch.float16])
    chip_smoke.time_kernels(fa, shape, errs, "_f16", torch.float16)
    if args.turns:
        chip_smoke.time_turns(fa, shape)
    return 0


if __name__ == "__main__":
    sys.exit(main())
