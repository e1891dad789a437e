"""Where fp32's dQ stands against the exact function, on one card: the
TF32 dQ (``flash_dq_f32``, ``flash_dq_f32_wide``) and the CUDA-core one it
replaced (``flash_dq_f32_simt``), each against the plain version computed
in fp32 and in fp64, beside the fp32 plain version against the fp64 one.

    python3 scripts/torch_f32_dq_precision.py

The measure is chip_smoke.py's `row_err` (each row of dQ against its own
size, a row whose dP − δ cancels held to 1e-3 of the largest row), at the
fp32 cases of phase 3: the main shape, D=128, D=16 padded, and
`F32_WIDE_CASES`. It shows why chip_smoke.py holds fp32's dQ against the
plain version in fp64 (`F32_DQ_ACC`): where the fp32 plain version's own
rounding of a cancelling row reads near or above the 1e-3 bar, a kernel is
held to that rounding rather than to the function. Prints the card's name
and power limit, then one line a case. Exits non-zero without a card.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_f32_dq_precision: CUDA is not available",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from vodascheduler_tpu_torch.ops import flash_attention as fa

    cs.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
           .splitlines()[0])
    cases = {"main": (8, 16, 2048, 2048, 64, True, 0),
             "d128": (2, 8, 1024, 1024, 128, True, 0),
             "d16": (2, 4, 1024, 1024, 16, True, 0), **cs.F32_WIDE_CASES}
    cuda_cores = {**cs.CUDA_CORE_F32, **cs.CUDA_CORE_F32_WIDE}
    for name, (B, H, Sq, Sk, D, causal, q_off) in cases.items():
        g = torch.Generator("cuda").manual_seed(1)
        q, k, v, do = (torch.randn(B, S, H, D, generator=g, device="cuda")
                       for S in (Sq, Sk, Sk, Sq))
        width, scale = fa.kernel_head_dim(D), D ** -0.5
        qp, kp, vp, dop = (fa.pad_head(t, width) for t in (q, k, v, do))
        o, lse = fa.flash_fwd(qp, kp, vp, causal, q_off, scale=scale)
        o = o[..., :D]
        op = fa.pad_head(o, width)
        plain = {acc: fa.flash_dq_reference(q, k, v, o, do, lse, causal,
                                            q_off, acc=acc)[0]
                 for acc in (torch.float32, torch.float64)}
        line = [f"dq_precision[{name}] B={B} H={H} Sq={Sq} Sk={Sk} D={D} "
                f"causal={causal} q_off={q_off} plain_fp32_vs_fp64="
                f"{cs.row_err(plain[torch.float32], plain[torch.float64]):.3g}"]
        for tag, table in (("tf32", {}), ("cuda_cores", cuda_cores)):
            with cs.routed(fa, table):
                kernel = fa._kernel("flash_dq", width, torch.float32)
                dq = fa.flash_dq(qp, kp, vp, op, dop, lse, causal, q_off,
                                 scale=scale)[0][..., :D]
            line.append(f"{tag}={kernel} vs_fp32="
                        f"{cs.row_err(dq, plain[torch.float32]):.3g} "
                        f"vs_fp64={cs.row_err(dq, plain[torch.float64]):.3g}")
        cs.log(" ".join(line))
        del q, k, v, do, qp, kp, vp, dop, o, op, lse, plain, dq
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
