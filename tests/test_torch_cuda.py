"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips without a CUDA device (decided inside the
fixture, never at import). On a machine with an H100 and nvcc:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py sets up JAX, which that machine need
not have.) The bars are chip_smoke.py's `LIMITS`: O, dq, dk and dv each
held row by row to ||err|| / ||ref|| (`row_err`), lse and δ by max abs
error.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import LIMITS, row_err  # noqa: E402
from vodascheduler_tpu_torch.ops import flash_attention as fa  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("causal,S,D,q_off,Sq", [
    (True, 256, 64, 0, 256),
    (False, 200, 64, 0, 200),
    (True, 192, 128, 0, 192),
    (True, 256, 64, 128, 128),
])
def test_kernels_match_plain_versions(cuda, causal, S, D, q_off, Sq):
    g = torch.Generator(cuda).manual_seed(0)
    q = torch.randn(2, Sq, 3, D, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(2, S, 3, D, generator=g, device=cuda).bfloat16()
            for _ in range(2))
    do = torch.randn(2, Sq, 3, D, generator=g, device=cuda).bfloat16()
    before = dict(fa.launches)
    o, lse = fa.flash_fwd(q, k, v, causal, q_off)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal, q_off)
    dq, delta = fa.flash_dq(q, k, v, o, do, lse, causal, q_off)
    dq_ref, delta_ref = fa.flash_dq_reference(q, k, v, o, do, lse, causal,
                                              q_off)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, causal, q_off)
    dk_ref, dv_ref = fa.flash_dkv_reference(q, k, v, do, lse, delta, causal,
                                            q_off)
    torch.cuda.synchronize()
    assert row_err(o, o_ref) <= LIMITS["o_row"]
    assert (lse - lse_ref).abs().max().item() <= LIMITS["lse"]
    assert (delta - delta_ref).abs().max().item() <= LIMITS["delta"]
    for n, got, ref in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                        ("dv", dv, dv_ref)):
        assert row_err(got, ref) <= LIMITS[f"{n}_row"], n
    assert {n: fa.launches[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}


def test_autograd_goes_through_the_kernels(cuda):
    g = torch.Generator(cuda).manual_seed(1)
    q, k, v = (torch.randn(1, 128, 2, 64, generator=g, device=cuda)
               .bfloat16().requires_grad_() for _ in range(3))
    fa.reset_launches()
    fa.flash_attention(q, k, v).float().sum().backward()
    assert fa.launches == {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
    with pytest.raises(TypeError):
        fa.flash_attention(q.float(), k.float(), v.float())
