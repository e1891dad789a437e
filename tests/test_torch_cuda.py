"""The port's CUDA kernels against their plain versions (the wide kernels
above D=128 too), and the session that runs them, on the card: the
families without `attn_fn` take their steps with no kernel, llama_tiny_text
through K1-K3.

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


def _counts(**launched):
    """Every kernel's count: those named, the others 0."""
    return {**dict.fromkeys(fa.launches, 0), **launched}


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
    # edges of the 128-row tiles of the forward and dK/dV kernels: less
    # than one tile of queries behind an offset, one full and one partial
    # tile, and a partial tile at D=128
    (True, 256, 64, 192, 64),
    (True, 320, 64, 0, 320),
    (False, 320, 64, 0, 320),
    (True, 200, 128, 0, 200),
    # edges of the dQ kernel's 128-row tiles: one row past a tile, a
    # partial query tile behind an offset against a ragged Sk, and less
    # than one tile at D=128
    (True, 129, 64, 0, 129),
    (True, 328, 64, 128, 200),
    (True, 64, 128, 0, 64),
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
    assert {n: fa.launches[n] - before[n] for n in before} == _counts(
        flash_fwd=1, flash_dq=1, flash_dkv=1)


@pytest.mark.parametrize("D", [16, 32, 96])
def test_padded_kernels_match_plain_versions(cuda, D):
    """Heads the kernels are not built for: the operator's padded path
    (zeros along D to 64 or 128, D's own scale, outputs cut back) through
    the three kernels against the plain versions at D itself."""
    g = torch.Generator(cuda).manual_seed(4)
    q, k, v, do = (torch.randn(2, 200, 3, D, generator=g, device=cuda)
                   .bfloat16() for _ in range(4))
    before = dict(fa.launches)
    o, lse = fa.padded_forward(fa.flash_fwd, q, k, v, True, 0)
    dq, dk, dv = fa.padded_backward(fa.flash_dq, fa.flash_dkv, q, k, v, o,
                                    do, lse, True, 0)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, True, 0)
    dq_ref, delta_ref = fa.flash_dq_reference(q, k, v, o, do, lse, True, 0)
    dk_ref, dv_ref = fa.flash_dkv_reference(q, k, v, do, lse, delta_ref,
                                            True, 0)
    torch.cuda.synchronize()
    assert o.shape == q.shape and dk.shape == k.shape
    assert row_err(o, o_ref) <= LIMITS["o_row"]
    assert (lse - lse_ref).abs().max().item() <= LIMITS["lse"]
    for n, got, ref in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                        ("dv", dv, dv_ref)):
        assert row_err(got, ref) <= LIMITS[f"{n}_row"], n
    assert {n: fa.launches[n] - before[n] for n in before} == _counts(
        flash_fwd=1, flash_dq=1, flash_dkv=1)


@pytest.mark.parametrize("model", ["llama_tiny", "mixtral_tiny"])
def test_narrow_heads_train_through_the_kernels(cuda, model, monkeypatch):
    """The tiny bundles (head width 16) take a step on the card with the
    kernels installed by default, and the kernels run: 2 layers."""
    from vodascheduler_tpu_torch.models import get_model
    from vodascheduler_tpu_torch.runtime import TrainSession
    monkeypatch.delenv("VODA_FLASH_ATTENTION", raising=False)
    session = TrainSession(get_model(model), global_batch_size=2,
                           device=cuda)
    batch = session.make_batch()
    fa.reset_launches()
    loss = session.train_step(batch)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert fa.launches["flash_fwd"] >= 2
    assert fa.launches["flash_dq"] == fa.launches["flash_dkv"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16],
                         ids=["fp32", "fp16"])
@pytest.mark.parametrize("causal,S,D,q_off,Sq", [
    (True, 256, 64, 0, 256),
    (False, 200, 64, 0, 200),
    (True, 200, 128, 0, 200),
    (True, 328, 64, 128, 200),
    (True, 192, 256, 0, 192),
    (True, 130, 384, 0, 130),
    (False, 128, 512, 0, 128),
])
def test_fp32_and_fp16_kernels_match_plain_versions(cuda, dtype, causal, S,
                                                    D, q_off, Sq):
    """The kernels of fp32 and fp16 tensors against the plain versions, at
    chip_smoke.py's SIMT_LIMITS: fp32's forward, dQ and dK/dV in TF32 at
    every width (csrc/flash_f32.cu: `_f32` up to D=128, `_f32_wide` above;
    dQ against the plain version in fp64, F32_DQ_ACC, as chip_smoke.py
    holds it); fp16's on the tensor cores up to D=128 (flash_fwd_f16,
    flash_dq_f16, flash_dkv_f16) and from 256 to 512 (`_f16_wide`)."""
    from chip_smoke import F32_DQ_ACC, SIMT_LIMITS
    limits = SIMT_LIMITS[dtype]
    g = torch.Generator(cuda).manual_seed(7)
    q, do = (torch.randn(2, Sq, 3, D, generator=g, device=cuda).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(2, S, 3, D, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    before = dict(fa.launches)
    o, lse = fa.flash_fwd(q, k, v, causal, q_off)
    dq, delta = fa.flash_dq(q, k, v, o, do, lse, causal, q_off)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, causal, q_off)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal, q_off)
    dq_ref, delta_ref = fa.flash_dq_reference(q, k, v, o, do, lse, causal,
                                              q_off)
    if dtype == torch.float32:
        dq_ref = fa.flash_dq_reference(q, k, v, o, do, lse, causal, q_off,
                                       acc=F32_DQ_ACC)[0]
    dk_ref, dv_ref = fa.flash_dkv_reference(q, k, v, do, lse, delta, causal,
                                            q_off)
    torch.cuda.synchronize()
    assert o.dtype == dq.dtype == dk.dtype == dv.dtype == dtype
    assert row_err(o, o_ref) <= limits["o_row"]
    assert (lse - lse_ref).abs().max().item() <= limits["lse"]
    assert (delta - delta_ref).abs().max().item() <= limits["delta"]
    for n, got, ref in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                        ("dv", dv, dv_ref)):
        assert row_err(got, ref) <= limits[f"{n}_row"], n
    assert {n: fa.launches[n] - before[n] for n in before} == _counts(
        **{fa._kernel(n, D, dtype): 1
           for n in ("flash_fwd", "flash_dq", "flash_dkv")})


def _f16_backward(q, k, v, do, causal, q_off):
    """K1, K2, K3 on fp16 tensors: (lse, delta, dq, dk, dv)."""
    o, lse = fa.flash_fwd(q, k, v, causal, q_off)
    dq, delta = fa.flash_dq(q, k, v, o, do, lse, causal, q_off)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, causal, q_off)
    torch.cuda.synchronize()
    return lse, delta, dq, dk, dv


@pytest.mark.parametrize("D", [64, 128, 256])
def test_fp16_dkv_keeps_the_small_gradients_of_an_unscaled_loss(cuda, D):
    """The tensor-core fp16 dK/dV rounds dSᵀ to fp16 under a per-key-row
    power of two (flash_dkv.cu; at D=256 flash_dkv_wide.cu, whose two
    warpgroups share each row's exponent), so an unscaled loss's dS near
    1e-8 (dO of 1e-6) is not flushed: dK within 5e-3 of the largest value
    of the plain version in fp32 on the same values (rounding dS to fp16
    unscaled reads 0.2 on the CPU model, test_torch_f16_dkv_scale.py), at
    the kernel's small dS as at D=64 and 128. Q is scaled by 64
    and K by 1/64 (S unchanged) so that dK = dSᵀ·Q lies among fp16's normal
    numbers."""
    import numpy as np
    import torch_f16_dkv_model as model
    q, k, v, do = (t.to(cuda) for t in model.small_gradient_inputs(
        np.random.default_rng(3), D=D, q_mult=64))
    kernel = fa._kernel("flash_dkv", D, torch.float16)
    assert kernel == ("flash_dkv_f16" if D <= 128 else "flash_dkv_f16_wide")
    before = fa.launches[kernel]
    lse, delta, _, dk, _ = _f16_backward(q, k, v, do, True, 0)
    assert fa.launches[kernel] == before + 1
    dk_ref, _ = fa.flash_dkv_reference(q.float(), k.float(), v.float(),
                                       do.float(), lse, delta, True, 0)
    err = (dk.float() - dk_ref).abs().max() / dk_ref.abs().max()
    assert err.item() <= 5e-3


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,q_off,small", [
    (1, 2, 256, 256, 64, True, 0, False),
    (2, 1, 200, 200, 64, False, 0, False),
    (1, 2, 192, 192, 128, True, 0, False),
    (1, 2, 96, 328, 128, True, 232, False),
    (1, 2, 128, 128, 64, True, 0, True),
    (1, 2, 128, 128, 128, True, 0, True),
    # flash_dkv_f16_wide: 64-key blocks, 64 query rows at D=256, 32 above
    (1, 2, 192, 192, 256, True, 0, False),
    (2, 1, 200, 200, 256, False, 0, False),
    (1, 2, 96, 328, 256, True, 232, False),
    (1, 1, 130, 130, 384, True, 0, False),
    (1, 1, 200, 200, 512, True, 0, False),
    (1, 2, 128, 128, 256, True, 0, True),
])
def test_fp16_dkv_matches_its_model(cuda, B, H, Sq, Sk, D, causal, q_off,
                                    small):
    """flash_dkv_f16 (and flash_dkv_f16_wide above D=128) against the plain
    model of its arithmetic (tests/torch_f16_dkv_model.py at the kernel's
    tiling: the tiles, the per-key-row exponents, P and the scaled dSᵀ
    rounded to fp16), on the kernel's own lse and δ,
    at 1e-3 of the largest value: the kernel rounds dK and dV to fp16
    (2^-12 of a value) and sums in another order. `small` is the unscaled
    loss's dO of 1e-6 (Q scaled by 64, K by 1/64), where dK alone is held:
    dV = Pᵀ·dO lies among fp16's subnormals."""
    import numpy as np
    import torch_f16_dkv_model as model
    rng = np.random.default_rng(Sq + D)
    if small:
        q, k, v, do = model.small_gradient_inputs(rng, B, Sq, H, D, 64)
    else:
        q, do = (torch.from_numpy(rng.standard_normal((B, Sq, H, D))
                                  .astype(np.float16)) for _ in range(2))
        k, v = (torch.from_numpy(rng.standard_normal((B, Sk, H, D))
                                 .astype(np.float16)) for _ in range(2))
    lse, delta, _, dk, dv = _f16_backward(
        *(t.to(cuda) for t in (q, k, v, do)), causal, q_off)
    dk_m, dv_m = model.dkv(q, k, v, do, lse.cpu(), delta.cpu(), causal, q_off,
                           D ** -0.5)
    for name, got, ref in (("dk", dk, dk_m), ("dv", dv, dv_m))[:2 - small]:
        err = (got.cpu().float() - ref).abs().max() / ref.abs().max()
        assert err.item() <= 1e-3, (name, err.item())


@pytest.mark.parametrize("D", [64, 128, 256, 512])
def test_fp16_wgmma_kernels_are_deterministic(cuda, D):
    """No atomics in flash_fwd_f16, flash_dq_f16 or flash_dkv_f16, nor in
    their wide twins: two launches on the same inputs give bitwise-equal
    O, lse, dQ, δ, dK and dV."""
    g = torch.Generator(cuda).manual_seed(9)
    q, k, v, do = (torch.randn(2, 320, 3, D, generator=g, device=cuda).half()
                   for _ in range(4))
    o1, lse1 = fa.flash_fwd(q, k, v, True, 0)
    o2, lse2 = fa.flash_fwd(q, k, v, True, 0)
    dq1, delta = fa.flash_dq(q, k, v, o1, do, lse1, True, 0)
    dq2, delta2 = fa.flash_dq(q, k, v, o1, do, lse1, True, 0)
    dk1, dv1 = fa.flash_dkv(q, k, v, do, lse1, delta, True, 0)
    dk2, dv2 = fa.flash_dkv(q, k, v, do, lse1, delta, True, 0)
    torch.cuda.synchronize()
    for a, b in ((o1, o2), (lse1, lse2), (dq1, dq2), (delta, delta2),
                 (dk1, dk2), (dv1, dv2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("D", [64, 128, 256])
def test_fp16_dq_keeps_the_small_gradients_of_an_unscaled_loss(cuda, D):
    """The tensor-core fp16 dQ rounds dS to fp16 under a per-query-row
    power of two (flash_dq.cu; at D=256 flash_dq_wide.cu, whose two
    warpgroups share each row's exponent), so an unscaled loss's dS near
    1e-8 (dO of 1e-6) is not flushed: dQ within 5e-3 of the largest value
    of the plain version in fp32 on the same values (rounding dS to fp16
    unscaled reads 0.16-0.18 on the CPU model, test_torch_f16_dq_scale.py).
    Q is scaled by 1/64 and K by 64 (S unchanged) so that dQ = dS·K lies
    among fp16's normal numbers."""
    import numpy as np
    import torch_f16_dkv_model as model
    q, k, v, do = (t.to(cuda) for t in model.small_gradient_inputs(
        np.random.default_rng(3), D=D))
    kernel = fa._kernel("flash_dq", D, torch.float16)
    assert kernel == ("flash_dq_f16" if D <= 128 else "flash_dq_f16_wide")
    before = fa.launches[kernel]
    o, lse = fa.flash_fwd(q, k, v, True, 0)
    dq, _ = fa.flash_dq(q, k, v, o, do, lse, True, 0)
    torch.cuda.synchronize()
    assert fa.launches[kernel] == before + 1
    dq_ref, _ = fa.flash_dq_reference(q.float(), k.float(), v.float(), o,
                                      do.float(), lse, True, 0)
    err = (dq.float() - dq_ref).abs().max() / dq_ref.abs().max()
    assert err.item() <= 5e-3


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,q_off,small", [
    (1, 2, 256, 256, 64, True, 0, False),
    (2, 1, 200, 200, 64, False, 0, False),
    (1, 2, 192, 192, 128, True, 0, False),
    (1, 2, 96, 328, 128, True, 232, False),
    (1, 2, 320, 320, 64, True, 0, True),
    (1, 2, 128, 128, 128, True, 0, True),
    # flash_dq_f16_wide: 64 query rows a CTA, 64-key tiles at D=256, 32
    # above
    (1, 2, 192, 192, 256, True, 0, False),
    (2, 1, 200, 200, 256, False, 0, False),
    (1, 2, 96, 328, 256, True, 232, False),
    (1, 1, 130, 130, 384, True, 0, False),
    (1, 1, 200, 200, 512, True, 0, False),
    (1, 2, 128, 128, 256, True, 0, True),
])
def test_fp16_dq_matches_its_model(cuda, B, H, Sq, Sk, D, causal, q_off,
                                   small):
    """flash_dq_f16 (and flash_dq_f16_wide above D=128) against the plain
    model of its arithmetic (tests/torch_f16_dkv_model.py's `dq` at the
    kernel's tiling: the key tiles, the per-query-row exponents, the scaled
    dS rounded to fp16), on the kernel's own lse and δ, at 1e-3 of the
    largest value: the kernel rounds dQ to fp16 (2^-12 of a value) and sums
    in another order. `small` is the unscaled loss's dO of 1e-6 (Q scaled
    by 1/64, K by 64)."""
    import numpy as np
    import torch_f16_dkv_model as model
    rng = np.random.default_rng(Sq + D)
    if small:
        q, k, v, do = model.small_gradient_inputs(rng, B, Sq, H, D)
    else:
        q, do = (torch.from_numpy(rng.standard_normal((B, Sq, H, D))
                                  .astype(np.float16)) for _ in range(2))
        k, v = (torch.from_numpy(rng.standard_normal((B, Sk, H, D))
                                 .astype(np.float16)) for _ in range(2))
    lse, delta, dq, _, _ = _f16_backward(
        *(t.to(cuda) for t in (q, k, v, do)), causal, q_off)
    dq_m = model.dq(q, k, v, do, lse.cpu(), delta.cpu(), causal, q_off,
                    D ** -0.5)
    err = (dq.cpu().float() - dq_m).abs().max() / dq_m.abs().max()
    assert err.item() <= 1e-3


def test_fp16_above_512_runs_the_chunked_kernels(cuda):
    """Above D=512 fp16's forward, dQ and dK/dV take the wide entries,
    whose kernels there stream D (counted as flash_fwd_f16_chunked,
    flash_dq_f16_chunked and flash_dkv_f16_chunked; no `_f16_simt`); all
    match the plain versions at SIMT_LIMITS."""
    from chip_smoke import SIMT_LIMITS
    limits = SIMT_LIMITS[torch.float16]
    g = torch.Generator(cuda).manual_seed(10)
    q, k, v, do = (torch.randn(2, 200, 2, 640, generator=g, device=cuda)
                   .half() for _ in range(4))
    before = dict(fa.launches)
    o, lse = fa.flash_fwd(q, k, v, True, 0)
    dq, delta = fa.flash_dq(q, k, v, o, do, lse, True, 0)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, True, 0)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, True, 0)
    dq_ref, delta_ref = fa.flash_dq_reference(q, k, v, o, do, lse, True, 0)
    dk_ref, dv_ref = fa.flash_dkv_reference(q, k, v, do, lse, delta, True, 0)
    torch.cuda.synchronize()
    assert row_err(o, o_ref) <= limits["o_row"]
    assert (lse - lse_ref).abs().max().item() <= limits["lse"]
    for n, got, ref in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                        ("dv", dv, dv_ref)):
        assert row_err(got, ref) <= limits[f"{n}_row"], n
    assert {n: fa.launches[n] - before[n] for n in before} == _counts(
        flash_fwd_f16_chunked=1, flash_dq_f16_chunked=1,
        flash_dkv_f16_chunked=1)


def _f32_inputs(B, H, Sq, Sk, D, seed, device="cuda"):
    """fp32 q, k, v, dO from numpy, so the CPU model takes the same."""
    import numpy as np
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((B, Sq, H, D))
                              .astype(np.float32)).to(device)
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, Sk, H, D))
                             .astype(np.float32)).to(device)
            for _ in range(2))
    return q, k, v, do


# The fp32 kernels against their model: the largest error over the largest
# value of the model's O, dK and dV. Both compute each product in three TF32
# passes; they differ by the order and the rounding of the fp32 sums (the
# tensor cores' accumulation), which against the plain versions read up to
# 3.2e-5 of the largest value at the main shape (phase 3, H100). Dropping
# the lo terms reads near 1e-3 (tests/test_torch_f32x3.py).
F32_MODEL_TOL = 5e-5


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,q_off", [
    (1, 2, 256, 256, 64, True, 0),
    (2, 1, 200, 200, 64, False, 0),      # ragged, non-causal
    (1, 2, 1000, 1000, 64, True, 0),     # neither a multiple of 64 nor 128
    (1, 2, 130, 500, 64, True, 370),     # a query slice behind an offset
    (1, 1, 200, 333, 64, False, 0),      # B·H = 1, Sq ≠ Sk, non-causal
    (1, 2, 192, 192, 128, True, 0),
    (2, 1, 200, 333, 128, False, 0),
    (1, 1, 65, 700, 128, True, 635),
])
def test_fp32_tensor_core_kernels_match_their_model(cuda, B, H, Sq, Sk, D,
                                                    causal, q_off):
    """flash_fwd_f32 and flash_dkv_f32 (three TF32 passes, flash_f32.cu)
    at the edges a ring or a tile can get wrong, against the plain versions
    at SIMT_LIMITS[float32] and against the plain model of their arithmetic
    (tests/torch_f32x3_model.py, at each kernel's tiling) at
    F32_MODEL_TOL. dK/dV runs on the kernel forward's lse and the plain
    version's δ, as does its model, and is launched twice, bitwise
    equal."""
    import torch_f32x3_model as model
    from chip_smoke import SIMT_LIMITS
    limits = SIMT_LIMITS[torch.float32]
    q, k, v, do = _f32_inputs(B, H, Sq, Sk, D, Sq + Sk)
    before = dict(fa.launches)
    o, lse = fa.flash_fwd(q, k, v, causal, q_off)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal, q_off)
    _, delta = fa.flash_dq_reference(q, k, v, o, do, lse, causal, q_off)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, causal, q_off)
    dk2, dv2 = fa.flash_dkv(q, k, v, do, lse, delta, causal, q_off)
    dk_ref, dv_ref = fa.flash_dkv_reference(q, k, v, do, lse, delta, causal,
                                            q_off)
    torch.cuda.synchronize()
    assert {n: fa.launches[n] - before[n] for n in before} == _counts(
        flash_fwd_f32=1, flash_dkv_f32=2)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert row_err(o, o_ref) <= limits["o_row"]
    assert (lse - lse_ref).abs().max().item() <= limits["lse"]
    assert row_err(dk, dk_ref) <= limits["dk_row"]
    assert row_err(dv, dv_ref) <= limits["dv_row"]
    cpu = [t.cpu() for t in (q, k, v, do, lse, delta)]
    o_m, lse_m = model.fwd(*cpu[:3], causal, q_off, D ** -0.5)
    dk_m, dv_m = model.dkv(*cpu, causal, q_off, D ** -0.5)
    errs = {n: ((got.cpu() - ref).abs().max() / ref.abs().max()).item()
            for n, got, ref in (("o", o, o_m), ("dk", dk, dk_m),
                                ("dv", dv, dv_m))}
    errs["lse"] = (lse.cpu() - lse_m).abs().max().item()
    print("f32 model", B, H, Sq, Sk, D, causal, q_off, errs)
    assert all(e <= F32_MODEL_TOL for e in errs.values()), errs


@pytest.mark.parametrize("D", [16, 96])
def test_fp32_padded_heads_take_the_tf32_kernels(cuda, D):
    """Heads of 16 and 96 in fp32: the operator's padded path (to 64 and
    128) through the TF32 forward, dQ and dK/dV, against the plain versions
    at D itself (dQ's in fp64), at SIMT_LIMITS[float32]."""
    from chip_smoke import F32_DQ_ACC, SIMT_LIMITS
    limits = SIMT_LIMITS[torch.float32]
    q, k, v, do = _f32_inputs(2, 3, 200, 200, D, D)
    before = dict(fa.launches)
    o, lse = fa.padded_forward(fa.flash_fwd, q, k, v, True, 0)
    dq, dk, dv = fa.padded_backward(fa.flash_dq, fa.flash_dkv, q, k, v, o,
                                    do, lse, True, 0)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, True, 0)
    _, delta_ref = fa.flash_dq_reference(q, k, v, o, do, lse, True, 0)
    dq_ref = fa.flash_dq_reference(q, k, v, o, do, lse, True, 0,
                                   acc=F32_DQ_ACC)[0]
    dk_ref, dv_ref = fa.flash_dkv_reference(q, k, v, do, lse, delta_ref,
                                            True, 0)
    torch.cuda.synchronize()
    assert row_err(o, o_ref) <= limits["o_row"]
    assert (lse - lse_ref).abs().max().item() <= limits["lse"]
    for n, got, ref in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                        ("dv", dv, dv_ref)):
        assert row_err(got, ref) <= limits[f"{n}_row"], n
    assert {n: fa.launches[n] - before[n] for n in before} == _counts(
        flash_fwd_f32=1, flash_dq_f32=1, flash_dkv_f32=1)


@pytest.mark.parametrize("D", [64, 128])
def test_fp32_tensor_core_kernels_are_deterministic(cuda, D):
    """No atomics in flash_fwd_f32, flash_dq_f32 or flash_dkv_f32: two
    launches on the same inputs give bitwise-equal O, lse, dQ, δ, dK and
    dV."""
    q, k, v, do = _f32_inputs(2, 3, 320, 320, D, 9)
    o1, lse1 = fa.flash_fwd(q, k, v, True, 0)
    o2, lse2 = fa.flash_fwd(q, k, v, True, 0)
    dq1, delta = fa.flash_dq(q, k, v, o1, do, lse1, True, 0)
    dq2, delta2 = fa.flash_dq(q, k, v, o1, do, lse1, True, 0)
    dk1, dv1 = fa.flash_dkv(q, k, v, do, lse1, delta, True, 0)
    dk2, dv2 = fa.flash_dkv(q, k, v, do, lse1, delta, True, 0)
    torch.cuda.synchronize()
    for a, b in ((o1, o2), (lse1, lse2), (dq1, dq2), (delta, delta2),
                 (dk1, dk2), (dv1, dv2)):
        assert torch.equal(a, b)


def test_autograd_goes_through_the_fp32_kernels(cuda):
    """fp32 through the operator: K1, K2 and K3 in TF32, and the gradients
    of the plain path on the CPU, at SIMT_LIMITS. The loss weighs O by a
    fixed random tensor, as the wide test's does: under O.square().sum()
    dO is 2·O, the first query's dP − δ cancels terms of |2·o₀·v₀|, and its
    row of dQ, 0 in exact arithmetic, reads only the two paths' rounding of
    them (1.5e-3 of the bar's measure on the card with the TF32 K2)."""
    from chip_smoke import SIMT_LIMITS
    limits = SIMT_LIMITS[torch.float32]
    *host, w = _f32_inputs(1, 2, 200, 200, 64, 11, "cpu")
    host = [t.requires_grad_() for t in host[:3]]
    card = [t.detach().to(cuda).requires_grad_() for t in host]
    fa.reset_launches()
    (fa.flash_attention(*card) * w.to(cuda)).sum().backward()
    assert fa.launches == _counts(flash_fwd_f32=1, flash_dq_f32=1,
                                  flash_dkv_f32=1)
    (fa.flash_attention(*host) * w).sum().backward()
    for n, got, ref in zip(("dq", "dk", "dv"), card, host):
        assert row_err(got.grad.cpu(), ref.grad) <= limits[f"{n}_row"], n


def test_fp32_above_128_runs_the_cuda_core_forward_and_dkv(cuda):
    """fp32's CUDA-core forward, dQ and dK/dV (`_f32_simt`), which the
    wrappers no longer route to (the TF32 kernels replaced them) but
    chip_smoke.py times in turns against their replacements, still run
    above 128 when routed to (`chip_smoke.CUDA_CORE_F32_WIDE`) and match
    the plain versions at SIMT_LIMITS."""
    from chip_smoke import CUDA_CORE_F32_WIDE, SIMT_LIMITS, routed
    limits = SIMT_LIMITS[torch.float32]
    q, k, v, do = _f32_inputs(2, 2, 200, 200, 256, 12)
    before = dict(fa.launches)
    with routed(fa, CUDA_CORE_F32_WIDE):
        o, lse = fa.flash_fwd(q, k, v, True, 0)
        dq, delta = fa.flash_dq(q, k, v, o, do, lse, True, 0)
        dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, True, 0)
    o_ref, _ = fa.flash_attention_reference(q, k, v, True, 0)
    dq_ref, _ = fa.flash_dq_reference(q, k, v, o, do, lse, True, 0)
    dk_ref, dv_ref = fa.flash_dkv_reference(q, k, v, do, lse, delta, True, 0)
    torch.cuda.synchronize()
    assert row_err(o, o_ref) <= limits["o_row"]
    for n, got, ref in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                        ("dv", dv, dv_ref)):
        assert row_err(got, ref) <= limits[f"{n}_row"], n
    assert {n: fa.launches[n] - before[n] for n in before} == _counts(
        flash_fwd_f32_simt=1, flash_dq_f32_simt=1, flash_dkv_f32_simt=1)


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,q_off", [
    (1, 2, 256, 256, 256, True, 0),
    (2, 1, 200, 200, 256, False, 0),     # ragged, non-causal
    (1, 2, 1000, 1000, 256, True, 0),    # neither a multiple of 64 nor 128
    (1, 2, 130, 500, 256, True, 370),    # a query slice behind an offset
    (1, 1, 200, 333, 384, False, 0),     # B·H = 1, Sq ≠ Sk, non-causal
    (2, 1, 65, 65, 384, True, 0),        # Sq = 65
    (1, 2, 192, 192, 512, True, 0),
    (1, 1, 130, 200, 640, True, 70),
])
def test_fp32_wide_kernels_match_their_model(cuda, B, H, Sq, Sk, D, causal,
                                             q_off):
    """flash_fwd_f32_wide and flash_dkv_f32_wide (three TF32 passes above
    D=128, streaming D, flash_f32.cu) at the edges a ring, a tile or a
    chunk of D can get wrong, against the plain versions at
    SIMT_LIMITS[float32] and against the plain model of their arithmetic
    (tests/torch_f32x3_model.py at their tiling: S, Sᵀ and dPᵀ over
    32-column chunks of D, Sᵀ's and dPᵀ's each summed apart, the output in
    128-column chunks) at
    F32_MODEL_TOL. dK/dV runs on the kernel forward's lse and the plain
    version's δ, as does its model, and is launched twice, bitwise
    equal."""
    import torch_f32x3_model as model
    from chip_smoke import SIMT_LIMITS
    limits = SIMT_LIMITS[torch.float32]
    q, k, v, do = _f32_inputs(B, H, Sq, Sk, D, Sq + Sk + D)
    before = dict(fa.launches)
    o, lse = fa.flash_fwd(q, k, v, causal, q_off)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal, q_off)
    _, delta = fa.flash_dq_reference(q, k, v, o, do, lse, causal, q_off)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, causal, q_off)
    dk2, dv2 = fa.flash_dkv(q, k, v, do, lse, delta, causal, q_off)
    dk_ref, dv_ref = fa.flash_dkv_reference(q, k, v, do, lse, delta, causal,
                                            q_off)
    torch.cuda.synchronize()
    assert {n: fa.launches[n] - before[n] for n in before} == _counts(
        flash_fwd_f32_wide=1, flash_dkv_f32_wide=2)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    errs = {"o_row": row_err(o, o_ref),
            "lse": (lse - lse_ref).abs().max().item(),
            "dk_row": row_err(dk, dk_ref), "dv_row": row_err(dv, dv_ref)}
    print("f32 wide plain", B, H, Sq, Sk, D, causal, q_off, errs)
    assert all(errs[n] <= limits[n] for n in errs), errs
    cpu = [t.cpu() for t in (q, k, v, do, lse, delta)]
    o_m, lse_m = model.fwd(*cpu[:3], causal, q_off, D ** -0.5)
    dk_m, dv_m = model.dkv(*cpu, causal, q_off, D ** -0.5)
    errs = {n: ((got.cpu() - ref).abs().max() / ref.abs().max()).item()
            for n, got, ref in (("o", o, o_m), ("dk", dk, dk_m),
                                ("dv", dv, dv_m))}
    errs["lse"] = (lse.cpu() - lse_m).abs().max().item()
    print("f32 wide model", B, H, Sq, Sk, D, causal, q_off, errs)
    assert all(e <= F32_MODEL_TOL for e in errs.values()), errs


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,q_off", [
    (1, 2, 256, 256, 64, True, 0),
    (2, 1, 200, 200, 64, False, 0),      # ragged, non-causal
    (1, 2, 1000, 1000, 64, True, 0),     # neither a multiple of 64 nor 128
    (1, 2, 130, 500, 64, True, 370),     # a query slice behind an offset
    (1, 1, 200, 333, 64, False, 0),      # B·H = 1, Sq ≠ Sk, non-causal
    (1, 2, 192, 192, 128, True, 0),
    (2, 1, 200, 333, 128, False, 0),
    (1, 1, 65, 700, 128, True, 635),
    (1, 2, 256, 256, 256, True, 0),
    (2, 1, 200, 200, 256, False, 0),
    (1, 2, 1000, 1000, 256, True, 0),
    (1, 2, 130, 500, 256, True, 370),
    (1, 1, 200, 333, 384, False, 0),
    (2, 1, 65, 65, 384, True, 0),        # Sq = 65
    (1, 2, 192, 192, 512, True, 0),
    (1, 1, 130, 200, 640, True, 70),
])
def test_fp32_dq_matches_its_model(cuda, B, H, Sq, Sk, D, causal, q_off):
    """fp32's TF32 dQ (flash_dq_f32_kernel: `flash_dq_f32` up to D=128,
    `flash_dq_f32_wide` above) at the edges a ring, a tile or a chunk of D
    can get wrong, on the kernel forward's O and lse: against the plain
    version in fp64 at SIMT_LIMITS[float32] (dq_row; δ against the fp32
    plain version's), against the plain model of its arithmetic
    (tests/torch_f32x3_model.py `dq`: S and dP over 32-column chunks, each
    summed apart, dQ in min(D, 128)-column chunks) at F32_MODEL_TOL, and
    launched twice, bitwise equal."""
    import torch_f32x3_model as model
    from chip_smoke import F32_DQ_ACC, SIMT_LIMITS
    limits = SIMT_LIMITS[torch.float32]
    q, k, v, do = _f32_inputs(B, H, Sq, Sk, D, Sq + Sk + D + 1)
    o, lse = fa.flash_fwd(q, k, v, causal, q_off)
    before = dict(fa.launches)
    dq, delta = fa.flash_dq(q, k, v, o, do, lse, causal, q_off)
    dq2, delta2 = fa.flash_dq(q, k, v, o, do, lse, causal, q_off)
    _, delta_ref = fa.flash_dq_reference(q, k, v, o, do, lse, causal, q_off)
    dq_ref = fa.flash_dq_reference(q, k, v, o, do, lse, causal, q_off,
                                   acc=F32_DQ_ACC)[0]
    torch.cuda.synchronize()
    kernel = "flash_dq_f32" if D <= 128 else "flash_dq_f32_wide"
    assert {n: fa.launches[n] - before[n] for n in before} == _counts(
        **{kernel: 2})
    assert torch.equal(dq, dq2) and torch.equal(delta, delta2)
    errs = {"dq_row": row_err(dq, dq_ref),
            "delta": (delta - delta_ref).abs().max().item()}
    print("f32 dq plain", B, H, Sq, Sk, D, causal, q_off, errs)
    assert all(errs[n] <= limits[n] for n in errs), errs
    cpu = [t.cpu() for t in (q, k, v, o, do, lse)]
    dq_m, delta_m = model.dq(*cpu, causal, q_off, D ** -0.5)
    errs = {"dq": ((dq.cpu() - dq_m).abs().max()
                   / dq_m.abs().max()).item(),
            "delta": (delta.cpu() - delta_m).abs().max().item()}
    print("f32 dq model", B, H, Sq, Sk, D, causal, q_off, errs)
    assert all(e <= F32_MODEL_TOL for e in errs.values()), errs


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,q_off", [
    (1, 2, 256, 256, 64, True, 0),
    (2, 1, 200, 200, 64, False, 0),      # ragged, non-causal
    (1, 2, 1000, 1000, 64, True, 0),     # neither a multiple of 64 nor 128
    (1, 2, 130, 500, 64, True, 370),     # a query slice behind an offset
    (1, 1, 200, 333, 64, False, 0),      # B·H = 1, Sq ≠ Sk, non-causal
    (2, 2, 65, 65, 64, True, 0),         # Sq = 65: a tile of one row
    (2, 2, 1, 64, 64, False, 0),         # one query: dSᵀ sums to 0
    (1, 2, 192, 192, 128, True, 0),
    (2, 1, 200, 333, 128, False, 0),
    (1, 1, 65, 700, 128, True, 635),
    (1, 2, 256, 256, 256, True, 0),
    (2, 1, 200, 200, 256, False, 0),
    (1, 2, 1000, 1000, 256, True, 0),
    (1, 2, 130, 500, 256, True, 370),
    (1, 1, 200, 333, 384, False, 0),
    (2, 1, 65, 65, 384, True, 0),        # Sq = 65
    (1, 2, 192, 192, 512, True, 0),
    (1, 1, 130, 200, 640, True, 70),
])
def test_fp32_dkv_matches_its_model(cuda, B, H, Sq, Sk, D, causal, q_off):
    """fp32's TF32 dK/dV (flash_dkv_f32_kernel: `flash_dkv_f32` up to
    D=128, `flash_dkv_f32_wide` above) at the edges a ring, a tile or a
    chunk of D can get wrong, on the kernel forward's lse and the plain δ:
    against the plain version in fp64 at SIMT_LIMITS[float32] (dk_row,
    dv_row), against the plain model of its arithmetic
    (tests/torch_f32x3_model.py `dkv`: Sᵀ and dPᵀ over 32-column chunks,
    each summed apart, dK and dV in min(D, 128)-column chunks) at
    F32_MODEL_TOL, and launched twice, bitwise equal."""
    import torch_f32x3_model as model
    from chip_smoke import SIMT_LIMITS
    limits = SIMT_LIMITS[torch.float32]
    q, k, v, do = _f32_inputs(B, H, Sq, Sk, D, Sq + Sk + D + 2)
    o, lse = fa.flash_fwd(q, k, v, causal, q_off)
    _, delta = fa.flash_dq_reference(q, k, v, o, do, lse, causal, q_off)
    before = dict(fa.launches)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, causal, q_off)
    dk2, dv2 = fa.flash_dkv(q, k, v, do, lse, delta, causal, q_off)
    dk_ref, dv_ref = fa.flash_dkv_reference(q, k, v, do, lse, delta, causal,
                                            q_off, acc=torch.float64)
    torch.cuda.synchronize()
    kernel = "flash_dkv_f32" if D <= 128 else "flash_dkv_f32_wide"
    assert {n: fa.launches[n] - before[n] for n in before} == _counts(
        **{kernel: 2})
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    errs = {"dk_row": row_err(dk, dk_ref), "dv_row": row_err(dv, dv_ref)}
    print("f32 dkv plain", B, H, Sq, Sk, D, causal, q_off, errs)
    assert all(errs[n] <= limits[n] for n in errs), errs
    cpu = [t.cpu() for t in (q, k, v, do, lse, delta)]
    dk_m, dv_m = model.dkv(*cpu, causal, q_off, D ** -0.5)
    errs = {n: ((got.cpu() - ref).abs().max() / ref.abs().max()).item()
            for n, got, ref in (("dk", dk, dk_m), ("dv", dv, dv_m))}
    print("f32 dkv model", B, H, Sq, Sk, D, causal, q_off, errs)
    assert all(e <= F32_MODEL_TOL for e in errs.values()), errs


@pytest.mark.parametrize("D", [256, 640])
def test_fp32_wide_kernels_are_deterministic(cuda, D):
    """No atomics in flash_fwd_f32_wide, flash_dq_f32_wide or
    flash_dkv_f32_wide: two launches on the same inputs give bitwise-equal
    O, lse, dQ, δ, dK and dV."""
    q, k, v, do = _f32_inputs(2, 2, 320, 320, D, 10)
    o1, lse1 = fa.flash_fwd(q, k, v, True, 0)
    o2, lse2 = fa.flash_fwd(q, k, v, True, 0)
    dq1, delta = fa.flash_dq(q, k, v, o1, do, lse1, True, 0)
    dq2, delta2 = fa.flash_dq(q, k, v, o1, do, lse1, True, 0)
    dk1, dv1 = fa.flash_dkv(q, k, v, do, lse1, delta, True, 0)
    dk2, dv2 = fa.flash_dkv(q, k, v, do, lse1, delta, True, 0)
    torch.cuda.synchronize()
    for a, b in ((o1, o2), (lse1, lse2), (dq1, dq2), (delta, delta2),
                 (dk1, dk2), (dv1, dv2)):
        assert torch.equal(a, b)


def test_autograd_goes_through_the_fp32_wide_kernels(cuda):
    """fp32 in heads of 256 through the operator: K1, K2 and K3 on the
    wide TF32 kernels, and the gradients of the plain path
    on the CPU, at SIMT_LIMITS. The loss weighs O by a fixed random tensor:
    under O.square().sum() dO is 2·O, and the first query's dQ (one key,
    P = 1) is 0 by exact cancellation in every implementation, so its row
    would read only the two paths' rounding."""
    from chip_smoke import SIMT_LIMITS
    limits = SIMT_LIMITS[torch.float32]
    *host, w = _f32_inputs(1, 2, 200, 200, 256, 13, "cpu")
    host = [t.requires_grad_() for t in host[:3]]
    card = [t.detach().to(cuda).requires_grad_() for t in host]
    fa.reset_launches()
    (fa.flash_attention(*card) * w.to(cuda)).sum().backward()
    assert fa.launches == _counts(flash_fwd_f32_wide=1, flash_dq_f32_wide=1,
                                  flash_dkv_f32_wide=1)
    (fa.flash_attention(*host) * w).sum().backward()
    for n, got, ref in zip(("dq", "dk", "dv"), card, host):
        assert row_err(got.grad.cpu(), ref.grad) <= limits[f"{n}_row"], n


def test_fp32_llama_in_heads_of_256_trains_through_the_wide_kernels(
        cuda, monkeypatch):
    """A Llama that computes in fp32 in heads of 256 (dim 512, 2 heads)
    takes the wide TF32 forward, dQ and dK/dV on the card, no other kernel,
    and its loss is the CPU's on the same weights and batch within 1e-4
    relative."""
    import dataclasses

    from vodascheduler_tpu_torch.models import llama
    from vodascheduler_tpu_torch.models.registry import llama_bundle
    from vodascheduler_tpu_torch.runtime import TrainSession
    bundle = llama_bundle("llama_tiny_float32_d256", dataclasses.replace(
        llama.LLAMA_TINY, dtype="float32", dim=512, num_heads=2,
        num_kv_heads=1, mlp_hidden=256), 64)
    monkeypatch.delenv("VODA_FLASH_ATTENTION", raising=False)
    host = TrainSession(bundle, global_batch_size=2, device="cpu")
    card = TrainSession(bundle, global_batch_size=2, device=cuda)
    card.module.load_state_dict(host.module.state_dict())
    batch = host.make_batch()
    fa.reset_launches()
    got = card.train_step({k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    L = bundle.cfg.num_layers
    assert fa.launches["flash_fwd_f32_wide"] >= L
    assert fa.launches == _counts(
        flash_fwd_f32_wide=fa.launches["flash_fwd_f32_wide"],
        flash_dq_f32_wide=L, flash_dkv_f32_wide=L)
    want = host.train_step(batch)
    assert torch.isfinite(got)
    assert abs(float(got) - float(want)) <= 1e-4 * abs(float(want))


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_fp32_and_fp16_llamas_train_through_their_kernels(cuda, dtype,
                                                          monkeypatch):
    """A Llama that computes in fp32 or fp16 takes the kernels of its
    dtype on the card (the JAX kernels compute in q's dtype): its step runs
    through them, launches no other kernel, and its loss is the CPU's on
    the same weights and batch (1e-4 relative in fp32; fp16 rounds the
    activations: 1e-2)."""
    import dataclasses

    from vodascheduler_tpu_torch.models import llama
    from vodascheduler_tpu_torch.models.registry import llama_bundle
    from vodascheduler_tpu_torch.runtime import TrainSession
    bundle = llama_bundle(f"llama_tiny_{dtype}", dataclasses.replace(
        llama.LLAMA_TINY, dtype=dtype), 64)
    monkeypatch.delenv("VODA_FLASH_ATTENTION", raising=False)
    host = TrainSession(bundle, global_batch_size=2, device="cpu")
    card = TrainSession(bundle, global_batch_size=2, device=cuda)
    card.module.load_state_dict(host.module.state_dict())
    batch = host.make_batch()
    fa.reset_launches()
    got = card.train_step({k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    sfx = fa.SIMT_SUFFIX[getattr(torch, dtype)]
    L = bundle.cfg.num_layers
    assert fa.launches[f"flash_fwd_{sfx}"] >= L
    assert fa.launches == _counts(**{
        f"flash_fwd_{sfx}": fa.launches[f"flash_fwd_{sfx}"],
        f"flash_dq_{sfx}": L, f"flash_dkv_{sfx}": L})
    want = host.train_step(batch)
    assert torch.isfinite(got)
    bar = 1e-4 if dtype == "float32" else 1e-2
    assert abs(float(got) - float(want)) <= bar * abs(float(want))


def test_local_backend_holds_nothing_on_the_card(cuda, tmp_path):
    """The GPU backend counts the cards without creating a CUDA context:
    in a fresh process, building it leaves torch.cuda uninitialised."""
    import subprocess
    code = ("import torch\n"
            "from vodascheduler_tpu_torch.cluster.local import LocalBackend\n"
            f"b = LocalBackend({str(tmp_path)!r})\n"
            "print(b.chips, torch.cuda.is_initialized())\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=repo))
    assert out.returncode == 0, out.stderr
    chips, initialised = out.stdout.split()
    assert int(chips) == torch.cuda.device_count() and initialised == "False"


def test_autograd_goes_through_the_kernels(cuda):
    g = torch.Generator(cuda).manual_seed(1)
    q, k, v = (torch.randn(1, 128, 2, 64, generator=g, device=cuda)
               .bfloat16().requires_grad_() for _ in range(3))
    fa.reset_launches()
    fa.flash_attention(q, k, v).float().sum().backward()
    assert fa.launches == _counts(flash_fwd=1, flash_dq=1, flash_dkv=1)
    with pytest.raises(TypeError):
        fa.flash_attention(q.double(), k.double(), v.double())


def test_dq_is_deterministic(cuda):
    """No atomics in K2: two launches on the same inputs give bitwise-equal
    dq and δ."""
    g = torch.Generator(cuda).manual_seed(2)
    q, k, v, do = (torch.randn(2, 320, 3, 64, generator=g, device=cuda)
                   .bfloat16() for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v, True, 0)
    dq1, delta1 = fa.flash_dq(q, k, v, o, do, lse, True, 0)
    dq2, delta2 = fa.flash_dq(q, k, v, o, do, lse, True, 0)
    torch.cuda.synchronize()
    assert torch.equal(dq1, dq2)
    assert torch.equal(delta1, delta2)


# A Llama small enough for a test whose heads are the kernels' width (64).
SMALL = dict(vocab_size=256, dim=128, num_layers=2, num_heads=2,
             num_kv_heads=1, mlp_hidden=256, max_seq_len=128,
             rope_base=10000.0, scan_layers=True, remat_layers=True)


def _small_bundle(policy, optimizer):
    from vodascheduler_tpu_torch.models import llama
    from vodascheduler_tpu_torch.models.registry import llama_bundle
    cfg = llama.LlamaConfig(**SMALL, remat_policy=policy)
    return llama_bundle(f"small_{policy}", cfg, 128, optimizer)


@pytest.mark.parametrize("policy,fwd", [(None, 4), ("dots", 4),
                                        ("attn_out", 2), ("dots_attn", 2)])
def test_remat_policy_sets_the_forward_launches(cuda, policy, fwd):
    """A policy that keeps the attention output spares the recompute its
    K1 launch: 2 layers, one step."""
    from vodascheduler_tpu_torch.runtime import TrainSession
    session = TrainSession(_small_bundle(policy, "adafactor"),
                           global_batch_size=2, device=cuda)
    batch = session.make_batch()
    fa.reset_launches()
    loss = session.train_step(batch)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert fa.launches == _counts(flash_fwd=fwd, flash_dq=2, flash_dkv=2)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_resume_on_the_card_continues_the_run(cuda, tmp_path, optimizer):
    """4 steps, a checkpoint, a fresh session resumed from it and 4 more
    steps give the losses and weights of 8 straight steps."""
    from vodascheduler_tpu_torch.runtime import TrainSession
    bundle = _small_bundle("dots_attn", optimizer)
    straight = TrainSession(bundle, global_batch_size=2, device=cuda)
    want = [straight.train_step(straight.make_batch()).item()
            for _ in range(8)]
    first = TrainSession(bundle, global_batch_size=2, device=cuda)
    got = [first.train_step(first.make_batch()).item() for _ in range(4)]
    first.save(str(tmp_path))
    second = TrainSession.resume(bundle, 1, str(tmp_path),
                                 global_batch_size=2, device=cuda)
    assert second.step == 4
    got += [second.train_step(second.make_batch()).item() for _ in range(4)]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    for (name, p), q in zip(second.module.named_parameters(),
                            straight.module.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=0, msg=name)


# A Mixtral small enough for a test, at the kernels' head width (64).
SMALL_MOE = dict(vocab_size=256, dim=128, num_layers=2, num_heads=2,
                 num_kv_heads=1, mlp_hidden=256, num_experts=4, top_k=2,
                 rope_base=10000.0, dispatch="gather", scan_layers=True,
                 remat_layers=True)


@pytest.mark.parametrize("policy,fwd", [(None, 4), ("dots", 4),
                                        ("attn_out", 2), ("dots_attn", 2)])
def test_mixtral_remat_policy_sets_the_forward_launches(cuda, policy, fwd):
    """The policies apply to Mixtral's layers as to Llama's: 2 layers, one
    step, K1 once more per layer unless the attention output is kept."""
    from vodascheduler_tpu_torch.models import mixtral
    from vodascheduler_tpu_torch.models.registry import mixtral_bundle
    from vodascheduler_tpu_torch.runtime import TrainSession
    cfg = mixtral.MixtralConfig(**SMALL_MOE, remat_policy=policy)
    session = TrainSession(mixtral_bundle(f"moe_{policy}", cfg, 128,
                                          "adafactor"),
                           global_batch_size=2, device=cuda)
    batch = session.make_batch()
    fa.reset_launches()
    loss = session.train_step(batch)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert fa.launches == _counts(flash_fwd=fwd, flash_dq=2, flash_dkv=2)


def test_dispatches_agree_on_the_card(cuda):
    """At capacity factor 100 nothing drops, and the three dispatches
    compute one function: gather equals routed at 1e-2, dense at 5e-2 (the
    reference's bars for the pairs, tests/test_models.py)."""
    import dataclasses

    from vodascheduler_tpu_torch.models import mixtral
    cfg = dataclasses.replace(mixtral.MixtralConfig(**SMALL_MOE),
                              capacity_factor=100.0)
    g = torch.Generator(cuda).manual_seed(3)
    x = torch.randn(2, 256, cfg.dim, generator=g, device=cuda).bfloat16()
    torch.manual_seed(0)
    blocks = {d: mixtral.MoEBlock(dataclasses.replace(cfg, dispatch=d),
                                  device=cuda) for d in mixtral.DISPATCHES}
    state = blocks["gather"].state_dict()
    with torch.no_grad():
        out = {}
        for d, block in blocks.items():
            block.load_state_dict(state)
            out[d] = block(x).float()
    assert torch.isfinite(out["gather"]).all()
    assert (out["gather"] - out["routed"]).abs().max().item() < 1e-2
    assert (out["dense"] - out["routed"]).abs().max().item() < 5e-2


# ---- head widths above 128: the wide kernels ---------------------------------


@pytest.mark.parametrize("causal,S,D,q_off,Sq", [
    (True, 200, 256, 0, 200),
    (False, 70, 256, 0, 130),
    (True, 300, 384, 230, 70),
    (True, 128, 512, 0, 128),
    (True, 65, 256, 0, 65),    # one row past a 64-row tile
    # above 512: the forward, dQ and dK/dV that stream D
    # (flash_{fwd,dq,dkv}_chunked_kernel); every chunk width of the output
    # (128 at 640 and 896, 256 at 768 and 1024)
    (True, 200, 640, 0, 200),
    (True, 200, 768, 0, 200),
    (False, 150, 896, 0, 100),
    (True, 300, 1024, 170, 130),
])
def test_wide_kernels_match_plain_versions(cuda, causal, S, D, q_off, Sq):
    """D > 128 (a multiple of 128) runs the wide kernels, each against its
    plain version by chip_smoke.py's bars, and counts under its own name
    (above 512 as flash_fwd_chunked, flash_dq_chunked and
    flash_dkv_chunked)."""
    g = torch.Generator(cuda).manual_seed(5)
    q, do = (torch.randn(2, Sq, 3, D, generator=g, device=cuda).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(2, S, 3, D, generator=g, device=cuda).bfloat16()
            for _ in range(2))
    before = dict(fa.launches)
    o, lse = fa.flash_fwd(q, k, v, causal, q_off)
    dq, delta = fa.flash_dq(q, k, v, o, do, lse, causal, q_off)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, causal, q_off)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal, q_off)
    dq_ref, delta_ref = fa.flash_dq_reference(q, k, v, o, do, lse, causal,
                                              q_off)
    dk_ref, dv_ref = fa.flash_dkv_reference(q, k, v, do, lse, delta, causal,
                                            q_off)
    torch.cuda.synchronize()
    assert row_err(o, o_ref) <= LIMITS["o_row"]
    assert (lse - lse_ref).abs().max().item() <= LIMITS["lse"]
    assert (delta - delta_ref).abs().max().item() <= LIMITS["delta"]
    for n, got, ref in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                        ("dv", dv, dv_ref)):
        assert row_err(got, ref) <= LIMITS[f"{n}_row"], n
    assert {n: fa.launches[n] - before[n] for n in before} == _counts(
        **{fa.counted(f"flash_{n}_wide", D): 1 for n in ("fwd", "dq", "dkv")})


def test_autograd_goes_through_the_wide_kernels(cuda):
    g = torch.Generator(cuda).manual_seed(6)
    q, k, v = (torch.randn(1, 192, 2, 256, generator=g, device=cuda)
               .bfloat16().requires_grad_() for _ in range(3))
    fa.reset_launches()
    fa.flash_attention(q, k, v).float().sum().backward()
    assert fa.launches == _counts(flash_fwd_wide=1, flash_dq_wide=1,
                                  flash_dkv_wide=1)
    with pytest.raises(NotImplementedError, match="multiple of 128"):
        fa.flash_attention(q[..., :200], k[..., :200], v[..., :200])


def _wide_inputs(B, H, Sq, Sk, D, seed):
    g = torch.Generator("cuda").manual_seed(seed)
    q, do = (torch.randn(B, Sq, H, D, generator=g, device="cuda").bfloat16()
             for _ in range(2))
    k, v = (torch.randn(B, Sk, H, D, generator=g, device="cuda").bfloat16()
            for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,q_off", [
    (2, 2, 65, 65, 256, True, 0),        # one row past a 64-row tile
    (2, 1, 200, 200, 384, True, 0),
    (2, 1, 1000, 1000, 256, True, 0),    # neither a multiple of 64 nor 128
    (1, 1, 1000, 1000, 512, True, 0),    # B·H = 1
    (1, 2, 130, 500, 256, True, 370),    # a query slice behind an offset
    (1, 2, 200, 700, 512, True, 500),
    (1, 1, 65, 1000, 384, True, 935),
    (2, 1, 200, 333, 384, False, 0),     # non-causal, Sq ≠ Sk
    (1, 1, 65, 200, 256, False, 0),
    (1, 2, 1000, 1000, 512, False, 0),
])
def test_redesigned_wide_kernels_match_plain_versions(cuda, B, H, Sq, Sk, D,
                                                      causal, q_off):
    """The TMA paths of the wide forward, dQ and dK/dV at the edges a ring
    can get wrong: ragged S, Sq ≠ Sk behind q_offset, non-causal, every
    wide width, a single (b, h). dQ and dK/dV run on the kernel forward's
    O and lse, and dK/dV on the plain version's δ, so each kernel is held
    alone, by chip_smoke.py's bars."""
    q, k, v, do = _wide_inputs(B, H, Sq, Sk, D, 7)
    before = dict(fa.launches)
    o, lse = fa.flash_fwd(q, k, v, causal, q_off)
    o_ref, lse_ref = fa.flash_attention_reference(q, k, v, causal, q_off)
    dq, delta = fa.flash_dq(q, k, v, o, do, lse, causal, q_off)
    dq_ref, delta_ref = fa.flash_dq_reference(q, k, v, o, do, lse, causal,
                                              q_off)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta_ref, causal, q_off)
    dk_ref, dv_ref = fa.flash_dkv_reference(q, k, v, do, lse, delta_ref,
                                            causal, q_off)
    torch.cuda.synchronize()
    assert row_err(o, o_ref) <= LIMITS["o_row"]
    assert (lse - lse_ref).abs().max().item() <= LIMITS["lse"]
    assert row_err(dq, dq_ref) <= LIMITS["dq_row"]
    assert (delta - delta_ref).abs().max().item() <= LIMITS["delta"]
    assert row_err(dk, dk_ref) <= LIMITS["dk_row"]
    assert row_err(dv, dv_ref) <= LIMITS["dv_row"]
    assert {n: fa.launches[n] - before[n] for n in before} == _counts(
        flash_fwd_wide=1, flash_dq_wide=1, flash_dkv_wide=1)


@pytest.mark.parametrize("D", [256, 384, 512, 640])
def test_redesigned_wide_kernels_are_deterministic(cuda, D):
    """No atomics in the wide forward, dQ or dK/dV: two launches on the
    same inputs give bitwise-equal O, lse, dQ, δ, dK and dV."""
    q, k, v, do = _wide_inputs(1, 2, 320, 320, D, 8)
    o1, lse1 = fa.flash_fwd(q, k, v, True, 0)
    o2, lse2 = fa.flash_fwd(q, k, v, True, 0)
    dq1, delta = fa.flash_dq(q, k, v, o1, do, lse1, True, 0)
    dq2, delta2 = fa.flash_dq(q, k, v, o1, do, lse1, True, 0)
    dk1, dv1 = fa.flash_dkv(q, k, v, do, lse1, delta, True, 0)
    dk2, dv2 = fa.flash_dkv(q, k, v, do, lse1, delta, True, 0)
    torch.cuda.synchronize()
    for a, b in ((o1, o2), (lse1, lse2), (dq1, dq2), (delta, delta2),
                 (dk1, dk2), (dv1, dv2)):
        assert torch.equal(a, b)


# ---- the forward above D=512 (flash_fwd_chunked_kernel) -----------------------


# The chunked forward against its model (tests/torch_fwd_chunked_model.py):
# the largest error over the largest value of the model's O, two ulps of
# the dtype at 1, and lse to 2e-5. Both round P and O to the dtype; they
# differ by the order of the fp32 sums and exp2's approximation, which can
# move a rounding by one ulp (lse against the plain version read 1.4e-6 to
# 3.8e-6 on an H100).
CHUNKED_MODEL_TOL = {torch.bfloat16: 2 ** -6, torch.float16: 2 ** -9}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,q_off", [
    (1, 2, 200, 200, 640, True, 0),      # two query tiles, ragged keys
    (2, 1, 130, 300, 768, False, 0),     # non-causal, Sq ≠ Sk
    (1, 2, 65, 400, 896, True, 335),     # a query slice behind an offset
    (1, 1, 256, 256, 1024, True, 0),     # B·H = 1
])
def test_chunked_forward_matches_its_model(cuda, dtype, B, H, Sq, Sk, D,
                                           causal, q_off):
    """flash_fwd_chunked_kernel, through the wide forward's entry, against
    the plain model of its arithmetic at its tiling."""
    import numpy as np
    import torch_fwd_chunked_model as model
    rng = np.random.default_rng(Sq + D)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, D))
                                .astype(np.float32)).to(dtype)
               for S in (Sq, Sk, Sk))
    before = dict(fa.launches)
    o, lse = fa.flash_fwd(q.to(cuda), k.to(cuda), v.to(cuda), causal, q_off)
    torch.cuda.synchronize()
    kernel = "flash_fwd_chunked" if dtype == torch.bfloat16 \
        else "flash_fwd_f16_chunked"
    assert {n: fa.launches[n] - before[n] for n in before} == _counts(
        **{kernel: 1})
    o_m, lse_m = model.fwd(q, k, v, causal, q_off, D ** -0.5)
    err = ((o.cpu().float() - o_m.float()).abs().max()
           / o_m.float().abs().max()).item()
    assert err <= CHUNKED_MODEL_TOL[dtype]
    assert (lse.cpu() - lse_m).abs().max().item() <= 2e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
def test_autograd_goes_through_the_chunked_forward(cuda, dtype):
    """attention_op at D=640: the forward that streams D, then the
    backward's dQ and dK/dV, which stream D too, against the same operator
    on CPU copies (the plain versions, O and the gradients rounded to the
    dtype as the kernels round them), row by row at the dtype's bars."""
    from chip_smoke import SIMT_LIMITS
    limits = LIMITS if dtype == torch.bfloat16 else SIMT_LIMITS[dtype]
    g = torch.Generator(cuda).manual_seed(11)
    q, k, v = (torch.randn(1, 192, 2, 640, generator=g, device=cuda)
               .to(dtype).requires_grad_() for _ in range(3))
    w = torch.randn(1, 192, 2, 640, generator=g, device=cuda)
    fa.reset_launches()
    o = fa.flash_attention(q, k, v)
    (o.float() * w).sum().backward()
    suffix = {torch.bfloat16: ("_chunked",) * 3,
              torch.float16: ("_f16_chunked",) * 3}[dtype]
    assert fa.launches == _counts(**{
        f"flash_{n}{x}": 1 for n, x in zip(("fwd", "dq", "dkv"), suffix)})
    ref = [t.detach().cpu().requires_grad_() for t in (q, k, v)]
    o_ref = fa.flash_attention(*ref)
    (o_ref.float() * w.cpu()).sum().backward()
    assert row_err(o.detach().cpu(), o_ref.detach()) <= limits["o_row"]
    for n, got, want in zip(("dq", "dk", "dv"), (q, k, v), ref):
        assert row_err(got.grad.cpu(), want.grad) <= limits[f"{n}_row"], n


# ---- dQ and dK/dV above D=512 (flash_{dq,dkv}_chunked_kernel) ----------------


# The chunked dQ and dK/dV against their model, by dtype: fp16 rounds dQ,
# dK and dV to 2^-12 of a value and bf16 to 2^-9, and both sum in another
# order than the model (a sum that moves a rounding of P or dS by one ulp
# moves the output far less).
BWD_CHUNKED_MODEL_TOL = {torch.bfloat16: 2 ** -7, torch.float16: 1e-3}


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16],
                         ids=["fp16", "bf16"])
@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,q_off,small", [
    (1, 2, 200, 200, 640, True, 0, False),    # ragged query and key tiles
    (2, 1, 130, 300, 640, False, 0, False),   # non-causal, Sq ≠ Sk
    (1, 2, 65, 400, 640, True, 335, False),   # a query slice behind q_off
    (1, 1, 256, 256, 1024, True, 0, False),   # CW=256, B·H = 1
    (1, 2, 128, 128, 640, True, 0, True),     # an unscaled loss's dO
])
def test_chunked_backward_matches_its_model(cuda, dtype, B, H, Sq, Sk, D,
                                            causal, q_off, small):
    """flash_dq_chunked_kernel and flash_dkv_chunked_kernel, through the
    wide entries of `dtype`, against the plain model of their arithmetic
    (tests/torch_bwd_chunked_model.py: S, dP, Sᵀ and dPᵀ over 64-column
    chunks; in fp16 the per-row exponents and the scaled dS rounded to
    fp16, in bf16 P and dS rounded as they stand), on the kernels' own lse
    and δ, at BWD_CHUNKED_MODEL_TOL of the largest value, each launched
    twice and bitwise equal. `small` is the dO of 1e-6: in fp16 with Q
    scaled by 1/64 for dQ (K by 64) and by 64 for dK, dV (among fp16's
    subnormals there) not held; in bf16, which needs no scale, Q and K as
    drawn and dQ, dK and dV all held."""
    import numpy as np
    import torch_bwd_chunked_model as model
    import torch_f16_dkv_model as f16_model
    f16 = dtype == torch.float16
    counts = {f"flash_{n}{'_f16' if f16 else ''}_chunked": 2
              for n in ("dq", "dkv")}
    for q_mult in ((1 / 64, 64) if small and f16 else (1,)):
        rng = np.random.default_rng(Sq + D)
        if small and f16:
            q, k, v, do = f16_model.small_gradient_inputs(rng, B, Sq, H, D,
                                                          q_mult)
        elif small:
            q, k, v, do = model.bf16_small_gradient_inputs(rng, B, Sq, H, D)
        else:
            q, do = (torch.from_numpy(rng.standard_normal((B, Sq, H, D))
                                      .astype(np.float32)).to(dtype)
                     for _ in range(2))
            k, v = (torch.from_numpy(rng.standard_normal((B, Sk, H, D))
                                     .astype(np.float32)).to(dtype)
                    for _ in range(2))
        qc, kc, vc, doc = (t.to(cuda) for t in (q, k, v, do))
        o, lse = fa.flash_fwd(qc, kc, vc, causal, q_off)
        before = dict(fa.launches)
        got = [fa.flash_dq(qc, kc, vc, o, doc, lse, causal, q_off)
               for _ in range(2)]
        got = [(*dq_delta, *fa.flash_dkv(qc, kc, vc, doc, lse, dq_delta[1],
                                         causal, q_off))
               for dq_delta in got]
        torch.cuda.synchronize()
        assert {n: fa.launches[n] - before[n] for n in before} == _counts(
            **counts)
        for a, b in zip(*got):
            assert torch.equal(a, b)
        dq, delta, dk, dv = got[0]
        dq_m = model.dq(q, k, v, do, lse.cpu(), delta.cpu(), causal, q_off,
                        D ** -0.5)
        dk_m, dv_m = model.dkv(q, k, v, do, lse.cpu(), delta.cpu(), causal,
                               q_off, D ** -0.5)
        held = {1 / 64: (("dq", dq, dq_m),), 64: (("dk", dk, dk_m),),
                1: (("dq", dq, dq_m), ("dk", dk, dk_m), ("dv", dv, dv_m))}
        for name, a, m in held[q_mult]:
            err = ((a.cpu().float() - m).abs().max() / m.abs().max()).item()
            print(f"chunked_backward_model {str(dtype)[6:]} D={D} "
                  f"small={small} {name}: {err:.3g}")
            assert err <= BWD_CHUNKED_MODEL_TOL[dtype], (name, err)


# ---- the families on the card ------------------------------------------------


@pytest.mark.parametrize("model", ["bert_tiny", "resnet_tiny", "nmt_tiny",
                                   "vit_tiny", "digits_mlp"])
def test_families_take_a_step_on_the_card(cuda, model, monkeypatch):
    """A family without `attn_fn` trains on the card with its plain
    attention and launches no kernel; a BatchNorm model's statistics stay
    where they were."""
    from vodascheduler_tpu_torch.models import get_model
    from vodascheduler_tpu_torch.runtime import TrainSession
    monkeypatch.delenv("VODA_FLASH_ATTENTION", raising=False)
    session = TrainSession(get_model(model), global_batch_size=2,
                           device=cuda)
    buffers = {n: b.clone() for n, b in session.module.named_buffers()}
    fa.reset_launches()
    losses = [session.train_step(session.make_batch()) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.isfinite(x) for x in losses)
    assert fa.launches == _counts()
    for n, b in session.module.named_buffers():
        assert torch.equal(b, buffers[n]), n


def test_llama_tiny_text_step_launches_the_kernels(cuda, monkeypatch):
    from vodascheduler_tpu_torch.models import get_model
    from vodascheduler_tpu_torch.runtime import TrainSession
    monkeypatch.delenv("VODA_FLASH_ATTENTION", raising=False)
    session = TrainSession(get_model("llama_tiny_text"), global_batch_size=2,
                           device=cuda)
    batch = session.make_batch()
    assert batch["inputs"].device.type == "cuda"
    fa.reset_launches()
    loss = session.train_step(batch)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    # LLAMA_TINY: 2 layers, no remat, so K1 once a layer
    assert fa.launches == _counts(flash_fwd=2, flash_dq=2, flash_dkv=2)


@pytest.mark.parametrize("model", ["llama_tiny", "mixtral_tiny"])
def test_one_rank_nccl_session_launches_the_kernels(cuda, monkeypatch,
                                                    tmp_path, model):
    """A session of one NCCL rank (a DeviceMesh of one, every parameter a
    DTensor) launches K1-K3 on its local tensors and takes the plain
    session's steps (phase 12's bar: 1e-3 relative); mixtral_tiny's
    through the expert-parallel form of its dispatch (the routing's
    all-gather and the experts' sums on NCCL groups of one)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from vodascheduler_tpu_torch.models import get_model
    from vodascheduler_tpu_torch.runtime import TrainSession
    monkeypatch.delenv("VODA_FLASH_ATTENTION", raising=False)
    plain = TrainSession(get_model(model), global_batch_size=2,
                         device=cuda)
    want = [float(plain.train_step(plain.make_batch())) for _ in range(3)]
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        session = TrainSession(get_model(model), global_batch_size=2,
                               device=cuda)
        assert session.plan.num_chips == 1
        assert all(isinstance(p, DTensor)
                   for p in session.module.parameters())
        fa.reset_launches()
        got = [float(session.train_step(session.make_batch()))
               for _ in range(3)]
        torch.cuda.synchronize()
        # both: 2 layers, no remat, so K1 once a layer
        assert fa.launches == _counts(flash_fwd=6, flash_dq=6, flash_dkv=6)
        if model == "mixtral_tiny":
            layout = session.module.layers[0].moe.layout
            assert len(layout.data_groups) == 2
            assert len(layout.expert_groups) == 2
    finally:
        dist.destroy_process_group()
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-3 * abs(w), (got, want)
