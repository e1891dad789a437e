"""The forward above D=512 (``csrc/flash_fwd_wide.cu``,
``flash_fwd_chunked_kernel``: S = Q·Kᵀ summed over D's 128-column chunks,
key tiles of 64 or 128, O in chunks of 256 or 128 columns), modelled in
plain PyTorch (``tests/torch_fwd_chunked_model.py``) at the kernel's
tiling, on the CPU. The kernel itself runs only on the card, where
`test_torch_cuda.py::test_chunked_forward_matches_its_model` holds it
against the same model.

The model is held against the Pallas `_fwd_kernel` in interpret mode and
against `flash_attention_reference`, both in fp32 on the same bf16 or fp16
values, at D=640 (CW=128, 128-key tiles) and 768 (CW=256, 64-key tiles),
causal over two query blocks with a ragged end, non-causal with Sq ≠ Sk,
and a query slice behind a q_offset. O as the largest error over the
largest value of the reference: bf16 at 8e-3, one ulp of bf16 at 1 (the
model rounds P to bf16 before P·V and O to bf16, the references neither);
fp16 at 2e-3, two ulps of fp16 at 1 (the same roundings, three bits
finer). lse, fp32 in all three, at 1e-5 absolute (the sums' order). The
model with one chunk of D left out of S, or without O's correction, must
break the O bar in both dtypes.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_fwd_chunked_model as model
from vodascheduler_tpu.ops.flash_attention import _fwd as jax_fwd
from vodascheduler_tpu_torch.ops import _build
from vodascheduler_tpu_torch.ops import flash_attention as fa

BLOCK = 32  # multi-block tiling in the Pallas kernel at these sizes
TOL = {torch.bfloat16: 8e-3, torch.float16: 2e-3}
LSE_TOL = 1e-5
DTYPES = pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                                 ids=["bf16", "fp16"])


def _rel(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _inputs(dtype, B, H, Sq, Sk, D, seed):
    """q, k, v [B,S,H,D] of `dtype` from numpy."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, S, H, D))
                             .astype(np.float32)).to(dtype)
            for S in (Sq, Sk, Sk)]


def _pallas(q, k, v, causal, q_off):
    """(O, lse [B,H,Sq]) of the Pallas forward in fp32, interpret mode."""
    t = lambda x: jnp.asarray(x.float().numpy()).transpose(0, 2, 1, 3)
    off = jnp.asarray(q_off, jnp.int32).reshape(1, 1)
    o, lse = jax_fwd(t(q), t(k), t(v), off, causal, BLOCK, BLOCK, True)
    B, Sq, H, _ = q.shape
    return (np.asarray(o).transpose(0, 2, 1, 3),
            np.asarray(lse[:, :, :, 0, :].reshape(B, H, Sq)))


CASES = pytest.mark.parametrize("B,H,Sq,Sk,D,causal,q_off", [
    # two query blocks of 128, the second ragged, against ragged key tiles
    (1, 2, 160, 160, 640, True, 0),
    (1, 1, 160, 160, 768, True, 0),
    # non-causal, Sq ≠ Sk
    (1, 1, 96, 160, 640, False, 0),
    (1, 1, 96, 160, 768, False, 0),
    # a query slice behind an offset, against longer keys
    (1, 2, 64, 192, 640, True, 128),
    (1, 1, 64, 192, 768, True, 128),
])


@DTYPES
@CASES
def test_the_model_matches_pallas_and_the_plain_version(dtype, B, H, Sq, Sk,
                                                        D, causal, q_off):
    q, k, v = _inputs(dtype, B, H, Sq, Sk, D, Sq + Sk + D)
    o, lse = model.fwd(q, k, v, causal, q_off, D ** -0.5)
    assert o.dtype == dtype and lse.dtype == torch.float32
    o_j, lse_j = _pallas(q, k, v, causal, q_off)
    o_ref, lse_ref = fa.flash_attention_reference(q.float(), k.float(),
                                                  v.float(), causal, q_off)
    for name, o_want, lse_want in (("pallas", o_j, lse_j),
                                   ("plain", o_ref, lse_ref)):
        err = _rel(o.float(), o_want)
        lse_err = float(np.abs(lse.numpy() - np.asarray(lse_want)).max())
        print(f"parity fwd_chunked_model {str(dtype)[6:]} D={D} o/{name}: "
              f"rel_err={err:.3g} lse_abs={lse_err:.3g}")
        assert err <= TOL[dtype], (name, err)
        assert lse_err <= LSE_TOL, (name, lse_err)


@DTYPES
@pytest.mark.parametrize("fault", ["drop_chunk", "no_correction"])
def test_the_planted_faults_break_the_bar(dtype, fault):
    """What chip_smoke.py's planted faults do to the kernel, done to the
    model: the O bar must see each."""
    B, H, Sq, Sk, D = 1, 2, 320, 320, 640
    q, k, v = _inputs(dtype, B, H, Sq, Sk, D, 640)
    kw = {"drop_chunk": 1} if fault == "drop_chunk" else {"correct": False}
    o, _ = model.fwd(q, k, v, True, 0, D ** -0.5, **kw)
    o_ref, _ = fa.flash_attention_reference(q.float(), k.float(), v.float(),
                                            True, 0)
    err = _rel(o.float(), o_ref)
    print(f"parity fwd_chunked_model {str(dtype)[6:]} {fault}: "
          f"rel_err={err:.3g}")
    assert err > 10 * TOL[dtype]


@pytest.mark.parametrize("D,want", [(640, (128, 128)), (768, (256, 64)),
                                    (896, (128, 128)), (1024, (256, 64))])
def test_the_model_takes_the_kernels_tiling(D, want):
    """CW and BN as `FwdChunked` sets them, read from the source's text (no
    nvcc here), and the wrappers' route there: bf16 and fp16 above 512
    both take the kernel, through the wide forward's entries."""
    assert model.tiling(D) == want
    text = (_build.CSRC / "flash_fwd_wide.cu").read_text()
    assert "static constexpr int BN = CW == 256 ? 64 : 128;" in text
    assert re.search(r"if \(D % 256 == 0\)\s+return launch_fwd_chunked<256",
                     text)
    assert fa._kernel("flash_fwd", D, torch.bfloat16) == "flash_fwd_wide"
    assert fa._kernel("flash_fwd", D, torch.float16) == "flash_fwd_f16_wide"
