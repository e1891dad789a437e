"""The fp16 dK/dV kernels' arithmetic (``csrc/flash_dkv.cu``,
``voda_flash_dkv_f16``, and ``csrc/flash_dkv_wide.cu``,
``voda_flash_dkv_f16_wide``: dSᵀ rounded to fp16 under a per-key-row power
of two), modelled in plain PyTorch (``tests/torch_f16_dkv_model.py``, at
each kernel's tiling), on the CPU. The kernels themselves run only on the
card, where `test_torch_cuda.py::test_fp16_dkv_matches_its_model` holds
them against the same model.

The model is held three ways, each as the largest error over the largest
value of the reference's tensor:

- against the Pallas `_dkv_kernel` in interpret mode and against
  `flash_dkv_reference`, both in fp32 on the same fp16 values, at D 64 and
  128 (the narrow kernel's tiling) and 256 (the wide kernel's), causal,
  non-causal and behind a q_offset; at D=384 (the wide kernel's 32-row
  query tiles) against `flash_dkv_reference` alone: 2e-3, four ulps of
  fp16 at 1 (the model rounds P and the scaled dS to fp16, 2^-11 each; the
  references round neither);
- on the inputs of `test_torch_flash_simt.py::
  test_fp16_keeps_the_small_gradients_of_an_unscaled_loss` (dO of 1e-6, dS
  near 1e-8), at D=64 and D=256: dK within 5e-3 of `flash_dkv_reference`
  in fp32;
- the same cases with the scale removed (dS rounded to fp16 as it stands,
  the Pallas kernel's rounding) read above 0.1: the check sees the flush.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_f16_dkv_model as model
from vodascheduler_tpu.ops.flash_attention import _bwd as jax_bwd
from vodascheduler_tpu.ops.flash_attention import _fwd as jax_fwd
from vodascheduler_tpu_torch.ops import flash_attention as fa

BLOCK = 32  # multi-block tiling in the Pallas kernels at these sizes
TOL = 2e-3
SMALL_TOL = 5e-3


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _stats(q, k, v, do, causal, q_off):
    """lse and δ in fp32 from the plain versions, on fp32 copies."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    o, lse = fa.flash_attention_reference(qf, kf, vf, causal, q_off)
    _, delta = fa.flash_dq_reference(qf, kf, vf, o, dof, lse, causal, q_off)
    return lse, delta


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,q_off", [
    (1, 2, 256, 256, 64, True, 0),
    (2, 1, 160, 160, 64, False, 0),
    (1, 2, 192, 192, 128, True, 0),
    (1, 1, 96, 96, 128, False, 0),
    # a query slice behind an offset, against longer keys
    (1, 2, 64, 320, 64, True, 256),
    (1, 1, 96, 256, 128, True, 160),
    # the wide kernel's tiling: 64 keys a block, 64 query rows a tile
    (1, 2, 192, 192, 256, True, 0),
    (1, 1, 130, 130, 256, False, 0),
    (1, 1, 96, 256, 256, True, 160),
])
def test_the_model_matches_pallas_and_the_plain_version(B, H, Sq, Sk, D,
                                                        causal, q_off):
    rng = np.random.default_rng(Sq + Sk + D)
    q, do = (rng.standard_normal((B, Sq, H, D)).astype(np.float16)
             for _ in range(2))
    k, v = (rng.standard_normal((B, Sk, H, D)).astype(np.float16)
            for _ in range(2))
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    lse, delta = _stats(qt, kt, vt, dot, causal, q_off)
    dk, dv = model.dkv(qt, kt, vt, dot, lse, delta, causal, q_off,
                       D ** -0.5)

    t = lambda x: jnp.asarray(x.astype(np.float32)).transpose(0, 2, 1, 3)
    off = jnp.asarray(q_off, jnp.int32).reshape(1, 1)
    o_j, lse_j = jax_fwd(t(q), t(k), t(v), off, causal, BLOCK, BLOCK, True)
    _, dk_j, dv_j = jax_bwd(t(q), t(k), t(v), o_j, lse_j, t(do), off, causal,
                            BLOCK, BLOCK, True)
    back = lambda x: np.asarray(x).transpose(0, 2, 1, 3)
    dk_ref, dv_ref = fa.flash_dkv_reference(qt.float(), kt.float(),
                                            vt.float(), dot.float(), lse,
                                            delta, causal, q_off)
    for name, got, ref in (("dk/pallas", dk, back(dk_j)),
                           ("dv/pallas", dv, back(dv_j)),
                           ("dk/plain", dk, dk_ref), ("dv/plain", dv, dv_ref)):
        err = _rel(got, ref)
        print(f"parity f16_dkv_model {name}: rel_err={err:.3g}")
        assert err <= TOL, (name, err)


def test_the_wide_model_at_384_matches_the_plain_version():
    """D=384: the wide kernel's 32-row query tiles (its 128-wide chunks of
    dK each derive the same exponents, so the model takes the whole row)."""
    rng = np.random.default_rng(384)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, 96, 1, 384))
                                    .astype(np.float16)) for _ in range(4))
    assert model.tiling(384) == (64, 32)
    lse, delta = _stats(q, k, v, do, True, 0)
    dk, dv = model.dkv(q, k, v, do, lse, delta, True, 0, 384 ** -0.5)
    dk_ref, dv_ref = fa.flash_dkv_reference(q.float(), k.float(), v.float(),
                                            do.float(), lse, delta, True, 0)
    for name, got, ref in (("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        err = _rel(got, ref)
        print(f"parity f16_dkv_model D=384 {name}/plain: rel_err={err:.3g}")
        assert err <= TOL, (name, err)


def _small_case(scaled: bool, D: int = 64) -> float:
    q, k, v, do = model.small_gradient_inputs(np.random.default_rng(3), D=D)
    lse, delta = _stats(q, k, v, do, True, 0)
    dk, _ = model.dkv(q, k, v, do, lse, delta, True, 0, D ** -0.5,
                      scaled=scaled)
    dk_ref, _ = fa.flash_dkv_reference(q.float(), k.float(), v.float(),
                                       do.float(), lse, delta, True, 0)
    return _rel(dk, dk_ref)


def test_the_scale_keeps_the_small_gradients_of_an_unscaled_loss():
    err = _small_case(scaled=True)
    print(f"parity f16_dkv_model small dO: rel_err={err:.3g}")
    assert err <= SMALL_TOL


def test_without_the_scale_the_small_gradients_flush():
    err = _small_case(scaled=False)
    print(f"parity f16_dkv_model small dO unscaled: rel_err={err:.3g}")
    assert err > 0.1


def test_the_wide_scale_keeps_the_small_gradients_of_an_unscaled_loss():
    """The same case at D=256, on the wide kernel's tiling."""
    err = _small_case(scaled=True, D=256)
    print(f"parity f16_dkv_model D=256 small dO: rel_err={err:.3g}")
    assert err <= SMALL_TOL


def test_without_the_scale_the_wide_small_gradients_flush():
    err = _small_case(scaled=False, D=256)
    print(f"parity f16_dkv_model D=256 small dO unscaled: rel_err={err:.3g}")
    assert err > 0.1
