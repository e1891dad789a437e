"""The fp16 dQ kernels' arithmetic (``csrc/flash_dq.cu``,
``voda_flash_dq_f16``, and ``csrc/flash_dq_wide.cu``,
``voda_flash_dq_f16_wide``: dS rounded to fp16 under a per-query-row power
of two), modelled in plain PyTorch (``tests/torch_f16_dkv_model.py``'s
`dq`, at each kernel's tiling), on the CPU. The kernels themselves run only
on the card, where `test_torch_cuda.py::test_fp16_dq_matches_its_model`
holds them against the same model.

The model is held three ways, each as the largest error over the largest
value of the reference's tensor:

- against the Pallas `_dq_kernel` in interpret mode and against
  `flash_dq_reference`, both in fp32 on the same fp16 values, at D 64 and
  128 (the narrow kernel's tiling: 64-key tiles) and 256 (the wide
  kernel's, 64-key tiles), causal, non-causal and behind a q_offset; at
  D=384 (the wide kernel's 32-key tiles) against `flash_dq_reference`
  alone: 2e-3, four ulps of fp16 at 1 (the model rounds the scaled dS to
  fp16, 2^-11; the references do not);
- on an unscaled loss's inputs (dO of 1e-6, dS near 1e-8; Q scaled by
  1/64 and K by 64, S unchanged, so that dQ = dS·K lies among fp16's
  normal numbers), at D=64 and D=256: dQ within 5e-3 of
  `flash_dq_reference` in fp32;
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
    return o, lse, delta


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,q_off", [
    (1, 2, 256, 256, 64, True, 0),
    (2, 1, 160, 160, 64, False, 0),
    (1, 2, 192, 192, 128, True, 0),
    (1, 1, 96, 96, 128, False, 0),
    # a query slice behind an offset, against longer keys
    (1, 2, 64, 320, 64, True, 256),
    (1, 1, 96, 256, 128, True, 160),
    # the wide kernel's tiling: 64 query rows a block, 64 keys a tile
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
    o, lse, delta = _stats(qt, kt, vt, dot, causal, q_off)
    dq = model.dq(qt, kt, vt, dot, lse, delta, causal, q_off, D ** -0.5)

    t = lambda x: jnp.asarray(x.astype(np.float32)).transpose(0, 2, 1, 3)
    off = jnp.asarray(q_off, jnp.int32).reshape(1, 1)
    o_j, lse_j = jax_fwd(t(q), t(k), t(v), off, causal, BLOCK, BLOCK, True)
    dq_j, _, _ = jax_bwd(t(q), t(k), t(v), o_j, lse_j, t(do), off, causal,
                         BLOCK, BLOCK, True)
    dq_ref, _ = fa.flash_dq_reference(qt.float(), kt.float(), vt.float(), o,
                                      dot.float(), lse, causal, q_off)
    back = np.asarray(dq_j).transpose(0, 2, 1, 3)
    for name, ref in (("pallas", back), ("plain", dq_ref)):
        err = _rel(dq, ref)
        print(f"parity f16_dq_model dq/{name}: rel_err={err:.3g}")
        assert err <= TOL, (name, err)


def test_the_wide_model_at_384_matches_the_plain_version():
    """D=384: the wide kernel's 32-key tiles."""
    rng = np.random.default_rng(384)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, 96, 1, 384))
                                    .astype(np.float16)) for _ in range(4))
    assert model.dq_tiling(384) == (64, 32)
    o, lse, delta = _stats(q, k, v, do, True, 0)
    dq = model.dq(q, k, v, do, lse, delta, True, 0, 384 ** -0.5)
    dq_ref, _ = fa.flash_dq_reference(q.float(), k.float(), v.float(), o,
                                      do.float(), lse, True, 0)
    err = _rel(dq, dq_ref)
    print(f"parity f16_dq_model D=384 dq/plain: rel_err={err:.3g}")
    assert err <= TOL


def _small_case(scaled: bool, D: int = 64) -> float:
    q, k, v, do = model.small_gradient_inputs(np.random.default_rng(3), D=D)
    o, lse, delta = _stats(q, k, v, do, True, 0)
    dq = model.dq(q, k, v, do, lse, delta, True, 0, D ** -0.5, scaled=scaled)
    dq_ref, _ = fa.flash_dq_reference(q.float(), k.float(), v.float(), o,
                                      do.float(), lse, True, 0)
    return _rel(dq, dq_ref)


def test_the_scale_keeps_the_small_gradients_of_an_unscaled_loss():
    err = _small_case(scaled=True)
    print(f"parity f16_dq_model small dO: rel_err={err:.3g}")
    assert err <= SMALL_TOL


def test_without_the_scale_the_small_gradients_flush():
    err = _small_case(scaled=False)
    print(f"parity f16_dq_model small dO unscaled: rel_err={err:.3g}")
    assert err > 0.1


def test_the_wide_scale_keeps_the_small_gradients_of_an_unscaled_loss():
    """The same case at D=256, on the wide kernel's tiling."""
    err = _small_case(scaled=True, D=256)
    print(f"parity f16_dq_model D=256 small dO: rel_err={err:.3g}")
    assert err <= SMALL_TOL


def test_without_the_scale_the_wide_small_gradients_flush():
    err = _small_case(scaled=False, D=256)
    print(f"parity f16_dq_model D=256 small dO unscaled: rel_err={err:.3g}")
    assert err > 0.1
