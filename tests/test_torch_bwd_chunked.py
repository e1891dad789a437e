"""dQ and dK/dV above D=512 (``csrc/flash_dq_wide.cu``,
``flash_dq_chunked_kernel``, and ``csrc/flash_dkv_wide.cu``,
``flash_dkv_chunked_kernel``: S, dP, Sᵀ and dPᵀ summed over D's 64-column
chunks, dS and dSᵀ rounded to fp16 under a per-row power of two, or to
bf16 as they stand, the output in chunks of 256 or 128 columns), modelled
in plain PyTorch (``tests/torch_bwd_chunked_model.py``) at the kernels'
tiling, on the CPU. The kernels themselves run only on the card, where
`test_torch_cuda.py::test_chunked_backward_matches_its_model` holds them
against the same model.

The fp16 model is held three ways, each as the largest error over the
largest value of the reference's tensor:

- against the Pallas `_bwd` kernels in interpret mode and against
  `flash_dq_reference` and `flash_dkv_reference`, both in fp32 on the same
  fp16 values, at D=640 (128 columns a CTA) and 768 (256), causal over
  two query blocks with a ragged end, non-causal with Sq ≠ Sk, and a query
  slice behind a q_offset: 2e-3, four ulps of fp16 at 1 (the model rounds
  P and the scaled dS to fp16, 2^-11 each; the references round neither);
- on an unscaled loss's inputs (dO of 1e-6, dS near 1e-8), at D=640: dQ
  and dK within 5e-3 of the plain versions in fp32, and above 0.1 with the
  scale removed (dS rounded to fp16 as it stands, the Pallas kernels'
  rounding): the check sees the flush;
- the model's two planted faults, one chunk of D left out of S (Sᵀ) and a
  fallen exponent never rescaled, each break the bar by at least 10×.

The bf16 model (P and dS rounded to bf16, no exponent) is held the same
ways on bf16 values at BF16_TOL, 8e-3: bf16 keeps 8 bits, so its rounding
of P and dS is 8 times fp16's (2^-9 of a value, against the references'
none). Over the cases the largest errors read 3.07e-3 (dQ at D=768) and
2.90e-3 (dV at D=640), against the Pallas kernels and the plain versions
alike; the bar leaves 2.6 times that, and stays below bf16's `LIMITS` rows
in chip_smoke.py (1e-2 and 1.5e-2). On an unscaled loss's inputs it needs
no exponent (2.05e-3 with dO of 1e-6), and one chunk of D left out of S
(Sᵀ) breaks BF16_TOL tenfold (0.329 and 0.237).
"""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_bwd_chunked_model as model
import torch_f16_dkv_model as f16_model
from vodascheduler_tpu.ops.flash_attention import _bwd as jax_bwd
from vodascheduler_tpu.ops.flash_attention import _fwd as jax_fwd
from vodascheduler_tpu_torch.ops import _build
from vodascheduler_tpu_torch.ops import flash_attention as fa

BLOCK = 32  # multi-block tiling in the Pallas kernels at these sizes
TOL = 2e-3
SMALL_TOL = 5e-3
BF16_TOL = 8e-3

CASES = [
    # three query blocks of 64 (two key tiles of 128 in dQ), the last
    # ragged; three key blocks of 64 in dK/dV
    (1, 2, 160, 160, 640, True, 0),
    (1, 1, 160, 160, 768, True, 0),
    # non-causal, Sq ≠ Sk
    (1, 1, 96, 160, 640, False, 0),
    (1, 1, 96, 160, 768, False, 0),
    # a query slice behind an offset, against longer keys
    (1, 2, 64, 192, 640, True, 128),
    (1, 1, 64, 192, 768, True, 128),
]


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _stats(q, k, v, do, causal, q_off):
    """O, lse and δ in fp32 from the plain versions, on fp32 copies."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    o, lse = fa.flash_attention_reference(qf, kf, vf, causal, q_off)
    _, delta = fa.flash_dq_reference(qf, kf, vf, o, dof, lse, causal, q_off)
    return o, lse, delta


def _values(rng, shape, dtype):
    """Standard normal values of `shape` rounded to `dtype` (fp16 or
    bf16)."""
    x = rng.standard_normal(shape)
    if dtype == torch.float16:
        return torch.from_numpy(x.astype(np.float16))
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


@functools.lru_cache(maxsize=None)
def _case(B, H, Sq, Sk, D, causal, q_off, dtype=torch.float16):
    """q, k, v, dO of a case in `dtype`, its statistics, and the gradients
    of the Pallas kernels (interpret mode, on the same values) and of the
    plain versions, fp32."""
    rng = np.random.default_rng(Sq + Sk + D)
    qt, dot = (_values(rng, (B, Sq, H, D), dtype) for _ in range(2))
    kt, vt = (_values(rng, (B, Sk, H, D), dtype) for _ in range(2))
    o, lse, delta = _stats(qt, kt, vt, dot, causal, q_off)

    t = lambda x: jnp.asarray(x.float().numpy()).transpose(0, 2, 1, 3)
    off = jnp.asarray(q_off, jnp.int32).reshape(1, 1)
    o_j, lse_j = jax_fwd(t(qt), t(kt), t(vt), off, causal, BLOCK, BLOCK,
                         True)
    grads_j = jax_bwd(t(qt), t(kt), t(vt), o_j, lse_j, t(dot), off, causal,
                      BLOCK, BLOCK, True)
    pallas = [np.asarray(g).transpose(0, 2, 1, 3) for g in grads_j]
    f32 = [x.float() for x in (qt, kt, vt)]
    dq_ref, _ = fa.flash_dq_reference(*f32, o, dot.float(), lse, causal,
                                      q_off)
    dk_ref, dv_ref = fa.flash_dkv_reference(*f32, dot.float(), lse, delta,
                                            causal, q_off)
    return (qt, kt, vt, dot), lse, delta, pallas, (dq_ref, dk_ref, dv_ref)


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,q_off", CASES)
def test_the_dq_model_matches_pallas_and_the_plain_version(B, H, Sq, Sk, D,
                                                           causal, q_off):
    ins, lse, delta, pallas, plain = _case(B, H, Sq, Sk, D, causal, q_off)
    dq = model.dq(*ins, lse, delta, causal, q_off, D ** -0.5)
    for name, ref in (("pallas", pallas[0]), ("plain", plain[0])):
        err = _rel(dq, ref)
        print(f"parity bwd_chunked_model D={D} dq/{name}: rel_err={err:.3g}")
        assert err <= TOL, (name, err)


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,q_off", CASES)
def test_the_dkv_model_matches_pallas_and_the_plain_version(B, H, Sq, Sk, D,
                                                            causal, q_off):
    ins, lse, delta, pallas, plain = _case(B, H, Sq, Sk, D, causal, q_off)
    dk, dv = model.dkv(*ins, lse, delta, causal, q_off, D ** -0.5)
    for name, (dk_ref, dv_ref) in (("pallas", pallas[1:]),
                                   ("plain", plain[1:])):
        for what, got, ref in (("dk", dk, dk_ref), ("dv", dv, dv_ref)):
            err = _rel(got, ref)
            print(f"parity bwd_chunked_model D={D} {what}/{name}: "
                  f"rel_err={err:.3g}")
            assert err <= TOL, (name, what, err)


def _small(kernel: str, dtype=torch.float16, **kw) -> float:
    """dQ's (`kernel` "dq") or dK's ("dkv") error against the plain version
    on an unscaled loss's inputs at D=640: dO of 1e-6; in fp16 Q scaled by
    1/64 (K by 64) for dQ = dS·K and by 64 for dK = dSᵀ·Q, in bf16 neither
    (`model.bf16_small_gradient_inputs`)."""
    D = 640
    rng = np.random.default_rng(640)
    if dtype == torch.float16:
        q, k, v, do = f16_model.small_gradient_inputs(
            rng, 1, 128, 2, D, 1 / 64 if kernel == "dq" else 64)
    else:
        q, k, v, do = model.bf16_small_gradient_inputs(rng, 1, 128, 2, D)
    o, lse, delta = _stats(q, k, v, do, True, 0)
    f32 = [x.float() for x in (q, k, v)]
    if kernel == "dq":
        got = model.dq(q, k, v, do, lse, delta, True, 0, D ** -0.5, **kw)
        ref, _ = fa.flash_dq_reference(*f32, o, do.float(), lse, True, 0)
    else:
        got, _ = model.dkv(q, k, v, do, lse, delta, True, 0, D ** -0.5, **kw)
        ref, _ = fa.flash_dkv_reference(*f32, do.float(), lse, delta, True,
                                        0)
    return _rel(got, ref)


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_the_scale_keeps_the_small_gradients_of_an_unscaled_loss(kernel):
    err = _small(kernel)
    print(f"parity bwd_chunked_model {kernel} small dO: rel_err={err:.3g}")
    assert err <= SMALL_TOL


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_without_the_scale_the_small_gradients_flush(kernel):
    err = _small(kernel, scaled=False)
    print(f"parity bwd_chunked_model {kernel} small dO unscaled: "
          f"rel_err={err:.3g}")
    assert err > 0.1


def _faulty(kernel: str, dtype=torch.float16, **kw) -> float:
    """The error of the model with a planted fault (`kw`) against the plain
    version: dQ's (`kernel` "dq") or dK's ("dkv"), on values of `dtype`."""
    B, H, S, D = 1, 2, 256, 640
    rng = np.random.default_rng(D)
    q, k, v, do = (_values(rng, (B, S, H, D), dtype) for _ in range(4))
    o, lse, delta = _stats(q, k, v, do, True, 0)
    f32 = [x.float() for x in (q, k, v)]
    if kernel == "dq":
        got = model.dq(q, k, v, do, lse, delta, True, 0, D ** -0.5, **kw)
        ref, _ = fa.flash_dq_reference(*f32, o, do.float(), lse, True, 0)
    else:
        got, _ = model.dkv(q, k, v, do, lse, delta, True, 0, D ** -0.5, **kw)
        ref, _ = fa.flash_dkv_reference(*f32, do.float(), lse, delta, True,
                                        0)
    return _rel(got, ref)


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("fault", ["drop_chunk", "no_rescale"])
def test_the_planted_faults_break_the_bar(kernel, fault):
    """What scripts/torch_planted_fault.py does to the kernels
    (`dqc_f16_drop_chunk` leaves D's second chunk out of S; the rescale
    taken out, as `dkvc_f16_no_rescale` takes it out of dK), done to the
    model: the bar of the kernel's output (dQ; dK) must see each."""
    kw = {"drop_chunk": 1} if fault == "drop_chunk" else {"rescale": False}
    err = _faulty(kernel, **kw)
    print(f"parity bwd_chunked_model {kernel} {fault}: rel_err={err:.3g}")
    assert err > 10 * TOL


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,q_off", CASES)
def test_the_bf16_dq_model_matches_pallas_and_the_plain_version(
        B, H, Sq, Sk, D, causal, q_off):
    ins, lse, delta, pallas, plain = _case(B, H, Sq, Sk, D, causal, q_off,
                                           torch.bfloat16)
    dq = model.dq(*ins, lse, delta, causal, q_off, D ** -0.5)
    for name, ref in (("pallas", pallas[0]), ("plain", plain[0])):
        err = _rel(dq, ref)
        print(f"parity bwd_chunked_model bf16 D={D} dq/{name}: "
              f"rel_err={err:.3g}")
        assert err <= BF16_TOL, (name, err)


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,q_off", CASES)
def test_the_bf16_dkv_model_matches_pallas_and_the_plain_version(
        B, H, Sq, Sk, D, causal, q_off):
    ins, lse, delta, pallas, plain = _case(B, H, Sq, Sk, D, causal, q_off,
                                           torch.bfloat16)
    dk, dv = model.dkv(*ins, lse, delta, causal, q_off, D ** -0.5)
    for name, (dk_ref, dv_ref) in (("pallas", pallas[1:]),
                                   ("plain", plain[1:])):
        for what, got, ref in (("dk", dk, dk_ref), ("dv", dv, dv_ref)):
            err = _rel(got, ref)
            print(f"parity bwd_chunked_model bf16 D={D} {what}/{name}: "
                  f"rel_err={err:.3g}")
            assert err <= BF16_TOL, (name, what, err)


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_bf16_keeps_the_small_gradients_of_an_unscaled_loss(kernel):
    """bf16 rounds dS (near 1e-8 here) with no exponent, as the Pallas
    kernels do: its range is fp32's, so nothing flushes."""
    err = _small(kernel, torch.bfloat16)
    print(f"parity bwd_chunked_model bf16 {kernel} small dO: "
          f"rel_err={err:.3g}")
    assert err <= BF16_TOL


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_the_bf16_drop_chunk_breaks_the_bar(kernel):
    """`dqc_bf16_drop_chunk` and `dkvc_bf16_drop_chunk`
    (scripts/torch_planted_fault.py), D's second chunk left out of S (Sᵀ),
    done to the bf16 model: dQ's (dK's) error breaks BF16_TOL tenfold."""
    err = _faulty(kernel, torch.bfloat16, drop_chunk=1)
    print(f"parity bwd_chunked_model bf16 {kernel} drop_chunk: "
          f"rel_err={err:.3g}")
    assert err > 10 * BF16_TOL


@pytest.mark.parametrize("D,cw", [(640, 128), (768, 256), (896, 128),
                                  (1024, 256)])
def test_the_model_takes_the_kernels_tiling(D, cw):
    """The model's tiles, chunks and CW as `DqChunked` and `DkvChunked` set
    them, read from the sources' text (no nvcc here), and the wrappers'
    route there: fp16's and bf16's dQ and dK/dV above 512 reach the chunked
    kernels through the wide entries, counted apart, and each dtype's entry
    launches the kernel's instantiation in that type."""
    assert model.cw(D) == cw
    assert model.DQ_TILES == (64, 128) and model.DKV_TILES == (64, 64)
    dq_src = (_build.CSRC / "flash_dq_wide.cu").read_text()
    dkv_src = (_build.CSRC / "flash_dkv_wide.cu").read_text()
    dq_c = dq_src[dq_src.index("struct DqChunked"):]
    dkv_c = dkv_src[dkv_src.index("struct DkvChunked"):]
    for text, rows, other in ((dq_c, "BM = 64;   // query rows of a CTA",
                               "BN = 128;  // keys of a tile"),
                              (dkv_c, "BN = 64;   // keys of a CTA",
                               "BM = 64;   // query rows of a tile")):
        assert f"static constexpr int {rows}" in text
        assert f"static constexpr int {other}" in text
        assert f"static constexpr int KC = {model.KC};" in text
    assert re.search(r"if \(D % 256 == 0\)\s+return launch_dq_chunked<256",
                     dq_src)
    assert "return D % 256 == 0 ? 256 : 128;" in dkv_src
    for dtype, suffix, ctype in ((torch.float16, "_f16", "f16"),
                                 (torch.bfloat16, "", "bf16")):
        for name, src in (("flash_dq", dq_src), ("flash_dkv", dkv_src)):
            route = fa._kernel(name, D, dtype)
            assert route == f"{name}{suffix}_wide"
            assert fa.counted(route, D) == f"{name}{suffix}_chunked"
            assert fa.counted(route, 512) == route
            body = src[src.index(f'extern "C" int voda_{route}('):]
            body = body[:body.index("\n}\n")]
            assert f"if (D > 512)\n    return {name[6:]}_chunked<{ctype}>(" \
                in body
