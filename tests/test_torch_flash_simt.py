"""The CUDA-core attention kernels (``ops/csrc/flash_simt.cu``: fp32's
forward, dQ and dK/dV, which the wrappers no longer take, ``_f32_simt``,
and fp16's forward, dQ and dK/dV, which they no longer take either,
``_f16_simt``)
against the JAX package's Pallas kernels in interpret mode, on the CPU.
fp16's kernels up to 512 are wgmma kernels (``flash_fwd.cu``,
``flash_dq.cu``, ``flash_dkv.cu`` and their wide twins), and fp32's
forward, dQ and dK/dV tensor-core ones at every width (``flash_f32.cu``), which
no CPU runs: here the wrappers route fp16 and fp32 to the CUDA-core kernels
at every width (the fixture `wrappers`), as those kernels take any width.

There is no ``nvcc`` here, so the CUDA source is compiled by ``g++`` against
a CPU emulation of the few CUDA pieces it uses (``tests/cuda_emulation``: a
block's 256 threads as ``std::thread``s meeting at a barrier for
``__syncthreads`` and each warp shuffle), and the port's own wrappers
(`flash_fwd`, `flash_dq`, `flash_dkv`: dtype dispatch, output allocation,
argument order) launch it in place of the card. Inputs come from numpy with
a fixed seed and go to both packages in fp32 or fp16.

Tolerances, as the largest error over the largest value of the JAX side's
tensor: fp32 at 5e-6 (the two sum in different orders; 9e-7 seen); fp16 at
2e-3, four ulps of fp16 at 1 (O, dQ, dK and dV are rounded to fp16, and P
before its products in both; dS is rounded to fp16 by the Pallas kernels
alone; 5.5e-4 seen before the kernels kept dS in fp32).
lse and δ, fp32 in both dtypes, at 1e-5 absolute. The card test of the
same kernels is
`test_torch_cuda.py::test_fp32_and_fp16_kernels_match_plain_versions`.
"""

import ctypes
import os
import re
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vodascheduler_tpu.ops.flash_attention import _bwd as jax_bwd
from vodascheduler_tpu.ops.flash_attention import _fwd as jax_fwd
from vodascheduler_tpu_torch.ops import flash_attention as fa

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
import chip_smoke  # noqa: E402
SOURCE = os.path.join(os.path.dirname(HERE), "vodascheduler_tpu_torch", "ops",
                      "csrc", "flash_simt.cu")
BLOCK = 32  # multi-block tiling in the Pallas kernels at these sizes
TOL = {np.float32: 5e-6, np.float16: 2e-3}


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernels' source built for the CPU emulation; name -> entry."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CPU emulation of the kernels")
    out = tmp_path_factory.mktemp("flash_simt")
    with open(SOURCE) as f:
        text = re.sub(r"(\w+)<<<(.*?)>>>", r"emu_launch(\1, \2)", f.read())
    src = out / "flash_simt_emulated.cpp"
    src.write_text(text + "\nnamespace voda { namespace simt { "
                   "float smem[65536]; } }\n")
    lib = out / "libflash_simt_emulated.so"
    subprocess.run([gxx, "-std=c++20", "-O2", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-I", os.path.join(
                        HERE, "cuda_emulation"), "-o", str(lib), str(src),
                    "-lpthread"], check=True, capture_output=True, timeout=300)
    so = ctypes.CDLL(str(lib))
    entries = {}
    for name in fa.launches:
        if fa.source(name) == fa.SIMT_SOURCE:
            fn = getattr(so, f"voda_{name}")
            fn.argtypes = fa._ARGTYPES[name]
            fn.restype = ctypes.c_int
            entries[name] = fn
    return entries


@pytest.fixture
def wrappers(emulated, monkeypatch):
    """The port's wrappers, launching the emulated kernels (fp16's and
    fp32's: the CUDA-core ones at every width, as chip_smoke.py's phase 3
    times them)."""
    def launch(name, device, *args, count=None):
        assert device.type == "cpu"
        assert emulated[name](*args, None) == 0
        fa.launches[count or name] += 1
    monkeypatch.setattr(fa, "_launch", launch)
    fa.reset_launches()
    with chip_smoke.routed(fa, {**chip_smoke.CUDA_CORE_F16,
                                **chip_smoke.CUDA_CORE_F32,
                                **chip_smoke.CUDA_CORE_F32_WIDE}):
        yield fa


def _jax(q, k, v, do, causal, q_off):
    """(o, lse [B,H,Sq], dq, dk, dv) of the Pallas kernels, [B,S,H,D]."""
    t = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)
    off = jnp.asarray(q_off, jnp.int32).reshape(1, 1)
    o, lse = jax_fwd(t(q), t(k), t(v), off, causal, BLOCK, BLOCK, True)
    dq, dk, dv = jax_bwd(t(q), t(k), t(v), o, lse, t(do), off, causal, BLOCK,
                         BLOCK, True)
    B, H, Sq = q.shape[0], q.shape[2], q.shape[1]
    back = lambda x: np.asarray(x.astype(jnp.float32)).transpose(0, 2, 1, 3)
    return (back(o), np.asarray(lse[:, :, :, 0, :].reshape(B, H, Sq)),
            back(dq), back(dk), back(dv))


@pytest.mark.parametrize("dtype", [np.float32, np.float16],
                         ids=["fp32", "fp16"])
@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,q_off", [
    (1, 2, 128, 128, 64, True, 0),
    (2, 1, 96, 96, 128, False, 0),
    # a query slice behind an offset, against longer keys
    (1, 1, 64, 192, 64, True, 128),
    # a head wider than one CTA's 128 output columns
    (1, 1, 64, 64, 256, True, 0),
    # above 512, where the kernels that stream D took fp16's routes (the
    # fixture's table sends the wide routes to the CUDA-core kernels)
    (1, 1, 64, 64, 640, True, 0),
])
def test_kernels_match_the_pallas_kernels(wrappers, dtype, B, H, Sq, Sk, D,
                                          causal, q_off):
    rng = np.random.default_rng(Sq + D)
    q, do = (rng.standard_normal((B, Sq, H, D)).astype(dtype)
             for _ in range(2))
    k, v = (rng.standard_normal((B, Sk, H, D)).astype(dtype)
            for _ in range(2))
    want = _jax(q, k, v, do, causal, q_off)

    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = wrappers.flash_fwd(qt, kt, vt, causal, q_off)
    dq, delta = wrappers.flash_dq(qt, kt, vt, o, dot, lse, causal, q_off)
    dk, dv = wrappers.flash_dkv(qt, kt, vt, dot, lse, delta, causal, q_off)
    assert o.dtype == dq.dtype == dk.dtype == qt.dtype
    assert all(fa.source(n) == fa.SIMT_SOURCE for n in fa.launches
               if fa.launches[n])
    assert fa.launches == {**dict.fromkeys(fa.launches, 0), **{
        fa._kernel(n, D, qt.dtype): 1
        for n in ("flash_fwd", "flash_dq", "flash_dkv")}}

    for name, got, ref in (("o", o, want[0]), ("dq", dq, want[2]),
                           ("dk", dk, want[3]), ("dv", dv, want[4])):
        err = np.abs(got.float().numpy() - ref).max() / np.abs(ref).max()
        assert err <= TOL[dtype], (name, err)
    assert np.abs(lse.numpy() - want[1]).max() <= 1e-5
    rowsum = (do.astype(np.float32) * o.float().numpy()).sum(-1)
    assert np.abs(delta.numpy() - rowsum.transpose(0, 2, 1)).max() <= 1e-5


def test_the_wrappers_route_dtypes_to_their_kernels():
    """fp32 takes its forward, dQ and dK/dV on the tensor cores at every
    width (flash_f32.cu: `_f32` up to 128, `_f32_wide` above), never the
    CUDA-core `_f32_simt`; fp16 its tensor-core kernels at every width (in
    the bf16 kernels' sources, `_f16` and `_f16_wide`, whose kernels stream
    D above 512), never the CUDA-core `_f16_simt`."""
    for name in ("flash_fwd", "flash_dq", "flash_dkv"):
        for D in (64, 128, 256, 512, 640):
            f32 = fa._kernel(name, D, torch.float32)
            assert f32 == f"{name}_f32" + ("_wide" if D > 128 else "")
            assert fa.source(f32) == fa.TF32_SOURCE
            f16 = fa._kernel(name, D, torch.float16)
            if D <= 128:
                assert f16 == f"{name}_f16" and fa.source(f16) == name
            else:
                assert f16 == f"{name}_f16_wide"
                assert fa.source(f16) == f"{name}_wide"
            assert f16 in fa.launches and f16 in fa._ARGTYPES
        assert fa._kernel(name, 64) == fa.source(name) == name
        assert fa._kernel(name, 256, torch.bfloat16) == f"{name}_wide"
        with pytest.raises(TypeError, match="float64"):
            fa._kernel(name, 64, torch.float64)
        with pytest.raises(NotImplementedError):
            fa._kernel(name, 96, torch.float32)
    x = torch.zeros(1, 8, 1, 64)
    with pytest.raises(TypeError, match="float16"):
        fa.flash_fwd(x, x.half(), x, True, 0)


def test_fp16_keeps_the_small_gradients_of_an_unscaled_loss(wrappers):
    """dS stays fp32 in the fp16 kernels (where the Pallas kernels round it
    to the input dtype): an unscaled loss's dO of 1e-6 gives a dS near
    1e-8, which fp16 (smallest normal 6e-5) would flush. K is scaled by 64
    and Q by 1/64 (S unchanged) so that dQ = dS·K lies among fp16's normal
    numbers. dQ and dK, the products of dS, against the plain versions,
    which compute in fp32 and round only their outputs, at 5e-3 of the
    largest value (the sound kernels read 0 on the emulation; rounding dS
    to fp16 reads 0.18 on dQ). dV = Pᵀ·dO does not read dS."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((1, 128, 2, 64)) for _ in range(3))
    q, k, v = (torch.from_numpy(x.astype(np.float16))
               for x in (q / 64, k * 64, v))
    do = torch.from_numpy((1e-6 * rng.standard_normal((1, 128, 2, 64)))
                          .astype(np.float16))
    o, lse = wrappers.flash_fwd(q, k, v, True, 0)
    dq, delta = wrappers.flash_dq(q, k, v, o, do, lse, True, 0)
    dk, _ = wrappers.flash_dkv(q, k, v, do, lse, delta, True, 0)
    dq_ref, delta_ref = fa.flash_dq_reference(q, k, v, o, do, lse, True, 0)
    dk_ref, _ = fa.flash_dkv_reference(q, k, v, do, lse, delta_ref, True, 0)
    for name, got, ref in (("dq", dq, dq_ref), ("dk", dk, dk_ref)):
        err = (got.float() - ref.float()).abs().max() / ref.float().abs().max()
        assert err <= 5e-3, (name, err.item())
