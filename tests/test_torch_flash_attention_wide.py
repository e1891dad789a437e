"""Head widths above 128 (a multiple of 128): the operator's path through
the wide kernels, with their plain versions standing in on the CPU,
against the JAX package's Pallas kernel in interpret mode at D=256 and
against autograd through a softmax attention at D=384.

On the CPU `attention_op` computes with the plain versions directly; the
path a CUDA tensor takes is `padded_forward` / `padded_backward` (no
padding above 128: the width is D itself) around the kernels' wrappers,
which is what is driven here with the plain versions in their place.

Tolerances: O and lse at 3e-5, dq, dk and dv at 2e-4 abs+rel against the
Pallas kernel (those of tests/test_torch_flash_attention.py, fp32 sums in
another order); 1e-5 against autograd.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vodascheduler_tpu.ops import flash_attention as jax_flash
from vodascheduler_tpu.ops.flash_attention import _fwd as jax_fwd
from vodascheduler_tpu_torch.ops import flash_attention as fa

from tests.torch_parity import assert_close

BLOCK = 32


def _inputs(seed, B, Sq, Sk, H, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D), dtype=np.float32)
            for S in (Sq, Sk, Sk, Sq)]


def _recording(fn, scales):
    def call(*args, scale):
        scales.append(scale)
        return fn(*args, scale=scale)
    return call


def _wide_path(q, k, v, w, causal, q_off):
    """O, lse and (dq, dk, dv) through the CUDA path's padding functions,
    with the plain versions in place of the kernels; the scales they were
    handed."""
    scales = []
    o, lse = fa.padded_forward(
        _recording(fa.flash_attention_reference, scales), q, k, v, causal,
        q_off)
    grads = fa.padded_backward(
        _recording(fa.flash_dq_reference, scales),
        _recording(fa.flash_dkv_reference, scales), q, k, v, o, w, lse,
        causal, q_off)
    return o, lse, grads, scales


@pytest.mark.parametrize("causal,q_off,Sq", [(True, 0, 64), (False, 0, 64),
                                             (True, 32, 32)])
def test_d256_matches_pallas_interpret(causal, q_off, Sq):
    D, B, H, Sk = 256, 1, 2, 64
    q, k, v, w = _inputs(11 + q_off, B, Sq, Sk, H, D)

    def loss(q, k, v):
        o = jax_flash(q, k, v, causal=causal, block_q=BLOCK, block_k=BLOCK,
                      block_bwd=BLOCK, q_offset=q_off, interpret=True)
        return jnp.sum(o * w), o
    (_, o_j), g_j = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    t = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)
    off = jnp.asarray(q_off, jnp.int32).reshape(1, 1)
    _, lse_j = jax_fwd(t(q), t(k), t(v), off, causal, BLOCK, BLOCK, True)
    lse_j = np.asarray(lse_j[:, :, :, 0, :].reshape(B, H, Sq))

    assert fa.kernel_head_dim(D) == D
    before = dict(fa.launches)
    o, lse, grads, scales = _wide_path(*(torch.tensor(x) for x in
                                         (q, k, v, w)), causal, q_off)
    assert fa.launches == before  # the CPU path launches no kernel
    assert scales == [D ** -0.5] * 3
    tag = f"wide D={D} causal={causal} q_off={q_off}"
    assert_close(f"{tag} O", o, np.asarray(o_j), atol=3e-5, rtol=3e-5)
    assert_close(f"{tag} lse", lse, lse_j, atol=3e-5, rtol=3e-5)
    for got, want, name in zip(grads, g_j, "qkv"):
        assert_close(f"{tag} d{name}", got, np.asarray(want), atol=2e-4,
                     rtol=2e-4)

    # the operator itself, on the CPU, agrees with the path
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o_op = fa.flash_attention(qt, kt, vt, causal=causal, q_offset=q_off)
    (o_op * torch.tensor(w)).sum().backward()
    assert_close(f"{tag} operator O", o_op, o, atol=1e-6, rtol=1e-6)
    for got, t_, name in zip(grads, (qt, kt, vt), "qkv"):
        assert_close(f"{tag} operator d{name}", t_.grad, got, atol=1e-6,
                     rtol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_d384_matches_autograd(causal):
    D, Sq, Sk = 384, 40, 40
    q, k, v, w = (torch.tensor(x) for x in _inputs(13, 2, Sq, Sk, 2, D))
    o, _, grads, scales = _wide_path(q, k, v, w, causal, 0)
    assert scales == [D ** -0.5] * 3
    qt, kt, vt = (x.clone().requires_grad_() for x in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qt, kt) * D ** -0.5
    if causal:
        s = s.masked_fill(torch.ones(Sq, Sk, dtype=torch.bool).triu(1),
                          float("-inf"))
    o_auto = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vt)
    (o_auto * w).sum().backward()
    tag = f"wide D={D} causal={causal} vs autograd"
    assert_close(f"{tag} O", o, o_auto, 1e-5, 1e-5)
    for got, t, name in zip(grads, (qt, kt, vt), "qkv"):
        assert got.shape == t.shape
        assert_close(f"{tag} d{name}", got, t.grad, 1e-5, 1e-5)


@pytest.mark.parametrize("D", [192, 320])
def test_a_width_the_reference_refuses_raises_in_both(D):
    q = np.zeros((1, 8, 1, D), np.float32)
    with pytest.raises(NotImplementedError, match="multiple of 128"):
        jax_flash(*(jnp.asarray(q),) * 3, interpret=True)
    with pytest.raises(NotImplementedError, match="multiple of 128"):
        fa.flash_attention(*(torch.tensor(q),) * 3)
    with pytest.raises(NotImplementedError, match="multiple of 128"):
        fa.kernel_head_dim(D)
    x = torch.zeros(1, 8, 1, D, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        fa.flash_fwd(x, x, x, True, 0)


@pytest.mark.parametrize("name", ["flash_fwd", "flash_dq", "flash_dkv"])
def test_wrappers_route_widths_to_their_kernels(name):
    assert fa._kernel(name, 64) == name and fa._kernel(name, 128) == name
    for D in (256, 512, 1024):
        assert fa._kernel(name, D) == f"{name}_wide"
    assert fa._ARGTYPES[f"{name}_wide"] == fa._ARGTYPES[name]
    assert fa.launches[f"{name}_wide"] >= 0
