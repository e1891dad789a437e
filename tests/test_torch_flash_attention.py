"""The port's flash attention (plain path on the CPU) against the JAX
package's Pallas kernels in interpret mode, values and gradients.

Inputs come from numpy with a fixed seed and go to both packages. The lse
of the TPU kernel is laid out [B, H, num_q, 8, bq]; the port's is
[B, H, S], so the comparison reads row 0 of the sublane axis. Tolerances
are those of tests/test_ops.py: fp32 O and lse at 3e-5, fp32 gradients at
2e-4, bf16 O at 3e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vodascheduler_tpu.ops import flash_attention as jax_flash
from vodascheduler_tpu.ops.flash_attention import _bwd as jax_bwd
from vodascheduler_tpu.ops.flash_attention import _fwd as jax_fwd
from vodascheduler_tpu_torch.ops import flash_attention as fa
from vodascheduler_tpu_torch.parallel.ring_attention import reference_attention

from tests.torch_parity import assert_close

BLOCK = 32  # multi-block tiling in the Pallas kernels at these sizes


def _inputs(seed, B, Sq, Sk, H, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D), dtype=np.float32)
    k = rng.standard_normal((B, Sk, H, D), dtype=np.float32)
    v = rng.standard_normal((B, Sk, H, D), dtype=np.float32)
    w = rng.standard_normal((B, Sq, H, D), dtype=np.float32)
    return q, k, v, w


def _jax_lse(q, k, v, causal, q_off):
    B, Sq, H, _ = q.shape
    t = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)
    off = jnp.asarray(q_off, jnp.int32).reshape(1, 1)
    _, lse = jax_fwd(t(q), t(k), t(v), off, causal, BLOCK, BLOCK, True)
    return np.asarray(lse[:, :, :, 0, :].reshape(B, H, Sq))


def _jax_out_grads(q, k, v, w, causal, q_off):
    def loss(q, k, v):
        o = jax_flash(q, k, v, causal=causal, block_q=BLOCK, block_k=BLOCK,
                      block_bwd=BLOCK, q_offset=q_off, interpret=True)
        return jnp.sum(o * w), o
    (_, o), g = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(o), [np.asarray(x) for x in g]


def _torch_out_grads(q, k, v, w, causal, q_off):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o = fa.flash_attention(qt, kt, vt, causal=causal, q_offset=q_off)
    (o * torch.tensor(w)).sum().backward()
    _, lse = fa.flash_attention_reference(qt.detach(), kt.detach(),
                                          vt.detach(), causal, q_off)
    return (o.detach().numpy(), lse.numpy(),
            [x.grad.numpy() for x in (qt, kt, vt)])


@pytest.mark.parametrize("causal,D,q_off,Sq", [
    (True, 16, 0, 64),
    (False, 16, 0, 64),
    (True, 64, 0, 64),
    (True, 128, 0, 64),
    (True, 16, 32, 32),   # a query slice at offset 32 of 64 keys
])
def test_plain_matches_pallas_interpret(causal, D, q_off, Sq):
    B, H = (1, 1) if D == 128 else (2, 2)
    q, k, v, w = _inputs(D + q_off, B, Sq, 64, H, D)
    o_j, g_j = _jax_out_grads(q, k, v, w, causal, q_off)
    lse_j = _jax_lse(q, k, v, causal, q_off)
    before = dict(fa.launches)
    o_t, lse_t, g_t = _torch_out_grads(q, k, v, w, causal, q_off)
    assert fa.launches == before  # the CPU path launches no kernel
    tag = f"flash fp32 D={D} causal={causal} q_off={q_off}"
    assert_close(f"{tag} O", o_t, o_j, atol=3e-5, rtol=3e-5)
    assert_close(f"{tag} lse", lse_t, lse_j, atol=3e-5, rtol=3e-5)
    for a, b, name in zip(g_t, g_j, "qkv"):
        assert_close(f"{tag} d{name}", a, b, atol=2e-4, rtol=2e-4)


def test_plain_matches_pallas_interpret_bf16():
    q, k, v, _ = _inputs(7, 2, 64, 64, 2, 32)
    o_j = jax_flash(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                    causal=True, block_q=BLOCK, block_k=BLOCK,
                    interpret=True)
    o_t = fa.flash_attention(*(torch.tensor(x).bfloat16() for x in (q, k, v)),
                             causal=True)
    assert o_t.dtype == torch.bfloat16
    assert_close("flash bf16 D=32 causal O", o_t,
                 np.asarray(o_j.astype(jnp.float32)), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_reference_attention_at_odd_length(causal):
    """S=257 has no aligned Pallas block; the port's oracle there is its
    own reference_attention, values and gradients."""
    q, k, v, w = (torch.tensor(x) for x in _inputs(3, 1, 257, 257, 2, 16))
    grads = []
    outs = []
    for fn in (lambda *a: fa.flash_attention(*a, causal=causal),
               lambda *a: reference_attention(*a, causal=causal)):
        args = [x.clone().requires_grad_() for x in (q, k, v)]
        o = fn(*args)
        (o * w).sum().backward()
        outs.append(o.detach())
        grads.append([x.grad for x in args])
    tag = f"flash plain vs reference_attention S=257 causal={causal}"
    assert_close(f"{tag} O", outs[0], outs[1], atol=3e-5, rtol=3e-5)
    for a, b, name in zip(*grads, "qkv"):
        assert_close(f"{tag} d{name}", a, b, atol=2e-4, rtol=2e-4)


def test_plain_lse_is_logsumexp_of_visible_scores():
    """A causal query slice at offset 8 of 48 keys: lse is the logsumexp of
    the scores the mask leaves, and O their softmax times V."""
    q, k, v, _ = (torch.tensor(x) for x in _inputs(5, 1, 16, 48, 1, 16))
    o, lse = fa.flash_attention_reference(q, k, v, causal=True, q_offset=8)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 16 ** -0.5
    rows = 8 + torch.arange(16)
    s = s.masked_fill(rows[:, None] < torch.arange(48)[None, :], -torch.inf)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(
        o, torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v),
        atol=1e-5, rtol=1e-5)


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    """The checks run before any launch, so they hold on the CPU too."""
    x = torch.zeros(1, 8, 1, 64)
    with pytest.raises(TypeError):
        fa.flash_fwd(x, x, x, True, 0)  # fp32
    y = torch.zeros(1, 8, 1, 48, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        fa.flash_fwd(y, y, y, True, 0)  # head_dim 48
    z = torch.zeros(1, 1, 8, 64, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError):
        fa.flash_fwd(z, z, z, True, 0)  # not contiguous


@pytest.mark.parametrize("v_shape", [(1, 16, 2, 64), (1, 8, 1, 64),
                                     (2, 8, 2, 64), (1, 8, 2, 128)])
def test_dims_rejects_a_v_unlike_k(v_shape):
    """The kernels build v's tensor map from k's dims: a v of another shape
    is refused before any map is built or kernel launched."""
    q = torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    v = torch.zeros(v_shape, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="v "):
        fa._dims(q, k, v)
    with pytest.raises(ValueError):
        fa.flash_fwd(q, k, v, True, 4)
    assert fa._dims(q, k, k) == (1, 2, 4, 8, 64)


def test_dims_rejects_an_output_gradient_unlike_q():
    q = torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa._dims(q, k, k, torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16))
    lse = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError):
        fa.flash_dkv(q, k, k, k, lse, lse, True, 4)


@pytest.mark.parametrize("causal,D,q_off,Sq,Sk", [
    (True, 16, 0, 192, 192),    # one full and one partial 128-row dQ tile
    (True, 16, 192, 64, 256),   # less than one tile behind an offset
    (False, 16, 0, 192, 192),
    (True, 64, 0, 192, 192),
])
def test_plain_dq_matches_pallas_bwd_at_dq_tile_edges(causal, D, q_off, Sq,
                                                      Sk):
    """K2's plain version against the Pallas `_bwd` in interpret mode, with
    64-row Pallas blocks, at the edges of the CUDA kernel's 128-row query
    tiles; δ against rowsum(dO∘O) taken in fp64."""
    q, k, v, w = _inputs(Sq + q_off + D, 1, Sq, Sk, 2, D)
    t = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)
    off = jnp.asarray(q_off, jnp.int32).reshape(1, 1)
    o_j, lse_j = jax_fwd(t(q), t(k), t(v), off, causal, 64, 64, True)
    dq_j, _, _ = jax_bwd(t(q), t(k), t(v), o_j, lse_j, t(w), off, causal, 64,
                         64, True)
    qt, kt, vt, wt = (torch.tensor(x) for x in (q, k, v, w))
    o, lse = fa.flash_attention_reference(qt, kt, vt, causal, q_off)
    dq, delta = fa.flash_dq_reference(qt, kt, vt, o, wt, lse, causal, q_off)
    tag = f"flash_dq plain fp32 D={D} causal={causal} q_off={q_off} Sq={Sq}"
    assert_close(f"{tag} dq", dq, np.asarray(dq_j).transpose(0, 2, 1, 3),
                 atol=2e-4, rtol=2e-4)
    delta64 = np.einsum("bshd,bshd->bhs", w.astype(np.float64),
                        o.numpy().astype(np.float64))
    assert delta.shape == (1, 2, Sq) and delta.is_contiguous()
    assert_close(f"{tag} delta", delta, delta64, atol=1e-5, rtol=1e-5)


def _dq_bad_args(case):
    """(o, lse) for q [1,8,2,64] bf16, broken as `case` says."""
    o = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 8)
    return {
        "lse_short": (o, torch.zeros(1, 2, 7)),
        "lse_heads_last": (o, torch.zeros(1, 8, 2)),
        "lse_bf16": (o, lse.bfloat16()),
        "lse_fp64": (o, lse.double()),
        "lse_not_contiguous": (o, torch.zeros(1, 8, 2).transpose(1, 2)),
        "o_longer": (torch.zeros(1, 16, 2, 64, dtype=torch.bfloat16), lse),
        "o_wider": (torch.zeros(1, 8, 2, 128, dtype=torch.bfloat16), lse),
        "o_fp32": (o.float(), lse),
    }[case]


@pytest.mark.parametrize("case,exc", [
    ("lse_short", ValueError), ("lse_heads_last", ValueError),
    ("lse_bf16", ValueError), ("lse_fp64", ValueError),
    ("lse_not_contiguous", ValueError), ("o_longer", ValueError),
    ("o_wider", ValueError), ("o_fp32", TypeError),
])
def test_flash_dq_refuses_a_bad_lse_or_o_before_any_launch(case, exc):
    """K2 builds O's tensor map from q's dims and reads lse as fp32
    [B,H,Sq]: a wrong one is refused before a kernel is built or launched,
    so the refusal holds on the CPU too."""
    q = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 16, 2, 64, dtype=torch.bfloat16)
    o, lse = _dq_bad_args(case)
    before = dict(fa.launches)
    with pytest.raises(exc):
        fa.flash_dq(q, k, k, o, q, lse, True, 8)
    assert fa.launches == before


# ---- head widths the kernels are not built for (zero padding along D) ------


@pytest.mark.parametrize("D,width", [(1, 64), (16, 64), (32, 64), (64, 64),
                                     (65, 128), (80, 128), (96, 128),
                                     (128, 128)])
def test_kernel_head_dim_is_the_next_kernel_width(D, width):
    assert fa.kernel_head_dim(D) == width


@pytest.mark.parametrize("D", [129, 192, 256])
def test_heads_wider_than_the_kernels_raise(D):
    with pytest.raises(NotImplementedError, match="C2"):
        fa.kernel_head_dim(D)


def _recording(fn, scales):
    def call(*args, scale):
        scales.append(scale)
        return fn(*args, scale=scale)
    return call


@pytest.mark.parametrize("causal,q_off,Sq,Sk", [
    (True, 0, 40, 40), (True, 16, 24, 40), (False, 0, 40, 40)])
@pytest.mark.parametrize("D", [16, 32, 80, 96])
def test_padding_to_the_kernel_width_is_exact(D, causal, q_off, Sq, Sk):
    """The operator's CUDA path pads q, k, v (and o, dO) with zeros along D
    to the kernels' width and cuts O, dQ, dK and dV back. With the plain
    versions standing in for the kernels, that path equals the unpadded
    plain attention (fp32, 1e-6), with D's own scale handed to every
    call, and equals autograd through a softmax attention at D."""
    q, k, v, w = (torch.tensor(x) for x in _inputs(5, 2, Sq, Sk, 3, D))
    scales = []
    o_pad, lse_pad = fa.padded_forward(
        _recording(fa.flash_attention_reference, scales), q, k, v, causal,
        q_off)
    o, lse = fa.flash_attention_reference(q, k, v, causal, q_off)
    assert o_pad.shape == o.shape and o_pad.is_contiguous()
    assert_close(f"padded O D={D}", o_pad, o, 1e-6, 1e-6)
    assert_close(f"padded lse D={D}", lse_pad, lse, 1e-6, 1e-6)

    grads_pad = fa.padded_backward(
        _recording(fa.flash_dq_reference, scales),
        _recording(fa.flash_dkv_reference, scales), q, k, v, o, w, lse,
        causal, q_off)
    dq, delta = fa.flash_dq_reference(q, k, v, o, w, lse, causal, q_off)
    dk, dv = fa.flash_dkv_reference(q, k, v, w, lse, delta, causal, q_off)
    for name, got, want in zip(("dq", "dk", "dv"), grads_pad, (dq, dk, dv)):
        assert got.shape == want.shape and got.is_contiguous()
        assert_close(f"padded {name} D={D}", got, want, 1e-6, 1e-6)
    assert scales == [D ** -0.5] * 3

    qt, kt, vt = (x.clone().requires_grad_() for x in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qt, kt) * D ** -0.5
    if causal:
        rows = q_off + torch.arange(Sq)
        s = s.masked_fill(rows[:, None] < torch.arange(Sk)[None, :],
                          float("-inf"))
    o_auto = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vt)
    (o_auto * w).sum().backward()
    assert_close(f"padded O vs autograd D={D}", o_pad, o_auto, 1e-5, 1e-5)
    for name, got, t in zip(("dq", "dk", "dv"), grads_pad, (qt, kt, vt)):
        assert_close(f"padded {name} vs autograd D={D}", got, t.grad,
                     1e-5, 1e-5)
