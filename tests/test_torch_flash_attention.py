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
