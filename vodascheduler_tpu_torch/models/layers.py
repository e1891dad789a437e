"""Shared transformer building blocks.

Counterpart of the JAX package's ``models/layers.py``. Parameters are fp32
masters; compute runs in the activations' dtype, each weight cast at use, as
flax's ``dtype=`` / ``param_dtype=float32`` does. Initializers follow flax's
distributions (not its random bits): Dense kernels ``lecun_normal`` (a
normal truncated at two standard deviations, std 1/√fan_in), norms ones.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

# Imported for its side effect: registers torch.ops.voda.flash_attention.
from vodascheduler_tpu_torch.ops import flash_attention  # noqa: F401
from vodascheduler_tpu_torch.parallel.ring_attention import reference_attention

# std of a unit normal truncated to [-2, 2]; flax divides by it so the
# truncated draw has the requested variance.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's lecun_normal: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


class Dense(nn.Module):
    """Bias-free dense layer, weight [out, in] in fp32, cast at use."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               device=device))
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype))


class RMSNorm(nn.Module):
    """Root-mean-square norm in fp32, cast back to the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        y = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + self.eps)
        return (y * self.scale).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding on x [B, S, H, D]: rotates the split
    halves (x[..., :D/2], x[..., D/2:]), with fp32 angles."""
    half = x.shape[-1] // 2
    freqs = base ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].float() * freqs  # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


@dataclasses.dataclass
class AttnConfig:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    causal: bool = True
    rope_base: float = 10000.0


class Attention(nn.Module):
    """Grouped-query self-attention. `attn_fn` ((q, k, v) -> out, all
    [B, S, H, D]) swaps in a kernel; None is the O(S²) reference."""

    def __init__(self, cfg: AttnConfig, dim: int,
                 attn_fn: Optional[Callable] = None, device=None):
        super().__init__()
        self.cfg = cfg
        self.attn_fn = attn_fn
        hd = cfg.head_dim
        self.q_proj = Dense(dim, cfg.num_heads * hd, device)
        self.k_proj = Dense(dim, cfg.num_kv_heads * hd, device)
        self.v_proj = Dense(dim, cfg.num_kv_heads * hd, device)
        self.o_proj = Dense(cfg.num_heads * hd, dim, device)

    def forward(self, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        B, S, _ = x.shape
        q = self.q_proj(x).view(B, S, cfg.num_heads, cfg.head_dim)
        k = self.k_proj(x).view(B, S, cfg.num_kv_heads, cfg.head_dim)
        v = self.v_proj(x).view(B, S, cfg.num_kv_heads, cfg.head_dim)
        if positions is None:
            positions = torch.arange(S, device=x.device).expand(B, S)
        if cfg.rope_base > 0:
            q = rope(q, positions, cfg.rope_base)
            k = rope(k, positions, cfg.rope_base)
        groups = cfg.num_heads // cfg.num_kv_heads
        if groups > 1:  # expand kv heads h0,h0,h1,h1,... as jnp.repeat does
            k = k.repeat_interleave(groups, dim=2)
            v = v.repeat_interleave(groups, dim=2)
        if self.attn_fn is None:
            out = reference_attention(q, k, v, causal=cfg.causal)
        else:
            out = self.attn_fn(q, k, v)
        return self.o_proj(out.reshape(B, S, cfg.num_heads * cfg.head_dim))


class SwiGLU(nn.Module):
    """Llama-family gated MLP."""

    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.gate_proj = Dense(dim, hidden, device)
        self.up_proj = Dense(dim, hidden, device)
        self.down_proj = Dense(hidden, dim, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class DecoderBlock(nn.Module):
    """Pre-norm decoder block (llama-style)."""

    def __init__(self, attn_cfg: AttnConfig, dim: int, mlp_hidden: int,
                 attn_fn: Optional[Callable] = None, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(dim, device=device)
        self.attn = Attention(attn_cfg, dim, attn_fn, device)
        self.mlp_norm = RMSNorm(dim, device=device)
        self.mlp = SwiGLU(dim, mlp_hidden, device)

    def forward(self, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), positions)
        return x + self.mlp(self.mlp_norm(x))


def reset_parameters(module: nn.Module, generator=None) -> None:
    """Re-initialises every Dense and RMSNorm under `module`, in
    registration order, from `generator`."""
    for m in module.modules():
        if isinstance(m, (Dense, RMSNorm)):
            m.reset_parameters(generator)


# The matrix products a policy saves: what F.linear, @ and einsum reach
# the dispatcher as (jax's dots_saveable saves every dot_general).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default)
# The attention kernel's operator; its outputs are the reference's
# checkpoint_name(out, "attn_out"). A layer whose attn_fn does not go
# through it (the plain attention) has no attn_out to save.
_ATTN_OUT = (torch.ops.voda.flash_attention.default,)

# name -> the ops whose outputs the backward keeps instead of recomputing
# (REMAT_POLICIES of the reference); None is full remat: only the layer
# boundaries are kept.
REMAT_POLICIES = {
    None: None,
    "dots": _DOTS,
    "attn_out": _ATTN_OUT,
    "dots_attn": _DOTS + _ATTN_OUT,
}


def remat_context(policy: Optional[str]):
    """`context_fn` for `torch.utils.checkpoint` under a named policy."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}; one of "
                         f"{list(REMAT_POLICIES)}")
    ops = REMAT_POLICIES[policy]
    if ops is None:
        return None
    return functools.partial(create_selective_checkpoint_contexts, list(ops))


def remat_stack(layers: nn.ModuleList, x: torch.Tensor, remat: bool,
                policy: Optional[str] = None) -> torch.Tensor:
    """Counterpart of `scan_stack`: runs the layers in order, each under
    `torch.utils.checkpoint` when `remat` is on. The backward recomputes
    each layer from its input, except the outputs `policy` keeps
    (REMAT_POLICIES)."""
    context_fn = remat_context(policy)
    kwargs = {} if context_fn is None else {"context_fn": context_fn}
    for layer in layers:
        if remat and torch.is_grad_enabled():
            x = checkpoint(layer, x, use_reentrant=False, **kwargs)
        else:
            x = layer(x)
    return x
