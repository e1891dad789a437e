"""Shared transformer building blocks.

Counterpart of the JAX package's ``models/layers.py``. Parameters are fp32
masters; compute runs in the activations' dtype, each weight cast at use, as
flax's ``dtype=`` / ``param_dtype=float32`` does. Initializers follow flax's
distributions (not its random bits): Dense and Conv kernels
``lecun_normal`` (a normal truncated at two standard deviations, std
1/√fan_in), biases zeros, norms ones (LayerNorm's bias zeros).

Where flax and torch differ by default, the flax behaviour is kept:
LayerNorm's eps is 1e-6 and its variance E[x²] − E[x]²; GELU is the tanh
form; ``SAME`` padding puts the odd pixel after (`same_pads`).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional, Tuple

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


class Dense(nn.Linear):
    """Dense layer, weight [out, in] in fp32, cast at use; bias-free
    unless `bias` (flax's Dense has one, its DenseGeneral here none). An
    `nn.Linear`, so that torch's tensor-parallel styles
    (`parallel/sharding.py`) take it."""

    def __init__(self, in_features: int, out_features: int, device=None,
                 bias: bool = False):
        nn.Module.__init__(self)
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               device=device))
        self.bias = (nn.Parameter(torch.empty(out_features, device=device))
                     if bias else None)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax's (lax's) ``SAME`` padding of one spatial axis: (before, after).
    The output has ceil(size / stride) positions; an odd total goes after,
    where torch's symmetric ``padding=k//2`` would split it evenly."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: Tuple[int, int],
             stride: Tuple[int, int], value: float = 0.0) -> torch.Tensor:
    """NCHW `x` padded as ``SAME`` pads it for `kernel` at `stride`."""
    top, bottom = same_pads(x.shape[2], kernel[0], stride[0])
    left, right = same_pads(x.shape[3], kernel[1], stride[1])
    if not (top or bottom or left or right):
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


class Conv(nn.Module):
    """flax's nn.Conv with ``SAME`` padding, on NCHW activations: weight
    OIHW in fp32 (flax's HWIO, transposed), cast at use; bias optional."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Tuple[int, int], stride: Tuple[int, int] = (1, 1),
                 bias: bool = False, device=None):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               *self.kernel, device=device))
        self.bias = (nn.Parameter(torch.empty(out_channels, device=device))
                     if bias else None)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        fan_in = self.weight.shape[1] * self.kernel[0] * self.kernel[1]
        lecun_normal_(self.weight, fan_in, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(pad_same(x, self.kernel, self.stride),
                        self.weight.to(x.dtype), bias, self.stride)


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


class LayerNorm(nn.Module):
    """flax's nn.LayerNorm with dtype float32: fp32 statistics, variance
    E[x²] − E[x]² clipped at 0 (flax's fast variance), eps 1e-6 (torch's
    default is 1e-5), scale and bias; the output is fp32."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = ((x32 * x32).mean(-1, keepdim=True) - mean * mean).clamp_min(0)
        return (x32 - mean) * (torch.rsqrt(var + self.eps) * self.scale) \
            + self.bias


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
    """Grouped-query attention. `attn_fn` ((q, k, v) -> out, all
    [B, S, H, D]) swaps in a kernel; None is the O(S²) reference. Pass
    `context` for cross-attention: keys and values are projected from it,
    and the keys rotate by the context's own positions."""

    def __init__(self, cfg: AttnConfig, dim: int,
                 attn_fn: Optional[Callable] = None, device=None):
        super().__init__()
        self.cfg = cfg
        self.attn_fn = attn_fn
        # The first of this rank's q heads when tp splits q but not k/v
        # (set by parallel/sharding.py); 0 otherwise.
        self.head_offset = 0
        hd = cfg.head_dim
        self.q_proj = Dense(dim, cfg.num_heads * hd, device)
        self.k_proj = Dense(dim, cfg.num_kv_heads * hd, device)
        self.v_proj = Dense(dim, cfg.num_kv_heads * hd, device)
        self.o_proj = Dense(cfg.num_heads * hd, dim, device)

    def forward(self, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        B, S, _ = x.shape
        kv_src = x if context is None else context
        Sk = kv_src.shape[1]
        # Heads by the projections' own widths: under tensor parallelism
        # (parallel/sharding.py) q/k/v hold this rank's heads.
        q = self.q_proj(x).unflatten(-1, (-1, cfg.head_dim))
        k = self.k_proj(kv_src).unflatten(-1, (-1, cfg.head_dim))
        v = self.v_proj(kv_src).unflatten(-1, (-1, cfg.head_dim))
        if positions is None:
            positions = torch.arange(S, device=x.device).expand(B, S)
        if cfg.rope_base > 0:
            q = rope(q, positions, cfg.rope_base)
            if context is None:
                k = rope(k, positions, cfg.rope_base)
            else:  # the encoder sequence's own positions
                k = rope(k, torch.arange(Sk, device=x.device).expand(B, Sk),
                         cfg.rope_base)
        groups = cfg.num_heads // cfg.num_kv_heads
        if groups > 1:  # expand kv heads h0,h0,h1,h1,... as jnp.repeat does
            k = k.repeat_interleave(groups, dim=2)
            v = v.repeat_interleave(groups, dim=2)
        if k.shape[2] != q.shape[2]:
            # q split over tp and k/v whole (tp divides the heads but not
            # the kv heads): this rank's heads of the expanded k/v.
            first = self.head_offset
            k = k[:, :, first:first + q.shape[2]]
            v = v[:, :, first:first + q.shape[2]]
        if self.attn_fn is None:
            out = reference_attention(q, k, v, causal=cfg.causal)
        else:
            out = self.attn_fn(q, k, v)
        return self.o_proj(out.flatten(2))


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


class EncoderBlock(nn.Module):
    """Pre-norm bidirectional block (BERT/ViT-style): fp32 LayerNorm,
    attention, LayerNorm, then fc1 -> tanh GELU -> fc2 with biases."""

    def __init__(self, attn_cfg: AttnConfig, dim: int, mlp_hidden: int,
                 device=None):
        super().__init__()
        self.ln1 = LayerNorm(dim, device=device)
        self.attn = Attention(attn_cfg, dim, device=device)
        self.ln2 = LayerNorm(dim, device=device)
        self.fc1 = Dense(dim, mlp_hidden, device, bias=True)
        self.fc2 = Dense(mlp_hidden, dim, device, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x).to(x.dtype))
        h = self.fc1(self.ln2(x).to(x.dtype))
        return x + self.fc2(F.gelu(h, approximate="tanh"))


def reset_parameters(module: nn.Module, generator=None) -> None:
    """Re-initialises every Dense, Conv and norm under `module` that has
    its own `reset_parameters` here, in registration order, from
    `generator`."""
    for m in module.modules():
        if isinstance(m, (Dense, Conv, RMSNorm, LayerNorm)):
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
