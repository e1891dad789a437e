"""Flash attention, forward and backward, as hand-written Hopper kernels.

Counterpart of the JAX package's ``ops/flash_attention.py``. Three CUDA
kernels (``ops/csrc``) replace its three Pallas kernels:

- ``flash_fwd`` (``csrc/flash_fwd.cu``) for ``_fwd_kernel``: O and the
  per-row logsumexp;
- ``flash_dq`` (``csrc/flash_dq.cu``) for ``_dq_kernel``: dQ, and δ =
  rowsum(dO∘O) for the next kernel;
- ``flash_dkv`` (``csrc/flash_dkv.cu``) for ``_dkv_kernel``: dK and dV.

Beside each stands its plain PyTorch version (`flash_attention_reference`,
`flash_dq_reference`, `flash_dkv_reference`), which computes the same
function in fp32 with O(S²) memory. A wrapper takes the plain version only for a
tensor on the CPU; on a CUDA tensor it launches its kernel or raises.

Divergences from the TPU kernels, on purpose:
- lse is fp32 ``[B, H, S]``; the TPU's ``[B, H, num_q, 8, bq]`` is a lane
  layout of that chip;
- any sequence length runs the kernel (the ragged edge is masked), so the
  TPU package's fallback to ``reference_attention`` for unaligned blocks
  does not exist here;
- the tile is 64 rows in every pass. ``block_q``, ``block_k`` and
  ``block_bwd`` are accepted for the same signature and do not change it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from vodascheduler_tpu_torch.ops import _build
from vodascheduler_tpu_torch.parallel.ring_attention import NEG_INF

HEAD_DIMS = (64, 128)

# Launches of each kernel since the last `reset_launches()`: one plain int
# per kernel, raised by its wrapper where it launches and nowhere else.
launches = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    # q k v o lse | B H Sq Sk D q_off causal scale stream
    "flash_fwd": [_P] * 5 + [_I] * 7 + [_F, _P],
    # q k v o do lse delta dq | B H Sq Sk D q_off causal scale stream
    "flash_dq": [_P] * 8 + [_I] * 7 + [_F, _P],
    # q k v do lse delta dk dv | B H Sq Sk D q_off causal scale stream
    "flash_dkv": [_P] * 8 + [_I] * 7 + [_F, _P],
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@functools.cache
def _entry(name: str):
    fn = getattr(_build.load(name), f"voda_{name}")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, *tensors: torch.Tensor) -> None:
    """What the kernels take: bf16, contiguous [B,S,H,D] on one CUDA
    device, D in HEAD_DIMS, 16-byte aligned rows."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: CUDA kernel takes bfloat16, got {t.dtype}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous [B,S,H,D], got "
                             f"shape {tuple(t.shape)} strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data pointer not 16-byte aligned")
    D = tensors[0].shape[-1]
    if D not in HEAD_DIMS:
        raise NotImplementedError(f"{name}: head_dim {D} not in {HEAD_DIMS}")


def _launch(name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _entry(name)(*args, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    launches[name] += 1


def _dims(q, k) -> Tuple[int, int, int, int, int]:
    B, Sq, H, D = q.shape
    if k.shape[0] != B or k.shape[2] != H or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "outside the sequence axis")
    return B, H, Sq, k.shape[1], D


# ---------------------------------------------------------------------------
# the kernels' wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------


def flash_fwd(q, k, v, causal: bool, q_off: int):
    """K1 on the card: (o [B,Sq,H,D] bf16, lse [B,H,Sq] fp32)."""
    _check("flash_fwd", q, k, v)
    B, H, Sq, Sk, D = _dims(q, k)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), B, H, Sq, Sk, D, int(q_off),
            int(causal), D ** -0.5)
    return o, lse


def flash_dq(q, k, v, o, do, lse, causal: bool, q_off: int):
    """K2 on the card: (dq [B,Sq,H,D] bf16, delta [B,H,Sq] fp32)."""
    _check("flash_dq", q, k, v, o, do)
    B, H, Sq, Sk, D = _dims(q, k)
    _check_stat(lse, B, H, Sq)
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    _launch("flash_dq", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), B, H, Sq, Sk, D, int(q_off), int(causal),
            D ** -0.5)
    return dq, delta


def flash_dkv(q, k, v, do, lse, delta, causal: bool, q_off: int):
    """K3 on the card: (dk, dv), each [B,Sk,H,D] bf16."""
    _check("flash_dkv", q, k, v, do)
    B, H, Sq, Sk, D = _dims(q, k)
    _check_stat(lse, B, H, Sq)
    _check_stat(delta, B, H, Sq)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_dkv", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, H, Sq, Sk, D, int(q_off), int(causal),
            D ** -0.5)
    return dk, dv


def _check_stat(t: torch.Tensor, B: int, H: int, Sq: int) -> None:
    if (t.dtype != torch.float32 or tuple(t.shape) != (B, H, Sq)
            or not t.is_contiguous()):
        raise ValueError(f"row statistic must be contiguous fp32 "
                         f"[{B},{H},{Sq}], got {t.dtype} {tuple(t.shape)}")


# ---------------------------------------------------------------------------
# plain versions (fp32, O(S²) memory)
# ---------------------------------------------------------------------------


def _scores(q, k, causal: bool, q_off: int) -> torch.Tensor:
    """Scaled, masked fp32 scores [B,H,Sq,Sk]."""
    qf = q.transpose(1, 2).float()
    kf = k.transpose(1, 2).float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * q.shape[-1] ** -0.5
    if causal:
        rows = q_off + torch.arange(q.shape[1], device=q.device)
        cols = torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(rows[:, None] < cols[None, :], NEG_INF)
    return s


def flash_attention_reference(q, k, v, causal: bool = True, q_offset: int = 0):
    """Plain version of K1 on [B,S,H,D]: (o in q's dtype, lse fp32 [B,H,Sq])."""
    s = _scores(q, k, causal, q_offset)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.transpose(1, 2).float()) / safe_l
    lse = (m + torch.log(safe_l)).squeeze(-1)
    return o.transpose(1, 2).to(q.dtype), lse


def _p_ds(q, k, v, do, lse, delta, causal: bool, q_off: int):
    """The backward's shared fp32 terms [B,H,Sq,Sk]: P = exp(S - lse) and
    dS = P∘(dO·Vᵀ - δ)·D^-½; also dO as fp32 [B,H,Sq,D]."""
    p = torch.exp(_scores(q, k, causal, q_off) - lse[..., None])
    dof = do.transpose(1, 2).float()
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.transpose(1, 2).float())
    ds = p * (dp - delta[..., None]) * q.shape[-1] ** -0.5
    return p, ds, dof


def flash_dq_reference(q, k, v, o, do, lse, causal: bool = True,
                       q_offset: int = 0):
    """Plain version of K2: (dq in q's dtype, delta fp32 [B,H,Sq])."""
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    _, ds, _ = _p_ds(q, k, v, do, lse, delta, causal, q_offset)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.transpose(1, 2).float())
    return dq.transpose(1, 2).to(q.dtype), delta.contiguous()


def flash_dkv_reference(q, k, v, do, lse, delta, causal: bool = True,
                        q_offset: int = 0):
    """Plain version of K3: (dk, dv) in k's and v's dtypes."""
    p, ds, dof = _p_ds(q, k, v, do, lse, delta, causal, q_offset)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.transpose(1, 2).float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    return dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    """custom_vjp of the reference: saves (q, k, v, o, lse, q_off)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_off: int):
        if q.is_cuda:
            o, lse = flash_fwd(q, k, v, causal, q_off)
        else:
            o, lse = flash_attention_reference(q, k, v, causal, q_off)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.q_off = causal, q_off
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, q_off = ctx.causal, ctx.q_off
        if q.is_cuda:
            do = do.contiguous()
            dq, delta = flash_dq(q, k, v, o, do, lse, causal, q_off)
            dk, dv = flash_dkv(q, k, v, do, lse, delta, causal, q_off)
        else:
            dq, delta = flash_dq_reference(q, k, v, o, do, lse, causal, q_off)
            dk, dv = flash_dkv_reference(q, k, v, do, lse, delta, causal,
                                         q_off)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = 1024,
                    block_k: int = 1024, block_bwd: int = 1024,
                    q_offset: Optional[int] = None) -> torch.Tensor:
    """Flash attention over [B, S, H, D] tensors (model layout).

    Heads must already be GQA-expanded (models/layers.py repeats KV heads
    before calling `attn_fn`). Differentiable through the backward kernels.
    `q_offset` is q's position within the K/V sequence, for causal masking
    of a query slice against the full keys. The block knobs are accepted
    for the reference's signature; the kernels tile by 64 rows.
    """
    for name, blk in (("block_q", block_q), ("block_k", block_k),
                      ("block_bwd", block_bwd)):
        if blk < 1:
            raise ValueError(f"{name} must be positive, got {blk}")
    return _FlashAttention.apply(q, k, v, bool(causal),
                                 int(q_offset or 0))
