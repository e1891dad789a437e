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
- the tiles are fixed by each kernel's design: the forward takes 128
  query rows a CTA against K/V tiles of 128 keys (64 at D=128), dQ 128
  query rows against 64-key tiles, dK/dV 128 keys a CTA against Q/dO
  tiles of 64 rows (32 at D=128).
  ``block_q``, ``block_k`` and ``block_bwd`` are accepted for the same
  signature and change none of them.

The kernels read their tiles through TMA tensor maps built from the
``[B, S, H, D]`` shape, so every tensor's shape is checked against q's
(``_dims``) before a map is built.
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


def _dims(q, k, v, *q_like) -> Tuple[int, int, int, int, int]:
    """(B, H, Sq, Sk, D), after checking k against q outside the sequence
    axis, v against k, and each of `q_like` (o, do) against q: the kernels
    read every tensor with its own tensor map built from these dims, so a
    mismatch would be read out of bounds."""
    B, Sq, H, D = q.shape
    if k.shape[0] != B or k.shape[2] != H or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "outside the sequence axis")
    if v.shape != k.shape:
        raise ValueError(f"v {tuple(v.shape)} and k {tuple(k.shape)} differ")
    for t in q_like:
        if t.shape != q.shape:
            raise ValueError(f"{tuple(t.shape)} and q {tuple(q.shape)} differ")
    return B, H, Sq, k.shape[1], D


# ---------------------------------------------------------------------------
# the kernels' wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------


def flash_fwd(q, k, v, causal: bool, q_off: int):
    """K1 on the card: (o [B,Sq,H,D] bf16, lse [B,H,Sq] fp32)."""
    _check("flash_fwd", q, k, v)
    B, H, Sq, Sk, D = _dims(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), B, H, Sq, Sk, D, int(q_off),
            int(causal), D ** -0.5)
    return o, lse


def flash_dq(q, k, v, o, do, lse, causal: bool, q_off: int):
    """K2 on the card: (dq [B,Sq,H,D] bf16, delta [B,H,Sq] fp32)."""
    _check("flash_dq", q, k, v, o, do)
    B, H, Sq, Sk, D = _dims(q, k, v, o, do)
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
    B, H, Sq, Sk, D = _dims(q, k, v, do)
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


@torch.library.custom_op("voda::flash_attention", mutates_args=())
def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, q_off: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward as one operator of the dispatcher: (o, lse). Being an
    operator, it is what a selective-checkpoint policy can save
    (`models/layers.py` REMAT_POLICIES "attn_out"), so that a recompute
    does not launch K1 again."""
    if q.is_cuda:
        return flash_fwd(q, k, v, causal, q_off)
    return flash_attention_reference(q, k, v, causal, q_off)


def _setup_context(ctx, inputs, output):
    """The reference's custom_vjp residuals: (q, k, v, o, lse, q_off)."""
    q, k, v, causal, q_off = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.mark_non_differentiable(lse)
    ctx.causal, ctx.q_off = causal, q_off


def _backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    causal, q_off = ctx.causal, ctx.q_off
    if q.is_cuda:
        do = do.contiguous()
        dq, delta = flash_dq(q, k, v, o, do, lse, causal, q_off)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, causal, q_off)
    else:
        dq, delta = flash_dq_reference(q, k, v, o, do, lse, causal, q_off)
        dk, dv = flash_dkv_reference(q, k, v, do, lse, delta, causal, q_off)
    return dq, dk, dv, None, None


attention_op.register_autograd(_backward, setup_context=_setup_context)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = 1024,
                    block_k: int = 1024, block_bwd: int = 1024,
                    q_offset: Optional[int] = None) -> torch.Tensor:
    """Flash attention over [B, S, H, D] tensors (model layout).

    Heads must already be GQA-expanded (models/layers.py repeats KV heads
    before calling `attn_fn`). Differentiable through the backward kernels.
    `q_offset` is q's position within the K/V sequence, for causal masking
    of a query slice against the full keys. The block knobs are accepted
    for the reference's signature; each kernel keeps its own tiles (module
    docstring).
    """
    for name, blk in (("block_q", block_q), ("block_k", block_k),
                      ("block_bwd", block_bwd)):
        if blk < 1:
            raise ValueError(f"{name} must be positive, got {blk}")
    return attention_op(q, k, v, bool(causal), int(q_offset or 0))[0]
