"""Flash attention, forward and backward, as hand-written Hopper kernels.

Counterpart of the JAX package's ``ops/flash_attention.py``. Three CUDA
kernels (``ops/csrc``) replace its three Pallas kernels:

- ``flash_fwd`` (``csrc/flash_fwd.cu``) for ``_fwd_kernel``: O and the
  per-row logsumexp;
- ``flash_dq`` (``csrc/flash_dq.cu``) for ``_dq_kernel``: dQ, and δ =
  rowsum(dO∘O) for the next kernel;
- ``flash_dkv`` (``csrc/flash_dkv.cu``) for ``_dkv_kernel``: dK and dV.

Those are built for head widths 64 and 128. Above 128 the JAX package takes
any multiple of 128, and so does each wrapper, through a second kernel of
the same function (``csrc/flash_{fwd,dq,dkv}_wide.cu``, on
``csrc/hopper.cuh``; above D=512 each source's second kernel, which streams
D: the forward in 128-column chunks, dQ and dK/dV in 64-column chunks):
``flash_fwd_wide``, ``flash_dq_wide`` and ``flash_dkv_wide``, each counted
apart. Those six take bf16. The JAX kernels compute in ``q.dtype``, so fp32 and fp16 tensors
go to kernels of their own, each counted apart; which one, by function,
dtype and head width D (after the operator's zero padding):

=====  ==========  ======================  =====================  ======================
dtype  D           K1                      K2                     K3
=====  ==========  ======================  =====================  ======================
bf16   ≤ 128       ``flash_fwd``           ``flash_dq``           ``flash_dkv``
bf16   > 128       ``flash_fwd_wide``      ``flash_dq_wide``      ``flash_dkv_wide``
fp16   ≤ 128       ``flash_fwd_f16``       ``flash_dq_f16``       ``flash_dkv_f16``
fp16   > 128       ``flash_fwd_f16_wide``  ``flash_dq_f16_wide``  ``flash_dkv_f16_wide``
fp32   ≤ 128       ``flash_fwd_f32``       ``flash_dq_f32``       ``flash_dkv_f32``
fp32   > 128       ``flash_fwd_f32_wide``  ``flash_dq_f32_wide``  ``flash_dkv_f32_wide``
=====  ==========  ======================  =====================  ======================

fp16's kernels are the bf16 kernels' TMA + wgmma designs in fp16
(``csrc/flash_{fwd,dq,dkv}.cu`` and their wide twins
``csrc/flash_{fwd,dq,dkv}_wide.cu``, templated on the element type), above
D=512 too (``flash_fwd_chunked_kernel``, ``flash_dq_chunked_kernel``,
``flash_dkv_chunked_kernel``).
fp32's K1, K2 and K3 run on the tensor cores in three TF32 passes on
wgmma (``csrc/flash_f32.cu``). K1, after a prologue that splits K and Vᵀ
into scratch, holds Q resident up to D=128 and above it (``_f32_wide``,
every multiple of 128) streams D in 32-column chunks, owning 128 columns of
O a CTA. K2 and K3 are one kernel each at every width, streaming D in
32-column chunks and owning min(D, 128) columns of the output a CTA: K2
after a prologue that splits K, V and Kᵀ into scratch, K3 after one that
splits Q, dO, K, V, Qᵀ and dOᵀ (``flash_dq_f32`` and ``flash_dkv_f32`` up
to 128, ``flash_dq_f32_wide`` and ``flash_dkv_f32_wide`` above). The choice
is by width, never a fallback: a kernel that fails to build or launch
raises.
Above 512 the kernels that stream D count apart from their route's
entries (`CHUNKED_COUNTS`): ``flash_fwd_chunked``, ``flash_dq_chunked`` and
``flash_dkv_chunked`` (bf16), ``flash_fwd_f16_chunked``,
``flash_dq_f16_chunked`` and ``flash_dkv_f16_chunked`` (fp16). The CUDA-core
kernels that lost their routes keep entries of their own, to be timed
against their replacements: fp32's forward, dQ and dK/dV
(``flash_{fwd,dq,dkv}_f32_simt``), which the TF32 kernels replaced at every
width, and fp16's forward, dQ and dK/dV (``flash_{fwd,dq,dkv}_f16_simt``),
which the chunked kernels replaced above 512.

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
- below 128 the kernels are built for head widths 64 and 128 only. The
  operator (`attention_op`) zero-pads q, k, v (and o, dO in the backward)
  along D to the next of those widths and slices O, dQ, dK and dV back,
  passing the true scale D^-½: zero columns change no entry of QKᵀ, give O
  zero columns, add nothing to δ = rowsum(dO∘O), and dQ's and dK's padded
  columns are products with zero columns. So any D up to 128 runs the
  kernels, as any D up to 128 runs the TPU kernels, and so does any
  multiple of 128 (the wide kernels); any other D raises, on every device,
  as the JAX package's `flash_attention` raises;
- the tiles are fixed by each kernel's design: the forward takes 128
  query rows a CTA against K/V tiles of 128 keys (64 at D=128), dQ 128
  query rows against 64-key tiles, dK/dV 128 keys a CTA against Q/dO
  tiles of 64 rows (32 at D=128), in fp16 as in bf16 (and the wide
  kernels theirs, ``csrc/flash_*_wide.cu``: above D=512 dQ 64 query rows
  against 128-key tiles, dK/dV 64 keys against 64-row tiles);
  fp32's tensor-core forward
  takes 128 query rows against K/V tiles of 64 keys (32 at D=128), and
  above D=128 against 64-key tiles, 128 columns of O a CTA; its dQ 128
  query rows against 64-key tiles at every width, min(D, 128) columns of
  dQ a CTA; its dK/dV 128 keys against Q/dO tiles of 64 rows at D=64 and
  32 rows from D=128, min(D, 128) columns of dK and dV a CTA; the
  CUDA-core kernels take 64×64
  tiles of (queries, keys) and 64 or 128 columns of the output a CTA.
  ``block_q``, ``block_k`` and ``block_bwd`` are accepted for the same
  signature and change none of them;
- fp32's tensor-core kernels (``flash_fwd_f32``, ``flash_dq_f32``,
  ``flash_dkv_f32`` and their ``_wide`` twins above D=128) take
  every fp32 product as three TF32 products (a_lo·b_hi + a_hi·b_lo +
  a_hi·b_hi, hi and lo the TF32 halves of each operand) in one fp32
  accumulator, where the TPU splits an f32 dot over bf16 passes of its
  matrix unit: at least as accurate, and as accurate as fp32 on the CUDA
  cores (dQ's S and dP, and dK/dV's Sᵀ and dPᵀ, sum each 32-column chunk
  of D in an accumulator of its own, added in fp32, as the tensor cores
  truncate their sums);
- fp32 and fp16 run the TPU kernels' arithmetic (products of the input
  dtype accumulated in fp32, P rounded to the input dtype before its
  products) except for dS, which the TPU kernels round to the input dtype
  (``ds.astype``) and fp16's range would flush for an unscaled loss (dS
  near 1e-8, below fp16's smallest normal, 6e-5): the CUDA-core kernels
  keep dS in fp32, and the fp16 wgmma kernels, whose products take dS in
  fp16, round each row of it under a power-of-two scale that puts the
  row's largest value in [2^13, 2^14) and undo it on the output: each key
  row of dSᵀ for dK (``flash_dkv_f16``, ``flash_dkv_f16_wide``), each
  query row of dS for dQ (``flash_dq_f16``, ``flash_dq_f16_wide``). In the
  wide kernels (``csrc/flash_{dq,dkv}_wide.cu``) the warpgroup that forms
  dS hands each row's exponent to the other with the fragments, as both
  accumulate over the same rows; above D=512 each CTA of a row (or key)
  block keeps its own exponents, which agree, as every such CTA sums the
  same chunks of D in the same order. Each wrapper picks the kernel by the
  tensors' dtype, which all must share; any other dtype raises.

The wgmma kernels read their tiles through TMA tensor maps built from the
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
# Above HEAD_DIMS[-1], the widths the wide kernels take: multiples of this.
WIDE_CHUNK = 128
# The widest head of the wide wgmma kernels that hold a CTA's operands over
# all of D. Above it the wide entries of the forward, dQ and dK/dV, in bf16
# and fp16, launch the kernels of their sources that stream D (counted
# apart: CHUNKED_COUNTS).
WGMMA_MAX_D = 512

# Launches of each kernel since the last `reset_launches()`: one plain int
# per kernel, raised by its wrapper where it launches and nowhere else.
launches = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
            "flash_fwd_wide": 0, "flash_dq_wide": 0, "flash_dkv_wide": 0,
            "flash_fwd_f32": 0, "flash_dq_f32": 0, "flash_dkv_f32": 0,
            "flash_fwd_f32_wide": 0, "flash_dq_f32_wide": 0,
            "flash_dkv_f32_wide": 0, "flash_fwd_f32_simt": 0,
            "flash_dq_f32_simt": 0, "flash_dkv_f32_simt": 0,
            "flash_fwd_f16": 0, "flash_dq_f16": 0, "flash_dkv_f16": 0,
            "flash_fwd_f16_wide": 0, "flash_dq_f16_wide": 0,
            "flash_dkv_f16_wide": 0, "flash_fwd_f16_simt": 0,
            "flash_dq_f16_simt": 0, "flash_dkv_f16_simt": 0,
            "flash_fwd_chunked": 0, "flash_dq_chunked": 0,
            "flash_dkv_chunked": 0, "flash_fwd_f16_chunked": 0,
            "flash_dq_f16_chunked": 0, "flash_dkv_f16_chunked": 0}
# Above WGMMA_MAX_D these routes' entries launch a second kernel of their
# source, one that streams D (flash_fwd_wide.cu's flash_fwd_chunked_kernel,
# flash_dq_wide.cu's flash_dq_chunked_kernel, flash_dkv_wide.cu's
# flash_dkv_chunked_kernel): its launches count under a name of its own, by
# the route that reaches it.
CHUNKED_COUNTS = {"flash_fwd_wide": "flash_fwd_chunked",
                  "flash_dq_wide": "flash_dq_chunked",
                  "flash_dkv_wide": "flash_dkv_chunked",
                  "flash_fwd_f16_wide": "flash_fwd_f16_chunked",
                  "flash_dq_f16_wide": "flash_dq_f16_chunked",
                  "flash_dkv_f16_wide": "flash_dkv_f16_chunked"}
# The suffix of the kernel names of fp32 and fp16 tensors.
SIMT_SUFFIX = {torch.float32: "f32", torch.float16: "f16"}
# The kernels on the CUDA cores, all in one source, and fp32's on the
# tensor cores, in another; every other kernel's source carries the name of
# its bf16 kernel (fp16's flash_dq_f16 is in flash_dq.cu, flash_dq_f16_wide
# in flash_dq_wide.cu).
SIMT_SOURCE = "flash_simt"
SIMT_KERNELS = frozenset({"flash_fwd_f32_simt", "flash_dq_f32_simt",
                          "flash_dkv_f32_simt", "flash_fwd_f16_simt",
                          "flash_dq_f16_simt", "flash_dkv_f16_simt"})
TF32_SOURCE = "flash_f32"
TF32_KERNELS = frozenset({"flash_fwd_f32", "flash_dq_f32", "flash_dkv_f32",
                          "flash_fwd_f32_wide", "flash_dq_f32_wide",
                          "flash_dkv_f32_wide"})

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
    # fp32's tensor-core K1 also takes its scratch (`f32_scratch`) after
    # lse, its K2 after dq, its K3 after dv
    "flash_fwd_f32": [_P] * 6 + [_I] * 7 + [_F, _P],
    "flash_fwd_f32_wide": [_P] * 6 + [_I] * 7 + [_F, _P],
    "flash_dq_f32": [_P] * 9 + [_I] * 7 + [_F, _P],
    "flash_dq_f32_wide": [_P] * 9 + [_I] * 7 + [_F, _P],
    "flash_dkv_f32": [_P] * 9 + [_I] * 7 + [_F, _P],
    "flash_dkv_f32_wide": [_P] * 9 + [_I] * 7 + [_F, _P],
}
# The entries that take that scratch.
F32_SCRATCH = frozenset({"flash_fwd_f32", "flash_fwd_f32_wide",
                         "flash_dq_f32", "flash_dq_f32_wide",
                         "flash_dkv_f32", "flash_dkv_f32_wide"})
for _name in launches.keys() - CHUNKED_COUNTS.values():  # every variant
    # takes its function's arguments
    _ARGTYPES.setdefault(_name, _ARGTYPES["_".join(_name.split("_")[:2])])


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def entry(kernel: str) -> str:
    """The C entry (``voda_<entry>``) that launches `kernel`, or the
    kernel that a count names: a chunked kernel's, its route's."""
    return {c: r for r, c in CHUNKED_COUNTS.items()}.get(kernel, kernel)


def source(kernel: str) -> str:
    """The source (in ``ops/csrc``) that holds `kernel`."""
    kernel = entry(kernel)
    if kernel in SIMT_KERNELS:
        return SIMT_SOURCE
    if kernel in TF32_KERNELS:
        return TF32_SOURCE
    return kernel.replace("_f16", "")


@functools.cache
def _entry(name: str):
    name = entry(name)
    fn = getattr(_build.load(source(name)), f"voda_{name}")
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def load_kernels(names) -> None:
    """Finds the kernels `names` (routes or counts, as `launches` names
    them) in the build cache (building them if absent) and loads them, so
    that their first launch loads nothing."""
    for name in names:
        _entry(name)


def _kernel(name: str, D: int, dtype: torch.dtype = torch.bfloat16) -> str:
    """The kernel of wrapper `name` for head width D and tensors of
    `dtype`: for bf16 its own at a width of HEAD_DIMS and its wide variant
    at a multiple of WIDE_CHUNK above them; for fp16 and fp32 the same,
    named ``_f16`` and ``_f16_wide``, ``_f32`` and ``_f32_wide``."""
    if D not in HEAD_DIMS and not (D > HEAD_DIMS[-1] and D % WIDE_CHUNK == 0):
        raise NotImplementedError(
            f"{name}: head_dim {D} is neither in {HEAD_DIMS} nor a multiple "
            f"of {WIDE_CHUNK} above them")
    if dtype not in (torch.bfloat16, *SIMT_SUFFIX):
        raise TypeError(f"{name}: the CUDA kernels take bfloat16, float32 "
                        f"and float16, got {dtype}")
    kernel = (name if dtype == torch.bfloat16
              else f"{name}_{SIMT_SUFFIX[dtype]}")
    return kernel if D in HEAD_DIMS else f"{kernel}_wide"


def counted(kernel: str, D: int) -> str:
    """The count that a launch of `kernel` at head width D raises: its
    chunked kernel's above WGMMA_MAX_D (CHUNKED_COUNTS), else its own."""
    if kernel in CHUNKED_COUNTS and D > WGMMA_MAX_D:
        return CHUNKED_COUNTS[kernel]
    return kernel


def _check(name: str, *tensors: torch.Tensor) -> str:
    """What the kernels take: contiguous [B,S,H,D] of one dtype (bf16,
    fp32 or fp16) on one CUDA device, 16-byte aligned rows, D in HEAD_DIMS
    or a multiple of WIDE_CHUNK above them. Returns the kernel that takes
    them."""
    dev, dtype = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: tensors of {t.dtype} and {dtype}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous [B,S,H,D], got "
                             f"shape {tuple(t.shape)} strides {t.stride()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data pointer not 16-byte aligned")
    return _kernel(name, tensors[0].shape[-1], dtype)


def _launch(name: str, device: torch.device, *args,
            count: Optional[str] = None) -> None:
    """Launches entry `name` and raises `count` (default: `name`)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _entry(name)(*args, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    launches[count or name] += 1


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


def flash_fwd(q, k, v, causal: bool, q_off: int,
              scale: Optional[float] = None):
    """K1 on the card: (o [B,Sq,H,D] in q's dtype, lse [B,H,Sq] fp32). `scale`
    multiplies QKᵀ; None means D^-½ of the tensors' own width."""
    kernel = _check("flash_fwd", q, k, v)
    B, H, Sq, Sk, D = _dims(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    # fp32's tensor-core K1 also takes its scratch, held here until launched
    scratch = ([f32_scratch(B, H, Sk, D, q.device, "flash_fwd")]
               if kernel in F32_SCRATCH else [])
    _launch(kernel, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), *(t.data_ptr() for t in scratch),
            B, H, Sq, Sk, D, int(q_off), int(causal), _scale(scale, D),
            count=counted(kernel, D))
    return o, lse


def f32_scratch(B: int, H: int, Sk: int, D: int, device: torch.device,
                name: str = "flash_fwd", Sq: int = 0) -> torch.Tensor:
    """The scratch of fp32's tensor-core K1, K2 or K3 (`name`:
    ``flash_fwd``, ``flash_dq`` or ``flash_dkv``; ``csrc/flash_f32.cu``, at
    every width), which the kernel's prologue fills with TF32 halves: K1's
    K_hi and K_lo ([B, Sk, H, D] each), then Vᵀ_hi and Vᵀ_lo ([B, H, D,
    SkP] each, SkP = Sk rounded up to 8); K2's K_hi, K_lo, V_hi and V_lo
    ([B, Sk, H, D] each), then Kᵀ_hi and Kᵀ_lo ([B, H, D, SkP] each); K3's
    Q_hi, Q_lo, dO_hi and dO_lo ([B, Sq, H, D] each), K_hi, K_lo, V_hi and
    V_lo ([B, Sk, H, D] each), then Qᵀ_hi, Qᵀ_lo, dOᵀ_hi and dOᵀ_lo ([B, H,
    D, SqP] each, SqP = Sq rounded up to 8). `Sq` is read for K3 alone."""
    if name == "flash_dkv":
        n = 4 * B * H * D * (Sq + Sk + -(-Sq // 8) * 8)
    else:
        rows = {"flash_fwd": 1, "flash_dq": 2}[name]
        n = 2 * B * H * D * (rows * Sk + -(-Sk // 8) * 8)
    return torch.empty(n, dtype=torch.float32, device=device)


def flash_dq(q, k, v, o, do, lse, causal: bool, q_off: int,
             scale: Optional[float] = None):
    """K2 on the card: (dq [B,Sq,H,D] in q's dtype, delta [B,H,Sq] fp32)."""
    kernel = _check("flash_dq", q, k, v, o, do)
    B, H, Sq, Sk, D = _dims(q, k, v, o, do)
    _check_stat(lse, B, H, Sq)
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    # fp32's tensor-core K2 also takes its scratch, held here until launched
    scratch = ([f32_scratch(B, H, Sk, D, q.device, "flash_dq")]
               if kernel in F32_SCRATCH else [])
    _launch(kernel, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), *(t.data_ptr() for t in scratch), B, H, Sq, Sk,
            D, int(q_off), int(causal), _scale(scale, D),
            count=counted(kernel, D))
    return dq, delta


def flash_dkv(q, k, v, do, lse, delta, causal: bool, q_off: int,
              scale: Optional[float] = None):
    """K3 on the card: (dk, dv), each [B,Sk,H,D] in q's dtype."""
    kernel = _check("flash_dkv", q, k, v, do)
    B, H, Sq, Sk, D = _dims(q, k, v, do)
    _check_stat(lse, B, H, Sq)
    _check_stat(delta, B, H, Sq)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    # fp32's tensor-core K3 also takes its scratch, held here until launched
    scratch = ([f32_scratch(B, H, Sk, D, q.device, "flash_dkv", Sq)]
               if kernel in F32_SCRATCH else [])
    _launch(kernel, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *(t.data_ptr() for t in scratch), B, H, Sq, Sk,
            D, int(q_off), int(causal), _scale(scale, D),
            count=counted(kernel, D))
    return dk, dv


def _scale(scale: Optional[float], D: int) -> float:
    return D ** -0.5 if scale is None else float(scale)


def _check_stat(t: torch.Tensor, B: int, H: int, Sq: int) -> None:
    if (t.dtype != torch.float32 or tuple(t.shape) != (B, H, Sq)
            or not t.is_contiguous()):
        raise ValueError(f"row statistic must be contiguous fp32 "
                         f"[{B},{H},{Sq}], got {t.dtype} {tuple(t.shape)}")


# ---------------------------------------------------------------------------
# plain versions (fp32, O(S²) memory)
# ---------------------------------------------------------------------------


def _scores(q, k, causal: bool, q_off: int, scale: Optional[float],
            acc: torch.dtype = torch.float32) -> torch.Tensor:
    """Scaled, masked scores [B,H,Sq,Sk] in `acc` (fp32 by default)."""
    qf = q.transpose(1, 2).to(acc)
    kf = k.transpose(1, 2).to(acc)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * _scale(scale, q.shape[-1])
    if causal:
        rows = q_off + torch.arange(q.shape[1], device=q.device)
        cols = torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(rows[:, None] < cols[None, :], NEG_INF)
    return s


def flash_attention_reference(q, k, v, causal: bool = True, q_offset: int = 0,
                              scale: Optional[float] = None):
    """Plain version of K1 on [B,S,H,D]: (o in q's dtype, lse fp32 [B,H,Sq])."""
    s = _scores(q, k, causal, q_offset, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.transpose(1, 2).float()) / safe_l
    lse = (m + torch.log(safe_l)).squeeze(-1)
    return o.transpose(1, 2).to(q.dtype), lse


def _p_ds(q, k, v, do, lse, delta, causal: bool, q_off: int,
          scale: Optional[float], acc: torch.dtype = torch.float32):
    """The backward's shared terms [B,H,Sq,Sk] in `acc` (fp32 by default):
    P = exp(S - lse) and dS = P∘(dO·Vᵀ - δ)·scale; also dO as [B,H,Sq,D]."""
    p = torch.exp(_scores(q, k, causal, q_off, scale, acc)
                  - lse.to(acc)[..., None])
    dof = do.transpose(1, 2).to(acc)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.transpose(1, 2).to(acc))
    ds = p * (dp - delta[..., None]) * _scale(scale, q.shape[-1])
    return p, ds, dof


def flash_dq_reference(q, k, v, o, do, lse, causal: bool = True,
                       q_offset: int = 0, scale: Optional[float] = None,
                       acc: torch.dtype = torch.float32):
    """Plain version of K2: (dq in q's dtype, delta fp32 [B,H,Sq]). `acc`
    is the type it computes in: fp32, or fp64 where a check wants the
    function nearer its exact value than fp32's own rounding (dQ's rows
    whose dP − δ cancels)."""
    delta = (do.to(acc) * o.to(acc)).sum(-1).transpose(1, 2)
    _, ds, _ = _p_ds(q, k, v, do, lse, delta, causal, q_offset, scale, acc)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.transpose(1, 2).to(acc))
    return (dq.transpose(1, 2).to(q.dtype),
            delta.to(torch.float32).contiguous())


def flash_dkv_reference(q, k, v, do, lse, delta, causal: bool = True,
                        q_offset: int = 0, scale: Optional[float] = None,
                        acc: torch.dtype = torch.float32):
    """Plain version of K3: (dk, dv) in k's and v's dtypes. `acc` is the
    type it computes in: fp32, or fp64 where a check wants the function
    nearer its exact value than fp32's own rounding."""
    p, ds, dof = _p_ds(q, k, v, do, lse, delta, causal, q_offset, scale, acc)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.transpose(1, 2).to(acc))
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    return dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)


# ---------------------------------------------------------------------------
# head widths the kernels are not built for: zero padding along D
# ---------------------------------------------------------------------------


def kernel_head_dim(D: int) -> int:
    """The kernels' width for a head of width D: the smallest of
    HEAD_DIMS that holds it, or D itself where it is a multiple of
    WIDE_CHUNK (the wide kernels). Any other D raises, by the JAX package's
    rule."""
    for width in HEAD_DIMS:
        if D <= width:
            return width
    if D % WIDE_CHUNK:
        raise NotImplementedError(
            f"head_dim {D} > {HEAD_DIMS[-1]} must be a multiple of "
            f"{WIDE_CHUNK}")
    return D


def pad_head(t: torch.Tensor, width: int) -> torch.Tensor:
    """`t` with zeros appended along its last (head) axis up to `width`."""
    D = t.shape[-1]
    return t if D == width else torch.nn.functional.pad(t, (0, width - D))


def _cut(t: torch.Tensor, D: int) -> torch.Tensor:
    return t if t.shape[-1] == D else t[..., :D].contiguous()


def padded_forward(fwd, q, k, v, causal: bool, q_off: int):
    """`fwd` (K1's wrapper, or its plain version) on q, k, v zero-padded
    along D to the kernels' width, with D's own scale; O cut back to D."""
    D = q.shape[-1]
    width = kernel_head_dim(D)
    o, lse = fwd(pad_head(q, width), pad_head(k, width),
                 pad_head(v, width), causal, q_off, scale=D ** -0.5)
    return _cut(o, D), lse


def padded_backward(dq_fn, dkv_fn, q, k, v, o, do, lse, causal: bool,
                    q_off: int):
    """K2 then K3 (or their plain versions) on zero-padded tensors, with
    D's own scale; dQ, dK and dV cut back to D."""
    D = q.shape[-1]
    width = kernel_head_dim(D)
    qp, kp, vp = pad_head(q, width), pad_head(k, width), pad_head(v, width)
    dop = pad_head(do, width)
    dq, delta = dq_fn(qp, kp, vp, pad_head(o, width), dop, lse, causal,
                      q_off, scale=D ** -0.5)
    dk, dv = dkv_fn(qp, kp, vp, dop, lse, delta, causal, q_off,
                    scale=D ** -0.5)
    return _cut(dq, D), _cut(dk, D), _cut(dv, D)


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
    kernel_head_dim(q.shape[-1])  # refuses what the JAX package refuses
    if q.is_cuda:
        return padded_forward(flash_fwd, q, k, v, causal, q_off)
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
        dq, dk, dv = padded_backward(flash_dq, flash_dkv, q, k, v, o,
                                     do.contiguous(), lse, causal, q_off)
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
    _refuse_dtensors(q, k, v)
    return attention_op(q, k, v, bool(causal), int(q_offset or 0))[0]


def _refuse_dtensors(*tensors: torch.Tensor) -> None:
    """The kernels take a rank's local tensors. A DTensor is refused, never
    redistributed: gathering it would run the kernel on every rank's
    whole batch and heads."""
    if not torch.distributed.is_available():
        return
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(
            "voda::flash_attention takes local tensors, got a DTensor: "
            "shard the projections with use_local_output=True "
            "(parallel/sharding.py) or pass DTensor.to_local()")


def make_flash_attention(mesh=None, causal: bool = True):
    """`attn_fn` for a sharded session: K1–K3 on this rank's local
    [B/(dp·fsdp), S, H/tp, D] tensors. Counterpart of the reference's
    `make_flash_attention` (B4a), which shard_maps the kernel over the
    data and tp axes. Here the layers already hold local tensors (tp's
    projections give local outputs, each data rank its own rows), so the
    function is the kernel itself; `mesh` is accepted for the reference's
    signature.

    Divergence: the reference falls back to the plain attention where the
    batch or the heads do not divide the mesh. The port does not: the
    sharding rules keep whole the projections whose heads tp does not
    divide, and a batch that does not divide the data axes is refused
    when the session starts, so the kernel runs on whatever local heads
    there are."""
    del mesh
    return functools.partial(flash_attention, causal=causal)
