"""A plain PyTorch model of the arithmetic of dQ and dK/dV above D=512
(``vodascheduler_tpu_torch/ops/csrc/flash_dq_wide.cu``,
``flash_dq_chunked_kernel``, and ``flash_dkv_wide.cu``,
``flash_dkv_chunked_kernel``, which the wide entries launch there, in fp16
and in bf16), written apart from the package so that the tests hold the
kernels' design, and the kernels themselves, against it.

The type of the kernel's tensors (`dtype`: fp16 by default, or bf16) is
the type it rounds P and dS to. In fp16, dS is rounded under the per-row
power of two below; in bf16, which keeps fp32's exponent range, P and dS
are rounded as they stand (the Pallas kernels' ``astype``), with no
exponent.

`dq`: a CTA owns 64 query rows and a chunk of dQ's columns (`cw`: 256
where D divides by 256, else 128) and walks the key tiles of 128 keys up
to the last one its last row sees under the causal mask. Per tile:

- S = Q·Kᵀ and dP = dO·Vᵀ sum in fp32 over D's 64-column chunks, chunk by
  chunk, each chunk's product of the fp16 values in fp32;
- keys past Sk and keys past a row's diagonal are masked to the finite
  NEG_INF; P·scale = 2^(S·scale·log2e − (lse·log2e − log2 scale)) and
  dS = P·scale∘(dP − δ) in fp32;
- for each query row i: m = max |dS| over the tile's row; where m > 0,
  e_i falls to DS_TOP − ⌊log2 m⌋ if that is lower (from E_MAX; never below
  −E_MAX), and the row of dQ's fp32 accumulator is multiplied by
  2^(new − old);
- dS·2^e_i is rounded to fp16, and dQ's chunk += that times K's chunk of
  columns (fp16), summed in fp32 (bf16: dS rounded to bf16, no exponent).

dQ is the accumulator times 2^−e_i. Every CTA of a row block forms the
same dS, so one pass over the rows stands for all of them.

`dkv`: a CTA owns 64 keys and a chunk of dK's and dV's columns (`cw`) and
walks the query tiles of 64 rows from the first one whose last row reaches
its first key. Per tile Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ sum over the same
64-column chunks, Pᵀ = 2^(Sᵀ·scale·log2e − lse·log2e) (masked entries 0),
dSᵀ/scale = Pᵀ∘(dPᵀ − δ); for each key row j the exponent e_j falls as
above on m = max |dSᵀ/scale| · scale, dK's row rescaled; dSᵀ·scale·2^e_j
rounded to fp16 times Q's chunk, Pᵀ rounded to fp16 times dO's chunk,
summed in fp32. dK is the accumulator times 2^−e_j.

Both return fp32, before the kernels round to their dtype. The planted
faults of the kernels, which the tests show breaking the bars:
``drop_chunk`` leaves one chunk of D out of every S (Sᵀ), ``rescale=False``
lowers an exponent without rescaling what the row has summed;
``scaled=False`` rounds dS to fp16 as it stands (the Pallas kernels'
``ds.astype``), which is what the scale repairs (bf16 never scales).
"""

import torch

from torch_f16_dkv_model import E_MAX, LOG2E, _exponents

NEG_INF = -1e30
KC = 64  # columns of D in one chunk of the sums
DQ_TILES = (64, 128)   # (query rows of a CTA, keys of a tile): `DqChunked`
DKV_TILES = (64, 64)   # (keys of a CTA, query rows of a tile): `DkvChunked`


def cw(D: int) -> int:
    """The columns of the output a CTA owns (`DqChunked<CW>`,
    `DkvChunked<CW>`: `dq_chunked`, `cw_dkv`)."""
    return 256 if D % 256 == 0 else 128


def _sums(a, b, x, y, drop_chunk):
    """a·bᵀ and x·yᵀ summed over D's KC-column chunks, chunk by chunk; the
    first sum leaves chunk `drop_chunk` out."""
    D = a.shape[-1]
    s = torch.zeros(*a.shape[:-1], b.shape[-2])
    t = torch.zeros(*x.shape[:-1], y.shape[-2])
    for c in range(D // KC):
        cols = slice(c * KC, (c + 1) * KC)
        if c != drop_chunk:
            s = s + a[..., cols] @ b[..., cols].transpose(-1, -2)
        t = t + x[..., cols] @ y[..., cols].transpose(-1, -2)
    return s, t


def _floats(*ts):
    return (t.float().transpose(1, 2) for t in ts)


def bf16_small_gradient_inputs(rng, B=1, S=128, H=2, D=640):
    """An unscaled loss's backward in bf16: dO of 1e-6, which puts dS near
    1e-8, among bf16's normal numbers (its range is fp32's), so Q and K
    stay as drawn. Returns bf16 (q, k, v, do)."""
    q, k, v = (rng.standard_normal((B, S, H, D)) for _ in range(3))
    do = 1e-6 * rng.standard_normal((B, S, H, D))
    return tuple(torch.from_numpy(x.astype("float32")).bfloat16()
                 for x in (q, k, v, do))


def _scaled(dtype, scaled: bool) -> bool:
    """Whether dS is rounded under the per-row power of two: in fp16 unless
    `scaled` is False, never in bf16."""
    if dtype not in (torch.float16, torch.bfloat16):
        raise TypeError(f"the chunked kernels take fp16 and bf16, not {dtype}")
    return scaled and dtype == torch.float16


def dq(q, k, v, do, lse, delta, causal: bool, q_off: int, scale: float,
       drop_chunk=None, rescale: bool = True, scaled: bool = True,
       dtype=None):
    """dQ [B, Sq, H, D] fp32 as flash_dq_chunked_kernel computes it. q, k,
    v, do are [B, S, H, D] of `dtype` (default: q's dtype, fp16 or bf16);
    lse and delta fp32 [B, H, Sq]."""
    dtype = dtype or q.dtype
    scaled = _scaled(dtype, scaled)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    BM, BN = DQ_TILES
    width = cw(D)
    qf, kf, vf, dof = _floats(q, k, v, do)
    sc = torch.tensor(scale, dtype=torch.float32)
    sl2 = sc * LOG2E
    lse2 = lse * LOG2E - torch.log2(sc)
    n_tiles = -(-Sk // BN)
    out = torch.zeros(B, H, Sq, D)
    for q0 in range(0, Sq, BM):
        rows = torch.arange(q0, min(q0 + BM, Sq))
        n_k = n_tiles
        if causal:
            n_k = min(n_k, (q_off + rows[-1].item()) // BN + 1)
        ex = torch.full((B, H, len(rows)), E_MAX, dtype=torch.int32)
        acc = torch.zeros(B, H, len(rows), D)
        for j in range(n_k):
            keys = torch.arange(j * BN, min((j + 1) * BN, Sk))
            kb = kf[:, :, keys]
            s, dp = _sums(qf[:, :, rows], kb, dof[:, :, rows],
                          vf[:, :, keys], drop_chunk)
            if causal:
                s = s.masked_fill((q_off + rows)[:, None] < keys[None, :],
                                  NEG_INF)
            u = torch.exp2(s * sl2 - lse2[:, :, rows][..., None]) * (
                dp - delta[:, :, rows][..., None])
            if scaled:
                en = _exponents(ex, u.abs().amax(-1))
                if rescale:
                    acc *= torch.exp2(torch.clamp(en - ex, min=-126)
                                      .float())[..., None]
                ex = en
                ds = u * torch.exp2(ex.float())[..., None]
            else:
                ds = u
            ds = ds.to(dtype).float()
            for c0 in range(0, D, width):
                acc[..., c0:c0 + width] += ds @ kb[..., c0:c0 + width]
        if scaled:
            acc *= torch.exp2(-ex.float())[..., None]
        out[:, :, rows] = acc
    return out.transpose(1, 2)


def dkv(q, k, v, do, lse, delta, causal: bool, q_off: int, scale: float,
        drop_chunk=None, rescale: bool = True, scaled: bool = True,
        dtype=None):
    """dK, dV [B, Sk, H, D] fp32 as flash_dkv_chunked_kernel computes them.
    q, k, v, do are [B, S, H, D] of `dtype` (default: q's dtype, fp16 or
    bf16); lse and delta fp32 [B, H, Sq]."""
    dtype = dtype or q.dtype
    scaled = _scaled(dtype, scaled)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    BN, BM = DKV_TILES
    width = cw(D)
    qf, kf, vf, dof = _floats(q, k, v, do)
    sc = torch.tensor(scale, dtype=torch.float32)
    dk = torch.zeros(B, H, Sk, D)
    dv = torch.zeros(B, H, Sk, D)
    for k0 in range(0, Sk, BN):
        keys = torch.arange(k0, min(k0 + BN, Sk))
        ex = torch.full((B, H, len(keys)), E_MAX, dtype=torch.int32)
        acc_k = torch.zeros(B, H, len(keys), D)
        acc_v = torch.zeros(B, H, len(keys), D)
        i0 = max(0, k0 - q_off) // BM if causal else 0
        for q0 in range(i0 * BM, Sq, BM):
            rows = torch.arange(q0, min(q0 + BM, Sq))
            qt, dot = qf[:, :, rows], dof[:, :, rows]
            st, dpt = _sums(kf[:, :, keys], qt, vf[:, :, keys], dot,
                            drop_chunk)
            st = st * (sc * LOG2E) - (lse[:, :, rows] * LOG2E)[:, :, None, :]
            if causal:
                st = st.masked_fill(
                    (q_off + rows)[None, :] < keys[:, None], NEG_INF)
            pt = torch.exp2(st)
            u = pt * (dpt - delta[:, :, rows][:, :, None, :])
            if scaled:
                en = _exponents(ex, u.abs().amax(-1) * sc)
                if rescale:
                    acc_k *= torch.exp2(torch.clamp(en - ex, min=-126)
                                        .float())[..., None]
                ex = en
                ds = u * (sc * torch.exp2(ex.float()))[..., None]
            else:
                ds = u * sc
            ds, pt = ds.to(dtype).float(), pt.to(dtype).float()
            for c0 in range(0, D, width):
                cols = slice(c0, c0 + width)
                acc_k[..., cols] += ds @ qt[..., cols]
                acc_v[..., cols] += pt @ dot[..., cols]
        if scaled:
            acc_k *= torch.exp2(-ex.float())[..., None]
        dk[:, :, keys], dv[:, :, keys] = acc_k, acc_v
    return dk.transpose(1, 2), dv.transpose(1, 2)
