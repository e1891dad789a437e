"""A plain PyTorch model of the fp16 dK/dV and dQ kernels' arithmetic
(``vodascheduler_tpu_torch/ops/csrc/flash_dkv.cu``, ``voda_flash_dkv_f16``,
and ``flash_dkv_wide.cu``, ``voda_flash_dkv_f16_wide``; `dq` below),
written apart from the package so that the tests hold the kernels'
design, and the kernels themselves, against it.

A kernel walks the query tiles of BM rows past each block of keys, from
the first tile whose last row reaches the block under the causal mask
(`tiling`: the narrow kernel's blocks of 128 keys against 64 query rows at
D=64 and 32 at D=128; the wide kernel's blocks of 64 keys against 64 query
rows at D=256 and 32 at 384 and 512, where its two warpgroups share each
row's exponent). Per tile it forms Pᵀ = exp(K·Qᵀ·scale − lse) and
dSᵀ/scale = Pᵀ∘(V·dOᵀ − δ) in fp32, and for each key row j:

- m = max |dSᵀ/scale| over the tile's row, times scale;
- where m > 0, e_j falls to DS_TOP − ⌊log2 m⌋ if that is lower (from
  E_MAX; never below −E_MAX), and the row of dK's fp32 accumulator is
  multiplied by 2^(new − old);
- dSᵀ·scale·2^e_j is rounded to fp16 and multiplied by Q (fp16), Pᵀ is
  rounded to fp16 and multiplied by dO, both summed in fp32;
- dK is the accumulator times 2^−e_j.

`dkv` returns dK and dV in fp32, before the kernel rounds them to fp16.
``scaled=False`` rounds dS to fp16 as it stands (the Pallas kernel's
``ds.astype(q.dtype)``), which is what the scale repairs.

`dq` models the fp16 dQ kernels (``flash_dq.cu``, ``voda_flash_dq_f16``,
and ``flash_dq_wide.cu``, ``voda_flash_dq_f16_wide``) the same way, on
query rows: a block of query rows walks the key tiles up to the last one
its last row sees under the causal mask (`dq_tiling`: the narrow kernel's
128 rows against 64-key tiles; the wide kernel's 64 rows against 64-key
tiles at D=256 and 32 at 384 and 512, where its two warpgroups share each
row's exponent). Per tile it forms P·scale = exp2(Q·Kᵀ·scale·log2e −
(lse·log2e − log2 scale)) and dS = P·scale∘(dO·Vᵀ − δ) in fp32, and for
each query row i: m = max |dS| over the tile's row; where m > 0, e_i falls
as above and the row of dQ's accumulator is rescaled; dS·2^e_i is rounded
to fp16 and multiplied by K (fp16), summed in fp32; dQ is the accumulator
times 2^−e_i.
"""

import math

import torch

DS_TOP = 13
E_MAX = 100
LOG2E = 1.4426950408889634


def tiling(D: int):
    """(keys of a block, query rows of a tile) of the fp16 kernel that
    takes head width D: flash_dkv.cu's up to 128, flash_dkv_wide.cu's
    (`DkvWide::BN`, `DkvWide::BM`) from 256 to 512."""
    if D <= 128:
        return 128, 64 if D == 64 else 32
    return 64, 64 if D == 256 else 32


def dq_tiling(D: int):
    """(query rows of a block, keys of a tile) of the fp16 dQ kernel that
    takes head width D: flash_dq.cu's (`Dq::BM`, `Dq::BN`) up to 128,
    flash_dq_wide.cu's (`DqWide::BM`, `DqWide::BN`) from 256 to 512."""
    if D <= 128:
        return 128, 64
    return 64, 64 if D == 256 else 32


def _binade(m: torch.Tensor) -> torch.Tensor:
    """⌊log2 m⌋ of positive fp32 m, as the kernel reads it from the bits (a
    subnormal reads as −127)."""
    return ((m.view(torch.int32) >> 23) & 0xFF) - 127


def dkv(q, k, v, do, lse, delta, causal: bool, q_off: int, scale: float,
        scaled: bool = True):
    """dK, dV [B, Sk, H, D] fp32 as the fp16 kernel of width D computes
    them, at its `tiling`. q, k, v, do are fp16 [B, S, H, D]; lse and delta
    fp32 [B, H, Sq]."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    key_block, BM = tiling(D)
    qf, kf, vf, dof = (t.float().transpose(1, 2) for t in (q, k, v, do))
    dk = torch.zeros(B, H, Sk, D)
    dv = torch.zeros(B, H, Sk, D)
    sc = torch.tensor(scale, dtype=torch.float32)
    for k0 in range(0, Sk, key_block):
        keys = torch.arange(k0, min(k0 + key_block, Sk))
        kb, vb = kf[:, :, keys], vf[:, :, keys]
        ex = torch.full((B, H, len(keys)), E_MAX, dtype=torch.int32)
        acc_k = torch.zeros(B, H, len(keys), D)
        acc_v = torch.zeros(B, H, len(keys), D)
        i0 = max(0, k0 - q_off) // BM if causal else 0
        for q0 in range(i0 * BM, Sq, BM):
            rows = torch.arange(q0, min(q0 + BM, Sq))
            qt, dot = qf[:, :, rows], dof[:, :, rows]
            st = kb @ qt.transpose(-1, -2) * (sc * LOG2E) \
                - (lse[:, :, rows] * LOG2E)[:, :, None, :]
            if causal:
                st = st.masked_fill(
                    (q_off + rows)[None, :] < keys[:, None], -math.inf)
            pt = torch.exp2(st)
            u = pt * (vb @ dot.transpose(-1, -2)
                      - delta[:, :, rows][:, :, None, :])
            if scaled:
                en = _exponents(ex, u.abs().amax(-1) * sc)
                acc_k *= torch.exp2(torch.clamp(en - ex, min=-126)
                                    .float())[..., None]
                ex = en
                ds = u * (sc * torch.exp2(ex.float()))[..., None]
            else:
                ds = u * sc
            acc_k += ds.half().float() @ qt
            acc_v += pt.half().float() @ dot
        if scaled:
            acc_k *= torch.exp2(-ex.float())[..., None]
        dk[:, :, keys], dv[:, :, keys] = acc_k, acc_v
    return dk.transpose(1, 2), dv.transpose(1, 2)


def _exponents(ex, m):
    """The rows' exponents after a tile whose largest |dS| in each row is m
    (`ds_exponent`)."""
    et = DS_TOP - _binade(m)
    return torch.where(m > 0, torch.clamp(torch.minimum(ex, et), min=-E_MAX),
                       ex)


def dq(q, k, v, do, lse, delta, causal: bool, q_off: int, scale: float,
       scaled: bool = True):
    """dQ [B, Sq, H, D] fp32 as the fp16 dQ kernel of width D computes it,
    at its `dq_tiling`. q, k, v, do are fp16 [B, S, H, D]; lse and delta
    fp32 [B, H, Sq]."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    BM, BN = dq_tiling(D)
    qf, kf, vf, dof = (t.float().transpose(1, 2) for t in (q, k, v, do))
    out = torch.zeros(B, H, Sq, D)
    sc = torch.tensor(scale, dtype=torch.float32)
    sl2 = sc * LOG2E
    lse2 = lse * LOG2E - torch.log2(sc)
    for q0 in range(0, Sq, BM):
        rows = torch.arange(q0, min(q0 + BM, Sq))
        qt, dot = qf[:, :, rows], dof[:, :, rows]
        n_k = -(-Sk // BN)
        if causal:
            n_k = min(n_k, (q_off + rows[-1].item()) // BN + 1)
        ex = torch.full((B, H, len(rows)), E_MAX, dtype=torch.int32)
        acc = torch.zeros(B, H, len(rows), D)
        for k0 in range(0, n_k * BN, BN):
            keys = torch.arange(k0, min(k0 + BN, Sk))
            kb, vb = kf[:, :, keys], vf[:, :, keys]
            s = qt @ kb.transpose(-1, -2) * sl2 \
                - lse2[:, :, rows][..., None]
            if causal:
                s = s.masked_fill(
                    (q_off + rows)[:, None] < keys[None, :], -math.inf)
            u = torch.exp2(s) * (dot @ vb.transpose(-1, -2)
                                 - delta[:, :, rows][..., None])
            if scaled:
                en = _exponents(ex, u.abs().amax(-1))
                acc *= torch.exp2(torch.clamp(en - ex, min=-126)
                                  .float())[..., None]
                ex = en
                ds = u * torch.exp2(ex.float())[..., None]
            else:
                ds = u
            acc += ds.half().float() @ kb
        if scaled:
            acc *= torch.exp2(-ex.float())[..., None]
        out[:, :, rows] = acc
    return out.transpose(1, 2)


def small_gradient_inputs(rng, B=1, S=128, H=2, D=64, q_mult=1 / 64):
    """An unscaled loss's backward in fp16: dO of 1e-6, which puts dS near
    1e-8 (below fp16's smallest normal, 6e-5). Q is multiplied by `q_mult`
    and K divided by it, which leaves S as it is; 1/64 (the CUDA-core
    kernels' test) puts dQ = dS·K among fp16's normal numbers, 64 does so
    for dK = dSᵀ·Q. Returns fp16 (q, k, v, do)."""
    q, k, v = (rng.standard_normal((B, S, H, D)) for _ in range(3))
    do = 1e-6 * rng.standard_normal((B, S, H, D))
    return tuple(torch.from_numpy(x.astype("float16"))
                 for x in (q * q_mult, k / q_mult, v, do))
