"""A plain PyTorch model of the arithmetic of the forward above D=512
(``vodascheduler_tpu_torch/ops/csrc/flash_fwd_wide.cu``,
``flash_fwd_chunked_kernel``, which ``voda_flash_fwd_wide`` and
``voda_flash_fwd_f16_wide`` launch there), written apart from the package so
that the tests hold the kernel's design, and the kernel itself, against it.

A CTA owns 128 query rows and a chunk of O's columns (`tiling`: CW = 256
where D divides by 256, else 128) and walks the key tiles of BN keys (64 at
CW=256, 128 at CW=128) up to the last one its last row sees under the
causal mask. Per tile:

- S = Q·Kᵀ sums in fp32 over D's 128-column chunks, chunk by chunk, each
  chunk's product of the T values in fp32;
- keys past Sk and keys past a row's diagonal are masked to the finite
  NEG_INF;
- the online softmax in log2 units: m' = max(m, rowmax(S)·scale·log2e),
  corr = 2^(m − m'), P = 2^(S·scale·log2e − m'), l = l·corr + rowsum(P)
  (P in fp32);
- O's chunk = O's chunk·corr + P·V, with P rounded to T and V's chunk of
  columns, summed in fp32.

O = acc / l is rounded to T (a row with l = 0 keeps 0), lse = m·ln2 +
ln l in fp32. `drop_chunk` leaves one chunk of D out of every S and
``correct=False`` skips O's correction: the planted faults of the kernel,
which the tests show breaking the bars.
"""

import torch

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG_INF = -1e30
BM = 128  # query rows of a CTA
KC = 128  # columns of D in one chunk of S


def tiling(D: int):
    """(CW, BN): the width of a CTA's chunk of O and the keys of a tile
    (`FwdChunked<CW>`)."""
    cw = 256 if D % 256 == 0 else 128
    return cw, 64 if cw == 256 else 128


def fwd(q, k, v, causal: bool, q_off: int, scale: float,
        drop_chunk=None, correct: bool = True):
    """(O [B,Sq,H,D] in q's dtype, lse fp32 [B,H,Sq]) as the kernel
    computes them from q, k, v [B,S,H,D] of bf16 or fp16."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    cw, bn = tiling(D)
    dtype = q.dtype
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    n_tiles = -(-Sk // bn)
    pad = n_tiles * bn - Sk  # keys past Sk arrive as zeros
    kf = torch.nn.functional.pad(kf, (0, 0, 0, pad))
    vf = torch.nn.functional.pad(vf, (0, 0, 0, pad))
    sl2 = scale * LOG2E
    o = torch.zeros(B, H, Sq, D)
    lse = torch.empty(B, H, Sq)
    for q0 in range(0, Sq, BM):
        q1 = min(q0 + BM, Sq)
        rows = q_off + torch.arange(q0, q1)
        n_k = min(n_tiles, (q_off + q1 - 1) // bn + 1) if causal else n_tiles
        m = torch.full((B, H, q1 - q0), NEG_INF)
        l = torch.zeros(B, H, q1 - q0)
        acc = torch.zeros(B, H, q1 - q0, D)
        for j in range(n_k):
            keys = slice(j * bn, (j + 1) * bn)
            s = torch.zeros(B, H, q1 - q0, bn)
            for c in range(D // KC):
                if c != drop_chunk:
                    cols = slice(c * KC, (c + 1) * KC)
                    s = s + qf[:, :, q0:q1, cols] @ kf[:, :, keys, cols] \
                        .transpose(-1, -2)
            col = j * bn + torch.arange(bn)
            mask = (col[None, :] >= Sk) | (causal & (rows[:, None] < col[None, :]))
            s = s.masked_fill(mask, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1) * sl2)
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s * sl2 - m_new[..., None])
            l = l * corr + p.sum(-1)
            pt = p.to(dtype).float()
            for c0 in range(0, D, cw):
                part = acc[..., c0:c0 + cw]
                if correct:
                    part = part * corr[..., None]
                acc[..., c0:c0 + cw] = part + pt @ vf[:, :, keys, c0:c0 + cw]
            m = m_new
        safe_l = torch.where(l == 0, torch.ones_like(l), l)
        o[:, :, q0:q1] = acc / safe_l[..., None]
        lse[:, :, q0:q1] = torch.where(m == NEG_INF,
                                       torch.full_like(m, NEG_INF),
                                       m * LN2 + torch.log(safe_l))
    return o.transpose(1, 2).to(dtype), lse
