"""A plain PyTorch model of the fp32 tensor-core kernels' arithmetic
(``vodascheduler_tpu_torch/ops/csrc/flash_f32.cu``: the forward,
``voda_flash_fwd_f32``, dQ, ``voda_flash_dq_f32``, and dK/dV,
``voda_flash_dkv_f32``), written apart from the package so that the tests
hold the kernels' design, and the kernels themselves, against it.

Every product a·b of fp32 inputs is three TF32 products summed in fp32:
hi = tf32(x), lo = tf32(x − hi), a·b ≈ a_lo·b_hi + a_hi·b_lo + a_hi·b_hi,
each k-step of 8 terms in that order. `tf32` rounds to nearest with ties
away from zero (the kernels' ``cvt.rna.tf32.f32``) by the fp32 bits:
``(bits + 0x1000) & ~0x1FFF``. ``passes=1`` keeps hi·hi alone, what the
kernels compute without the lo terms.

`fwd` walks the key tiles of a kernel's tiling (`fwd_tiling`: 64 keys at
D=64, 32 at D=128, 64 above) with the online softmax: S = Q·Kᵀ, the running
max and sum, P = exp(S·scale − m) split and multiplied by V with the keys
of each k-step in the kernel's order PERM (Vᵀ's order in the kernel's
scratch), O rescaled by each tile's correction. Inputs and outputs are
[B, S, H, D] fp32 (lse and δ [B, H, Sq]), as the kernels take them.

Above D=128 the forward (``voda_flash_fwd_f32_wide``) sums S over D chunk
by chunk of WIDE_KC columns into one accumulator, in the same k-steps in
the same order, and owns WIDE_CW columns of O a CTA, each CTA computing the
same S: `fwd` does the same at those widths (`cut`), and `drop_chunk`
leaves one chunk of D out of every S, as a kernel that skipped a stage's
products would.

`dkv` models K3 (``voda_flash_dkv_f32``, ``voda_flash_dkv_f32_wide``: one
kernel at every width) at its tiling: for each query tile of `dkv_tiling`
rows (64 at D=64, 32 from D=128), the last tile first, as the kernel
walks them, Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ over D's
WIDE_KC-column chunks, each chunk's three passes summed apart (the small
terms first) and the chunks' sums added in fp32 (`mm3_parts`); Pᵀ =
exp(Sᵀ·scale − lse), dSᵀ = Pᵀ∘(dPᵀ − δ)·scale, then dV += Pᵀ·dO and dK +=
dSᵀ·Q in three passes a k-step with the queries of each k-step in the
order PERM (Qᵀ's and dOᵀ's order in the kernel's scratch), over min(D,
WIDE_CW) columns of the output a CTA, each CTA computing the same Sᵀ and
dPᵀ (`bwd_cut`).

`dq` models K2 (``voda_flash_dq_f32``, ``voda_flash_dq_f32_wide``: one
kernel at every width) at its tiling: for each tile of DQ_BN keys, S =
Q·Kᵀ and dP = dO·Vᵀ over D's WIDE_KC-column chunks, each chunk's three
passes summed apart (the small terms first) and the chunks' sums added in
fp32 (`mm3_parts`);
P·scale = exp(S·scale − lse)·scale, dS = P·scale∘(dP − δ), then dQ += dS·K
in three passes with the keys of each k-step in the order PERM (Kᵀ's order
in the kernel's scratch), over min(D, WIDE_CW) columns of dQ a CTA, each
CTA computing the same S and dP (`bwd_cut`). δ = rowsum(dO∘O) in fp32.
"""

import torch

# Logical column j of a k-step holds physical column PERM[j] (flash_f32.cu's
# perm8): the A fragment of a TF32 k-step holds columns t and t+4 of a row,
# the accumulator 2t and 2t+1.
PERM = (0, 2, 4, 6, 1, 3, 5, 7)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 `x` rounded to TF32 (10 stored mantissa bits), to nearest with
    ties away from zero; the low 13 bits of the result are 0."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    """(hi, lo): x's TF32 value and the TF32 value of what it leaves."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a: torch.Tensor, b: torch.Tensor, passes: int = 3,
        acc: torch.Tensor = None) -> torch.Tensor:
    """acc + a·b over the last axis of `a` and the second last of `b`, in
    k-steps of 8, each as a_lo·b_hi + a_hi·b_lo + a_hi·b_hi (passes=3) or
    a_hi·b_hi (passes=1), accumulated in fp32 in that order."""
    ah, al = split(a)
    bh, bl = split(b)
    out = acc if acc is not None else torch.zeros(
        *a.shape[:-1], b.shape[-1], dtype=torch.float32)
    terms = ((al, bh), (ah, bl), (ah, bh)) if passes == 3 else ((ah, bh),)
    for k0 in range(0, a.shape[-1], 8):
        for x, y in terms:
            out = out + x[..., k0:k0 + 8] @ y[..., k0:k0 + 8, :]
    return out


def perm_index(n: int) -> torch.Tensor:
    """The order PERM within each group of 8 of an axis of n (a multiple of
    8) entries."""
    base = torch.arange(0, n, 8)[:, None]
    return (base + torch.tensor(PERM)[None, :]).reshape(-1)


# Above D=128: columns of O a CTA of the forward owns (`FwdF32Wide`: CW);
# at every width, of dQ and of dK and dV (`DqF32`, `DkvF32`: min(D, CW));
# columns of D a stage holds (KC).
WIDE_CW = 128
WIDE_KC = 32


def fwd_tiling(D: int) -> int:
    """Keys of a K/V tile of the fp32 forward at head width D (`Fwd::BN`,
    `FwdF32Wide::BN` above 128)."""
    return 32 if D == 128 else 64


def dkv_tiling(D: int) -> int:
    """Query rows of a Q/dO tile of the fp32 dK/dV (`DkvF32::BM`: 64 at
    CW = 64, 32 at CW = 128)."""
    return 64 if bwd_cut(D)[0] == 64 else 32


def cut(D: int):
    """(columns of O a CTA of the forward owns, columns of D a stage
    holds) at head width D: the whole of D up to 128, (WIDE_CW, WIDE_KC)
    above."""
    return (D, D) if D <= 128 else (WIDE_CW, WIDE_KC)


def bwd_cut(D: int):
    """(columns of the output a CTA owns, columns of D a stage holds) of K2
    and K3 at head width D: (min(D, WIDE_CW), WIDE_KC) at every width."""
    return min(D, WIDE_CW), WIDE_KC


def mm3_chunks(a: torch.Tensor, b: torch.Tensor, passes: int, kc: int,
               drop_chunk=None) -> torch.Tensor:
    """a·b over the last axis of `a` (D) as the kernels sum it: chunk by
    chunk of kc columns, each in mm3's k-steps, into one accumulator;
    chunk `drop_chunk` (an index, or None) left out."""
    out = None
    for c0 in range(0, a.shape[-1], kc):
        if c0 // kc == drop_chunk:
            continue
        out = mm3(a[..., c0:c0 + kc], b[..., c0:c0 + kc, :], passes, out)
    return out


def _mask(rows: torch.Tensor, cols: torch.Tensor, Sq: int, Sk: int,
          causal: bool, q_off: int) -> torch.Tensor:
    """True where the (query, key) pair is masked out."""
    off = (cols[None, :] >= Sk) | (rows[:, None] >= Sq)
    if causal:
        off = off | (q_off + rows[:, None] < cols[None, :])
    return off


def _pad(x: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """`x` with zeros along `axis` up to length n (as TMA fills a tile
    past the end of a tensor)."""
    extra = n - x.shape[axis]
    if extra <= 0:
        return x
    shape = list(x.shape)
    shape[axis] = extra
    return torch.cat([x, x.new_zeros(shape)], axis)


def fwd(q, k, v, causal: bool, q_off: int, scale: float, passes: int = 3,
        drop_chunk=None):
    """(o [B,Sq,H,D], lse [B,H,Sq]) as the fp32 forward computes them: for
    each chunk of O's columns (`cut`), the key tiles with the online
    softmax, S summed over D's chunks."""
    q, k, v = (t.float().transpose(1, 2) for t in (q, k, v))  # [B,H,S,D]
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    BN = fwd_tiling(D)
    cw, kc = cut(D)
    nk = -(-Sk // BN)
    k, v = _pad(k, 2, nk * BN), _pad(v, 2, nk * BN)
    rows = torch.arange(Sq)
    order = perm_index(BN)
    outs = []
    for c0 in range(0, D, cw):  # the CTAs of a row block
        m = torch.full((B, H, Sq, 1), -float("inf"))
        l = torch.zeros(B, H, Sq, 1)
        acc = torch.zeros(B, H, Sq, cw)
        for j in range(nk):
            cols = j * BN + torch.arange(BN)
            s = mm3_chunks(q, k[:, :, j * BN:(j + 1) * BN].transpose(-1, -2),
                           passes, kc, drop_chunk) * scale
            s = s.masked_fill(_mask(rows, cols, Sq, Sk, causal, q_off),
                              -float("inf"))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            live = m_new > -float("inf")
            corr = torch.where(live, torch.exp(m - m_new),
                               torch.ones_like(m))
            p = torch.where(live, torch.exp(s - m_new), torch.zeros_like(s))
            l = l * corr + p.sum(-1, keepdim=True)
            vt = v[:, :, j * BN:(j + 1) * BN, c0:c0 + cw]
            acc = mm3(p[..., order], vt[:, :, order], passes, acc * corr)
            m = m_new
        safe = torch.where(l == 0, torch.ones_like(l), l)
        outs.append(acc / safe)
    o = torch.cat(outs, -1)
    lse = torch.where(m > -float("inf"), m + torch.log(safe),
                      torch.full_like(m, -1e30))
    return o.transpose(1, 2).contiguous(), lse.squeeze(-1)


def dkv(q, k, v, do, lse, delta, causal: bool, q_off: int, scale: float,
        passes: int = 3, drop_chunk=None):
    """(dk, dv), each [B,Sk,H,D] fp32, as fp32's K3 computes them on the
    given lse and δ: for each chunk of the output's columns (`bwd_cut`),
    the query tiles, Sᵀ and dPᵀ summed over D's chunks apart
    (`mm3_parts`)."""
    q, k, v, do = (t.float().transpose(1, 2) for t in (q, k, v, do))
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    BM = dkv_tiling(D)
    cw, kc = bwd_cut(D)
    nq = -(-Sq // BM)
    q, do = _pad(q, 2, nq * BM), _pad(do, 2, nq * BM)
    lse, delta = (_pad(t.float(), 2, nq * BM) for t in (lse, delta))
    keys = torch.arange(Sk)
    order = perm_index(BM)
    dks, dvs = [], []
    for c0 in range(0, D, cw):  # the CTAs of a key block
        dk = torch.zeros(B, H, Sk, cw)
        dv = torch.zeros(B, H, Sk, cw)
        for i in reversed(range(nq)):  # the kernel's order: the last first
            rows = i * BM + torch.arange(BM)
            qt = q[:, :, i * BM:(i + 1) * BM]
            dot = do[:, :, i * BM:(i + 1) * BM]
            st = mm3_parts(k, qt.transpose(-1, -2), passes, kc,
                           drop_chunk)                       # [B,H,Sk,BM]
            dpt = mm3_parts(v, dot.transpose(-1, -2), passes, kc,
                            drop_chunk)
            off = _mask(rows, keys, Sq, Sk, causal, q_off).transpose(0, 1)
            p = torch.exp(st * scale - lse[:, :, None, i * BM:(i + 1) * BM])
            p = p.masked_fill(off, 0.0)
            ds = p * (dpt - delta[:, :, None, i * BM:(i + 1) * BM]) * scale
            dv = mm3(p[..., order], dot[:, :, order, c0:c0 + cw], passes, dv)
            dk = mm3(ds[..., order], qt[:, :, order, c0:c0 + cw], passes, dk)
        dks.append(dk)
        dvs.append(dv)
    dk, dv = torch.cat(dks, -1), torch.cat(dvs, -1)
    return (dk.transpose(1, 2).contiguous(), dv.transpose(1, 2).contiguous())


# K2's keys of a tile (`DqF32::BN`).
DQ_BN = 64


def mm3_small_first(a: torch.Tensor, b: torch.Tensor,
                    passes: int = 3) -> torch.Tensor:
    """a·b over the last axis of `a` in k-steps of 8, as K2 and K3 order one
    chunk's products: every k-step's a_lo·b_hi and a_hi·b_lo first, then
    every k-step's a_hi·b_hi (passes=3); a_hi·b_hi alone (passes=1)."""
    ah, al = split(a)
    bh, bl = split(b)
    out = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32)
    small = ((al, bh), (ah, bl)) if passes == 3 else ()
    for terms in (small, ((ah, bh),)):
        for k0 in range(0, a.shape[-1], 8):
            for x, y in terms:
                out = out + x[..., k0:k0 + 8] @ y[..., k0:k0 + 8, :]
    return out


def mm3_parts(a: torch.Tensor, b: torch.Tensor, passes: int, kc: int,
              drop_chunk=None) -> torch.Tensor:
    """a·b over the last axis of `a` (D) as K2 and K3 sum it: each chunk of kc
    columns into an accumulator of its own (`mm3_small_first`), the chunks'
    sums added in fp32 in order; chunk `drop_chunk` (an index, or None)
    left out."""
    out = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32)
    for c0 in range(0, a.shape[-1], kc):
        if c0 // kc != drop_chunk:
            out = out + mm3_small_first(a[..., c0:c0 + kc],
                                        b[..., c0:c0 + kc, :], passes)
    return out


def dq(q, k, v, o, do, lse, causal: bool, q_off: int, scale: float,
       passes: int = 3, drop_chunk=None):
    """(dq [B,Sq,H,D], delta [B,H,Sq]) as fp32's K2 computes them on the
    given o and lse: for each chunk of dQ's columns (`bwd_cut`), the key
    tiles, S and dP summed over D's chunks apart (`mm3_parts`)."""
    q, k, v, o, do = (t.float().transpose(1, 2) for t in (q, k, v, o, do))
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    cw, kc = bwd_cut(D)
    nk = -(-Sk // DQ_BN)
    k, v = _pad(k, 2, nk * DQ_BN), _pad(v, 2, nk * DQ_BN)
    delta = (do * o).sum(-1)
    rows = torch.arange(Sq)
    order = perm_index(DQ_BN)
    outs = []
    for c0 in range(0, D, cw):  # the CTAs of a row block
        acc = torch.zeros(B, H, Sq, cw)
        for j in range(nk):
            cols = j * DQ_BN + torch.arange(DQ_BN)
            kj = k[:, :, j * DQ_BN:(j + 1) * DQ_BN]
            vj = v[:, :, j * DQ_BN:(j + 1) * DQ_BN]
            s = mm3_parts(q, kj.transpose(-1, -2), passes, kc, drop_chunk)
            dp = mm3_parts(do, vj.transpose(-1, -2), passes, kc, drop_chunk)
            p = torch.exp(s * scale - lse.float()[..., None]) * scale
            p = p.masked_fill(_mask(rows, cols, Sq, Sk, causal, q_off), 0.0)
            ds = p * (dp - delta[..., None])
            acc = mm3(ds[..., order], kj[:, :, order, c0:c0 + cw], passes,
                      acc)
        outs.append(acc)
    return (torch.cat(outs, -1).transpose(1, 2).contiguous(),
            delta.contiguous())
