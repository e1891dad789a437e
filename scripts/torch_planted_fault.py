"""Shows that the bars of chip_smoke.py reject flash-attention kernels with
a planted fault, beside what the sound kernels read against them.

    python3 scripts/torch_planted_fault.py [FAULT ...]

Each fault is planted in a copy of ``vodascheduler_tpu_torch/ops/csrc``
under ``build/planted_fault/`` and built there; the sources of the package
are not touched. The faults sit where a bar held against the largest value
of a whole tensor cannot see them, in the late causal rows whose values are
small:

- ``fwd_last_tile``: K1 skips the P·V products of the last K/V tile it
  visits in the last 128-row query tile of every (batch, head). lse stays
  exact.
- ``dq_last_tile``: K2 skips dQ += dS·K for the last K/V tile it visits
  in the last 128-row query tile of every (batch, head). δ stays exact.
- ``dkv_last_tile``: K3 never accumulates dV for the last 128-key tile.
- ``dqw_last_tile``: the wide K2 (flash_dq_wide.cu) skips dQ += dS·K for
  the last K/V tile it visits in the last 64-row query tile of every
  (batch, head). δ stays exact.
- ``dkvw_f16_no_rescale``: fp16's wide K3 (flash_dkv_wide.cu) lowers a key
  row's exponent of dSᵀ but never rescales what dK's row has summed so
  far. bf16 does not compile that code.
- ``dq_f16_no_rescale``: fp16's K2 (flash_dq.cu) lowers a query row's
  exponent of dS but never rescales what dQ's row has summed so far.
- ``dqw_f16_no_rescale``: the same in fp16's wide K2 (flash_dq_wide.cu), in
  both warpgroups: warpgroup 0 still takes the exponents that warpgroup 1
  hands over (for its epilogue) but rescales nothing with them.
- ``f32_one_pass``: fp32's tensor-core kernels (flash_f32.cu) drop the lo
  terms of the three TF32 passes (every lo half is 0, in the CTAs and in
  the prologues' scratch), so each product is hi·hi alone, 11 bits of each
  operand.
- ``fwdc_drop_chunk``: the forward above D=512 (flash_fwd_wide.cu's
  flash_fwd_chunked_kernel) leaves the second 128-column chunk of D out of
  every S (its stage still loaded, waited on and released).
- ``fwdc_no_correction``: the same kernel never rescales O's rows when a
  tile raises their running max.
- ``f32w_fwd_one_pass``, ``f32w_dkv_one_pass``: fp32's TF32 forward above
  D=128 (flash_f32.cu: flash_fwd_f32_wide_kernel) and its dK/dV
  (flash_dkv_f32_kernel, at every width) take every product as hi·hi alone,
  one pass (the forward's S and P·V, dK/dV's Sᵀ, dPᵀ, dV and dK).
- ``f32w_fwd_drop_chunk``, ``f32w_dkv_drop_chunk``: the same kernels leave
  D's second 32-column chunk out of every S (the forward) or every Sᵀ and
  dPᵀ (dK/dV), its stage still loaded, waited on and released (dK/dV's
  products still issued and waited on).
- ``f32_dkv_natural_order``: fp32's dK/dV prologue
  (flash_f32_split_dkv_kernel) writes Qᵀ and dOᵀ with the queries in their
  natural order, not in the order PERM that the A fragments of Pᵀ and dSᵀ
  take, so that dV and dK pair each query's P and dS with another query's
  dO and Q within each group of 8.
- ``dqc_f16_drop_chunk``: fp16's dQ above D=512 (flash_dq_wide.cu's
  flash_dq_chunked_kernel) leaves D's second 64-column chunk out of every
  S (its products still issued and waited on, its stage released).
- ``dkvc_f16_no_rescale``: fp16's dK/dV above D=512 (flash_dkv_wide.cu's
  flash_dkv_chunked_kernel) lowers a key row's exponent of dSᵀ but never
  rescales what dK's row has summed so far.
- ``dqc_bf16_drop_chunk``: ``dqc_f16_drop_chunk``'s edit, held in bf16
  (the kernel is one template for both types).
- ``dkvc_bf16_drop_chunk``: bf16's dK/dV above D=512 (the same
  flash_dkv_chunked_kernel) leaves D's second 64-column chunk out of every
  Sᵀ and dPᵀ (its stage still loaded, waited on and released).
- ``f32_dq_one_pass``: fp32's TF32 dQ (flash_f32.cu's flash_dq_f32_kernel,
  at every width) takes S, dP and dS·K as hi·hi alone, one pass.
- ``f32_dq_drop_chunk``: the same kernel leaves D's second 32-column chunk
  out of every S and dP (its products still issued and waited on, its
  stage released).

The first three are held at llama_350m's attention shape (B=8, H=16,
S=2048, D=64, bf16, causal), the wide one at the same width in heads of
256 (H=4), where the wide kernels run, and the fp16 ones at the shape of
their kernel in fp16 under chip_smoke.py's fp16 bars (`SIMT_LIMITS`) and
against the plain model of their kernel's arithmetic
(tests/torch_f16_dkv_model.py, at 1e-3 of the largest value, as
tests/test_torch_cuda.py holds it; on random inputs and on an unscaled
loss's dO of 1e-6), the fp32 one at llama_350m's attention shape in
fp32 under chip_smoke.py's fp32 bars, and the chunked forward's at D=640
(B=2, H=2, S=1024), the first in bf16, the second in fp16 under the fp16
bars, the fp32 wide ones at the wide shape in fp32 under the fp32
bars, the fp16 dQ and dK/dV above D=512 at D=640 under the fp16 bars,
and the bf16 ones there under the bf16 bars (`LIMITS`), and fp32's TF32 dQ, its one pass at the main shape and its dropped chunk
at the wide one, and fp32's dK/dV prologue in natural order at the main
shape, under the fp32 bars, each required to break the bars of
its own kernel (O for the
forward, dK and dV for dK/dV, which runs on the sound forward's lse when
the fault is its own), the fp16 and fp32 dQ and dK/dV ones no bar of
another kernel (`OWN_BARS`). A fault names its file as ``name.cu:kernel`` where two
kernels of one source share the line it changes
(``scripts/source_edits.py``). The script logs each kernel set's
errors against the plain versions under chip_smoke.py's bars (the sound
set at every shape and dtype, and against every model), then llama_350m's forward and
backward through each set against the plain attention (chip_smoke.py's
slice comparison). It exits non-zero if the sound kernels break a bar or
a faulty set passes the bars it is held to. Named faults run alone
(after the sound set); none named, every one. Needs CUDA and nvcc.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import source_edits  # noqa: E402

MAIN_SHAPE = (8, 16, 2048, 2048, 64, True, 0)
WIDE_SHAPE = (8, 4, 2048, 2048, 256, True, 0)
CHUNKED_SHAPE = (2, 2, 1024, 1024, 640, True, 0)
# the fp16 kernels' model checks, by kernel: (B, H, Sq, Sk, D, causal,
# q_off, small dO)
MODEL_CASES = {
    "dkvw": ((1, 2, 192, 192, 256, True, 0, False),
             (1, 2, 128, 128, 256, True, 0, True)),
    "dq": ((1, 2, 320, 320, 64, True, 0, False),
           (1, 2, 320, 320, 64, True, 0, True)),
    "dqw": ((1, 2, 192, 192, 256, True, 0, False),
            (1, 2, 128, 128, 256, True, 0, True))}
MODEL_TOL = 1e-3
# name -> (source file, the line as it stands, the line with the fault,
# the shape and dtype it is held at, the model check it is held to); a
# fault of several edits names a tuple of lines as they stand and a tuple
# of the lines with the fault
_F32W_S = ("""        wgmma_ss_tf32<BN>(sc, qlod + qs, khid + ks, !first || kk > 0);
        wgmma_ss_tf32<BN>(sc, qhid + qs, klod + ks, 1);
        wgmma_ss_tf32<BN>(sc, qhid + qs, khid + ks, 1);
""", """        wgmma_ss_tf32<BN>(sc, qhid + qs, khid + ks, !first || kk > 0);
""")
_F32W_PV = ("""        wgmma_rs_tf32<CW>(acc, pl[kk], vhid + vk);
        wgmma_rs_tf32<CW>(acc, ph[kk], vlod + vk);
        wgmma_rs_tf32<CW>(acc, ph[kk], vhid + vk);
""", """        wgmma_rs_tf32<CW>(acc, ph[kk], vhid + vk);
""")
# fp32's TF32 dK/dV (flash_dkv_f32_kernel): each chunk's small terms of Sᵀ
# and dPᵀ, then its hi·hi terms; one pass keeps the hi·hi loop alone, which
# then starts the chunk's accumulator. dV += Pᵀ·dO and dK += dSᵀ·Q in three
# passes a k-step.
_F32DKV_S = tuple((
    f"        wgmma_ss_tf32<BM>({c}, kh + {lo} + a, qh + {bh}bk, kk > 0);\n"
    f"        wgmma_ss_tf32<BM>({c}, kh + {hi}a, qh + {bl} + bk, 1);\n"
    "      }\n#pragma unroll\n"
    "      for (int kk = 0; kk < KC / 8; ++kk)\n"
    f"        wgmma_ss_tf32<BM>({c}, kh + {hi}kmajor_step(64, kk),\n"
    f"                          qh + {bh}kmajor_step(BM, kk), 1);\n",
    "        (void)a;\n        (void)bk;\n"
    "      }\n#pragma unroll\n"
    "      for (int kk = 0; kk < KC / 8; ++kk)\n"
    f"        wgmma_ss_tf32<BM>({c}, kh + {hi}kmajor_step(64, kk),\n"
    f"                          qh + {bh}kmajor_step(BM, kk), kk > 0);\n")
    for c, lo, hi, bh, bl in (("ps", "KV", "", "", "T"),
                              ("pp", "3 * KV", "2 * KV + ", "2 * T + ",
                               "3 * T")))
_F32DKV_PV = tuple((
    f"        wgmma_rs_tf32<CW>({c}, al[kk], {b});\n"
    f"        wgmma_rs_tf32<CW>({c}, ah[kk], {b} + TR);\n"
    f"        wgmma_rs_tf32<CW>({c}, ah[kk], {b});\n",
    f"        wgmma_rs_tf32<CW>({c}, ah[kk], {b});\n")
    for c, b in (("dva", "dth"), ("dka", "bq")))
# fp32's TF32 dQ (flash_dq_f32_kernel): each chunk's small terms of S and
# dP, then its hi·hi terms; one pass keeps the hi·hi loop alone, which then
# starts the chunk's accumulator. dQ += dS·K in three passes.
_F32DQ_S = tuple((
    f"        wgmma_ss_tf32<BN>({c}, {a}ld + a, {b}hd + bk, kk > 0);\n"
    f"        wgmma_ss_tf32<BN>({c}, {a}hd + a, {b}ld + bk, 1);\n"
    "      }\n#pragma unroll\n"
    "      for (int kk = 0; kk < KC / 8; ++kk)\n"
    f"        wgmma_ss_tf32<BN>({c}, {a}hd + kmajor_step(64, kk),\n"
    f"                          {b}hd + kmajor_step(BN, kk), 1);\n",
    "        (void)a;\n        (void)bk;\n"
    "      }\n#pragma unroll\n"
    "      for (int kk = 0; kk < KC / 8; ++kk)\n"
    f"        wgmma_ss_tf32<BN>({c}, {a}hd + kmajor_step(64, kk),\n"
    f"                          {b}hd + kmajor_step(BN, kk), kk > 0);\n")
    for c, a, b in (("ps", "q", "k"), ("pp", "d", "v")))
_F32DQ_DQ = ("""        wgmma_rs_tf32<CW>(acc, dsl[kk], thd + bk);
        wgmma_rs_tf32<CW>(acc, dsh[kk], tld + bk);
        wgmma_rs_tf32<CW>(acc, dsh[kk], thd + bk);
""", """        wgmma_rs_tf32<CW>(acc, dsh[kk], thd + bk);
""")
FAULTS = {
    "fwd_last_tile": (
        "flash_fwd.cu",
        "        wgmma_rs<D, T>(acc, pa[kk], vd + mnmajor_step(kk));\n",
        "        if (!(i == gridDim.x - 1 && j == n_k - 1))\n"
        "          wgmma_rs<D, T>(acc, pa[kk], vd + mnmajor_step(kk));\n",
        MAIN_SHAPE, torch.bfloat16),
    "dq_last_tile": (
        "flash_dq.cu",
        "        wgmma_rs<D, T>(acc, dsa[kk], kd + mnmajor_step(kk));\n",
        "        if (!(i == gridDim.x - 1 && j == n_k - 1))\n"
        "          wgmma_rs<D, T>(acc, dsa[kk], kd + mnmajor_step(kk));\n",
        MAIN_SHAPE, torch.bfloat16),
    "dkv_last_tile": (
        "flash_dkv.cu",
        "        wgmma_rs<D, T>(dva, pa[kk], dd + mnmajor_step(kk));\n",
        "        if (j != gridDim.z - 1)\n"
        "          wgmma_rs<D, T>(dva, pa[kk], dd + mnmajor_step(kk));\n",
        MAIN_SHAPE, torch.bfloat16),
    "dqw_last_tile": (
        "flash_dq_wide.cu",
        "        wgmma_rs<HW, T>(acc, dsa[kk], kd + mnmajor_step(kk));\n",
        "        if (!(i == gridDim.x - 1 && j == n_k - 1))\n"
        "          wgmma_rs<HW, T>(acc, dsa[kk], kd + mnmajor_step(kk));\n",
        WIDE_SHAPE, torch.bfloat16),
    "dkvw_f16_no_rescale": (
        "flash_dkv_wide.cu:flash_dkv_wide_kernel",
        "      if (__any_sync(0xffffffffu, fell)) {\n",
        "      if (false && __any_sync(0xffffffffu, fell)) {\n",
        WIDE_SHAPE, torch.float16, "dkvw"),
    "dq_f16_no_rescale": (
        "flash_dq.cu",
        "        if (__any_sync(0xffffffffu, fell)) {\n",
        "        if (false && __any_sync(0xffffffffu, fell)) {\n",
        MAIN_SHAPE, torch.float16, "dq"),
    "dqw_f16_no_rescale": (
        "flash_dq_wide.cu:flash_dq_wide_kernel",
        "      if (__any_sync(0xffffffffu, fell)) {\n",
        "      if (false && __any_sync(0xffffffffu, fell)) {\n",
        WIDE_SHAPE, torch.float16, "dqw"),
    "f32_one_pass": (
        "flash_f32.cu",
        "  const uint32_t lo = to_tf32(x - __uint_as_float(hi));\n",
        "  const uint32_t lo = 0;\n",
        MAIN_SHAPE, torch.float32),
    "fwdc_drop_chunk": (
        "flash_fwd_wide.cu",
        "      for (int kk = 0; kk < KC / 16; ++kk)\n",
        "      for (int kk = 0; kk < (it % nc == 1 ? 0 : KC / 16); ++kk)\n",
        CHUNKED_SHAPE, torch.bfloat16),
    "fwdc_no_correction": (
        "flash_fwd_wide.cu",
        "        for (int e = 0; e < CW / 2; ++e) "
        "acc[e] *= corr[(e >> 1) & 1];\n",
        "        for (int e = 0; e < CW / 2; ++e) acc[e] *= 1.f;\n",
        CHUNKED_SHAPE, torch.float16),
    "f32w_fwd_one_pass": (
        "flash_f32.cu", (_F32W_S[0], _F32W_PV[0]), (_F32W_S[1], _F32W_PV[1]),
        WIDE_SHAPE, torch.float32),
    "f32w_dkv_one_pass": (
        "flash_f32.cu:flash_dkv_f32_kernel",
        tuple(o for o, _ in _F32DKV_S + _F32DKV_PV),
        tuple(n for _, n in _F32DKV_S + _F32DKV_PV), WIDE_SHAPE,
        torch.float32),
    "f32w_fwd_drop_chunk": (
        "flash_f32.cu",
        "      for (int kk = 0; kk < KC / 8; ++kk) {\n"
        "        const uint32_t qs = kmajor_step(BM, kk)",
        "      for (int kk = 0; kk < (it % nc == 1 ? 0 : KC / 8); ++kk) {\n"
        "        const uint32_t qs = kmajor_step(BM, kk)",
        WIDE_SHAPE, torch.float32),
    "f32w_dkv_drop_chunk": (
        "flash_f32.cu:flash_dkv_f32_kernel",
        "          st[e] += ps[e];\n          dpt[e] += pp[e];\n",
        "          st[e] += c == 1 ? 0.f : ps[e];\n"
        "          dpt[e] += c == 1 ? 0.f : pp[e];\n",
        WIDE_SHAPE, torch.float32),
    "f32_dkv_natural_order": (
        "flash_f32.cu:flash_f32_split_dkv_kernel",
        "  const int src = (tx & ~7) + perm8(tx & 7);\n",
        "  const int src = tx;\n", MAIN_SHAPE, torch.float32),
    "dqc_f16_drop_chunk": (
        "flash_dq_wide.cu:flash_dq_chunked_kernel",
        "        for (int e = 0; e < BN / 2; ++e) sc[e] += part[e];\n",
        "        for (int e = 0; e < BN / 2; ++e)\n"
        "          sc[e] += cw == 0 && c == 1 ? 0.f : part[e];\n",
        CHUNKED_SHAPE, torch.float16),
    "dkvc_f16_no_rescale": (
        "flash_dkv_wide.cu:flash_dkv_chunked_kernel",
        "      if (__any_sync(0xffffffffu, fell)) {\n",
        "      if (false && __any_sync(0xffffffffu, fell)) {\n",
        CHUNKED_SHAPE, torch.float16),
    "dqc_bf16_drop_chunk": (
        "flash_dq_wide.cu:flash_dq_chunked_kernel",
        "        for (int e = 0; e < BN / 2; ++e) sc[e] += part[e];\n",
        "        for (int e = 0; e < BN / 2; ++e)\n"
        "          sc[e] += cw == 0 && c == 1 ? 0.f : part[e];\n",
        CHUNKED_SHAPE, torch.bfloat16),
    "dkvc_bf16_drop_chunk": (
        "flash_dkv_wide.cu:flash_dkv_chunked_kernel",
        "      for (int kk = 0; kk < KC / 16; ++kk)\n",
        "      for (int kk = 0; kk < (it % nc == 1 ? 0 : KC / 16); ++kk)\n",
        CHUNKED_SHAPE, torch.bfloat16),
    "f32_dq_one_pass": (
        "flash_f32.cu:flash_dq_f32_kernel",
        (*(o for o, _ in _F32DQ_S), _F32DQ_DQ[0]),
        (*(n for _, n in _F32DQ_S), _F32DQ_DQ[1]), MAIN_SHAPE, torch.float32),
    "f32_dq_drop_chunk": (
        "flash_f32.cu:flash_dq_f32_kernel",
        "          sc[e] += ps[e];\n          dp[e] += pp[e];\n",
        "          sc[e] += c == 1 ? 0.f : ps[e];\n"
        "          dp[e] += c == 1 ? 0.f : pp[e];\n",
        WIDE_SHAPE, torch.float32),
}
# The bars a fault must break, where it is held against them: those of the
# kernel it sits in.
MUST_BREAK = {"f32w_fwd_one_pass": ("o_row",),
              "f32w_fwd_drop_chunk": ("o_row",),
              "f32w_dkv_one_pass": ("dk_row", "dv_row"),
              "f32w_dkv_drop_chunk": ("dk_row", "dv_row"),
              "f32_dkv_natural_order": ("dk_row", "dv_row"),
              "dqc_f16_drop_chunk": ("dq_row",),
              "dkvc_f16_no_rescale": ("dk_row",),
              "dqc_bf16_drop_chunk": ("dq_row",),
              "dkvc_bf16_drop_chunk": ("dk_row", "dv_row"),
              "f32_dq_one_pass": ("dq_row",),
              "f32_dq_drop_chunk": ("dq_row",)}
# The faults that must break no bar but those of their own kernel (K2's dQ
# and δ, K3's dK and dV).
OWN_BARS = {"f32w_dkv_one_pass": ("dk_row", "dv_row"),
            "f32w_dkv_drop_chunk": ("dk_row", "dv_row"),
            "f32_dkv_natural_order": ("dk_row", "dv_row"),
            "dqc_f16_drop_chunk": ("dq_row", "delta"),
            "dkvc_f16_no_rescale": ("dk_row", "dv_row"),
            "dqc_bf16_drop_chunk": ("dq_row", "delta"),
            "dkvc_bf16_drop_chunk": ("dk_row", "dv_row"),
            "f32_dq_one_pass": ("dq_row", "delta"),
            "f32_dq_drop_chunk": ("dq_row", "delta")}


def model_errors(fa, which: str) -> list:
    """An fp16 kernel against the plain model of its arithmetic at
    MODEL_CASES[which]: the largest error over the largest value of the
    model's dQ ("dq", "dqw"), or dK and dV ("dkvw"; dK alone on the small
    dO, whose dV lies among fp16's subnormals), one a case."""
    import numpy as np
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_f16_dkv_model as model

    errs = []
    for B, H, Sq, Sk, D, causal, q_off, small in MODEL_CASES[which]:
        rng = np.random.default_rng(Sq + D)
        if small:
            # K3's dK = dSᵀ·Q wants Q large, K2's dQ = dS·K wants K large
            q_mult = 64 if which == "dkvw" else 1 / 64
            q, k, v, do = model.small_gradient_inputs(rng, B, Sq, H, D,
                                                      q_mult)
        else:
            q, do = (torch.from_numpy(rng.standard_normal((B, Sq, H, D))
                                      .astype(np.float16)) for _ in range(2))
            k, v = (torch.from_numpy(rng.standard_normal((B, Sk, H, D))
                                     .astype(np.float16)) for _ in range(2))
        qc, kc, vc, doc = (t.cuda() for t in (q, k, v, do))
        o, lse = fa.flash_fwd(qc, kc, vc, causal, q_off)
        dq, delta = fa.flash_dq(qc, kc, vc, o, doc, lse, causal, q_off)
        dk, dv = fa.flash_dkv(qc, kc, vc, doc, lse, delta, causal, q_off)
        if which == "dkvw":
            dk_m, dv_m = model.dkv(q, k, v, do, lse.cpu(), delta.cpu(),
                                   causal, q_off, D ** -0.5)
            pairs = ((dk, dk_m), (dv, dv_m))[:1 if small else 2]
        else:
            pairs = ((dq, model.dq(q, k, v, do, lse.cpu(), delta.cpu(),
                                   causal, q_off, D ** -0.5)),)
        errs.append(max(((got.cpu().float() - ref).abs().max()
                         / ref.abs().max()).item() for got, ref in pairs))
    return errs


def use_sources(build, fa, csrc, build_root) -> None:
    """Points the kernels' loader at another source tree and drops the
    libraries it has loaded."""
    build.CSRC, build.BUILD_ROOT = csrc, build_root
    build._libs.clear()
    fa._entry.cache_clear()


def plant(sound_csrc: Path, name: str):
    """A copy of the sound sources with fault `name`: (csrc dir, build
    root)."""
    target, olds, news = FAULTS[name][:3]
    fname, kernel = source_edits.split(target)
    if isinstance(olds, str):
        olds, news = (olds,), (news,)
    base = os.path.join(ROOT, "build", "planted_fault", name)
    csrc = os.path.join(base, "csrc")
    shutil.rmtree(base, ignore_errors=True)
    shutil.copytree(sound_csrc, csrc)
    path = os.path.join(csrc, fname)
    with open(path) as f:
        text = f.read()
    for old, new in zip(olds, news):
        try:
            text = source_edits.replace_once(text, kernel, old, new)
        except ValueError as e:
            raise SystemExit(f"{name}: {fname}: {e}")
    with open(path, "w") as f:
        f.write(text)
    return Path(csrc), Path(base) / "lib"


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_planted_fault: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke
    from vodascheduler_tpu_torch.models import get_model
    from vodascheduler_tpu_torch.ops import _build as build
    from vodascheduler_tpu_torch.ops import flash_attention as fa
    from vodascheduler_tpu_torch.runtime import TrainSession

    log = chip_smoke.log
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip().splitlines()[0])
    bundle = get_model("llama_350m")
    session = TrainSession(bundle, 1, global_batch_size=8)
    batch = session.make_batch()

    faults = sys.argv[1:] or list(FAULTS)
    unknown = set(faults) - set(FAULTS)
    if unknown:
        raise SystemExit(f"no such planted faults: {sorted(unknown)}")
    sound = (build.CSRC, build.BUILD_ROOT)
    wrong = []
    for name in ("sound", *faults):
        use_sources(build, fa, *(sound if name == "sound"
                                 else plant(sound[0], name)))
        build.build()
        log(f"--- {name}")
        f16 = torch.float16
        held = ((MAIN_SHAPE, torch.bfloat16), (WIDE_SHAPE, torch.bfloat16),
                (MAIN_SHAPE, f16), (WIDE_SHAPE, f16),
                (MAIN_SHAPE, torch.float32), (WIDE_SHAPE, torch.float32),
                (CHUNKED_SHAPE, torch.bfloat16),
                (CHUNKED_SHAPE, f16)) if name == "sound" \
            else (FAULTS[name][3:5],)
        bad = [b for shape, dtype in held
               for b in chip_smoke.kernel_errors(
                   fa, name, shape, dtype, chip_smoke.SIMT_LIMITS.get(
                       dtype, chip_smoke.LIMITS))[1]]
        for which in (MODEL_CASES if name == "sound"
                      else FAULTS[name][5:]):
            errs = model_errors(fa, which)
            log(f"model[{name}] fp16 {which} against its model: "
                + " ".join(f"{e:.3g}" for e in errs) + f" (bar {MODEL_TOL})")
            bad += [f"model[{which}]={e:.3g}>{MODEL_TOL}" for e in errs
                    if not e <= MODEL_TOL]
        slice_bad = chip_smoke.check_slice(
            chip_smoke.slice_gaps(bundle, session.module, batch))
        log(f"verdict[{name}] kernel bars broken: {bad or 'none'}; "
            f"slice bars broken: {slice_bad or 'none'}")
        missed = [n for n in MUST_BREAK.get(name, ())
                  if not any(b.startswith(f"{n}=") for b in bad)]
        if missed:
            log(f"verdict[{name}] its kernel's bars not broken: {missed}")
        others = [b for b in bad if name in OWN_BARS and not b.startswith(
            tuple(f"{n}=" for n in OWN_BARS[name]))]
        if others:
            log(f"verdict[{name}] bars of another kernel broken: {others}")
        judged_right = (not (bad or slice_bad) if name == "sound"
                        else bool(bad) and not missed and not others)
        if not judged_right:
            wrong.append(name)
    if wrong:
        log(f"the bars misjudged: {wrong}")
        return 1
    log("the bars pass the sound kernels and reject every planted fault")
    return 0


if __name__ == "__main__":
    sys.exit(main())
