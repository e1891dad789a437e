"""Times variants of the forward (K1), dQ (K2) and dK/dV (K3) kernels
against the sources as they stand, in turns, on one card: what each part
of a kernel costs, and what each design choice of theirs is worth.

    python3 scripts/torch_kernel_ablate.py [--rounds 6] [--only NAME ...]
        [--shape main|d128|d256|d512|d640|d640_record] [--dtype bf16|fp16]

Each variant is a copy of ``vodascheduler_tpu_torch/ops/csrc`` with a few
lines changed (VARIANTS below), built under ``build/kernel_ablate/<name>``
by the package's build module (``ops/_build.py``); the sources of the
package are not touched.
Some variants compute wrong results on purpose (they drop work to weigh
it) and are only timed. At `--shape` (scripts/torch_kernel_ab.py's:
`main` is llama_350m's attention, B=8, H=16, S=2048, D=64, bf16, causal;
`d128` the same width in heads of 128; `d256` and `d512` in heads of 256
and 512, which run the wide kernels, whose variants are named `fwdw_`,
`dqw_` and `dkvw_`; `d640` in heads of 640, where the forward is
flash_fwd_chunked_kernel, whose variants are named `fwdc_`, and dQ and
dK/dV are flash_dq_chunked_kernel and flash_dkv_chunked_kernel, named
`dqc_` and `dkvc_`, in bf16 and fp16 alike: `--dtype` picks the
instantiation they weigh) every round times the tree and then each variant, K1, K2, K3
and K2 then K3 (the backward) each by CUDA events (chip_smoke.cuda_ms, 30
repeats after 5 warm-ups); the script prints the
card's name and power limit, the median of each, its ratio to the tree's,
and a last line of JSON. Exits non-zero without a card or when a
variant's lines are not in the sources.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import source_edits  # noqa: E402
import torch_kernel_ab as ab  # noqa: E402

F, Q, K = "flash_fwd.cu", "flash_dq.cu", "flash_dkv.cu"
FW, QW, KW = "flash_fwd_wide.cu", "flash_dq_wide.cu", "flash_dkv_wide.cu"
# the wide dQ and dK/dV kernels alone: their sources also hold the kernels
# above D=512, which share some of their lines (scripts/source_edits.py)
QWK, KWK = QW + ":flash_dq_wide_kernel", KW + ":flash_dkv_wide_kernel"
# dQ and dK/dV above D=512 (run with --shape d640, in either dtype)
QCK, KCK = QW + ":flash_dq_chunked_kernel", KW + ":flash_dkv_chunked_kernel"
_DQC_SUM = """      for (int c = 0; c < nc; ++c) {
        issue_chunk(j * nc + c);
        wgmma_wait<0>();
        fence_regs(part);
        mbar_arrive(&empty[(j * nc + c) % ST]);
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) sc[e] += part[e];
      }"""
_DQC_ASYNC = """      issue_chunk(j * nc);
      for (int c = 1; c < nc; ++c) {
        issue_chunk(j * nc + c);
        wgmma_wait<1>();
        mbar_arrive(&empty[(j * nc + c - 1) % ST]);
      }
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(&empty[(j * nc + nc - 1) % ST]);"""
_DQC_LOADS = """          mbar_expect_tx(&full[s], C::STAGE_BYTES);
          tma_rows<KC>(qs + s * BM * KC, &tq, &full[s], BM, h, q0, b, c * KC);
          tma_rows<KC>(dos + s * BM * KC, &tdo, &full[s], BM, h, q0, b,
                       c * KC);
          tma_rows<KC>(ks + s * BN * KC, &tk, &full[s], BN, h, j * BN, b,
                       c * KC);
          tma_rows<KC>(vs + s * BN * KC, &tv, &full[s], BN, h, j * BN, b,
                       c * KC);"""
_DKVC_LOADS = """            mbar_expect_tx(&full[s], C::STAGE_BYTES);
            tma_rows<KC>(ks + s * BN * KC, &tk, &full[s], BN, h, k0, b,
                         c * KC);
            tma_rows<KC>(vs + s * BN * KC, &tv, &full[s], BN, h, k0, b,
                         c * KC);
            tma_rows<KC>(qs + s * BM * KC, &tq, &full[s], BM, h, q0, b,
                         c * KC);
            tma_rows<KC>(dos + s * BM * KC, &tdo, &full[s], BM, h, q0, b,
                         c * KC);"""
_CHUNK_PRODUCTS = "      for (int kk = 0; kk < KC / 16; ++kk)\n"
_FIRST_CHUNK = "      for (int kk = 0; kk < (it % nc ? 0 : KC / 16); ++kk)\n"
HOPPER = "hopper.cuh"  # the forwards' softmax_tile
_KV_LOADS = """        mbar_expect_tx(&k_full[s], C::KV_BYTES);
        tma_rows<D>(ks + s * C::BN * D, &tk, &k_full[s], C::BN, h, j * C::BN, b);
        mbar_expect_tx(&v_full[s], C::KV_BYTES);
        tma_rows<D>(vs + s * C::BN * D, &tv, &v_full[s], C::BN, h, j * C::BN, b);"""
_NO_SOFTMAX = (F, "      softmax_tile<C::BN>(sc,", "      if (j < 0) softmax_tile<C::BN>(sc,")
_KV_ONCE = (F, _KV_LOADS, "if (j < C::STAGES) {\n" + _KV_LOADS
            + "\n} else { mbar_arrive(&k_full[s]); mbar_arrive(&v_full[s]); }")
_KV_LOADS_WIDE = """        mbar_expect_tx(&k_full[s], C::K_BYTES);
        tma_rows<D>(ks + s * BN * D, &tk, &k_full[s], BN, h, j * BN, b);"""
_V_LOADS_WIDE = """        mbar_expect_tx(&v_full[s], C::V_BYTES);
        tma_rows<CW>(vs + s * BN * CW, &tv, &v_full[s], BN, h, j * BN, b, c0);"""
_KV_LOADS_DQW = """        mbar_expect_tx(&k_full[s], C::KV_BYTES);
        tma_rows<D>(ks + s * BN * D, &tk, &k_full[s], BN, h, j * BN, b);
        mbar_expect_tx(&v_full[s], C::KV_BYTES);
        tma_rows<D>(vs + s * BN * D, &tv, &v_full[s], BN, h, j * BN, b);"""
_QK_LOADS_CHUNKED = """          mbar_expect_tx(&full[s], C::Q_BYTES + C::K_BYTES);
          tma_rows<KC>(qs + s * BM * KC, &tq, &full[s], BM, h, q0, b, c * KC);
          tma_rows<KC>(ks + s * BN * KC, &tk, &full[s], BN, h, j * BN, b,
                       c * KC);"""
_V_LOADS_CHUNKED = """        mbar_expect_tx(&v_full[sv], C::V_BYTES);
        tma_rows<CW>(vs + sv * BN * CW, &tv, &v_full[sv], BN, h, j * BN, b,
                     c0);"""
_DKV_LOOP = """        issue_grads(i);
        wgmma_wait<0>();
        fence_regs(dva);
        fence_regs(dka);
        mbar_arrive(&empty[(i - i0) % C::STAGES]);
        issue_scores(i + 1);
        wgmma_wait<0>();"""

# name -> (what it weighs, [(file, the lines as they stand, the lines instead)])
VARIANTS = {
    "fwd_no_softmax": ("K1 without its softmax (wrong results)", [_NO_SOFTMAX]),
    "fwd_no_exp": ("K1 with exp2 replaced by its argument (wrong results)", [
        (HOPPER, "const float p = fast_exp2(fmaf(sc[4 * c + e], sl2, -mrow[e >> 1]));",
         "const float p = fmaf(sc[4 * c + e], sl2, -mrow[e >> 1]);")]),
    "fwd_kv_once": ("K1 loading K/V for its first stages only (wrong results)",
                    [_KV_ONCE]),
    "fwd_no_softmax_kv_once": ("both of the above (wrong results)",
                               [_NO_SOFTMAX, _KV_ONCE]),
    "fwd_heads_outer": ("K1 with the query tile as the grid's slowest axis", [
        (F, "const int h = blockIdx.y, b = blockIdx.z;\n"
            "  const int i = gridDim.x - 1 - blockIdx.x;",
         "const int h = blockIdx.x, b = blockIdx.y;\n"
         "  const int i = gridDim.z - 1 - blockIdx.z;"),
        (F, "const dim3 grid((Sq + C::BM - 1) / C::BM, H, B);",
         "const dim3 grid(H, B, (Sq + C::BM - 1) / C::BM);")]),
    "fwd_no_turns": ("K1 without the warpgroups' turns", [
        (F, "const Turns<> turns{cw};", "const Turns<false> turns{cw};")]),
    "dkv_overlap": ("K3 issuing the next tile's scores under dV and dK", [
        (K, _DKV_LOOP, """        issue_grads(i);
        issue_scores(i + 1);
        wgmma_wait<1>();
        fence_regs(dva);
        fence_regs(dka);
        mbar_arrive(&empty[(i - i0) % C::STAGES]);
        wgmma_wait<0>();""")]),
    "dq_bn128": ("K2 with 128-key K/V tiles at D=64 (64 as it stands)",
                 [(Q, "static constexpr int BN = 64;",
                   "static constexpr int BN = D == 64 ? 128 : 64;")]),
    "dq_no_turns": ("K2 without the warpgroups' turns", [
        (Q, "const Turns<C::OVERLAP> turns{cw};", "const Turns<false> turns{cw};")]),
    "dq_no_overlap": ("K2 tile by tile at D=64, as at D=128", [
        (Q, "static constexpr bool OVERLAP = D == 64;",
         "static constexpr bool OVERLAP = false;")]),
    "dq_no_ds": ("K2 without its dS elementwise pass (wrong results)", [
        (Q, "      ds_tile<C::BN, SCALED>(sc, dp,",
         "      if (j < 0) ds_tile<C::BN, SCALED>(sc, dp,")]),
    "fwdw_no_softmax": ("wide K1 without its softmax (wrong results)", [
        (FW, "      softmax_tile<BN>(sc,", "      if (j < 0) softmax_tile<BN>(sc,")]),
    "fwdw_no_turns": ("wide K1 without the warpgroups' turns", [
        (FW, "const Turns<> turns{cw};", "const Turns<false> turns{cw};")]),
    "fwdw_kv_once": ("wide K1 loading K/V for its first stages only "
                     "(wrong results)", [
        (FW, _KV_LOADS_WIDE, "if (j < ST) {\n" + _KV_LOADS_WIDE
         + "\n} else { mbar_arrive(&k_full[s]); }"),
        (FW, _V_LOADS_WIDE, "if (j < ST) {\n" + _V_LOADS_WIDE
         + "\n} else { mbar_arrive(&v_full[s]); }")]),
    "fwdw_bn64": ("wide K1 with 64-key K/V tiles at D=256 (80 as it stands)", [
        (FW, "static constexpr int BN = D == 256 ? 80 : 64;",
         "static constexpr int BN = 64;")]),
    "fwdw_bn32_d512": ("wide K1 with 32-key K/V tiles at D=512, so that two "
                       "stages fit (64 and one stage as it stands)", [
        (FW, "static constexpr int BN = D == 256 ? 80 : 64;",
         "static constexpr int BN = D == 256 ? 80 : D == 512 ? 32 : 64;")]),
    "fwdc_s_first_chunk": ("K1 above D=512 summing S over D's first chunk "
                           "only, every chunk still loaded (wrong results)",
                           [(FW, "      for (int kk = 0; kk < KC / 16; ++kk)",
                             "      for (int kk = 0; kk < (it % nc ? 0 : "
                             "KC / 16); ++kk)")]),
    "fwdc_loads_once": ("K1 above D=512 loading Q/K chunks and V tiles for "
                        "the first stages only (wrong results)", [
        (FW, _QK_LOADS_CHUNKED, "if (it < ST) {\n" + _QK_LOADS_CHUNKED
         + "\n} else { mbar_arrive(&full[s]); }"),
        (FW, _V_LOADS_CHUNKED, "if (j < VST) {\n" + _V_LOADS_CHUNKED
         + "\n} else { mbar_arrive(&v_full[sv]); }")]),
    "fwdc_no_softmax": ("K1 above D=512 without its softmax (wrong results)",
                        [(FW, "      softmax_tile<BN>(sacc,",
                          "      if (j < 0) softmax_tile<BN>(sacc,")]),
    "fwdc_bn64": ("K1 above D=512 with 64-key tiles at CW=128 (128 as it "
                  "stands)", [
        (FW, "static constexpr int BN = CW == 256 ? 64 : 128;",
         "static constexpr int BN = 64;")]),
    "dkvw_q_once": ("wide K3 loading Q/dO for its first stages only "
                    "(wrong results)", [
        (KW, "        if (lane == 0) {\n          mbar_expect_tx(&q_full[s]",
         "        if (lane == 0 && it < ST) {\n          mbar_expect_tx(&q_full[s]"),
        (KW, "        if (lane == 0) {\n          mbar_expect_tx(&do_full[s]",
         "        if (lane == 0 && it < ST) {\n          mbar_expect_tx(&do_full[s]")]),
    "dkvw_no_handoff": ("wide K3 without waiting for the other warpgroup's "
                        "Pᵀ and dSᵀ (wrong results)", [
        (KWK, 'asm volatile("bar.sync 3, 256;" ::: "memory");', ""),
        (KWK, 'asm volatile("bar.arrive 3, 256;" ::: "memory");', ""),
        (KWK, 'asm volatile("bar.sync 4, 256;" ::: "memory");', ""),
        (KWK, 'asm volatile("bar.arrive 4, 256;" ::: "memory");', "")]),
    "dkvw_no_exp": ("wide K3 with exp2 replaced by its argument (wrong "
                    "results)", [
        (KWK, "sc[4 * c + e] = fast_exp2(sc[4 * c + e]);", "")]),
    "dqw_kv_once": ("wide K2 loading K/V for its first stages only (wrong "
                    "results)", [
        (QW, _KV_LOADS_DQW, "if (j < ST) {\n" + _KV_LOADS_DQW
         + "\n} else { mbar_arrive(&k_full[s]); mbar_arrive(&v_full[s]); }")]),
    "dqw_no_handoff": ("wide K2 without waiting for the other warpgroup's "
                       "P and dS (wrong results)", [
        (QWK, 'asm volatile("bar.sync 3, 256;" ::: "memory");', ""),
        (QWK, 'asm volatile("bar.arrive 3, 256;" ::: "memory");', ""),
        (QWK, 'asm volatile("bar.sync 4, 256;" ::: "memory");', ""),
        (QWK, 'asm volatile("bar.arrive 4, 256;" ::: "memory");', "")]),
    "dqw_no_exp": ("wide K2 with exp2 replaced by its argument (wrong "
                   "results)", [
        (QWK, "sc[4 * c + e] = fast_exp2(fmaf(sc[4 * c + e], sl2, -lse2[e >> 1]));",
         "sc[4 * c + e] = fmaf(sc[4 * c + e], sl2, -lse2[e >> 1]);")]),
    "dqc_async": ("K2 above D=512 summing S and dP over all of D in "
                  "one tensor-core accumulator, each chunk's stage released "
                  "under the next chunk's products (as the chunked forward; "
                  "a fp32 add a chunk as it stands)", [
        (QCK, "        wgmma_ss<BN, T>(part, ad + kmajor_step(BM, kk),\n"
              "                        bd + kmajor_step(BN, kk), kk > 0);",
         "        wgmma_ss<BN, T>(sc, ad + kmajor_step(BM, kk),\n"
         "                        bd + kmajor_step(BN, kk), "
         "it % nc > 0 || kk > 0);"),
        (QCK, _DQC_SUM, _DQC_ASYNC)]),
    "dqc_s_first_chunk": ("K2 above D=512 taking S's and dP's products "
                          "of D's first chunk only, every chunk still loaded "
                          "(wrong results)", [
        (QCK, _CHUNK_PRODUCTS, _FIRST_CHUNK)]),
    "dqc_loads_once": ("K2 above D=512 loading Q, dO, K and V chunks "
                       "for the first stages only (wrong results)", [
        (QCK, _DQC_LOADS, "if (it < ST) {\n" + _DQC_LOADS
         + "\n} else { mbar_arrive(&full[s]); }")]),
    "dqc_bn64": ("K2 above D=512 with 64-key tiles (128 as it stands)",
                 [(QW, "static constexpr int BN = 128;  // keys of a tile",
                   "static constexpr int BN = 64;  // keys of a tile")]),
    "dkvc_s_first_chunk": ("K3 above D=512 taking Sᵀ's and dPᵀ's "
                           "products of D's first chunk only, every chunk "
                           "still loaded (wrong results)", [
        (KCK, _CHUNK_PRODUCTS, _FIRST_CHUNK)]),
    "dkvc_loads_once": ("K3 above D=512 loading K, V, Q and dO chunks "
                        "for the first stages only (wrong results)", [
        (KCK, _DKVC_LOADS, "if (it < ST) {\n" + _DKVC_LOADS
         + "\n} else { mbar_arrive(&full[s]); }")]),
    "dkvc_kc128": ("K3 above D=512 streaming D in 128-column chunks "
                   "(64 as it stands)", [
        (KW, "  static constexpr int KC = 64;   // columns of D in a stage\n"
             "  static constexpr int HW = CW / 2;  // a consumer warpgroup's "
             "half\n  static constexpr int CHUNK_BYTES",
         "  static constexpr int KC = 128;   // columns of D in a stage\n"
         "  static constexpr int HW = CW / 2;  // a consumer warpgroup's "
         "half\n  static constexpr int CHUNK_BYTES")]),
}


def make(sound: Path, name: str) -> Path:
    """A copy of the sources with variant `name` under build/kernel_ablate."""
    base = Path(ROOT) / "build" / "kernel_ablate" / name
    shutil.rmtree(base, ignore_errors=True)
    shutil.copytree(sound, base / "csrc")
    for target, old, new in VARIANTS[name][1]:
        fname, kernel = source_edits.split(target)
        path = base / "csrc" / fname
        try:
            path.write_text(source_edits.replace_once(path.read_text(),
                                                      kernel, old, new))
        except ValueError as e:
            raise SystemExit(f"{name}: {fname}: {e}")
    return base / "csrc"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--only", nargs="*", choices=sorted(VARIANTS))
    ap.add_argument("--shape", choices=sorted(ab.SHAPES), default="main")
    ap.add_argument("--dtype", choices=sorted(ab.DTYPES), default="bf16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_ablate: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke
    from vodascheduler_tpu_torch.ops import _build as build
    from vodascheduler_tpu_torch.ops import flash_attention as fa

    log = chip_smoke.log
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip().splitlines()[0])
    sound = build.CSRC
    names = args.only or list(VARIANTS)
    sets = {"tree": ab.load_entries(build, fa, sound, build.BUILD_ROOT)}
    for name in names:
        csrc = make(sound, name)
        sets[name] = ab.load_entries(build, fa, csrc, csrc.parent / "lib")
    shape = ab.SHAPES[args.shape]
    dtype = ab.DTYPES[args.dtype]
    names = ab.row_names(fa, shape, dtype)
    log(f"shape {args.shape} (B, H, Sq, Sk, D, causal, q_off) = {shape} "
        f"{args.dtype}")
    q, k, v, do = ab.inputs(shape, dtype)
    ms = {n: {names[kn]: [] for kn in ab.ROWS} for n in sets}
    for _ in range(args.rounds):
        for name, entries in sets.items():
            ab.use_entries(fa, entries)
            for kn, call in ab.timers(fa, shape, q, k, v, do).items():
                ms[name][names[kn]].append(
                    chip_smoke.cuda_ms(call, warmup=5, reps=30))
    summary = {}
    for name in sets:
        med = {kn: statistics.median(t) for kn, t in ms[name].items()}
        ratio = {kn: med[kn] / statistics.median(ms["tree"][kn])
                 for kn in med}
        summary[name] = {"ms": med, "over_tree": ratio}
        what = VARIANTS[name][0] if name in VARIANTS else "the sources"
        log(f"{name}: " + " ".join(f"{kn}={med[kn]:.4f} ms ({ratio[kn]:.3f})"
                                   for kn in med) + f"  [{what}]")
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
