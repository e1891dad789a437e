"""Times variants of fp32's tensor-core forward, dQ and dK/dV
(``vodascheduler_tpu_torch/ops/csrc/flash_f32.cu``) against the source as
it stands, in turns, on one card: what the three TF32 passes, the
splitting of the operands into TF32 halves, the prologues, the chunks'
separate sums and dQ's and dK/dV's loads cost.

    python3 scripts/torch_f32_ablate.py [--rounds 2] [--shape d64|d256]

Each variant is a copy of ``ops/csrc`` with a few lines of flash_f32.cu
changed (VARIANTS below), built under ``build/f32_ablate/<name>`` by the
package's build module; the package's sources are not touched. Every
variant computes wrong results on purpose (it drops work to weigh it) and
is only timed:

- ``one_pass``: every product as hi·hi alone (K1, K2 and K3 issue one
  wgmma product, not three; the lo halves are never read);
- ``no_split``: hi and lo are the raw fp32 bits, with no rounding and no
  subtraction (three products still, of unsplit operands);
- ``dq_no_qsplit``: K2's warpgroups do not split their rows of each chunk
  of Q and dO in shared memory (Q_lo and dO_lo as the buffers hold them);
- ``dq_no_prologue``: K2's entry launches no prologue (K, V and Kᵀ's
  halves as the scratch holds them);
- ``dq_loads_once``: K2's producer loads the ring's chunks and Kᵀ's tile
  for their first stages only, and arrives on the later ones' barriers;
- ``dq_turns``: K2's warpgroups take turns at issuing their products
  (hopper.cuh's `Turns`, as K1 up to D=128 does);
- ``dq_split_ahead``: at CW=64 (D=64), where a second set of the
  warpgroups' lo buffers fits, each warpgroup splits its rows of the next
  chunk of Q and dO while its products of this chunk run (the results
  right; the wide instantiation unchanged);
- ``dkv_no_prologue``: K3's entry launches no prologue (the halves of Q,
  dO, K, V, Qᵀ and dOᵀ as the scratch holds them);
- ``dkv_joint_sums``: K3 sums each tile's Sᵀ and dPᵀ over all of D's
  chunks in the tensor cores' accumulator, not each chunk apart (the
  per-chunk wait stays);
- ``dkv_loads_once``: K3's producer loads the ring's first two items (a
  tile's first chunks) only, and arrives on the later ones' barriers;
- ``dkv_no_frag_split``: K3 takes Pᵀ and dSᵀ as their raw fp32 bits for
  both halves of its A fragments, where it splits them in the CTA (three
  products still).

At llama_350m's attention shape in fp32 (B=8, H=16, S=2048, D=64, causal;
``--shape d256``: B=8, H=4, D=256, where the wrappers take the kernels
that stream D, ``_f32_wide``, whose products the same variants reach)
each round times the tree and each variant, then the variants and the
tree in reverse order, K1, K2 and K3 each by CUDA events
(chip_smoke.cuda_ms);
the script prints the card's name and power limit, the median of each and
its ratio to the tree's. Exits non-zero without a card or when a variant's
lines are not in the source.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = {"d64": (8, 16, 2048, 2048, 64, True, 0),
          "d256": (8, 4, 2048, 2048, 256, True, 0)}
_S3 = """        wgmma_ss_tf32<BN>(sc, qld + qa, khd + kb, kk > 0);
        wgmma_ss_tf32<BN>(sc, qhd + qa, kld + kb, 1);
        wgmma_ss_tf32<BN>(sc, qhd + qa, khd + kb, 1);"""
_PV3 = """        wgmma_rs_tf32<D>(acc, pl[kk], vhd + vb);
        wgmma_rs_tf32<D>(acc, ph[kk], vld + vb);
        wgmma_rs_tf32<D>(acc, ph[kk], vhd + vb);"""
_SPLIT = """  const uint32_t hi = to_tf32(x);
  const uint32_t lo = to_tf32(x - __uint_as_float(hi));"""
# the wide forward's products (flash_fwd_f32_wide_kernel)
_S3W = """        wgmma_ss_tf32<BN>(sc, qlod + qs, khid + ks, !first || kk > 0);
        wgmma_ss_tf32<BN>(sc, qhid + qs, klod + ks, 1);
        wgmma_ss_tf32<BN>(sc, qhid + qs, khid + ks, 1);"""
_PV3W = """        wgmma_rs_tf32<CW>(acc, pl[kk], vhid + vk);
        wgmma_rs_tf32<CW>(acc, ph[kk], vlod + vk);
        wgmma_rs_tf32<CW>(acc, ph[kk], vhid + vk);"""
# K2's (flash_dq_f32_kernel): its producer's loads, and its prologue
_DQ_LOADS = """          mbar_expect_tx(&full[s], C::STAGE_BYTES);
          tma_load(st, &tq, &full[s], c * KC, h, q0, b);
          tma_load(st + BM * KC, &tdo, &full[s], c * KC, h, q0, b);
          float* kv = st + 2 * BM * KC;
          tma_load(kv, &tkh, &full[s], c * KC, h, j * BN, b);
          tma_load(kv + BN * KC, &tkl, &full[s], c * KC, h, j * BN, b);
          tma_load(kv + 2 * BN * KC, &tvh, &full[s], c * KC, h, j * BN, b);
          tma_load(kv + 3 * BN * KC, &tvl, &full[s], c * KC, h, j * BN, b);"""
_DQ_KT_LOADS = """            mbar_expect_tx(kt_full, 2 * C::KT_BYTES);
#pragma unroll
            for (int p = 0; p < BN / 32; ++p) {
              tma_load(kt + p * CW * 32, &tth, kt_full, j * BN + 32 * p, c0,
                       h, b);
              tma_load(kt + CW * BN + p * CW * 32, &ttl, kt_full,
                       j * BN + 32 * p, c0, h, b);
            }"""
_DQ_PROLOGUE = """        reinterpret_cast<const void*>(&flash_dq_f32_kernel<CW>), C::SMEM);
  if (!err) err = kv.launch(k, v, B, H, Sk, D, st);"""
sys.path.insert(0, os.path.join(ROOT, "scripts"))
from torch_planted_fault import (_F32DKV_PV, _F32DKV_S, _F32DQ_DQ,  # noqa: E402
                                 _F32DQ_S)

# K3's (flash_dkv_f32_kernel): its chunks' sums, its producer's chunk
# loads, its prologue and the split of its A fragments
_DKV_SUMS = [
    ("        wgmma_ss_tf32<BM>(ps, kh + KV + a, qh + bk, kk > 0);",
     "        wgmma_ss_tf32<BM>(ps, kh + KV + a, qh + bk, 1);"),
    ("        wgmma_ss_tf32<BM>(pp, kh + 3 * KV + a, qh + 2 * T + bk, kk > 0);",
     "        wgmma_ss_tf32<BM>(pp, kh + 3 * KV + a, qh + 2 * T + bk, 1);"),
    ("      for (int e = 0; e < BM / 2; ++e) st[e] = dpt[e] = 0.f;",
     "      for (int e = 0; e < BM / 2; ++e)\n"
     "        st[e] = dpt[e] = ps[e] = pp[e] = 0.f;"),
    ("          st[e] += ps[e];\n          dpt[e] += pp[e];",
     "          st[e] = ps[e];\n          dpt[e] = pp[e];")]
_DKV_LOADS = ("          if (c < nc) {\n"
              "            mbar_expect_tx(&full[s], C::CHUNK_BYTES);")
_DKV_PROLOGUE = ("  if (!err) err = x.launch(q, dout, k, v, B, H, Sq, Sk, D, st);\n")
_DKV_FRAGS = [(f"""        split_frag(ah[kk], al[kk], {x}[4 * kk], {x}[4 * kk + 2],
                   {x}[4 * kk + 1], {x}[4 * kk + 3]);""",
               "{\n" + "".join(f"        ah[kk][{i}] = al[kk][{i}] = "
                                f"__float_as_uint({x}[4 * kk + {j}]);\n"
                                for i, j in enumerate((0, 2, 1, 3))) + "}")
              for x in ("st", "dpt")]

# K2 with the warpgroups taking turns at issuing (named barriers 1 and 2;
# the split's own barrier moves to 3 and 4)
_DQ_TURNS = [
    ("""      asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
      const uint64_t qhd = sw128_desc(qhi, 16), qld = sw128_desc(qlo, 16);""",
     """      asm volatile("bar.sync %0, 128;" ::"r"(3 + cw) : "memory");
      const uint64_t qhd = sw128_desc(qhi, 16), qld = sw128_desc(qlo, 16);
      turns.begin();"""),
    ("""                          vhd + kmajor_step(BN, kk), 1);
      wgmma_commit();
    };""",
     """                          vhd + kmajor_step(BN, kk), 1);
      wgmma_commit();
      turns.end(false);
    };"""),
    ("""    float* dolo = qlo + 64 * KC;
""", """    float* dolo = qlo + 64 * KC;
    const Turns<> turns{cw};
"""),
    ("""    for (int j = 0; j < n_k; ++j) {
      // S and dP of tile j, summed""",
     """    turns.start_kernel();
    for (int j = 0; j < n_k; ++j) {
      // S and dP of tile j, summed"""),
    ("""      const uint64_t tld = sw128_desc(kt + CW * BN, 16);
      wgmma_fence();""",
     """      const uint64_t tld = sw128_desc(kt + CW * BN, 16);
      turns.begin();
      wgmma_fence();"""),
    ("""        wgmma_rs_tf32<CW>(acc, dsh[kk], thd + bk);
      }
      wgmma_commit();""",
     """        wgmma_rs_tf32<CW>(acc, dsh[kk], thd + bk);
      }
      wgmma_commit();
      turns.end(j == n_k - 1);""")]
# K2 splitting the next chunk under this chunk's products, at CW=64
_DQ_SPLIT_AHEAD = [
    ("""  static constexpr int LO_OFF = STAGES * STAGE_BYTES;
  static constexpr int KT_OFF = LO_OFF + 4 * LO_BYTES;""",
     """  static constexpr int LO_SETS = CW == 64 ? 2 : 1;
  static constexpr int LO_OFF = STAGES * STAGE_BYTES;
  static constexpr int KT_OFF = LO_OFF + LO_SETS * 4 * LO_BYTES;"""),
    ("""    float* qlo = lo + 2 * cw * 64 * KC;
    float* dolo = qlo + 64 * KC;
""", """    constexpr int LS = C::LO_SETS;
    auto lo_of = [&](int it) {
      return lo + ((it % LS) * 2 + cw) * 2 * 64 * KC;
    };
"""),
    ("""    auto issue_chunk = [&](int it) {
      const int s = it % ST;
      float* qhi = stage(s) + cw * 64 * KC;
      float* dohi = qhi + BM * KC;
      const float* khi = stage(s) + 2 * BM * KC;
      mbar_wait(&full[s], (it / ST) & 1);
      split_rows(qhi, qlo);
      split_rows(dohi, dolo);""",
     """    auto split_chunk = [&](int it) {
      float* qhi = stage(it % ST) + cw * 64 * KC;
      mbar_wait(&full[it % ST], (it / ST) & 1);
      split_rows(qhi, lo_of(it));
      split_rows(qhi + BM * KC, lo_of(it) + 64 * KC);
    };
    auto issue_chunk = [&](int it) {
      const int s = it % ST;
      float* qhi = stage(s) + cw * 64 * KC;
      float* dohi = qhi + BM * KC;
      float* qlo = lo_of(it);
      float* dolo = qlo + 64 * KC;
      const float* khi = stage(s) + 2 * BM * KC;"""),
    ("""      for (int c = 0; c < nc; ++c) {
        issue_chunk(j * nc + c);
        wgmma_wait<0>();""",
     """      for (int c = 0; c < nc; ++c) {
        const int it = j * nc + c;
        if constexpr (LS == 1) split_chunk(it);
        issue_chunk(it);
        if constexpr (LS == 2) {
          if (it + 1 < n_k * nc) split_chunk(it + 1);
        }
        wgmma_wait<0>();"""),
    ("""    for (int j = 0; j < n_k; ++j) {
      // S and dP of tile j, summed""",
     """    if constexpr (LS == 2) {
      if (n_k > 0) split_chunk(0);
    }
    for (int j = 0; j < n_k; ++j) {
      // S and dP of tile j, summed""")]

# name -> [(the lines as they stand in flash_f32.cu, the lines instead)]
VARIANTS = {
    "one_pass": [(_S3, "        wgmma_ss_tf32<BN>(sc, qhd + qa, khd + kb, "
                       "kk > 0);"),
                 (_PV3, "        wgmma_rs_tf32<D>(acc, ph[kk], vhd + vb);"),
                 (_S3W, "        wgmma_ss_tf32<BN>(sc, qhid + qs, khid + ks, "
                        "!first || kk > 0);"),
                 (_PV3W, "        wgmma_rs_tf32<CW>(acc, ph[kk], vhid + vk);"),
                 *_F32DQ_S, _F32DQ_DQ, *_F32DKV_S, *_F32DKV_PV],
    "no_split": [(_SPLIT, "  const uint32_t hi = __float_as_uint(x);\n"
                          "  const uint32_t lo = hi;")],
    "dq_no_qsplit": [("      split_rows(qhi, qlo);\n"
                      "      split_rows(dohi, dolo);\n", "")],
    "dq_no_prologue": [(_DQ_PROLOGUE, _DQ_PROLOGUE.splitlines()[0])],
    "dq_loads_once": [
        (_DQ_LOADS, "if (it < ST) {\n" + _DQ_LOADS
         + "\n} else { mbar_arrive(&full[s]); }"),
        (_DQ_KT_LOADS, "if (j == 0) {\n" + _DQ_KT_LOADS
         + "\n} else { mbar_arrive(kt_full); }")],
    "dq_turns": _DQ_TURNS,
    "dq_split_ahead": _DQ_SPLIT_AHEAD,
    "dkv_no_prologue": [(_DKV_PROLOGUE, "")],
    "dkv_joint_sums": _DKV_SUMS,
    "dkv_loads_once": [(_DKV_LOADS, "          if (it >= ST) {\n"
                        "            mbar_arrive(&full[s]);\n"
                        "          } else if (c < nc) {\n"
                        "            mbar_expect_tx(&full[s], C::CHUNK_BYTES);")],
    "dkv_no_frag_split": _DKV_FRAGS,
}


def build_set(build, fa, csrc: Path, root: Path) -> dict:
    """flash_f32.cu of `csrc` built under `root`: {kernel: C entry}."""
    build.CSRC, build.BUILD_ROOT = csrc, root
    lib = ctypes.CDLL(str(build.build((fa.TF32_SOURCE,))[fa.TF32_SOURCE]))
    out = {}
    for name in sorted(fa.TF32_KERNELS):
        fn = getattr(lib, f"voda_{name}")
        fn.argtypes = fa._ARGTYPES[name]
        fn.restype = ctypes.c_int
        out[name] = fn
    return out


def make(sound: Path, name: str) -> Path:
    base = Path(ROOT) / "build" / "f32_ablate" / name
    shutil.rmtree(base, ignore_errors=True)
    shutil.copytree(sound, base / "csrc")
    path = base / "csrc" / "flash_f32.cu"
    text = path.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the lines to change are not once in "
                             "flash_f32.cu")
        text = text.replace(old, new)
    path.write_text(text)
    return base / "csrc"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--shape", choices=sorted(SHAPES), default="d64")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_f32_ablate: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke
    from vodascheduler_tpu_torch.ops import _build as build
    from vodascheduler_tpu_torch.ops import flash_attention as fa

    log = chip_smoke.log
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip().splitlines()[0])
    sound, sound_root = build.CSRC, build.BUILD_ROOT
    sets = {"tree": build_set(build, fa, sound, sound_root)}
    for name in VARIANTS:
        csrc = make(sound, name)
        sets[name] = build_set(build, fa, csrc, csrc.parent / "lib")
    build.CSRC, build.BUILD_ROOT = sound, sound_root
    B, H, Sq, Sk, D, causal, q_off = SHAPES[args.shape]
    g = torch.Generator("cuda").manual_seed(2)
    q, k, v, do = (torch.randn(B, S, H, D, generator=g, device="cuda")
                   for S in (Sq, Sk, Sk, Sq))
    entry = fa._entry
    fa._entry = lambda n: sets["tree"][n] if n in fa.TF32_KERNELS else entry(n)
    o, lse = fa.flash_fwd(q, k, v, causal, q_off)
    _, delta = fa.flash_dq(q, k, v, o, do, lse, causal, q_off)
    calls = {fa._kernel("flash_fwd", D, torch.float32):
             lambda: fa.flash_fwd(q, k, v, causal, q_off),
             fa._kernel("flash_dq", D, torch.float32):
             lambda: fa.flash_dq(q, k, v, o, do, lse, causal, q_off),
             fa._kernel("flash_dkv", D, torch.float32):
             lambda: fa.flash_dkv(q, k, v, do, lse, delta, causal, q_off)}
    ms = {n: {kn: [] for kn in calls} for n in sets}
    order = list(sets)
    for _ in range(args.rounds):
        for name in order + order[::-1]:
            fa._entry = (lambda n, s=sets[name]: s[n] if n in fa.TF32_KERNELS
                         else entry(n))
            for kn, call in calls.items():
                ms[name][kn].append(chip_smoke.cuda_ms(call))
    fa._entry = entry
    for name in sets:
        med = {kn: statistics.median(t) for kn, t in ms[name].items()}
        log(f"f32_ablate[{name}] " + " ".join(
            f"{kn}={med[kn]:.4f} ms "
            f"({med[kn] / statistics.median(ms['tree'][kn]):.3f} of the "
            f"tree's) {[round(x, 4) for x in ms[name][kn]]}" for kn in med))
    return 0


if __name__ == "__main__":
    sys.exit(main())
