"""Times variants of the forward (K1), dQ (K2) and dK/dV (K3) kernels
against the sources as they stand, in turns, on one card: what each part
of a kernel costs, and what each design choice of theirs is worth.

    python3 scripts/torch_kernel_ablate.py [--rounds 6] [--only NAME ...]

Each variant is a copy of ``vodascheduler_tpu_torch/ops/csrc`` with a few
lines changed (VARIANTS below), built under ``build/kernel_ablate/<name>``
by the package's build module (``ops/_build.py``); the sources of the
package are not touched.
Some variants compute wrong results on purpose (they drop work to weigh
it) and are only timed. At llama_350m's attention shape (B=8, H=16,
S=2048, D=64, bf16, causal) every round times the tree and then each
variant, K1, K2, K3 and K2 then K3 (the backward) each by CUDA events
(chip_smoke.cuda_ms, 30 repeats after 5 warm-ups); the script prints the
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

F, Q, K = "flash_fwd.cu", "flash_dq.cu", "flash_dkv.cu"
_KV_LOADS = """        mbar_expect_tx(&k_full[s], C::KV_BYTES);
        tma_rows<D>(ks + s * C::BN * D, &tk, &k_full[s], C::BN, h, j * C::BN, b);
        mbar_expect_tx(&v_full[s], C::KV_BYTES);
        tma_rows<D>(vs + s * C::BN * D, &tv, &v_full[s], C::BN, h, j * C::BN, b);"""
_NO_SOFTMAX = (F, "      softmax_tile<C::BN>(sc,", "      if (j < 0) softmax_tile<C::BN>(sc,")
_KV_ONCE = (F, _KV_LOADS, "if (j < C::STAGES) {\n" + _KV_LOADS
            + "\n} else { mbar_arrive(&k_full[s]); mbar_arrive(&v_full[s]); }")
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
        (F, "const float p = fast_exp2(fmaf(sc[4 * c + e], sl2, -mrow[e >> 1]));",
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
        (Q, "      ds_tile<C::BN>(sc, dp,", "      if (j < 0) ds_tile<C::BN>(sc, dp,")]),
}


def make(sound: Path, name: str) -> Path:
    """A copy of the sources with variant `name` under build/kernel_ablate."""
    base = Path(ROOT) / "build" / "kernel_ablate" / name
    shutil.rmtree(base, ignore_errors=True)
    shutil.copytree(sound, base / "csrc")
    for fname, old, new in VARIANTS[name][1]:
        path = base / "csrc" / fname
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the lines to change are not once in "
                             f"{fname}")
        path.write_text(text.replace(old, new))
    return base / "csrc"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--only", nargs="*", choices=sorted(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_ablate: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke
    import torch_kernel_ab as ab
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
    q, k, v, do = ab.inputs(ab.MAIN_SHAPE)
    ms = {n: {kn: [] for kn in ab.ROWS} for n in sets}
    for _ in range(args.rounds):
        for name, entries in sets.items():
            ab.use_entries(fa, entries)
            for kn, call in ab.timers(fa, ab.MAIN_SHAPE, q, k, v, do).items():
                ms[name][kn].append(chip_smoke.cuda_ms(call, warmup=5, reps=30))
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
