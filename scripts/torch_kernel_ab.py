"""Times the forward (K1), dQ (K2) and dK/dV (K3) flash-attention kernels
of two source trees against each other, in turns, on one card.

    python3 scripts/torch_kernel_ab.py [--base build/ab_parent/csrc] [--reps 3]
        [--shape main|d128|d256|d512|d640|d640_record]
        [--dtype bf16|fp16|fp32]

`--base` is a copy of another commit's ``vodascheduler_tpu_torch/ops/csrc``
(the copy on the card is no git repository, so write it first, e.g. for the
parent commit P:

    mkdir -p build/ab_parent/csrc
    for f in $(git ls-tree --name-only P vodascheduler_tpu_torch/ops/csrc/); do
      git show P:$f > build/ab_parent/csrc/$(basename $f); done

). Both trees are built by the package's build module (``ops/_build.py``),
each into its own directory. At `--shape` each kernel is timed base,
tree, tree, base, `--reps` times over, by CUDA events (chip_smoke.cuda_ms:
median of 10 after 3 warm-ups), through the package's wrappers on the
same inputs, beside PyTorch's own flash attention forward and backward
(timed as a yardstick only) and each kernel's bound; K2 then K3, the whole
backward, is timed the same way as a row of its own ("backward") beside
the library's backward. The shapes (causal, S=2048, B=8): `main`,
llama_350m's attention (H=16, D=64, the kernels of flash_{fwd,dq,dkv}.cu,
as `d128` at H=8, D=128); `d256` (H=4, D=256) and `d512` (H=2, D=512),
the same width in wider heads, which run the wide kernels
(flash_{fwd,dq,dkv}_wide.cu; rows named with `_wide`); `d640` (H=2,
D=640), where the forward, dQ and dK/dV stream D (flash_fwd_chunked_kernel,
flash_dq_chunked_kernel, flash_dkv_chunked_kernel, in bf16 and fp16);
`d640_record` the same width at B=2, H=2, S=1024, the shape of the rows of
record of the kernels those replaced. `--dtype` (bf16 by default) picks the
tensors' type; each row is named after the kernel that launches there in
the tree, as its launches count (`flash_dq_f16_chunked` in fp16 at d640,
say; the backward after dQ's suffix), whatever kernel the base's entry
launches there (a base older than bf16's chunked dQ and dK/dV runs its
wmma pair under those rows). A base tree must hold the entries the
wrappers route to in that dtype (the parent of the commit that added
fp16's chunked dQ and dK/dV returns an error for fp16 above 512).
Where a base entry takes one pointer fewer than the tree's, its scratch,
which the wrappers pass last among the pointers (fp32's dK/dV before its
wgmma redesign took none), the base is called without it. Prints the
card's name and power limit, every reading, and a last line of JSON with
the medians and base/tree ratios. Exits non-zero
without a card or without the base sources; it prints no time it did not
measure.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MAIN_SHAPE = (8, 16, 2048, 2048, 64, True, 0)
SHAPES = {"main": MAIN_SHAPE,
          "d128": (8, 8, 2048, 2048, 128, True, 0),
          "d256": (8, 4, 2048, 2048, 256, True, 0),
          "d512": (8, 2, 2048, 2048, 512, True, 0),
          "d640": (8, 2, 2048, 2048, 640, True, 0),
          "d640_record": (2, 2, 1024, 1024, 640, True, 0)}
KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
ROWS = KERNELS + ("backward",)
DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16,
          "fp32": torch.float32}


def row_names(fa, shape, dtype=torch.bfloat16) -> dict:
    """ROWS -> the name each row has at `shape` in `dtype`: each kernel's
    as its launches count there (a wide head's carry `_wide`, fp16's
    `_f16`, a kernel that streams D `_chunked`), the backward's with dQ's
    suffix."""
    D = shape[4]
    names = {r: fa.counted(fa._kernel(r, D, dtype), D) for r in KERNELS}
    names["backward"] = "backward" + names["flash_dq"][len("flash_dq"):]
    return names


def pointers(text: str, name: str):
    """The number of pointer parameters of C entry ``voda_<name>`` in the
    source `text`, or None where it is not there."""
    m = re.search(rf'extern "C" int voda_{name}\(([^)]*)\)', text)
    return None if m is None else m.group(1).count("*") - 1  # the stream


def load_entries(build, fa, csrc: Path, build_root: Path) -> dict:
    """Builds the sources in `csrc` into `build_root` and returns each
    kernel's C entry point, as the wrappers call it: an entry that takes
    one pointer fewer than the wrappers pass (no scratch) is called
    without the last of them."""
    build.CSRC, build.BUILD_ROOT = Path(csrc), Path(build_root)
    build._libs.clear()
    out = {}
    # an older tree may lack sources the package has since gained
    # (the CUDA-core sources are not compared here)
    present = [n for n in build.SOURCES
               if n != fa.SIMT_SOURCE and (Path(csrc) / f"{n}.cu").exists()]
    libs = {src: ctypes.CDLL(str(path))
            for src, path in build.build(present).items()}
    # every entry of those sources the wrappers may route to, where the
    # tree has it
    for name in fa._ARGTYPES:
        fn = getattr(libs.get(fa.source(name)), f"voda_{name}", None)
        if fn is None:
            continue
        types = fa._ARGTYPES[name]
        n = types.index(ctypes.c_int)  # the wrappers' pointers
        text = (Path(csrc) / f"{fa.source(name)}.cu").read_text()
        fn.restype = ctypes.c_int
        if pointers(text, name) == n - 1:
            fn.argtypes = types[:n - 1] + types[n:]
            out[name] = (lambda *a, fn=fn, n=n: fn(*a[:n - 1], *a[n:]))
        else:
            fn.argtypes = types
            out[name] = fn
    return out


def use_entries(fa, entries: dict) -> None:
    """Routes the wrappers' launches to `entries`."""
    fa._entry = entries.__getitem__


def inputs(shape, dtype=torch.bfloat16):
    B, H, Sq, Sk, D, causal, q_off = shape
    g = torch.Generator("cuda").manual_seed(2)
    return [torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
            for S in (Sq, Sk, Sk, Sq)]


def timers(fa, shape, q, k, v, do):
    """row name (each kernel, and "backward": K2 then K3) -> a call of the
    wrappers on these inputs."""
    import chip_smoke
    causal, q_off = shape[5], shape[6]
    o, lse = fa.flash_fwd(q, k, v, causal, q_off)
    _, delta = fa.flash_dq(q, k, v, o, do, lse, causal, q_off)
    return {"flash_fwd": lambda: fa.flash_fwd(q, k, v, causal, q_off),
            "flash_dq": lambda: fa.flash_dq(q, k, v, o, do, lse, causal,
                                            q_off),
            "flash_dkv": lambda: fa.flash_dkv(q, k, v, do, lse, delta, causal,
                                              q_off),
            "backward": chip_smoke.backward_call(fa, q, k, v, o, do, lse,
                                                 causal, q_off)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", default=os.path.join(ROOT, "build", "ab_parent",
                                                   "csrc"))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--shape", choices=sorted(SHAPES), default="main")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    args = ap.parse_args()
    shape, dtype = SHAPES[args.shape], DTYPES[args.dtype]
    if not torch.cuda.is_available():
        print("torch_kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    base = Path(args.base)
    if not all((base / f"{n}.cu").is_file() for n in KERNELS):
        print(f"torch_kernel_ab: no base sources in {base}", file=sys.stderr)
        return 1
    import chip_smoke
    from vodascheduler_tpu_torch.ops import _build as build
    from vodascheduler_tpu_torch.ops import flash_attention as fa

    names = row_names(fa, shape, dtype)
    log = chip_smoke.log
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip().splitlines()[0])
    sets = {"tree": load_entries(build, fa, build.CSRC, build.BUILD_ROOT),
            "base": load_entries(build, fa, base, base.parent / "lib")}
    log(f"shape {args.shape} (B, H, Sq, Sk, D, causal, q_off) = {shape} "
        f"{args.dtype}")
    q, k, v, do = inputs(shape, dtype)
    readings = {n: {"base": [], "tree": []} for n in ROWS}
    for rep in range(args.reps):
        for which in ("base", "tree", "tree", "base"):
            use_entries(fa, sets[which])
            for name, call in timers(fa, shape, q, k, v, do).items():
                ms = chip_smoke.cuda_ms(call)
                readings[name][which].append(ms)
                log(f"rep {rep} {which} {names[name]} ms={ms:.4f}")
    lib_fwd, lib_bwd = chip_smoke.library_times(q, k, v, do, shape[5])
    log(f"library fwd_ms={lib_fwd:.4f} bwd_ms={lib_bwd:.4f} (dq, dk, dv)")
    bounds = {"flash_fwd": chip_smoke.bound(2, 4, 1, *shape, dtype),
              "flash_dq": chip_smoke.bound(3, 6, 2, *shape, dtype),
              "flash_dkv": chip_smoke.bound(4, 6, 2, *shape, dtype),
              "backward": chip_smoke.bound(7, 8, 1, *shape, dtype)}
    library = {"flash_fwd": lib_fwd, "flash_dq": lib_bwd, "flash_dkv": lib_bwd,
               "backward": lib_bwd}
    summary = {}
    for name in ROWS:
        b = statistics.median(readings[name]["base"])
        t = statistics.median(readings[name]["tree"])
        summary[names[name]] = {
            "base_ms": b, "tree_ms": t, "base_over_tree": b / t,
            "bound_ms": bounds[name][0],
            "tree_share_of_bound": bounds[name][0] / t,
            "base_share_of_bound": bounds[name][0] / b,
            "library_ms": library[name]}
        log(f"{names[name]}: base {b:.4f} ms, tree {t:.4f} ms, base/tree "
            f"{b / t:.3f}, tree at {bounds[name][0] / t:.3f} of its bound "
            f"({bounds[name][0]:.4f} ms), library {library[name]:.4f} ms")
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
