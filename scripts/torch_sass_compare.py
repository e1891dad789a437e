"""Compares the machine code (SASS) of the flash-attention kernels of two
source trees: whether a change to the sources left them as they were.

    python3 scripts/torch_sass_compare.py [--base build/ab_parent/csrc]
        [--sources flash_fwd flash_dq flash_dkv flash_fwd_wide
                   flash_dq_wide flash_dkv_wide]

`--base` is a copy of another commit's ``vodascheduler_tpu_torch/ops/csrc``
(written as scripts/torch_kernel_ab.py says). Both trees' `--sources` are
built by the package's build module (``ops/_build.py``), each into its own
directory, and ``cuobjdump -sass`` lists every function of each library.
A kernel is named by its function, head width and element type, read from
its mangled name (a template parameter added to a kernel changes the name
and nothing else; a name without an element type is bf16's). For each
kernel of the base the script prints whether the tree's SASS of it is
identical, instruction for instruction with its encoding (each line with
its runs of blanks collapsed: cuobjdump pads its columns to the widest
instruction of the whole library, so a kernel added to a source moves the
columns of the others), or how many lines differ, then a last line of JSON. Exits non-zero without ``cuobjdump`` or the base
sources, or when a base kernel is missing from the tree; a kernel whose
SASS differs is reported, not refused. For every kernel of the tree it
also prints the tensor-core instructions it issues (``HGMMA``, with their
shapes and types: a kernel that issues none runs its products on the CUDA
cores). Needs ``nvcc`` and ``cuobjdump``, not a card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SOURCES = ("flash_fwd", "flash_dq", "flash_dkv", "flash_fwd_wide",
           "flash_dq_wide", "flash_dkv_wide")


def kernel_key(mangled: str):
    """(function, head width, element type) of a kernel's mangled name, or
    None for a function that is no templated flash kernel."""
    m = re.search(r"(flash_\w+?)_kernelILi(\d+)E(6__half|13__nv_bfloat16)?",
                  mangled)
    if not m:
        return None
    return m.group(1), int(m.group(2)), "f16" if m.group(3) == "6__half" \
        else "bf16"


def sass_by_kernel(lib: Path) -> dict:
    """(function, width, type) -> the SASS lines of that kernel in `lib`,
    each with its runs of blanks collapsed to one space."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out, key = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            key = kernel_key(m.group(1))
            if key:
                out[key] = []
            continue
        if key and line.strip():
            out[key].append(" ".join(line.split()))
    return out


def hgmma_forms(lines) -> dict:
    """{HGMMA opcode with its modifiers: count} in a kernel's SASS."""
    out = {}
    for line in lines:
        m = re.search(r"\b(HGMMA\.\S+)", line)
        if m:
            out[m.group(1)] = out.get(m.group(1), 0) + 1
    return out


def build_tree(build, csrc: Path, root: Path, sources) -> dict:
    build.CSRC, build.BUILD_ROOT = Path(csrc), Path(root)
    return build.build(sources)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", default=os.path.join(ROOT, "build", "ab_parent",
                                                   "csrc"))
    ap.add_argument("--sources", nargs="+", default=list(SOURCES))
    args = ap.parse_args()
    base = Path(args.base)
    if not all((base / f"{n}.cu").is_file() for n in args.sources):
        print(f"torch_sass_compare: no base sources in {base}",
              file=sys.stderr)
        return 1
    if not (shutil.which("cuobjdump")
            or os.path.exists("/usr/local/cuda/bin/cuobjdump")):
        print("torch_sass_compare: cuobjdump not found", file=sys.stderr)
        return 1
    from vodascheduler_tpu_torch.ops import _build as build

    tree_libs = build_tree(build, build.CSRC, build.BUILD_ROOT, args.sources)
    base_libs = build_tree(build, base, base.parent / "sass_lib",
                           args.sources)
    result, missing, hgmma = {}, [], {}
    for src in args.sources:
        old, new = sass_by_kernel(base_libs[src]), sass_by_kernel(tree_libs[src])
        for key, lines in sorted(old.items()):
            name = f"{key[0]}@D={key[1]}/{key[2]}"
            if key not in new:
                missing.append(name)
                print(f"sass[{name}] missing from the tree", flush=True)
                continue
            differ = sum(a != b for a, b in zip(lines, new[key])) + abs(
                len(lines) - len(new[key]))
            result[name] = {"lines": len(lines), "differ": differ}
            print(f"sass[{name}] {len(lines)} lines: "
                  + ("identical" if not differ else f"{differ} differ"),
                  flush=True)
        for key, lines in sorted(new.items()):
            name = f"{key[0]}@D={key[1]}/{key[2]}"
            hgmma[name] = hgmma_forms(lines)
            print(f"hgmma[{name}] {sum(hgmma[name].values())} "
                  f"instructions: {hgmma[name]}", flush=True)
        extra = sorted(set(new) - set(old))
        print(f"sass[{src}] kernels only in the tree: "
              + (" ".join(f"{k[0]}@D={k[1]}/{k[2]}" for k in extra) or "none"),
              flush=True)
    print(json.dumps({"identical": not missing and not any(
        r["differ"] for r in result.values()), "kernels": result,
        "missing": missing, "hgmma": hgmma}), flush=True)
    return 1 if missing else 0


if __name__ == "__main__":
    sys.exit(main())
