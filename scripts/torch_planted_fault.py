"""Shows that the bars of chip_smoke.py reject flash-attention kernels with
a planted fault, beside what the sound kernels read against them.

    python3 scripts/torch_planted_fault.py

Each fault is planted in a copy of ``vodascheduler_tpu_torch/ops/csrc``
under ``build/planted_fault/`` and built there; the sources of the package
are not touched. The faults sit where a bar held against the largest value
of a whole tensor cannot see them, in the late causal rows whose values are
small:

- ``fwd_last_tile``: K1 skips the P·V product of the last K/V tile it visits
  in the last 64-row query tile of every (batch, head). lse stays exact.
- ``dkv_last_tile``: K3 never accumulates dV for the last 64-row key tile.

At llama_350m's attention shape (B=8, H=16, S=2048, D=64, bf16, causal)
the script logs each kernel set's errors against the plain versions under
chip_smoke.py's bars, then llama_350m's forward and backward through each
set against the plain attention (chip_smoke.py's slice comparison). It
exits non-zero if the sound kernels break a bar or a faulty set passes the
kernel bars. Needs CUDA and nvcc.
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

# name -> (source file, the line as it stands, the line with the fault)
FAULTS = {
    "fwd_last_tile": (
        "flash_fwd.cu", "    mma_pm<D>(acc, s, vs, lane);\n",
        "    if (!(i == gridDim.x - 1 && (j + 1 == num_k ||"
        " !tile_runs(causal, q_off, i, j + 1))))\n"
        "      mma_pm<D>(acc, s, vs, lane);\n"),
    "dkv_last_tile": (
        "flash_dkv.cu", "    mma_pm<D>(dva, p, dos, lane);\n",
        "    if (j != gridDim.x - 1) mma_pm<D>(dva, p, dos, lane);\n"),
}
MAIN_SHAPE = (8, 16, 2048, 2048, 64, True, 0)


def use_sources(build, fa, csrc, build_root) -> None:
    """Points the kernels' loader at another source tree and drops the
    libraries it has loaded."""
    build.CSRC, build.BUILD_ROOT = csrc, build_root
    build._libs.clear()
    fa._entry.cache_clear()


def plant(sound_csrc: Path, name: str):
    """A copy of the sound sources with fault `name`: (csrc dir, build
    root)."""
    fname, old, new = FAULTS[name]
    base = os.path.join(ROOT, "build", "planted_fault", name)
    csrc = os.path.join(base, "csrc")
    shutil.rmtree(base, ignore_errors=True)
    shutil.copytree(sound_csrc, csrc)
    path = os.path.join(csrc, fname)
    with open(path) as f:
        text = f.read()
    if text.count(old) != 1:
        raise SystemExit(f"{name}: the line to change is not once in {fname}")
    with open(path, "w") as f:
        f.write(text.replace(old, new))
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

    sound = (build.CSRC, build.BUILD_ROOT)
    wrong = []
    for name in ("sound", *FAULTS):
        use_sources(build, fa, *(sound if name == "sound"
                                 else plant(sound[0], name)))
        build.build()
        log(f"--- {name}")
        _, bad = chip_smoke.kernel_errors(fa, name, MAIN_SHAPE)
        slice_bad = chip_smoke.check_slice(
            chip_smoke.slice_gaps(bundle, session.module, batch))
        log(f"verdict[{name}] kernel bars broken: {bad or 'none'}; "
            f"slice bars broken: {slice_bad or 'none'}")
        judged_right = (not (bad or slice_bad) if name == "sound"
                        else bool(bad))
        if not judged_right:
            wrong.append(name)
    if wrong:
        log(f"the bars misjudged: {wrong}")
        return 1
    log("the bars pass the sound kernels and reject every planted fault")
    return 0


if __name__ == "__main__":
    sys.exit(main())
