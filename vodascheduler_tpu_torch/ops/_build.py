"""Builds the CUDA sources in ``ops/csrc`` and loads them with ctypes.

Each ``*.cu`` file becomes its own shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a``. All sources build in parallel, one
``nvcc`` each, at first use, into ``build/torch_kernels/<hash>/`` beside
the package, where the hash covers the sources, the headers and the flags:
a changed source builds anew and an unchanged one loads from disk.
``nvcc -Xptxas -v`` writes each kernel's register and shared-memory use to
``<name>.log`` in the same directory.

Nothing here runs at import: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("flash_fwd", "flash_dq", "flash_dkv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Dict[str, Path]:
    """Compiles every source whose library is missing; returns name -> .so."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    libs = {n: out / f"lib{n}.so" for n in SOURCES}
    todo = [n for n in SOURCES if not libs[n].exists()]
    if not todo:
        return libs
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = out / f"lib{n}.so.{os.getpid()}.tmp"
        log = open(out / f"{n}.log", "w")
        procs[n] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for n, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc:
            failed.append(f"{n} (rc {rc}):\n{(out / f'{n}.log').read_text()}")
        else:
            os.replace(tmp, libs[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source `name`, building all sources if needed."""
    with _lock:
        if name not in _libs:
            for n, path in build().items():
                _libs.setdefault(n, ctypes.CDLL(str(path)))
        return _libs[name]
