"""Loader for the C++ resched-hot-path kernels (voda_native.cc).

Builds `_voda_native.so` on demand with g++ and exposes ctypes wrappers.
Every caller keeps a pure-Python fallback — the native path is a drop-in
accelerator, never a requirement (SURVEY.md §2.9).

The library is built into ``build/native/<source hash>/`` beside the
package, never into the package itself: the hash covers the source and
the flags, so a changed source builds anew, and each process compiles
to its own temporary name before an atomic rename, so concurrent
processes (test workers, supervisors) never write one file.

Set VODA_NO_NATIVE=1 to force the Python fallbacks (used by parity tests).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

log = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "voda_native.cc")
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(_HERE)),
                           "build", "native")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _so_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD_ROOT, h.hexdigest()[:16], "_voda_native.so")


def _build(so: str) -> bool:
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", *_FLAGS, "-o", tmp, _SRC]
    try:
        os.makedirs(os.path.dirname(so), exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        log.debug("native build failed (falling back to Python): %s", e)
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, building it on first use; None if unavailable."""
    global _lib, _load_failed
    if os.environ.get("VODA_NO_NATIVE"):  # kill-switch beats the cache
        return None
    if _lib is not None:
        return _lib
    if _load_failed:
        return None
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        so = _so_path()
        if not os.path.exists(so) and not _build(so):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(so)
            lib.voda_hungarian_max.argtypes = [
                ctypes.c_int32, ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_int32)]
            lib.voda_hungarian_max.restype = None
            lib.voda_ffdl_dp.argtypes = [
                ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32)]
            lib.voda_ffdl_dp.restype = None
            # PR 8 kernels (decide-path fast kernels): bound leniently so
            # a stale prebuilt .so without them still serves the original
            # ABI-stable entry points (callers fall back to Python).
            try:
                lib.voda_hungarian_warm.argtypes = [
                    ctypes.c_int32, ctypes.POINTER(ctypes.c_double),
                    ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_double),
                    ctypes.POINTER(ctypes.c_double)]
                lib.voda_hungarian_warm.restype = None
                lib.voda_lexmin_pm.argtypes = [
                    ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8),
                    ctypes.POINTER(ctypes.c_int32)]
                lib.voda_lexmin_pm.restype = None
            except AttributeError:  # pragma: no cover - stale binary
                log.debug("stale native binary lacks the warm kernels; "
                          "rebuild with `make native`")
            # PR 11 fleet batch kernels (greedy sweeps, the
            # ElasticTiresias auction, fleet comms scoring) — same
            # lenient binding: a stale prebuilt .so keeps serving the
            # older ABI and callers fall back to the Python fastpath.
            try:
                i32p = ctypes.POINTER(ctypes.c_int32)
                i64p = ctypes.POINTER(ctypes.c_int64)
                u8p = ctypes.POINTER(ctypes.c_uint8)
                f64p = ctypes.POINTER(ctypes.c_double)
                lib.voda_alloc_sweep.argtypes = [
                    ctypes.c_int32, i32p, i32p, i32p, i32p,
                    ctypes.c_int32, ctypes.c_int32, i32p]
                lib.voda_alloc_sweep.restype = None
                lib.voda_et_schedule.argtypes = [
                    ctypes.c_int32, i32p, i32p, i32p, i32p, i32p,
                    u8p, u8p, ctypes.c_int32, ctypes.c_int32,
                    ctypes.c_double, i32p, i64p, f64p, ctypes.c_int32,
                    i32p, i32p]
                lib.voda_et_schedule.restype = None
                lib.voda_comms_score.argtypes = [
                    ctypes.c_int32, i32p, ctypes.c_int32, i64p, i32p,
                    i32p, u8p, i64p, i64p]
                lib.voda_comms_score.restype = None
            except AttributeError:  # pragma: no cover - stale binary
                log.debug("stale native binary lacks the fleet batch "
                          "kernels; rebuild with `make native`")
            _lib = lib
        except OSError as e:
            log.debug("native load failed: %s", e)
            _load_failed = True
    return _lib


def hungarian_max(score: Sequence[Sequence[float]]) -> Optional[List[Tuple[int, int]]]:
    """Native max-assignment; None if the kernel is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(score)
    flat = (ctypes.c_double * (n * n))()
    for i, row in enumerate(score):
        for j, x in enumerate(row):
            flat[i * n + j] = float(x)
    out = (ctypes.c_int32 * n)()
    lib.voda_hungarian_max(n, flat, out)
    return [(i, int(out[i])) for i in range(n)]


def hungarian_warm(score: Sequence[Sequence[float]], row_to_col: List[int],
                   u: List[float], v: List[float], dirty: Sequence[int]):
    """Native warm/cold JV augmentation of `dirty` rows against the
    given duals + partial assignment; returns (row_to_col, u, v) or
    None when the kernel is unavailable (pure-Python fallback in
    placement/hungarian.py)."""
    lib = get_lib()
    if lib is None:
        return None
    try:
        warm_fn = lib.voda_hungarian_warm
    except AttributeError:  # pragma: no cover - stale prebuilt binary
        return None
    n = len(score)
    if n == 0 or not dirty:
        return list(row_to_col), list(u), list(v)
    try:  # numpy marshalling: a Python n^2 fill would dwarf the solve
        import numpy as np
        flat = (ctypes.c_double * (n * n)).from_buffer_copy(
            np.ascontiguousarray(score, dtype=np.float64).tobytes())
    except ImportError:  # pragma: no cover - numpy ships with jax
        flat = (ctypes.c_double * (n * n))()
        for i, row in enumerate(score):
            for j, x in enumerate(row):
                flat[i * n + j] = float(x)
    c_dirty = (ctypes.c_int32 * len(dirty))(*dirty)
    c_rtc = (ctypes.c_int32 * n)(*row_to_col)
    c_u = (ctypes.c_double * n)(*u)
    c_v = (ctypes.c_double * n)(*v)
    warm_fn(n, flat, len(dirty), c_dirty, c_rtc, c_u, c_v)
    return ([int(c_rtc[i]) for i in range(n)],
            [float(c_u[i]) for i in range(n)],
            [float(c_v[j]) for j in range(n)])


def lexmin_pm(tight, row_to_col: List[int]):
    """Native lexicographically-smallest perfect matching of the tight
    graph (`tight`: n x n numpy bool / 0-1 array, row-major);
    `row_to_col` must be a perfect matching within it. Returns the
    canonical row_to_col, or None when the kernel is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    try:
        lexmin_fn = lib.voda_lexmin_pm
    except AttributeError:  # pragma: no cover - stale prebuilt binary
        return None
    n = len(row_to_col)
    if n == 0:
        return []
    try:
        buf = tight.astype("uint8").tobytes()  # numpy path
    except AttributeError:
        buf = bytes(1 if x else 0 for row in tight for x in row)
    c_tight = (ctypes.c_uint8 * (n * n)).from_buffer_copy(buf)
    c_rtc = (ctypes.c_int32 * n)(*row_to_col)
    lexmin_fn(n, c_tight, c_rtc)
    return [int(c_rtc[i]) for i in range(n)]


def _i32(values) -> "object":
    """int32 ctypes view of a Python int sequence via numpy (a pure-
    ctypes splat costs more than some kernels it feeds at 100k jobs).
    Returns (array-keepalive, pointer)."""
    import numpy as np
    arr = np.asarray(values, dtype=np.int32)
    if not arr.flags["C_CONTIGUOUS"]:  # pragma: no cover - asarray copies
        arr = np.ascontiguousarray(arr)
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64(values):
    import numpy as np
    arr = np.asarray(values, dtype=np.int64)
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _u8(values):
    import numpy as np
    arr = np.asarray(values, dtype=np.uint8)
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f64(values):
    import numpy as np
    arr = np.asarray(values, dtype=np.float64)
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def alloc_sweep(order: Sequence[int], mins: Sequence[int],
                maxes: Sequence[int], nums: Sequence[int],
                free_chips: int, mode: int) -> Optional[List[int]]:
    """Native greedy allocation sweep (fastpath.py semantics): mode
    0 = minimums only, 1 = minimums + water-filled leftover, 2 = fixed
    NumProc. Returns the per-index result list, or None when the kernel
    is unavailable (callers keep the pure-Python sweeps)."""
    lib = get_lib()
    if lib is None:
        return None
    try:
        fn = lib.voda_alloc_sweep
    except AttributeError:  # pragma: no cover - stale prebuilt binary
        return None
    n = len(order)
    if n == 0:
        return []
    try:
        import numpy as np
    except ImportError:  # pragma: no cover - numpy ships with jax
        return None
    k_order, p_order = _i32(order)
    k_mins, p_mins = _i32(mins)
    k_maxes, p_maxes = _i32(maxes)
    k_nums, p_nums = _i32(nums)
    out = np.zeros(n, dtype=np.int32)
    fn(n, p_order, p_mins, p_maxes, p_nums, int(free_chips), int(mode),
       out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    del k_order, k_mins, k_maxes, k_nums
    return out.tolist()


def et_schedule(order: Sequence[int], mins: Sequence[int],
                maxes: Sequence[int], nums: Sequence[int],
                prios: Sequence[int], lease_ok: Sequence[int],
                lift_ok: Sequence[int], free_chips: int,
                compaction_threshold: int, floor_lift_weight: float,
                curve_idx: Sequence[int], curve_off: Sequence[int],
                curves: Sequence[float], run_auction: bool = True
                ) -> Optional[Tuple[List[int], int]]:
    """Native ElasticTiresias, bit-identical to
    fastpath.py::elastic_tiresias: phases 0/1/compaction always, plus
    the lazy-heap auction when `run_auction` (curves arrive
    deduplicated — job i reads row curve_idx[i]; row c spans
    curve_off[c]..curve_off[c+1] of the flat `curves`; with
    run_auction=False they may be dummies and the caller finishes with
    the retained Python auction). Returns (result, post-phase free) or
    None when the kernel is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    try:
        fn = lib.voda_et_schedule
    except AttributeError:  # pragma: no cover - stale prebuilt binary
        return None
    n = len(order)
    if n == 0:
        return [], int(free_chips)
    try:
        import numpy as np
    except ImportError:  # pragma: no cover - numpy ships with jax
        return None
    keep = []
    ptrs = []
    for conv, values in ((_i32, order), (_i32, mins), (_i32, maxes),
                         (_i32, nums), (_i32, prios), (_u8, lease_ok),
                         (_u8, lift_ok), (_i32, curve_idx),
                         (_i64, curve_off), (_f64, curves)):
        arr, ptr = conv(values)
        keep.append(arr)
        ptrs.append(ptr)
    out = np.zeros(n, dtype=np.int32)
    free_out = ctypes.c_int32(0)
    fn(n, ptrs[0], ptrs[1], ptrs[2], ptrs[3], ptrs[4], ptrs[5], ptrs[6],
       int(free_chips), int(compaction_threshold),
       float(floor_lift_weight), ptrs[7], ptrs[8], ptrs[9],
       1 if run_auction else 0,
       out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
       ctypes.byref(free_out))
    del keep
    return out.tolist(), int(free_out.value)


def comms_score(grid: Sequence[int], offsets: Sequence[int],
                coords: Sequence[int], weights: Sequence[int],
                crossed: Sequence[int]
                ) -> Optional[Tuple[List[int], Tuple[int, int, int]]]:
    """Native fleet comms scoring (placement manager `_fleet_stats`
    semantics): per-job contiguity costs plus the (cross, contiguity,
    comms) fleet totals. `coords` is row-major (sum of per-job host
    counts) x len(grid). None when the kernel is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    try:
        fn = lib.voda_comms_score
    except AttributeError:  # pragma: no cover - stale prebuilt binary
        return None
    n_jobs = len(weights)
    try:
        import numpy as np
    except ImportError:  # pragma: no cover - numpy ships with jax
        return None
    k_grid, p_grid = _i32(grid)
    k_off, p_off = _i64(offsets)
    k_coords, p_coords = _i32(coords)
    k_w, p_w = _i32(weights)
    k_x, p_x = _u8(crossed)
    out_contig = np.zeros(max(1, n_jobs), dtype=np.int64)
    out_totals = np.zeros(3, dtype=np.int64)
    fn(len(grid), p_grid, n_jobs, p_off, p_coords, p_w, p_x,
       out_contig.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
       out_totals.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    del k_grid, k_off, k_coords, k_w, k_x
    return (out_contig.tolist()[:n_jobs],
            (int(out_totals[0]), int(out_totals[1]), int(out_totals[2])))


def ffdl_dp(K: int, lo: Sequence[int], hi: Sequence[int],
            speedup_rows: Sequence[Sequence[float]]) -> Optional[List[int]]:
    """Native FfDL DP; speedup_rows[j][g] for g in 0..K. None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    J = len(lo)
    W = K + 1
    c_lo = (ctypes.c_int32 * J)(*lo)
    c_hi = (ctypes.c_int32 * J)(*hi)
    flat = (ctypes.c_double * (J * W))()
    for j, row in enumerate(speedup_rows):
        for g in range(W):
            flat[j * W + g] = float(row[g])
    out = (ctypes.c_int32 * J)()
    lib.voda_ffdl_dp(J, K, c_lo, c_hi, flat, out)
    return [int(out[j]) for j in range(J)]
