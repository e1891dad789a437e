"""GPU telemetry: the supervisor's memory readings and the control plane's
card exporter.

Counterpart of the JAX package's ``runtime/tpu_monitor.py``:

- `hbm_in_use_bytes` attaches device memory before and after a resize to
  the supervisor's spans: the bytes the caching allocator holds in live
  tensors (``allocated_bytes.all.current`` of `torch.cuda.memory_stats`),
  summed over this process's CUDA devices;
- `telemetry_snapshot` is one benchmark point's memory as its process
  ends (the benchrunner's worker and the resize bench's children): the
  caching allocator's current and peak bytes for each device this process
  initialised, and each card's NVML reading of memory used and total and
  of its power limit;
- `GpuMonitor` publishes the cards' counters as labelled gauges on the
  control plane's /metrics endpoints, where `TpuMonitor` publishes the
  TPU's. Like it, it has no timer of its own: the service daemon's
  periodic list calls `collect_once()`.

The monitor reads each card's counters through NVML
(``libnvidia-ml.so.1`` by ctypes), never through CUDA: it creates no CUDA context in the server's
process, so the control plane holds no card memory that the jobs need (the
TPU monitor keeps the server off the chips for the same reason). NVML's
readings are the card's, all processes together, where libtpu's memory
statistics are the reading process's.

Series, each labelled ``accelerator`` (the NVML index), and the TPU series
each stands for:

=====================================  ====================================
``voda_gpu_devices``                   ``voda_tpu_devices``
``voda_gpu_memory_bytes_in_use``       ``voda_tpu_memory_bytes_in_use``,
                                       ``voda_tpu_hbm_usage_bytes``
``voda_gpu_memory_bytes_total``        ``voda_tpu_memory_bytes_limit``,
                                       ``voda_tpu_hbm_total_bytes``
``voda_gpu_memory_bytes_free``         ``voda_tpu_memory_largest_free_block_bytes``
``voda_gpu_utilization_pct``           ``voda_tpu_duty_cycle_pct``
``voda_gpu_memory_utilization_pct``    none (the share of time the memory
                                       was read or written)
``voda_gpu_power_watts``,              ``voda_tpu_throttle_score`` (power
``voda_gpu_power_limit_watts``         near its limit is where a card
                                       slows)
=====================================  ====================================

NVML has no counterpart of ``voda_tpu_memory_peak_bytes_in_use`` or of
``voda_tpu_tensorcore_util_pct``.

In hermetic mode (jobs on the CPU) the monitor exports only the device
count, the hermetic device count, as the TPU monitor does off-TPU. Enabled
on a host whose NVML cannot be loaded, it raises at construction: it never
quietly exports nothing.
"""

from __future__ import annotations

import ctypes
import logging
from typing import Dict, Optional

import torch

from vodascheduler_tpu_torch.common.metrics import Registry

log = logging.getLogger(__name__)

NVML_LIBRARY = "libnvidia-ml.so.1"
_NVML_ERROR_NOT_SUPPORTED = 3


def hbm_in_use_bytes() -> Optional[float]:
    """Bytes in use across the local CUDA devices, or None where there are
    no memory statistics (no CUDA, or none initialised by this process):
    callers skip the reading rather than record a zero."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    vals = [torch.cuda.memory_stats(i).get("allocated_bytes.all.current")
            for i in range(torch.cuda.device_count())]
    vals = [v for v in vals if v is not None]
    return float(sum(vals)) if vals else None


# torch.cuda.memory_stats keys a snapshot keeps: the bytes in live tensors
# now and at their peak, and the peak the caching allocator reserved.
_STAT_KEYS = ("allocated_bytes.all.current", "allocated_bytes.all.peak",
              "reserved_bytes.all.peak")
# NVML readings a snapshot keeps.
_NVML_KEYS = ("memory_bytes_in_use", "memory_bytes_total",
              "power_limit_watts")


def telemetry_snapshot() -> dict:
    """This process's device memory and the cards' NVML readings, for a
    benchmark point that is its own process: the allocator's peak is then
    the point's peak. ``{"memory": {device: {stat: bytes}}, "nvml": {card:
    {reading: value}}}``, each part left out where there is nothing to
    read (no CUDA initialised here, no NVML). Never raises."""
    out: dict = {}
    try:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            mem = {}
            for i in range(torch.cuda.device_count()):
                stats = torch.cuda.memory_stats(i)
                row = {k: float(stats[k]) for k in _STAT_KEYS if k in stats}
                if row:
                    mem[str(i)] = row
            if mem:
                out["memory"] = mem
    except Exception:  # noqa: BLE001 - telemetry must never fail a point
        pass
    try:
        reader = NvmlReader()
        cards = {}
        for i in range(reader.device_count()):
            row = {k: v for k, v in reader.read(i).items() if k in _NVML_KEYS}
            if row:
                cards[str(i)] = row
        if cards:
            out["nvml"] = cards
    except Exception:  # noqa: BLE001 - no NVML, or a card's read failed
        pass
    return out


class NvmlError(RuntimeError):
    def __init__(self, fn: str, code: int, text: str):
        super().__init__(f"{fn}: {text} (NVML error {code})")
        self.code = code


class _Memory(ctypes.Structure):
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


class _Utilization(ctypes.Structure):
    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


class NvmlReader:
    """Each card's counters, through NVML."""

    def __init__(self):
        # OSError where the host has no NVML library.
        self._lib = ctypes.CDLL(NVML_LIBRARY)
        self._lib.nvmlErrorString.restype = ctypes.c_char_p
        self._call("nvmlInit_v2")

    def _call(self, fn: str, *args) -> None:
        code = getattr(self._lib, fn)(*args)
        if code != 0:
            raise NvmlError(fn, code,
                            self._lib.nvmlErrorString(code).decode())

    def device_count(self) -> int:
        n = ctypes.c_uint()
        self._call("nvmlDeviceGetCount_v2", ctypes.byref(n))
        return n.value

    def read(self, index: int) -> Dict[str, float]:
        """{reading: value} of card `index`; a counter the card does not
        support is left out."""
        handle = ctypes.c_void_p()
        self._call("nvmlDeviceGetHandleByIndex_v2", ctypes.c_uint(index),
                   ctypes.byref(handle))
        mem, util = _Memory(), _Utilization()
        power, limit = ctypes.c_uint(), ctypes.c_uint()
        out: Dict[str, float] = {}
        for fn, arg, fill in (
                ("nvmlDeviceGetMemoryInfo", mem, lambda: {
                    "memory_bytes_in_use": mem.used,
                    "memory_bytes_total": mem.total,
                    "memory_bytes_free": mem.free}),
                ("nvmlDeviceGetUtilizationRates", util, lambda: {
                    "utilization_pct": util.gpu,
                    "memory_utilization_pct": util.memory}),
                ("nvmlDeviceGetPowerUsage", power, lambda: {
                    "power_watts": power.value / 1000.0}),
                ("nvmlDeviceGetEnforcedPowerLimit", limit, lambda: {
                    "power_limit_watts": limit.value / 1000.0})):
            try:
                self._call(fn, handle, ctypes.byref(arg))
            except NvmlError as e:
                if e.code != _NVML_ERROR_NOT_SUPPORTED:
                    raise
                continue
            out.update({k: float(v) for k, v in fill().items()})
        return out


# reading -> (series, help)
_SERIES = (
    ("memory_bytes_in_use", "voda_gpu_memory_bytes_in_use",
     "Card memory in use, all processes (NVML)"),
    ("memory_bytes_total", "voda_gpu_memory_bytes_total",
     "Card memory in all (NVML)"),
    ("memory_bytes_free", "voda_gpu_memory_bytes_free",
     "Card memory free (NVML)"),
    ("utilization_pct", "voda_gpu_utilization_pct",
     "Percentage of the last sample period in which a kernel ran (NVML)"),
    ("memory_utilization_pct", "voda_gpu_memory_utilization_pct",
     "Percentage of the last sample period in which memory was read or "
     "written (NVML)"),
    ("power_watts", "voda_gpu_power_watts", "Card power draw (NVML)"),
    ("power_limit_watts", "voda_gpu_power_limit_watts",
     "Enforced power limit of the card (NVML)"),
)


class GpuMonitor:
    """Polls every card's NVML counters into labelled gauges.

    `hermetic_devices` (jobs on the CPU) exports that count alone and reads
    nothing. `reader` stands in for NVML (tests); by default the monitor
    loads NVML here and raises if it cannot."""

    def __init__(self, registry: Registry,
                 hermetic_devices: Optional[int] = None,
                 reader: Optional[object] = None):
        self.hermetic_devices = hermetic_devices
        self.reader = None
        if hermetic_devices is None:
            if reader is None:
                try:
                    reader = NvmlReader()
                except (OSError, NvmlError) as e:
                    raise RuntimeError(
                        f"the GPU monitor is enabled but NVML "
                        f"({NVML_LIBRARY}) cannot be read: {e}") from e
            self.reader = reader
        self.m_devices = registry.gauge(
            "voda_gpu_devices", "Number of cards NVML reports")
        self.m_series = {} if self.reader is None else {
            key: registry.gauge(series, desc, labels=("accelerator",))
            for key, series, desc in _SERIES}

    def collect_once(self) -> None:
        if self.reader is None:
            self.m_devices.set(float(self.hermetic_devices))
            return
        try:
            count = self.reader.device_count()
        except Exception:  # noqa: BLE001 - NVML failed
            log.exception("device discovery failed")
            count = 0
        self.m_devices.set(float(count))
        # Full rebuild, swapped in atomically per series: cards that
        # vanished stop exporting, and a concurrent scrape never sees a
        # half-cleared label set.
        new_values = {key: {} for key in self.m_series}
        for i in range(count):
            try:
                readings = self.reader.read(i)
            except Exception:  # noqa: BLE001 - one card's read failed
                log.exception("reading card %d failed", i)
                readings = {}
            for key, value in readings.items():
                if key in new_values:
                    new_values[key][(str(i),)] = value
        for key, values in new_values.items():
            self.m_series[key].set_all(values)
