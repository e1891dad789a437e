"""Device memory readings for the supervisor's resize spans.

Counterpart of `hbm_in_use_bytes` in the JAX package's
``runtime/tpu_monitor.py``: the bytes the caching allocator holds in live
tensors (``allocated_bytes.all.current`` of `torch.cuda.memory_stats`),
summed over this process's CUDA devices.
"""

from __future__ import annotations

from typing import Optional

import torch


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
