"""Default-device resolution for the port's entry points.

Entry points run on CUDA unless the caller passes a device. With no device
given and no CUDA available they raise: a silent drop to the CPU would turn
a training job into a job that trains a thousand times slower.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device` as a torch.device; None means CUDA, which must exist."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' explicitly to run "
            "on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
