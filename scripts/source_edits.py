"""Line edits of the kernels' sources, for the scripts that build altered
copies of them (``scripts/torch_planted_fault.py``,
``scripts/torch_kernel_ablate.py``).

An edit names its file as ``name.cu``, or as ``name.cu:kernel`` to confine
it to the definition of that kernel (from ``kernel(`` to the next
``template <`` line), where one source holds two kernels that share lines
(``flash_dq_wide.cu``'s ``flash_dq_wide_kernel`` and
``flash_dq_chunked_kernel``, for one). The lines to change must stand
there exactly once.
"""

from __future__ import annotations

from typing import Tuple


def split(target: str) -> Tuple[str, str]:
    """(file, kernel) of an edit's target; kernel "" for the whole file."""
    fname, _, kernel = target.partition(":")
    return fname, kernel


def replace_once(text: str, kernel: str, old: str, new: str) -> str:
    """`text` with `old` replaced by `new` inside `kernel`'s definition (the
    whole text where `kernel` is ""); ValueError unless `old` stands there
    exactly once."""
    start, end = 0, len(text)
    if kernel:
        if text.count(f"{kernel}(") != 1:
            raise ValueError(f"{kernel} is not defined once")
        start = text.index(f"{kernel}(")
        end = text.find("\ntemplate <", start)
        end = len(text) if end < 0 else end
    if text.count(old, start, end) != 1:
        raise ValueError(f"the lines to change are not once in "
                         f"{kernel or 'the file'}")
    at = text.index(old, start, end)
    return text[:at] + new + text[at + len(old):]
