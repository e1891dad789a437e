"""Chunked softmax cross-entropy: LM loss without full-vocab logits.

Counterpart of the JAX package's ``ops/chunked_ce.py``. The sequence is cut
into chunks; each runs its own head matmul and cross-entropy under
`torch.utils.checkpoint`, so a chunk's logits are dropped after the forward
and recomputed in the backward. Peak logits memory falls from O(S·V) to
O(S/C·V) for one extra head matmul in the backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _ce_sum(hidden: torch.Tensor, head: torch.Tensor,
            targets: torch.Tensor) -> torch.Tensor:
    logits = (hidden @ head).float()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1), reduction="sum")


def chunked_softmax_ce(hidden: torch.Tensor, head_w: torch.Tensor,
                       targets: torch.Tensor,
                       num_chunks: int = 8) -> torch.Tensor:
    """Mean token cross-entropy of `hidden @ head_w` against `targets`.

    hidden  [B, S, D] activations
    head_w  [D, V]    fp32 master weight, cast once to hidden's dtype
    targets [B, S]    int labels

    `num_chunks` is clamped to a divisor of S (1 = unchunked).
    """
    B, S, _ = hidden.shape
    c = min(num_chunks, S)
    while S % c:
        c -= 1
    # Cast outside the loop and the checkpoint: inside, every chunk would
    # re-read the fp32 head and write it in the compute dtype again.
    head = head_w.to(hidden.dtype)
    if c <= 1:
        return _ce_sum(hidden, head, targets) / (B * S)
    total = hidden.new_zeros((), dtype=torch.float32)
    for h, t in zip(hidden.split(S // c, dim=1), targets.split(S // c, dim=1)):
        total = total + checkpoint(_ce_sum, h, head, t, use_reentrant=False)
    return total / (B * S)
