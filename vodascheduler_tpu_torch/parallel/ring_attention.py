"""O(S²) softmax attention, the oracle the flash kernels are held against.

Counterpart of `reference_attention` in the JAX package's
``parallel/ring_attention.py``. Ring attention itself (sequence shards
passed around a ring of devices) waits for the multi-GPU slice.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # finite: a fully masked row softmaxes to uniform, not NaN


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """[B,S,H,D] in and out; fp32 math, result cast back to q's dtype."""
    qT = q.transpose(1, 2).float()
    kT = k.transpose(1, 2).float()
    vT = v.transpose(1, 2).float()
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", qT, kT) * scale
    if causal:
        S = q.shape[1]
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", w, vT)
    return out.transpose(1, 2).to(q.dtype)
