"""Weights between the JAX package's Llama params and the port's state_dict.

The reference's params are a nested dict of numpy arrays, as
``jax.tree.map(np.asarray, params)`` gives them. A scanned config
(``scan_layers``) stacks each layer parameter on a leading L axis under
``layers_scan/block``; an unscanned one names ``layer_{i}`` without it:

    embed/embedding                         [V, D]
    <layer>/attn/{q,k,v}_proj/kernel        [D, H, hd]
    <layer>/attn/o_proj/kernel              [H*hd, D]
    <layer>/{attn,mlp}_norm/scale           [D]
    <layer>/mlp/{gate,up}_proj/kernel       [D, F]
    <layer>/mlp/down_proj/kernel            [F, D]
    final_norm/scale                        [D]
    lm_head_kernel                          [D, V]

The port keeps Dense weights as [out, in] (F.linear), so kernels are
transposed; nothing is rounded, so a round trip is exact.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_PROJ = ("q_proj", "k_proj", "v_proj")


def _layer_to_torch(p: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    attn, mlp = p["attn"], p["mlp"]
    out = {}
    for name in _PROJ:
        k = np.asarray(attn[name]["kernel"])  # [D, H, hd]
        out[f"{prefix}attn.{name}.weight"] = k.reshape(k.shape[0], -1).T
    out[f"{prefix}attn.o_proj.weight"] = np.asarray(attn["o_proj"]["kernel"]).T
    for name in ("gate_proj", "up_proj", "down_proj"):
        out[f"{prefix}mlp.{name}.weight"] = np.asarray(mlp[name]["kernel"]).T
    out[f"{prefix}attn_norm.scale"] = np.asarray(p["attn_norm"]["scale"])
    out[f"{prefix}mlp_norm.scale"] = np.asarray(p["mlp_norm"]["scale"])
    return out


def _layer_to_flax(sd: Dict[str, np.ndarray], prefix: str,
                   num_heads: int, num_kv_heads: int) -> Dict[str, Any]:
    def kernel(name):
        return sd[f"{prefix}{name}.weight"].T

    attn = {}
    for name, h in zip(_PROJ, (num_heads, num_kv_heads, num_kv_heads)):
        k = kernel(f"attn.{name}")  # [D, H*hd]
        attn[name] = {"kernel": k.reshape(k.shape[0], h, -1)}
    attn["o_proj"] = {"kernel": kernel("attn.o_proj")}
    mlp = {n: {"kernel": kernel(f"mlp.{n}")}
           for n in ("gate_proj", "up_proj", "down_proj")}
    return {"attn": attn, "mlp": mlp,
            "attn_norm": {"scale": sd[f"{prefix}attn_norm.scale"]},
            "mlp_norm": {"scale": sd[f"{prefix}mlp_norm.scale"]}}


def flax_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Reference Llama params (scanned or not) -> the port's state_dict."""
    out = {"embed.weight": np.asarray(params["embed"]["embedding"]),
           "final_norm.scale": np.asarray(params["final_norm"]["scale"]),
           "lm_head_kernel": np.asarray(params["lm_head_kernel"])}
    if "layers_scan" in params:
        block = params["layers_scan"]["block"]
        n = np.asarray(block["attn_norm"]["scale"]).shape[0]
        for i in range(n):
            layer = _map(lambda a, i=i: np.asarray(a)[i], block)
            out.update(_layer_to_torch(layer, f"layers.{i}."))
    else:
        i = 0
        while f"layer_{i}" in params:
            out.update(_layer_to_torch(params[f"layer_{i}"], f"layers.{i}."))
            i += 1
    return {k: torch.tensor(v) for k, v in out.items()}


def state_dict_to_flax(state_dict: Dict[str, torch.Tensor],
                       cfg) -> Dict[str, Any]:
    """The port's state_dict -> reference params for `cfg` (a LlamaConfig
    of either package: num_layers, num_heads, num_kv_heads, scan_layers)."""
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    layers = [_layer_to_flax(sd, f"layers.{i}.", cfg.num_heads,
                             cfg.num_kv_heads)
              for i in range(cfg.num_layers)]
    out: Dict[str, Any] = {"embed": {"embedding": sd["embed.weight"]},
                           "final_norm": {"scale": sd["final_norm.scale"]},
                           "lm_head_kernel": sd["lm_head_kernel"]}
    if cfg.scan_layers:
        out["layers_scan"] = {"block": _map(lambda *a: np.stack(a), *layers)}
    else:
        out.update({f"layer_{i}": layer for i, layer in enumerate(layers)})
    return out


def _map(fn, *trees):
    """Maps `fn` over the leaves of nested dicts of equal structure."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)
