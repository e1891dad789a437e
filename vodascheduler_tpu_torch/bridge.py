"""Weights between the JAX package's params and the port's state_dict.

Llama and Mixtral (`flax_to_state_dict`, `state_dict_to_flax`) name their
layers apart, as below. The other families (MLP, ResNet, BERT, ViT, NMT:
`mlp_to_state_dict`, `resnet_to_state_dict`, ... and their `*_to_flax`)
name every submodule as flax does, so a leaf's path maps to its key by
joining with dots, and only the layouts change (`tree_to_state_dict`):
Dense kernels ``[in, out]`` become ``[out, in]``, DenseGeneral q/k/v
kernels ``[D, H, hd]`` become ``[H·hd, D]``, Conv kernels HWIO become
OIHW, an Embed's ``embedding`` becomes ``weight``, and ResNet's
``batch_stats`` (``mean``, ``var``) become buffers of the same names.

The reference's params are a nested dict of numpy arrays, as
``jax.tree.map(np.asarray, params)`` gives them. A scanned config
(``scan_layers``) stacks each layer parameter on a leading L axis under
``layers_scan/block``; an unscanned one names ``layer_{i}`` without it:

    embed/embedding                         [V, D]
    <layer>/attn/{q,k,v}_proj/kernel        [D, H, hd]
    <layer>/attn/o_proj/kernel              [H*hd, D]
    <layer>/attn_norm/scale                 [D]
    Llama:
    <layer>/mlp_norm/scale                  [D]
    <layer>/mlp/{gate,up}_proj/kernel       [D, F]
    <layer>/mlp/down_proj/kernel            [F, D]
    Mixtral:
    <layer>/moe_norm/scale                  [D]
    <layer>/moe/router/kernel               [D, E]
    <layer>/moe/experts_{gate,up}_kernel    [E, D, F]
    <layer>/moe/experts_down_kernel         [E, F, D]
    final_norm/scale                        [D]
    lm_head_kernel                          [D, V]

The port keeps Dense weights as [out, in] (F.linear), so kernels are
transposed; the experts are raw parameters in the reference's layout and
pass as they are. Nothing is rounded, so a round trip is exact.
`reference_param_groups` names the reference leaf of every parameter, for
an optimizer whose update depends on the leaf's shape (Adafactor).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterable, List, Tuple

import numpy as np
import torch

_PROJ = ("q_proj", "k_proj", "v_proj")
_TOP_LEAVES = {"embed.weight": "embed/embedding",
               "final_norm.scale": "final_norm/scale",
               "lm_head_kernel": "lm_head_kernel"}
_LAYER_PARAM = re.compile(r"layers\.(\d+)\.(.+)")
_MLP = ("gate_proj", "up_proj", "down_proj")
_EXPERTS = ("experts_gate_kernel", "experts_up_kernel", "experts_down_kernel")


def _layer_to_torch(p: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    attn = p["attn"]
    out = {}
    for name in _PROJ:
        k = np.asarray(attn[name]["kernel"])  # [D, H, hd]
        out[f"{prefix}attn.{name}.weight"] = k.reshape(k.shape[0], -1).T
    out[f"{prefix}attn.o_proj.weight"] = np.asarray(attn["o_proj"]["kernel"]).T
    out[f"{prefix}attn_norm.scale"] = np.asarray(p["attn_norm"]["scale"])
    if "moe" in p:
        moe = p["moe"]
        out[f"{prefix}moe.router.weight"] = np.asarray(
            moe["router"]["kernel"]).T
        for name in _EXPERTS:
            out[f"{prefix}moe.{name}"] = np.asarray(moe[name])
        out[f"{prefix}moe_norm.scale"] = np.asarray(p["moe_norm"]["scale"])
    else:
        for name in _MLP:
            out[f"{prefix}mlp.{name}.weight"] = np.asarray(
                p["mlp"][name]["kernel"]).T
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
    out = {"attn": attn,
           "attn_norm": {"scale": sd[f"{prefix}attn_norm.scale"]}}
    if f"{prefix}moe.router.weight" in sd:
        out["moe"] = {"router": {"kernel": kernel("moe.router")},
                      **{n: sd[f"{prefix}moe.{n}"] for n in _EXPERTS}}
        out["moe_norm"] = {"scale": sd[f"{prefix}moe_norm.scale"]}
    else:
        out["mlp"] = {n: {"kernel": kernel(f"mlp.{n}")} for n in _MLP}
        out["mlp_norm"] = {"scale": sd[f"{prefix}mlp_norm.scale"]}
    return out


def flax_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Reference Llama or Mixtral params (scanned or not) -> the port's
    state_dict."""
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
    or MixtralConfig of either package: num_layers, num_heads,
    num_kv_heads, scan_layers)."""
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


def reference_param_groups(named_parameters: Iterable[Tuple[str, Any]],
                           cfg=None) -> List[Dict[str, Any]]:
    """One optimizer param group per leaf of the reference's param tree,
    in the form `runtime/optim.py` reads: the leaf's path and shape, its
    parameters in layer order, whether they are stacked on a leading layer
    axis (a scanned `cfg`) and whether each is its slice transposed. q/k/v
    slices are ``[D, H, hd]`` (`cfg.head_dim`); a Mixtral router slice is
    ``[D, E]`` and an expert slice its own ``[E, in, out]``, so their
    stacked leaves are ``[L, D, E]`` and ``[L, E, in, out]``. A parameter
    this layout
    does not name (or any, without `cfg`) is a leaf of its own shape."""
    groups: Dict[str, Dict[str, Any]] = {}
    scanned = bool(cfg is not None and cfg.scan_layers)
    for name, p in named_parameters:
        m = _LAYER_PARAM.fullmatch(name)
        if cfg is None or (m is None and name not in _TOP_LEAVES):
            key, shape, transposed, stacked = name, tuple(p.shape), False, False
        elif m is None:
            key, shape, transposed, stacked = (_TOP_LEAVES[name],
                                               tuple(p.shape), False, False)
        else:
            part = m.group(2)
            key = (("layers_scan/block/" if scanned else
                    f"layer_{m.group(1)}/") + part.replace(".", "/")
                   .replace("/weight", "/kernel"))
            transposed = part.endswith(".weight")
            shape = tuple(p.shape[::-1]) if transposed else tuple(p.shape)
            if part.split(".")[1] in _PROJ:  # [D, H*hd] -> [D, H, hd]
                shape = (shape[0], shape[1] // cfg.head_dim, cfg.head_dim)
            stacked = scanned
        g = groups.setdefault(key, {"params": [], "leaf": key, "shape": shape,
                                    "stacked": stacked,
                                    "transposed": transposed})
        g["params"].append(p)
    for g in groups.values():
        if g["stacked"]:
            g["shape"] = (len(g["params"]),) + tuple(g["shape"])
    return list(groups.values())


def _map(fn, *trees):
    """Maps `fn` over the leaves of nested dicts of equal structure."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


# ---------------------------------------------------------------------------
# the other families: MLP, ResNet, BERT, ViT, NMT
# ---------------------------------------------------------------------------

_QKV = ("q_proj", "k_proj", "v_proj")


def _flat(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def tree_to_state_dict(params: Dict[str, Any],
                       batch_stats: Dict[str, Any] = None
                       ) -> Dict[str, torch.Tensor]:
    """A family's flax params (and batch_stats) -> the port's state_dict,
    for modules named as flax names them. Also carries gradients, which
    have the params' layout."""
    out = {}
    for path, a in _flat(params).items():
        parts = path.split("/")
        leaf = parts[-1]
        if leaf == "kernel":
            parts[-1] = "weight"
            if a.ndim == 4:  # Conv HWIO -> OIHW
                a = a.transpose(3, 2, 0, 1)
            else:  # Dense [in, out], DenseGeneral [D, H, hd] -> [out, in]
                a = a.reshape(a.shape[0], -1).T
        elif leaf == "embedding":
            parts[-1] = "weight"
        out[".".join(parts)] = a
    for path, a in _flat(batch_stats or {}).items():
        out[path.replace("/", ".")] = a
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in out.items()}


def state_dict_to_tree(state_dict: Dict[str, torch.Tensor],
                       head_dim: int = 0,
                       buffers: Iterable[str] = ()) -> Tuple[Dict, Dict]:
    """The port's state_dict -> (params, batch_stats) trees of numpy
    arrays, the inverse of `tree_to_state_dict`. `head_dim` reshapes the
    attention's q/k/v weights back to [D, H, hd]; the keys ending in one
    of `buffers` go to batch_stats."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for key, t in state_dict.items():
        a = t.detach().cpu().numpy()
        parts = key.split(".")
        tree = stats if parts[-1] in buffers else params
        if parts[-1] == "weight":
            if a.ndim == 4:
                parts[-1], a = "kernel", a.transpose(2, 3, 1, 0)
            elif len(parts) > 1 and parts[-2] in _QKV:
                parts[-1], a = "kernel", a.T.reshape(a.shape[1], -1,
                                                     head_dim)
            elif parts[0] in ("embed", "pos_embed") and len(parts) == 2:
                parts[-1] = "embedding"
            else:
                parts[-1], a = "kernel", a.T
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.ascontiguousarray(a)
    return params, stats


# One function per family each way. The families' modules name their
# submodules as flax does, so the forward direction is the generic one;
# the way back needs the attention's head width, and ResNet's splits off
# the BatchNorm statistics.
mlp_to_state_dict = bert_to_state_dict = vit_to_state_dict = \
    nmt_to_state_dict = tree_to_state_dict
resnet_to_state_dict = tree_to_state_dict  # (params, batch_stats)


def mlp_to_flax(state_dict) -> Dict[str, Any]:
    return state_dict_to_tree(state_dict)[0]


def resnet_to_flax(state_dict) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """-> (params, batch_stats)."""
    return state_dict_to_tree(state_dict, buffers=("mean", "var"))


def bert_to_flax(state_dict, cfg) -> Dict[str, Any]:
    return state_dict_to_tree(state_dict, cfg.dim // cfg.num_heads)[0]


vit_to_flax = bert_to_flax  # ViTConfig has BERT's dim and num_heads


def nmt_to_flax(state_dict, cfg) -> Dict[str, Any]:
    return state_dict_to_tree(state_dict, cfg.head_dim)[0]


# ---------------------------------------------------------------------------
# into a sharded module
# ---------------------------------------------------------------------------


def load_reference_params(module: torch.nn.Module, state_dict) -> None:
    """Load a full state_dict (as `flax_to_state_dict` or
    `tree_to_state_dict` give it from the reference's numpy params) into
    `module`, sharded or not. Under a process group rank 0's copy is
    broadcast (`set_model_state_dict` with full state dicts), so the other
    ranks may pass an empty dict; each rank keeps its shards."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        module.load_state_dict(state_dict)
        return
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions,
        set_model_state_dict,
    )
    device = next(module.parameters()).device
    # contiguous: the broadcast sends a tensor's storage as laid out, and
    # the bridge's transposed kernels are views
    full = ({k: torch.as_tensor(v).to(device).contiguous()
             for k, v in state_dict.items()}
            if dist.get_rank() == 0 else {})
    set_model_state_dict(module, full, options=StateDictOptions(
        full_state_dict=True, broadcast_from_rank0=True))
