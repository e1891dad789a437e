"""Model registry: name -> everything the runtime needs to train it.

Counterpart of the JAX package's ``models/registry.py``, for the Llama
and Mixtral bundles that train on one card. A torch module allocates its
parameters when it is built, so a bundle holds a builder, not a module:
`build_module(device, generator)` returns the initialised model.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from vodascheduler_tpu_torch.models import llama, mixtral


@dataclasses.dataclass
class ModelBundle:
    name: str
    cfg: Any
    # (device, generator) -> nn.Module with its parameters initialised
    build_module: Callable[[torch.device, torch.Generator], torch.nn.Module]
    # (batch_size, generator) -> batch on the generator's device
    make_batch: Callable[[int, torch.Generator], Any]
    loss_fn: Callable[[torch.nn.Module, Any], torch.Tensor]  # (module, batch)
    seq_len: int = 0
    optimizer: str = "adamw"
    num_experts: int = 0  # MoE bundles: hwbench counts active parameters


def _lm_batch(vocab: int, seq: int):
    def make(batch_size: int, generator: torch.Generator):
        tokens = torch.randint(0, vocab, (batch_size, seq + 1),
                               generator=generator, device=generator.device)
        return {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
    return make


def _lm_fused_loss(module, batch):
    """Loss computed inside the model (chunked CE): full-vocab logits never
    materialise."""
    return module(batch["inputs"], targets=batch["targets"])


def llama_bundle(name: str, cfg: llama.LlamaConfig, seq_len: int,
                 optimizer: str = "adamw") -> ModelBundle:
    def build(device, generator):
        module = llama.Llama(cfg, device=device)
        module.reset_parameters(generator)
        return module
    return ModelBundle(name=name, cfg=cfg, build_module=build,
                       make_batch=_lm_batch(cfg.vocab_size, seq_len),
                       loss_fn=_lm_fused_loss, seq_len=seq_len,
                       optimizer=optimizer)


def mixtral_bundle(name: str, cfg: mixtral.MixtralConfig, seq_len: int,
                   optimizer: str = "adamw") -> ModelBundle:
    def build(device, generator):
        module = mixtral.Mixtral(cfg, device=device)
        module.reset_parameters(generator)
        return module
    return ModelBundle(name=name, cfg=cfg, build_module=build,
                       make_batch=_lm_batch(cfg.vocab_size, seq_len),
                       loss_fn=_lm_fused_loss, seq_len=seq_len,
                       optimizer=optimizer, num_experts=cfg.num_experts)


def _bundles() -> Dict[str, Callable[[], ModelBundle]]:
    return {
        "llama_tiny": lambda: llama_bundle("llama_tiny", llama.LLAMA_TINY, 64),
        "llama_350m": lambda: llama_bundle("llama_350m", llama.LLAMA_350M,
                                           2048),
        "llama_350m_8k": lambda: llama_bundle("llama_350m_8k",
                                              llama.LLAMA_350M_8K, 8192),
        "llama_1b": lambda: llama_bundle("llama_1b", llama.LLAMA_1B, 2048,
                                         "adafactor"),
        "llama_350m_af": lambda: llama_bundle(
            "llama_350m_af", llama.LLAMA_350M_AF, 2048, "adafactor"),
        "llama_350m_8k_af": lambda: llama_bundle(
            "llama_350m_8k_af", llama.LLAMA_350M_8K_AF, 8192, "adafactor"),
        "mixtral_tiny": lambda: mixtral_bundle(
            "mixtral_tiny", mixtral.MIXTRAL_TINY, 64),
        "mixtral_small": lambda: mixtral_bundle(
            "mixtral_small", mixtral.MIXTRAL_SMALL, 2048),
        "mixtral_small_af": lambda: mixtral_bundle(
            "mixtral_small_af", mixtral.MIXTRAL_SMALL_AF, 2048, "adafactor"),
    }


# Bundles of the reference not ported yet, with the ROADMAP item that ports
# each.
_NOT_PORTED = {
    "llama3_8b": "queue A item 10 (multi-GPU: 8B fp32 masters plus AdamW "
                 "state exceed one card)",
    "llama_tiny_text": "queue A item 14 (data)",
    "llama_350m_text": "queue A item 14 (data)",
    "mixtral_8x7b": "queue A item 10 (multi-GPU: 47B parameters need "
                    "several cards; the expert all_to_all with A12)",
    "mnist_mlp": "queue A item 14 (other families)",
    "digits_mlp": "queue A item 14 (other families)",
    "resnet50": "queue A item 14 (other families)",
    "resnet_tiny": "queue A item 14 (other families)",
    "bert_base": "queue A item 14 (other families)",
    "bert_tiny": "queue A item 14 (other families)",
    "vit_l16": "queue A item 14 (other families)",
    "vit_tiny": "queue A item 14 (other families)",
    "nmt_base": "queue A item 14 (other families)",
    "nmt_tiny": "queue A item 14 (other families)",
}

MODEL_REGISTRY = tuple(sorted(_bundles()))

# Trace/model-family aliases (replay traces use family names).
_ALIASES = {
    "bert": "bert_base",
    "vitl": "vit_l16",
    "llama8b": "llama3_8b",
    "mixtral": "mixtral_8x7b",
    "nmt": "nmt_base",
    "transformer_nmt": "nmt_base",
}


def get_model(name: str) -> ModelBundle:
    bundles = _bundles()
    key = _ALIASES.get(name, name)
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported to PyTorch yet: ROADMAP "
            f"{_NOT_PORTED[key]}")
    if key not in bundles:
        raise ValueError(f"unknown model {name!r}; known: {MODEL_REGISTRY}")
    return bundles[key]()
