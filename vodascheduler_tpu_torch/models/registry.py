"""Model registry: name -> everything the runtime needs to train it.

Counterpart of the JAX package's ``models/registry.py``: every bundle of
the reference, with the reference's batches, losses,
scale (`params_b`, for plan_mesh) and sharding rules (synthetic batches
keep the framework hermetic; the ``_text`` and ``digits`` bundles train
on real data, ``data/real.py``). A torch module
allocates its parameters when it is built, so a bundle holds a builder,
not a module: `build_module(device, generator)` returns the initialised
model. `loss_fn(module, batch)` calls the module on the batch's input
(``images`` or ``inputs``, `input_key`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F

from vodascheduler_tpu_torch.models import bert, llama, mixtral, mlp, nmt
from vodascheduler_tpu_torch.models import resnet, vit
from vodascheduler_tpu_torch.parallel.sharding import (
    CONV_RULES,
    TRANSFORMER_RULES,
    ShardingRules,
)


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
    params_b: float = 0.0  # billions, for plan_mesh
    # how the parameters shard over a mesh (parallel/sharding.py)
    rules: ShardingRules = dataclasses.field(
        default_factory=lambda: TRANSFORMER_RULES)


def input_key(batch) -> str:
    """The key of a batch that the module takes: ``images`` for the image
    families, else ``inputs``."""
    return "images" if "images" in batch else "inputs"


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


def _token_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of fp32 logits [..., V] at integer
    targets [...] (optax's softmax_cross_entropy_with_integer_labels,
    averaged)."""
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))


def _lm_loss(module, batch):
    return _token_ce(module(batch["inputs"]), batch["targets"])


_mlm_loss = _lm_loss  # the reference's two names for one loss


def _cls_loss(module, batch):
    return _token_ce(module(batch["images"]), batch["labels"])


def _nmt_batch(vocab: int, src_seq: int, tgt_seq: int):
    def make(batch_size: int, generator: torch.Generator):
        dev = generator.device
        src = torch.randint(0, vocab, (batch_size, src_seq),
                            generator=generator, device=dev)
        tgt = torch.randint(0, vocab, (batch_size, tgt_seq + 1),
                            generator=generator, device=dev)
        return {"inputs": {"src": src, "tgt": tgt[:, :-1]},
                "targets": tgt[:, 1:]}
    return make


def _image_batch(size: int, channels: int, classes: int):
    """NHWC fp32 images from a unit normal and uniform labels."""
    def make(batch_size: int, generator: torch.Generator):
        dev = generator.device
        return {
            "images": torch.randn((batch_size, size, size, channels),
                                  generator=generator, device=dev),
            "labels": torch.randint(0, classes, (batch_size,),
                                    generator=generator, device=dev),
        }
    return make


def family_bundle(name: str, cls, cfg, make_batch, loss_fn,
                  seq_len: int = 0, rules: ShardingRules = TRANSFORMER_RULES,
                  params_b: float = 0.0) -> ModelBundle:
    """A bundle of a family whose module is `cls(cfg, device=...)`."""
    def build(device, generator):
        module = cls(cfg, device=device)
        module.reset_parameters(generator)
        return module
    return ModelBundle(name=name, cfg=cfg, build_module=build,
                       make_batch=make_batch, loss_fn=loss_fn,
                       seq_len=seq_len, rules=rules, params_b=params_b)


def _text_lm_bundle(name: str, cfg: llama.LlamaConfig,
                    seq_len: int, params_b: float = 0.0) -> ModelBundle:
    """Byte-level Llama on the bundled real-prose corpus (data/real.py):
    the batch's windows are drawn by the step's generator, so a resumed job
    sees the stream an uninterrupted one would have seen."""
    from vodascheduler_tpu_torch.data import load_text_corpus, make_lm_batch_fn
    bundle = llama_bundle(name, cfg, seq_len, params_b=params_b)
    bundle.make_batch = make_lm_batch_fn(load_text_corpus(), seq_len)
    return bundle


def _digits_bundle() -> ModelBundle:
    from vodascheduler_tpu_torch.data import (
        load_digits_dataset,
        make_sampling_batch_fn,
    )
    return family_bundle("digits_mlp", mlp.Mlp, mlp.DIGITS_MLP,
                         make_sampling_batch_fn(load_digits_dataset()),
                         _cls_loss, rules=CONV_RULES)


def llama_bundle(name: str, cfg: llama.LlamaConfig, seq_len: int,
                 optimizer: str = "adamw",
                 params_b: float = 0.0) -> ModelBundle:
    def build(device, generator):
        module = llama.Llama(cfg, device=device)
        module.reset_parameters(generator)
        return module
    return ModelBundle(name=name, cfg=cfg, build_module=build,
                       make_batch=_lm_batch(cfg.vocab_size, seq_len),
                       loss_fn=_lm_fused_loss, seq_len=seq_len,
                       optimizer=optimizer, params_b=params_b)


def mixtral_bundle(name: str, cfg: mixtral.MixtralConfig, seq_len: int,
                   optimizer: str = "adamw",
                   params_b: float = 0.0) -> ModelBundle:
    def build(device, generator):
        module = mixtral.Mixtral(cfg, device=device)
        module.reset_parameters(generator)
        return module
    return ModelBundle(name=name, cfg=cfg, build_module=build,
                       make_batch=_lm_batch(cfg.vocab_size, seq_len),
                       loss_fn=_lm_fused_loss, seq_len=seq_len,
                       optimizer=optimizer, num_experts=cfg.num_experts,
                       params_b=params_b)


def _bundles() -> Dict[str, Callable[[], ModelBundle]]:
    # params_b and the rules are the reference's, bundle by bundle.
    return {
        "mnist_mlp": lambda: family_bundle(
            "mnist_mlp", mlp.Mlp, mlp.MNIST_MLP, _image_batch(28, 1, 10),
            lambda m, b: _cls_loss(lambda x: m(x.reshape(x.shape[0], -1)),
                                   b), rules=CONV_RULES),
        # Real data: the batch is a function of the step's generator, so a
        # resized job resumes its stream exactly.
        "digits_mlp": _digits_bundle,
        "resnet50": lambda: family_bundle(
            "resnet50", resnet.ResNet, resnet.RESNET50,
            _image_batch(224, 3, 1000), _cls_loss, rules=CONV_RULES,
            params_b=0.026),
        "resnet_tiny": lambda: family_bundle(
            "resnet_tiny", resnet.ResNet, resnet.RESNET_TINY,
            _image_batch(32, 3, 10), _cls_loss, rules=CONV_RULES),
        "bert_base": lambda: family_bundle(
            "bert_base", bert.Bert, bert.BERT_BASE,
            _lm_batch(bert.BERT_BASE.vocab_size, 512), _mlm_loss,
            seq_len=512, params_b=0.11),
        "bert_tiny": lambda: family_bundle(
            "bert_tiny", bert.Bert, bert.BERT_TINY,
            _lm_batch(bert.BERT_TINY.vocab_size, 64), _mlm_loss, seq_len=64),
        "vit_l16": lambda: family_bundle(
            "vit_l16", vit.ViT, vit.VIT_L16, _image_batch(224, 3, 1000),
            _cls_loss, params_b=0.30),
        "vit_tiny": lambda: family_bundle(
            "vit_tiny", vit.ViT, vit.VIT_TINY, _image_batch(32, 3, 10),
            _cls_loss),
        "nmt_base": lambda: family_bundle(
            "nmt_base", nmt.Seq2SeqTransformer, nmt.NMT_BASE,
            _nmt_batch(nmt.NMT_BASE.vocab_size, 256, 256), _lm_loss,
            seq_len=256, params_b=0.07),
        "nmt_tiny": lambda: family_bundle(
            "nmt_tiny", nmt.Seq2SeqTransformer, nmt.NMT_TINY,
            _nmt_batch(nmt.NMT_TINY.vocab_size, 32, 32), _lm_loss,
            seq_len=32),
        "llama_tiny_text": lambda: _text_lm_bundle(
            "llama_tiny_text", llama.LLAMA_TINY, 64),
        "llama_350m_text": lambda: _text_lm_bundle(
            "llama_350m_text", llama.LLAMA_350M_BYTES, 2048, params_b=0.32),
        "llama_tiny": lambda: llama_bundle("llama_tiny", llama.LLAMA_TINY, 64),
        "llama_350m": lambda: llama_bundle("llama_350m", llama.LLAMA_350M,
                                           2048, params_b=0.35),
        "llama_350m_8k": lambda: llama_bundle(
            "llama_350m_8k", llama.LLAMA_350M_8K, 8192, params_b=0.35),
        "llama_1b": lambda: llama_bundle("llama_1b", llama.LLAMA_1B, 2048,
                                         "adafactor", params_b=1.0),
        "llama3_8b": lambda: llama_bundle("llama3_8b", llama.LLAMA3_8B, 4096,
                                          params_b=8.0),
        "llama_350m_af": lambda: llama_bundle(
            "llama_350m_af", llama.LLAMA_350M_AF, 2048, "adafactor",
            params_b=0.35),
        "llama_350m_8k_af": lambda: llama_bundle(
            "llama_350m_8k_af", llama.LLAMA_350M_8K_AF, 8192, "adafactor",
            params_b=0.35),
        "mixtral_tiny": lambda: mixtral_bundle(
            "mixtral_tiny", mixtral.MIXTRAL_TINY, 64),
        "mixtral_small": lambda: mixtral_bundle(
            "mixtral_small", mixtral.MIXTRAL_SMALL, 2048, params_b=0.39),
        "mixtral_small_af": lambda: mixtral_bundle(
            "mixtral_small_af", mixtral.MIXTRAL_SMALL_AF, 2048, "adafactor",
            params_b=0.39),
        # 47B parameters: several ranks over dp × fsdp × ep × tp (its
        # plans put tp=4 on a host and ep over the rest).
        "mixtral_8x7b": lambda: mixtral_bundle(
            "mixtral_8x7b", mixtral.MIXTRAL_8X7B_LIKE, 4096, params_b=47.0),
    }


# Bundles of the reference not ported yet, with the ROADMAP item that ports
# each.
_NOT_PORTED: Dict[str, str] = {}

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
