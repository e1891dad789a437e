"""Model zoo of the port: every family of the JAX package that trains on
one card (MLP, ResNet, BERT, ViT, NMT, Llama, Mixtral)."""

from vodascheduler_tpu_torch.models.registry import (
    MODEL_REGISTRY,
    ModelBundle,
    get_model,
)

__all__ = ["MODEL_REGISTRY", "ModelBundle", "get_model"]
