"""Model zoo of the port: the Llama family so far."""

from vodascheduler_tpu_torch.models.registry import (
    MODEL_REGISTRY,
    ModelBundle,
    get_model,
)

__all__ = ["MODEL_REGISTRY", "ModelBundle", "get_model"]
