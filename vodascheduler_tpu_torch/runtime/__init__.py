"""Training runtime of the port: a single-card TrainSession so far."""

from vodascheduler_tpu_torch.runtime.train import TrainSession, make_optimizer

__all__ = ["TrainSession", "make_optimizer"]
