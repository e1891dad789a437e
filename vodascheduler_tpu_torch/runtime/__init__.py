"""Training runtime of the port: a single-card TrainSession so far.

Its names load on first use: ``python -m
vodascheduler_tpu_torch.runtime.resize_bench`` imports this package before
its own first line, which marks the process's start before torch is
imported.
"""

__all__ = ["TrainSession", "make_optimizer"]


def __getattr__(name):
    if name in __all__:
        from vodascheduler_tpu_torch.runtime import train
        return getattr(train, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
