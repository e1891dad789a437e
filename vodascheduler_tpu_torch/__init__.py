"""PyTorch/CUDA port of the Voda training plane.

The JAX package `vodascheduler_tpu` is the reference; this package mirrors
its module paths and public names (``ops/flash_attention.py``,
``models/layers.py``, ...) and imports nothing of it. The attention kernels
are hand-written CUDA C++ for Hopper (``ops/csrc/``); everything else is
plain PyTorch.
"""
