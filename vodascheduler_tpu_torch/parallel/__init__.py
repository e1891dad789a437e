"""Parallelism for the port. Only `reference_attention` exists so far; ring
attention and the mesh planner come with the multi-GPU slice."""
