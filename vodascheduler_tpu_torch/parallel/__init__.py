"""Parallelism for the port: the mesh plan (`mesh.py`), the sharding rules
(`sharding.py`) and `reference_attention` (`ring_attention.py`; ring
attention itself comes with sequence parallelism, ROADMAP A13)."""
