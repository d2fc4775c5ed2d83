"""Sharding rules for the dry run (`sharding.py`, the substrate half of the
JAX package's `distributed/sharding.py`). The fleet layout, the activation
constraints (`act.py`) and the GPipe schedule (`pipeline.py`) wait for the
mesh slice (ROADMAP.md, "Modules to port", item 3)."""
