"""Runnable examples (the JAX package's `examples/`): `python -m
repro_torch.examples.quickstart`, `.edge_serving` and `.train_100m`."""
