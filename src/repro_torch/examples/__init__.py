"""Runnable examples (the JAX package's `examples/`): `python -m
repro_torch.examples.train_100m`."""
