"""Entry points: `python -m repro_torch.launch.serve` (prefill + lockstep
decode with slot-based continuous batching), `python -m
repro_torch.launch.train` (the train loop with checkpoints and resume),
the fleet, control and Pareto CLIs, and the step functions (`steps`)."""
