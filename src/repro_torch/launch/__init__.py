"""Entry points: `python -m repro_torch.launch.serve` (prefill + lockstep
decode with slot-based continuous batching) and the serve step config."""
