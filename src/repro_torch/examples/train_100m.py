"""End-to-end example: train a ~100M-parameter qwen-family model (the JAX
package's `examples/train_100m.py`).

The production path (train step, checkpointing, resume, data pipeline)
through the port's train CLI. The default --steps 300 is the "few hundred
steps" recipe; --smoke runs a 20-step version.

    PYTHONPATH=src python -m repro_torch.examples.train_100m [--smoke] [--device cpu]
"""
import argparse
import os
import sys
import tempfile

from repro_torch.launch import train as train_mod
from repro_torch.models.config import ModelConfig

# ~112M params: qwen-style dense stack, 12L x d768 x ff2112, 32k vocab.
CONFIG_100M = ModelConfig(
    name="qwen-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    vocab=32_000,
    n_heads=12,
    n_kv_heads=4,
    head_dim=64,
    d_ff=2112,
    mlp_act="swiglu",
    qkv_bias=True,
    tie_embeddings=True,
    remat=False,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_100m_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print(f"model: {CONFIG_100M.name}  params={CONFIG_100M.n_params()/1e6:.1f}M")

    # Reuse the trainer by registering the config for this run only.
    import repro_torch.configs.registry as reg

    reg._MODULES = dict(reg._MODULES)
    mod = type(sys)("qwen_100m_cfg")
    mod.CONFIG = CONFIG_100M
    sys.modules["repro_torch.configs._qwen_100m"] = mod
    reg._MODULES["qwen-100m"] = "repro_torch.configs._qwen_100m"

    steps = args.steps or (20 if args.smoke else 300)
    batch, seq = (8, 128) if args.smoke else (8, 256)
    return train_mod.main(
        [
            "--arch", "qwen-100m",
            "--steps", str(steps),
            "--global-batch", str(batch),
            "--seq-len", str(seq),
            "--ckpt-dir", args.ckpt_dir,
            "--ckpt-every", "100",
            "--log-every", "10" if not args.smoke else "2",
            "--lr", "6e-4",
            "--device", args.device,
        ]
    )


if __name__ == "__main__":
    raise SystemExit(main())
