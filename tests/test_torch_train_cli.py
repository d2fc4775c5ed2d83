"""The port's train CLI (`python -m repro_torch.launch.train`) on the CPU,
held to the contract the reference's `test_train_loop_resume` intends (the
JAX CLI cannot take a step under its own mesh on this machine: ROADMAP.md
section 3): 8 steps checkpointed every 4, then `--steps 12 --resume`
prints "resumed from step 8" and ends on params bitwise those of an
uninterrupted 12-step run; SIGTERM checkpoints at step + 1 and exits 0;
an encoder-decoder, and a --model-parallel that does not divide the
world, are refused before any step (tests/test_torch_model_parallel.py
runs the CLI over a mesh). Every entry
point of the training path defaults to the GPU and raises without one.
"""
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_bridge  # noqa: F401  (pins torch to one CPU thread)
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import reduced_config
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.examples import train_100m
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params, trainable
from repro_torch.models.convert import opt_state_from_jax
from repro_torch.optim import adamw_init

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
BASE = ["--arch", "qwen1.5-0.5b", "--reduced", "--global-batch", "4", "--seq-len", "64",
        "--ckpt-every", "4", "--log-every", "2", "--device", "cpu"]


def _run_cli(args) -> subprocess.CompletedProcess:
    """The CLI in a fresh interpreter, which must not import JAX or the
    JAX package on the way."""
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['train', *{list(args)!r}]\n"
        "try:\n"
        "    runpy.run_module('repro_torch.launch.train', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') or m.startswith(('jax.', 'repro.')))\n"
        "sys.exit(3 if bad else 0)\n"
    )
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=ENV,
                          cwd=ROOT, timeout=300)


def _uninterrupted(steps: int):
    """The CLI's loop without the CLI: the same init, stream and step."""
    cfg = reduced_config("qwen1.5-0.5b")
    params = init_params(cfg, 0, device="cpu")
    opt = adamw_init(trainable(params))
    stream = make_pipeline(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4, seed=1234))
    step = make_train_step(cfg, lr=3e-4)
    for _ in range(steps):
        params, opt, _ = step(params, opt, {"tokens": torch.from_numpy(stream.next_batch())})
    return params, opt


def test_train_cli_resume_is_bitwise_uninterrupted(tmp_path):
    first = _run_cli(BASE + ["--ckpt-dir", str(tmp_path), "--steps", "8"])
    assert first.returncode == 0, first.stdout[-2000:] + first.stderr[-2000:]
    assert "done: first-5-avg=" in first.stdout
    assert CheckpointManager(tmp_path).steps() == [4, 8]
    second = _run_cli(BASE + ["--ckpt-dir", str(tmp_path), "--steps", "12", "--resume"])
    assert second.returncode == 0, second.stdout[-2000:] + second.stderr[-2000:]
    assert "resumed from step 8" in second.stdout
    assert '"step": 8,' in second.stdout and '"step": 6,' not in second.stdout
    params, opt = _uninterrupted(12)
    tree, extra, step = CheckpointManager(tmp_path).restore(None, {"params": params, "opt": opt}, device="cpu")
    assert step == 12 and extra["data"] == {"seed": 1234, "step": 12}
    for name, p in params.named_parameters():
        assert torch.equal(tree["params"][name], p.detach()), name
    assert int(tree["opt"]["step"]) == int(opt["step"]) == 12
    for name, m in opt["mu"].items():
        assert torch.equal(tree["opt"]["mu"][name], m) and torch.equal(tree["opt"]["nu"][name], opt["nu"][name])


def test_train_cli_sigterm_checkpoints_step_plus_one(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *BASE, "--log-every", "1",
           "--ckpt-every", "100000", "--steps", "100000", "--ckpt-dir", str(tmp_path)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ENV, cwd=ROOT)
    try:
        lines = [proc.stdout.readline()]
        assert lines[0].startswith('{"step": 0,'), lines[0] + proc.stderr.read()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        proc.kill()
    lines += out.splitlines()
    assert proc.returncode == 0, err[-2000:]
    assert "preemption signal: checkpointing and exiting" in out
    last = max(int(ln.split(",")[0].split(":")[1]) for ln in lines if ln.startswith('{"step"'))
    assert CheckpointManager(tmp_path).steps() == [last + 1]


def test_train_cli_refuses_encdec_and_mesh(tmp_path):
    with pytest.raises(ValueError, match="dec_tokens"):
        train.main(["--arch", "seamless-m4t-medium", "--reduced", "--device", "cpu", "--steps", "1"])
    # One process is a world of one rank, which --model-parallel 2 does not divide.
    with pytest.raises(ValueError, match="does not divide"):
        train.main(["--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu", "--model-parallel", "2"])


_NO_MESH = r"""
import sys
from repro_torch.launch import train

def refuse(*args, **kwargs):
    raise AssertionError("build_mesh called")

train.build_mesh = refuse
sys.exit(train.main(sys.argv[1:]))
"""


def test_train_cli_world_of_one_runs_the_plain_step(tmp_path):
    """Under a launcher of one process (`torchrun --nproc-per-node 1`, the
    one-GPU launch) with --model-parallel 1 the CLI joins the group but
    builds no mesh: it runs the plain step."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(ENV, WORLD_SIZE="1", RANK="0", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    r = subprocess.run([sys.executable, "-c", _NO_MESH, *BASE, "--steps", "2", "--ckpt-dir", str(tmp_path)],
                       env=env, capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    assert sum(ln.startswith('{"step"') for ln in r.stdout.splitlines()) == 1


def test_training_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """Without a GPU, every training entry point called without device=
    raises; none continues on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config("qwen1.5-0.5b")
    params = init_params(cfg, 0, device="cpu")
    opt = adamw_init(params)
    CheckpointManager(tmp_path).save(1, {"opt": opt})
    numpy_opt = {"mu": {}, "nu": {}, "step": np.zeros((), np.int32)}
    for call in (
        lambda: train.main(["--arch", "qwen1.5-0.5b", "--reduced", "--steps", "1"]),
        lambda: train_100m.main(["--smoke", "--ckpt-dir", str(tmp_path / "ex")]),
        lambda: CheckpointManager(tmp_path).restore(None, {"opt": opt}),
        lambda: opt_state_from_jax(cfg, numpy_opt),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
