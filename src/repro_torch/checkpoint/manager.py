"""Fault-tolerant checkpointing (the JAX package's `checkpoint/manager.py`).

  * atomic:    written to step_NNNNNNNN.tmp/, the manifest fsynced, then
               renamed, so a preempted save never corrupts the latest good
               checkpoint;
  * keep-K:    bounded disk, the oldest pruned after a successful save;
  * self-describing: a manifest of every leaf's name, shape and dtype, so
               a restore is checked against the running model;
  * device- and mesh-agnostic: leaves are saved as host arrays and
               restored onto any device (`restore(..., device=)`), e.g.
               saved from the card and restored on the CPU; a DTensor
               leaf is saved whole (`full_tensor()`, a collective every
               rank joins; rank 0 writes) and restored in the layout of
               the running model's leaf, so a checkpoint moves between
               mesh shapes as the reference's does;
  * resumable data stream: `extra` carries the pipeline state.

A tree is a nested dict whose leaves are tensors, or modules (a
`ParamTree`), whose leaves are their `state_dict()` entries. Leaves are
keyed by their dotted names (`params.blocks.0.attn.wq`, `opt.mu.embed.embed`,
`opt.step`) where the reference keys them by flattening order under a
treedef string.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from ..device import resolve_device


def _flatten(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    if isinstance(tree, nn.Module):
        return {prefix + k: v for k, v in tree.state_dict().items()}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
        return out
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"checkpoint leaf {prefix[:-1]!r} is a {type(tree).__name__}, not a tensor")
    return {prefix[:-1]: tree}


def _unflatten(like, flat: dict, prefix: str = ""):
    """`flat`'s tensors in `like`'s structure; a module becomes the dict of
    its state_dict names. A DTensor leaf of `like` takes its layout."""
    if isinstance(like, nn.Module):
        return {k: _like(v, flat[prefix + k]) for k, v in like.state_dict().items()}
    if isinstance(like, dict):
        return {k: _unflatten(v, flat, f"{prefix}{k}.") for k, v in like.items()}
    return _like(like, flat[prefix[:-1]])


def _like(like: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """`t` (the whole tensor, on every rank) laid out as `like`."""
    if isinstance(like, DTensor):
        return distribute_tensor(t, like.device_mesh, like.placements, src_data_rank=None)
    return t


def _writer() -> bool:
    """Rank 0 writes (every process without a group)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:  # numpy has no bfloat16: keep the raw bits
        return t.view(torch.int16).numpy()
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    t = torch.from_numpy(a)
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # -- helpers -----------------------------------------------------------
    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}"

    def steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and not p.name.endswith(".tmp"):
                try:
                    out.append(int(p.name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # -- save/restore ------------------------------------------------------
    def save(self, step: int, tree, extra: dict | None = None) -> None:
        """tree: nested dict of tensors / modules. extra: small json-able
        state (data stream, schedule position...). With a process group,
        every rank calls this (DTensor leaves are gathered whole), rank 0
        writes and the ranks leave together."""
        flat = _flatten(tree)
        if not _writer():
            for leaf in flat.values():
                if isinstance(leaf, DTensor):
                    leaf.full_tensor()  # the writer's gather, joined
            dist.barrier()
            return
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "n_leaves": len(flat), "leaves": [], "extra": extra or {}}
        for i, (name, leaf) in enumerate(flat.items()):
            fname = f"leaf_{i:05d}.npy"
            np.save(tmp / fname, _to_numpy(leaf))
            manifest["leaves"].append(
                {"name": name, "file": fname, "shape": list(leaf.shape), "dtype": _dtype_name(leaf)}
            )
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        final = self._step_dir(step)
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic on POSIX
        self._prune()
        if dist.is_initialized():
            dist.barrier()

    def restore(self, step: int | None, like_tree, *, device="cuda"):
        """(tree, extra, step): the checkpoint at `step` (the latest if None)
        in `like_tree`'s structure, its leaves on `device`, a DTensor leaf
        of `like_tree` in its layout (every rank reads the host arrays).
        Raises ValueError unless the checkpoint holds exactly `like_tree`'s
        leaf names, shapes and dtypes."""
        dev = resolve_device(device)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        want = {n: (list(t.shape), _dtype_name(t)) for n, t in _flatten(like_tree).items()}
        have = {e["name"]: (e["shape"], e["dtype"]) for e in manifest["leaves"]}
        if have != want:
            missing = sorted(set(want) - set(have))[:5]
            extra_ = sorted(set(have) - set(want))[:5]
            differ = sorted(n for n in set(want) & set(have) if want[n] != have[n])[:5]
            raise ValueError(
                f"checkpoint {d} has {len(have)} leaves, the model needs {len(want)}: "
                f"missing {missing}, unexpected {extra_}, shape/dtype differs {differ}"
            )
        flat = {e["name"]: _from_numpy(np.load(d / e["file"]), e["dtype"], dev) for e in manifest["leaves"]}
        return _unflatten(like_tree, flat), manifest["extra"], step

    def _prune(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
