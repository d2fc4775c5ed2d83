"""Mesh construction (the JAX package's `launch/mesh.py`).

Production mesh shapes: a mesh here is its axis names and sizes, with no
devices and no process group, the layouts of the JAX package's dry run,
kept so that the port's sharding specs (`distributed/sharding.py`) can be
held to JAX's.

Production target of the reference: TPU v5e pods, 16x16 = 256 chips a pod.
  single pod:  (data=16, model=16)
  multi-pod:   (pod=2, data=16, model=16)    -- "pod" is the DCN-class axis

Model parallelism runs over `build_mesh(model_parallel)`, a ("data",
"model") `DeviceMesh` over the default group (the train CLI under a
launcher); the dry run counts a production mesh's per-device cost inside
`fake_mesh(MeshShape)`, a `fake` process group of the mesh's size in one
process (no device, no data moved).

The fleet control plane uses a real, 1-D mesh (`make_fleet_mesh`): a
`DeviceMesh` named ("fleet",) over the ranks of the default process group,
one process a device as PyTorch runs them (`python -m torch.distributed.run
--nproc-per-node N`; NCCL on the card, gloo on the CPU). It shards the
instance axis of a stacked scenario ensemble (fleet/solve.py).
`init_from_env` joins the group a launcher such as torchrun describes in
the environment. Importing this module touches no device and no group.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os

import torch
import torch.distributed as dist

from ..device import resolve_device

# The host devices the JAX package's dry run fakes
# (`--xla_force_host_platform_device_count=512`), over which its debug mesh
# is laid out.
DRYRUN_DEVICES = 512


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes. `shape` maps name -> size, as a JAX mesh's
    `shape` does, so the sharding rules read it the same way."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes, strict=True))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def name(self) -> str:
        return "x".join(map(str, self.sizes))

    @classmethod
    def of(cls, mesh) -> "MeshShape":
        """The names and sizes of a `DeviceMesh`."""
        return cls(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_debug_mesh(*, multi_pod: bool = False, model: int = 2,
                    n_devices: int = DRYRUN_DEVICES) -> MeshShape:
    """A mesh of `model`-way model parallelism over `n_devices` devices, the
    rest data (and 2 pods); JAX's takes the device count its process sees,
    `DRYRUN_DEVICES` under its dry run. `n_devices=1, model=1` is the
    one-device mesh."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, n_devices // (2 * model), model))
    return MeshShape(("data", "model"), (n_devices // model, model))


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def init_from_env(device: str | torch.device = "cuda") -> int:
    """Join the default process group that a launcher describes in the
    environment (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`, as
    `torch.distributed.run` sets them), with NCCL for `cuda` (first making
    `cuda:LOCAL_RANK` this process's device) or gloo for `cpu`. Without
    `WORLD_SIZE` in the environment, or with a group already initialised,
    it joins nothing. Returns this process's rank (0 without a group)."""
    dev = resolve_device(device)
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(_backend(dev), init_method="env://")
    return dist.get_rank() if dist.is_initialized() else 0


def fleet_ranks(n_devices: int | None = None, *, device: str | torch.device = "cuda") -> int:
    """The ranks a fleet mesh of `n_devices` spans (None: the whole world),
    checked before any collective. The world is the default process group's
    size, or 1 when no group is initialised. Asking for more ranks than the
    world, or on `cuda` for more than the visible GPUs (NCCL takes one GPU a
    rank), raises ValueError: no solve quietly runs on fewer devices than
    asked for. `device` is taken as given (`make_fleet_mesh` resolves it)."""
    dev = torch.device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(
            f"requested {n} devices, the process group has {world} rank(s); launch one "
            "process a device (python -m torch.distributed.run --nproc-per-node N)"
        )
    if dev.type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(
            f"requested {n} devices, {torch.cuda.device_count()} GPU(s) visible: NCCL takes "
            "one GPU a rank"
        )
    return n


_FLEET_MESHES: dict = {}


def make_fleet_mesh(n_devices: int | None = None, *, device: str | torch.device = "cuda"):
    """1-D instance-axis `DeviceMesh` named ("fleet",) over the first
    `n_devices` ranks of the default process group (None: all of them),
    on `device`: NCCL groups for `cuda`, gloo for `cpu`.

    A mesh needs an initialised process group (`init_from_env` under a
    launcher, or `torch.distributed.init_process_group`); without one the
    world is this one process, and a one-rank solve needs no mesh
    (`solve_fleet` runs it unsharded), so this raises ValueError rather
    than start a group of its own. Every rank of the world calls this (a
    mesh of fewer ranks than the world creates a subgroup, which is
    collective); a rank past the first `n_devices` gets a mesh it has no
    coordinate in. Meshes are reused for the same (ranks, device type,
    group)."""
    from ..distributed.sharding import FLEET_AXIS

    dev = resolve_device(device)
    n = fleet_ranks(n_devices, device=dev)
    if not dist.is_initialized():
        raise ValueError(
            "make_fleet_mesh needs an initialised process group: launch one process a device "
            "(python -m torch.distributed.run --nproc-per-node N) and call init_from_env"
        )
    backend = str(dist.get_backend())
    if _backend(dev) not in backend:
        raise ValueError(
            f"a {dev.type} fleet mesh needs a {_backend(dev)} process group, the default "
            f"group's backend is {backend!r}"
        )
    key = (n, dev.type, dist.group.WORLD)
    if key not in _FLEET_MESHES:
        from torch.distributed.device_mesh import DeviceMesh

        _FLEET_MESHES[key] = DeviceMesh(dev.type, list(range(n)), mesh_dim_names=(FLEET_AXIS,))
    return _FLEET_MESHES[key]


def build_mesh(model_parallel: int, device: str | torch.device = "cuda"):
    """A ("data", "model") `DeviceMesh` of shape (world // mp, mp) over the
    default process group on `device` (JAX's train CLI mesh), the world
    being one process without a group. Raises ValueError unless
    `model_parallel` divides the world (JAX clamps it to the device count;
    here no run quietly uses fewer devices than asked for), or, on `cuda`,
    for more ranks than visible GPUs."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(
            f"--model-parallel {model_parallel} does not divide the world of {world} rank(s); "
            "launch a multiple of it (python -m torch.distributed.run --nproc-per-node N)"
        )
    fleet_ranks(world, device=dev)  # NCCL takes one GPU a rank
    if not dist.is_initialized():
        raise ValueError(
            "build_mesh needs an initialised process group (init_from_env under a launcher, or "
            "torch.distributed.init_process_group); one process runs without a mesh"
        )
    ranks = torch.arange(world).reshape(world // model_parallel, model_parallel)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def fake_mesh(shape: MeshShape):
    """A `DeviceMesh` of `shape`'s names and sizes over a `fake` process
    group of `shape.size` ranks in this one process, as its rank 0: DTensor
    computes every rank's layout and dispatches the collectives, which move
    nothing. The group is destroyed on exit, also on an error. Refuses
    (RuntimeError) when a process group is already initialised."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_mesh: a process group is already initialised in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=shape.size)
    try:
        yield init_device_mesh("cpu", shape.sizes, mesh_dim_names=shape.axis_names)
    finally:
        dist.destroy_process_group()
