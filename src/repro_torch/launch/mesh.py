"""Production mesh shapes (the JAX package's `launch/mesh.py`).

A mesh here is its axis names and sizes, with no devices and no process
group: the layouts of the JAX package's dry run, kept so that the port's
sharding specs (`distributed/sharding.py`) can be held to JAX's. Importing
this module touches no device.

Production target of the reference: TPU v5e pods, 16x16 = 256 chips a pod.
  single pod:  (data=16, model=16)
  multi-pod:   (pod=2, data=16, model=16)    -- "pod" is the DCN-class axis

The fleet control plane's 1-D instance-axis mesh (`make_fleet_mesh`) waits
for the mesh slice (ROADMAP.md, "Modules to port", item 3).
"""
from __future__ import annotations

import dataclasses
import math

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
