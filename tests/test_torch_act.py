"""The port's activation sharding constraints (`repro_torch.distributed.act`)
against the JAX package's (`repro.distributed.act`).

JAX's constraint for each of the eleven kinds is read, in one subprocess
with 8 fake host devices, as the output sharding of
`jax.jit(lambda x: shard(x, kind))` under `activation_sharding`, on a
(data=4, model=2) and a (pod=2, data=2, model=2) mesh: shapes that divide
the axes and shapes that do not, a batch that does not divide the data
axes, `seq_shard_residual` on and off, and a spec longer than the tensor
(JAX leaves it unconstrained). `act_spec` must name the same placement
for every dim. Without a context `shard` is the identity; under one it
redistributes a DTensor and refuses a plain tensor.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import _torch_bridge  # noqa: F401  (pins torch to one CPU thread)
from repro_torch.distributed import act
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.mesh import MeshShape, fake_mesh

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"4x2": MeshShape(("data", "model"), (4, 2)), "2x2x2": MeshShape(("pod", "data", "model"), (2, 2, 2))}
# (kind, shape): one shape whose dims divide the axes, one whose do not.
CASES = [
    ("residual", (8, 6, 4)), ("residual", (6, 5, 4)),
    ("heads", (8, 3, 4, 2)), ("heads", (8, 3, 3, 2)),
    ("heads_t", (8, 4, 3, 2)), ("heads_t", (6, 3, 3, 2)),
    ("ffn", (8, 3, 6)), ("ffn", (8, 3, 5)),
    ("logits", (8, 3, 10)), ("logits", (2, 3, 7)),
    ("expert_buffers", (4, 3, 2)), ("expert_buffers", (3, 3, 2)),
    ("moe_groups", (4, 3, 2)), ("moe_groups", (2, 3, 2)),
    ("tokens_flat", (8, 3)), ("tokens_flat", (6, 3)),
    ("ssm_inner", (8, 3, 5)), ("ssm_inner", (6, 3, 5)),
    ("kv_cache", (8, 2, 6, 2)), ("kv_cache", (8, 2, 5, 2)),
    ("decode_scores", (8, 2, 3, 6)), ("decode_scores", (4, 2, 3, 5)),
    ("residual", (8, 4)),  # longer spec than dims: unconstrained
]
SEQ_SHARD_CASES = [("residual", (8, 6, 4)), ("residual", (8, 5, 4)), ("residual", (6, 4, 4))]

_JAX_SIDE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.distributed.act import activation_sharding, shard
from repro.distributed.sharding import ShardingRules

cases = json.loads(sys.argv[1])
devs = np.array(jax.devices()[:8])
meshes = {"4x2": Mesh(devs.reshape(4, 2), ("data", "model")),
          "2x2x2": Mesh(devs.reshape(2, 2, 2), ("pod", "data", "model"))}
out = []
for mesh_name, kind, shape, seq in cases:
    mesh = meshes[mesh_name]
    rules = ShardingRules(pod_axis="pod" if "pod" in mesh.axis_names else None, seq_shard_residual=seq)
    with mesh, activation_sharding(mesh, rules):  # the mesh context, as JAX's dry run enters it
        compiled = jax.jit(lambda x: shard(x, kind)).lower(jax.ShapeDtypeStruct(tuple(shape), jnp.float32)).compile()
    sharding = compiled.output_shardings  # one device's sharding where nothing constrained x
    spec = list(sharding.spec) if hasattr(sharding, "spec") else []
    out.append([[list(e) if isinstance(e, tuple) else ([] if e is None else [e]) for e in spec]])
print(json.dumps(out))
"""


def _dims(spec, ndim: int) -> list:
    """A spec as one list of axis names a dim, padded to `ndim`."""
    dims = [list(e) if isinstance(e, (tuple, list)) else ([] if e is None else [e]) for e in spec]
    return dims + [[]] * (ndim - len(dims))


def _all_cases():
    return ([(m, k, s, False) for m in MESHES for k, s in CASES]
            + [(m, k, s, True) for m in MESHES for k, s in SEQ_SHARD_CASES])


@pytest.fixture(scope="module")
def jax_specs():
    cases = _all_cases()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", _JAX_SIDE, json.dumps(cases)], env=env, capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    specs = json.loads(r.stdout.strip().splitlines()[-1])
    return {(m, k, tuple(s), seq): spec[0] for (m, k, s, seq), spec in zip(cases, specs, strict=True)}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("kind", act.KINDS)
def test_act_spec_matches_jax(jax_specs, mesh_name, kind):
    """act_spec names JAX's constraint dim for dim, for every shape of the
    kind (one that divides the mesh axes, one that does not), with
    seq_shard_residual off and, for the residual stream, on."""
    mesh = MESHES[mesh_name]
    rules_of = {seq: ShardingRules(pod_axis="pod" if "pod" in mesh.axis_names else None, seq_shard_residual=seq)
                for seq in (False, True)}
    cases = [(k, s, seq) for m, k, s, seq in _all_cases() if m == mesh_name and k == kind]
    assert len(cases) >= 2
    for k, shape, seq in cases:
        got = act.act_spec(shape, kind, mesh.shape, rules_of[seq])
        want = jax_specs[(mesh_name, k, shape, seq)]
        if len(got) > len(shape):  # JAX's constraint fails and it leaves x unconstrained
            assert _dims(want, len(shape)) == [[]] * len(shape), (shape, want)
            continue
        assert _dims(got, len(shape)) == _dims(want, len(shape)), (kind, shape, seq, got, want)


def test_shard_is_identity_without_a_context():
    x = torch.randn(8, 6, 4)
    for kind in act.KINDS:
        assert act.shard(x, kind) is x
    assert not act.active()


def test_shard_under_a_context():
    """Under activation_sharding a DTensor is redistributed to act_spec's
    placements, a plain tensor raises TypeError, and a spec longer than
    the tensor leaves it as it is; the context ends with its block."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    shape = MeshShape(("data", "model"), (4, 2))
    with fake_mesh(shape) as mesh:
        rules = ShardingRules()
        x = distribute_tensor(torch.empty(8, 6, 4, device="meta"), mesh, [Replicate(), Replicate()],
                              src_data_rank=None)
        with act.activation_sharding(mesh, rules):
            assert act.active()
            assert act.shard(x, "ffn").placements == (Shard(0), Shard(2))
            assert act.shard(x, "residual").placements == (Shard(0), Replicate())
            flat = distribute_tensor(torch.empty(8, 6, device="meta"), mesh, [Replicate(), Replicate()],
                                     src_data_rank=None)
            assert act.shard(flat, "residual") is flat
            with pytest.raises(TypeError, match="plain"):
                act.shard(torch.empty(8, 6, 4), "residual")
        with act.activation_sharding(mesh, ShardingRules(seq_shard_residual=True)):
            assert act.shard(x, "residual").placements == (Shard(0), Shard(1))
        assert not act.active()


def test_ssd_runs_on_each_ranks_slab():
    """The SSD scan on DTensors (`ssm._ssd`) runs on each rank's local slab,
    batch over data and heads over model, B and C split on the batch
    alone: on a (data=2, model=2) fake mesh rank 0's output, final state
    and input gradient are the plain scan's first batch half and first
    head half, and the outputs keep that layout."""
    import numpy as np
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed.sharding import to_placements
    from repro_torch.models import ssm

    rng = np.random.RandomState(0)
    b, l, h, p, n, chunk = 4, 16, 4, 3, 5, 8
    xs, B, C = (torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in ((b, l, h, p), (b, l, n), (b, l, n)))
    dt = torch.from_numpy(rng.rand(b, l, h).astype(np.float32))
    A = torch.from_numpy(-rng.rand(h).astype(np.float32))
    x0 = xs.clone().requires_grad_()
    y, s = ssm.ssd_chunked(x0, dt, A, B, C, chunk)
    y.sum().backward()
    specs = [("data", None, "model", None), ("data", None, "model"), ("model",), ("data", None, None),
             ("data", None, None)]
    with fake_mesh(MeshShape(("data", "model"), (2, 2))) as mesh, act.activation_sharding(mesh, ShardingRules()):
        xd, dtd, Ad, Bd, Cd = (distribute_tensor(t, mesh, to_placements(mesh, sp), src_data_rank=None)
                               for t, sp in zip((xs, dt, A, B, C), specs))
        xd.requires_grad_()
        yd, sd = ssm._ssd(xd, dtd, Ad, Bd, Cd, chunk)
        yd.to_local().sum().backward()
        assert yd.placements == (Shard(0), Shard(2)) and sd.placements == (Shard(0), Shard(1))
        assert yd.shape == y.shape and sd.shape == s.shape
        torch.testing.assert_close(yd.to_local(), y[: b // 2, :, : h // 2].detach(), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(sd.to_local(), s[: b // 2, : h // 2].detach(), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(xd.grad.to_local(), x0.grad[: b // 2, :, : h // 2], rtol=1e-6, atol=1e-6)
        # A batch the data axis does not divide stays whole; the heads still split.
        rep = [Replicate(), Replicate()]
        odd = [distribute_tensor(t[:3], mesh, rep, src_data_rank=None) for t in (xs, dt, B, C)]
        yo, _ = ssm._ssd(odd[0], odd[1], Ad, odd[2], odd[3], chunk)
        assert yo.placements == (Replicate(), Shard(2))
        y3, _ = ssm.ssd_chunked(xs[:3], dt[:3], A, B[:3], C[:3], chunk)
        torch.testing.assert_close(yo.to_local(), y3[:, :, : h // 2], rtol=1e-6, atol=1e-6)
