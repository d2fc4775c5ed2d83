"""Package rules of the PyTorch port: it imports neither JAX nor the JAX
package, its entry points default to the GPU and never fall back to the
CPU on their own, and its kernel wrappers never stand the plain version in
for the kernel on a CUDA tensor."""
import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_bridge  # noqa: F401  (pins torch to one CPU thread)
import repro_torch
from repro_torch.configs import reduced_config
from repro_torch import fleet
from repro_torch.core import alt, engine, scenarios, structs
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.forwarding import ops as fw_ops
from repro_torch.kernels.minplus import ops as mp_ops
from repro_torch.kernels.neumann import ops as ne_ops
from repro_torch.kernels.phi_contract import ops as pc_ops
from repro_torch.kernels.placement import ops as pl_ops
from repro_torch import chaos
from repro_torch.distributed import pipeline_apply
from repro_torch.examples import edge_serving, quickstart
from repro_torch.launch import control as control_cli
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import fleet as fleet_cli
from repro_torch.launch import pareto as pareto_cli
from repro_torch.launch import serve
from repro_torch.models import init_caches, init_params, quantize_params
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.partition import apps_from_profiles, profile_arch, run_partition, split_params, sweep_zoo

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_cpu_solve_imports_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "from repro_torch.core import iot, solve_alt\n"
        "r = solve_alt(iot(device='cpu'), m_max=2, t_phi=2, device='cpu')\n"
        "assert r.J > 0\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') or m.startswith(('jax.', 'repro.')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_cpu_serve_cli_imports_neither_jax_nor_repro():
    code = (
        "import runpy, sys\n"
        "sys.argv = ['serve', '--arch', 'qwen1.5-0.5b', '--reduced', '--requests', '3',\n"
        "            '--batch-slots', '2', '--prompt-len', '8', '--max-new', '3', '--device', 'cpu']\n"
        "try:\n"
        "    runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') or m.startswith(('jax.', 'repro.')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert '"requests": 3' in res.stdout and '"generated_tokens": 9' in res.stdout, res.stdout


def test_torchrun_fleet_and_control_clis_import_neither_jax_nor_repro(tmp_path):
    """The fleet and control CLIs under `torch.distributed.run`, 2 gloo
    ranks, with `jax` and `repro` shadowed by packages that raise on import:
    the instances are laid over both ranks and only rank 0 prints."""
    for name in ("jax", "repro"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(f"raise ImportError('the port imported {name}')\n")
    env = {"PYTHONPATH": os.pathsep.join([str(tmp_path), str(ROOT / "src")]), "PATH": os.environ["PATH"],
           "OMP_NUM_THREADS": "1", "HOME": str(tmp_path)}
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=2", "-m"]
    fleet_run = subprocess.run(run + ["repro_torch.launch.fleet", "--instances", "3", "--m-max", "2",
                                      "--t-phi", "2", "--shard", "--device", "cpu"],
                               capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert fleet_run.returncode == 0, fleet_run.stderr[-3000:]
    assert fleet_run.stdout.count('"method": "ALT"') == 1, fleet_run.stdout[-2000:]
    shard = json.loads(fleet_run.stdout)["shard"]
    assert shard["reason"] == "sharded" and shard["n_devices"] == 2 and shard["padded_batch"] == 4
    assert shard["output_sharded"]
    control_run = subprocess.run(run + ["repro_torch.launch.control", "--instances", "2", "--epochs", "4",
                                        "--m-max", "2", "--t-phi", "2", "--shard", "--device", "cpu"],
                                 capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert control_run.returncode == 0, control_run.stderr[-3000:]
    assert json.loads(control_run.stdout)["summary"]["epochs"] == 4


def test_mesh_pipeline_and_examples_default_to_cuda(monkeypatch):
    """Without a GPU, the fleet mesh, the pipeline schedule, a sharded solve
    and the two examples called without device= raise; none continues on
    the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cpu_problem = scenarios.iot(device="cpu")
    x = torch.zeros(2, 4, 8)
    for call in (
        mesh_mod.make_fleet_mesh,
        lambda: mesh_mod.make_fleet_mesh(1),
        mesh_mod.init_from_env,
        lambda: pipeline_apply(lambda p, v: v, {"w": torch.zeros(1, 8, 8)}, x, mesh=None),
        lambda: fleet.solve_fleet([cpu_problem], shard=True),
        quickstart.main,
        edge_serving.main,
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_or_repro_import(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_import_check_reaches_every_subpackage():
    """The import rule above walks every module of the port, the control
    plane and the Pareto search included."""
    checked = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"chaos/__init__.py", "chaos/events.py", "chaos/repair.py", "launch/control.py",
            "launch/pareto.py", "obs/validate.py", "partition/profile.py",
            "partition/pareto.py"} <= checked
    subpackages = {p.parent.name for p in PORT.rglob("__init__.py")}
    assert {"chaos", "core", "fleet", "kernels", "launch", "models", "obs", "partition"} <= subpackages


def test_constructors_and_solvers_default_to_cuda(monkeypatch):
    """Without a GPU, every entry point called without device= raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cpu_problem = scenarios.iot(device="cpu")
    arrays = cpu_problem.to_numpy()
    state = engine.engine_solve(engine.stack_single(cpu_problem), m_max=1, t_phi=1, alpha=0.5, tol=1e-3,
                                patience=1, keep_state=True, device="cpu")["state"]
    for call in (
        scenarios.iot,
        scenarios.mesh,
        scenarios.smallworld,
        scenarios.geant,
        lambda: scenarios.random_connected(16, 4),
        lambda: structs.Problem.from_numpy(arrays, hop_bound=4),
        lambda: structs.State.from_numpy({"x": np.zeros((1, 2, 3)), "phi": np.zeros((1, 3, 3, 3))}),
        lambda: alt.solve_alt(cpu_problem),
        lambda: alt.solve_congunaware(cpu_problem),
        lambda: alt.compare_all(cpu_problem),
        lambda: engine.engine_solve(engine.stack_single(cpu_problem), m_max=1, t_phi=1,
                                    alpha=0.5, tol=1e-3, patience=1),
        lambda: repro_torch.resolve_device(),
        lambda: fleet.sample_fleet(2),
        lambda: fleet.erdos_renyi(12, 4),
        lambda: fleet.perturbed_geant(),
        lambda: fleet.solve_fleet([cpu_problem]),
        lambda: fleet.solve_fleet([cpu_problem], method="CongUnaware"),
        lambda: fleet.solve_sequential([cpu_problem]),
        lambda: fleet_cli.main(["--instances", "1"]),
        lambda: structs.hop_bound_cache(cpu_problem.net),
        lambda: chaos.refresh_apsp0([cpu_problem], None),
        lambda: chaos.repair_fleet([cpu_problem], state, [np.ones(17, np.float32)]),
        lambda: control_cli.run_control([cpu_problem], epochs=4),
        lambda: control_cli.main(["--instances", "1", "--epochs", "4"]),
        lambda: apps_from_profiles([profile_arch(reduced_config("qwen1.5-0.5b"))], [0], [1], [1.0]),
        lambda: sweep_zoo(archs=("qwen1.5-0.5b",), topologies=("iot",)),
        lambda: pareto_cli.main(["--archs", "qwen1.5-0.5b", "--topologies", "iot"]),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_model_entry_points_default_to_cuda(monkeypatch):
    """The serve path's entry points, called without device=, raise too:
    for every family, the encoder through the executor and int8 trees."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config("qwen1.5-0.5b")
    model = init_params(cfg, 0, device="cpu")
    p1, _ = split_params(cfg, model, 1)
    tree = params_to_numpy(model)
    int8_tree = params_to_numpy(quantize_params(model))
    enc_cfg = reduced_config("seamless-m4t-medium")
    enc_p1, _ = split_params(enc_cfg, init_params(enc_cfg, 0, device="cpu"), 0)
    feats = torch.zeros(1, 4, enc_cfg.frontend_dim)
    prompts = np.zeros((2, 4), np.int32)
    for call in (
        lambda: init_params(cfg),
        lambda: init_caches(cfg, 1, 8),
        lambda: params_from_jax(cfg, tree),
        lambda: run_partition(cfg, p1, {"tokens": torch.zeros(1, 4, dtype=torch.long)}, part=1),
        lambda: serve.serve(cfg, model, prompts, batch_slots=2, max_new=2, max_seq=16),
        lambda: serve.main(["--arch", "qwen1.5-0.5b", "--reduced", "--requests", "1"]),
        *(lambda a=a: init_params(reduced_config(a)) for a in ("mamba2-370m", "hymba-1.5b", "mixtral-8x22b",
                                                               "seamless-m4t-medium", "internvl2-76b")),
        lambda: init_caches(enc_cfg, 1, 8),
        lambda: init_caches(reduced_config("hymba-1.5b"), 1, 8),
        lambda: run_partition(enc_cfg, enc_p1, {"feats": feats}, part=1),
        lambda: init_params(dataclasses.replace(cfg, quantize_int8=True)),
        lambda: params_from_jax(cfg, int8_tree),
        lambda: serve.main(["--arch", "mamba2-370m", "--reduced", "--requests", "1"]),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_solve_device_must_match_problem(monkeypatch):
    """A solve never moves the problem: asking for another device raises."""
    p = scenarios.iot(device="cpu")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        alt.solve_alt(p, device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    # resolve_device switches TF32 off; restore the process's flags after.
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", torch.backends.cuda.matmul.allow_tf32)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", torch.backends.cudnn.allow_tf32)
    with pytest.raises(ValueError, match="lives on cpu"):
        alt.solve_alt(p, device="cuda")
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")


class _FakeCuda:
    """Stands in for a CUDA tensor on a machine without CUDA: it reports a
    CUDA device and answers every other question like the real tensor."""

    device = torch.device("cuda", 0)

    def __init__(self, t):
        self._t = t

    def __getattr__(self, name):
        return getattr(self._t, name)


def _no_plain(*_a, **_k):
    raise AssertionError("the plain version ran for a CUDA tensor")


def test_kernel_wrappers_raise_instead_of_plain_on_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(ne_ops, "neumann_propagate_ref", _no_plain)
    monkeypatch.setattr(mp_ops, "minplus_matmul_blocked", _no_plain)
    monkeypatch.setattr(mp_ops, "minplus_matmul_argmin_blocked", _no_plain)
    monkeypatch.setattr(_build, "_LIBS", {})
    w, b = _FakeCuda(torch.zeros(2, 5, 5)), _FakeCuda(torch.ones(2, 5))
    for transpose in (False, True):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            ne_ops.neumann_propagate(w, b, hops=3, transpose=transpose)
    a = _FakeCuda(torch.zeros(2, 4, 4))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        mp_ops.minplus_matmul(a, a)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        mp_ops.minplus_matmul_argmin(a, a)
    monkeypatch.setattr(fa_ops, "attention_ref", _no_plain)
    monkeypatch.setattr(fa_ops, "attention_chunked", _no_plain)
    for dtype in (torch.float32, torch.bfloat16):
        q = _FakeCuda(torch.zeros(1, 2, 6, 1, 16, dtype=dtype)[..., 0, :].transpose(1, 2))
        kv = _FakeCuda(torch.zeros(1, 1, 6, 16, dtype=dtype))
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            fa_ops.flash_attention(q, kv, kv, window=4, q_offset=2)


def test_kernel_wrappers_validate_cuda_inputs():
    """Shape, dtype and layout errors are raised before any launch."""
    w, b = _FakeCuda(torch.zeros(2, 5, 5)), _FakeCuda(torch.ones(2, 4))
    with pytest.raises(ValueError, match="shapes"):
        ne_ops.neumann_propagate(w, b, hops=3)
    w64 = _FakeCuda(torch.zeros(2, 5, 5, dtype=torch.float64))
    with pytest.raises(TypeError):
        ne_ops.neumann_propagate(w64, _FakeCuda(torch.ones(2, 5)), hops=3)
    wt = _FakeCuda(torch.zeros(2, 5, 5).mT)
    with pytest.raises(ValueError, match="row-major"):
        ne_ops.neumann_propagate(wt, _FakeCuda(torch.ones(2, 5)), hops=3)
    a = _FakeCuda(torch.zeros(4, 6))
    with pytest.raises(ValueError, match="shapes"):
        mp_ops.minplus_matmul(a, a)
    with pytest.raises(ValueError, match="contiguous"):
        mp_ops.minplus_matmul(_FakeCuda(torch.zeros(6, 6).mT), _FakeCuda(torch.zeros(6, 6)))
    q, kv = _FakeCuda(torch.zeros(1, 4, 8, 16)), _FakeCuda(torch.zeros(1, 2, 8, 16))
    with pytest.raises(ValueError, match="shapes"):
        fa_ops.flash_attention(q, _FakeCuda(torch.zeros(1, 3, 8, 16)), _FakeCuda(torch.zeros(1, 3, 8, 16)))
    with pytest.raises(ValueError, match="shapes"):
        fa_ops.flash_attention(q, kv, _FakeCuda(torch.zeros(1, 2, 9, 16)))
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q, kv, _FakeCuda(torch.zeros(1, 2, 8, 16, dtype=torch.bfloat16)))
    with pytest.raises(ValueError, match="head dim"):
        big = _FakeCuda(torch.zeros(1, 1, 2, 264))
        fa_ops.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_attention(_FakeCuda(torch.zeros(1, 4, 16, 8).mT), kv, kv)
    with pytest.raises(ValueError, match="window"):
        fa_ops.flash_attention(q, kv, kv, window=-1)


def test_kernel_wrappers_validate_variant_rules(monkeypatch):
    """The launch rules of the tensor-core flash kernel and of the clustered
    rows and cols kernels raise before any launch; inputs outside them take
    the other kernel, never the plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(fa_ops, "attention_ref", _no_plain)
    monkeypatch.setattr(fa_ops, "attention_chunked", _no_plain)
    monkeypatch.setattr(ne_ops, "neumann_propagate_ref", _no_plain)
    # A sequence stride of 20 elements is not a whole number of 16-byte units.
    for dtype, d, route in ((torch.bfloat16, 16, "tensor-core"), (torch.float32, 16, "needs a CUDA device"),
                            (torch.bfloat16, 12, "needs a CUDA device")):
        q = _FakeCuda(torch.zeros(1, 2, 8, 20, dtype=dtype)[..., :d])
        kv = _FakeCuda(torch.zeros(1, 2, 8, d, dtype=dtype))
        with pytest.raises((ValueError, RuntimeError), match=route):
            fa_ops.flash_attention(q, kv, kv)
    for v in (8200, 28928):  # past 256 column quads a CTA at C = 8: the launch arguments validate
        wide = _FakeCuda(torch.empty(1, v, v, dtype=torch.bfloat16, device="meta"))
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            ne_ops.neumann_propagate(wide, _FakeCuda(torch.ones(1, v)), hops=3, transpose=True)
    wide = _FakeCuda(torch.empty(1, 28929, 28929, dtype=torch.bfloat16, device="meta"))  # iterates past 227 KB
    with pytest.raises(ValueError, match="shared memory"):
        ne_ops.neumann_propagate(wide, _FakeCuda(torch.ones(1, 28929)), hops=3, transpose=True)
    for transpose in (False, True):  # V = 0: the empty result, no layout and no launch
        out = ne_ops.neumann_propagate(_FakeCuda(torch.zeros(2, 0, 0)), _FakeCuda(torch.ones(2, 0)), hops=3,
                                       transpose=transpose)
        assert tuple(out.shape) == (2, 0)
    w, b = _FakeCuda(torch.zeros(2, 100, 100)), _FakeCuda(torch.ones(2, 100))
    monkeypatch.setattr(ne_ops, "_rows_cluster", lambda v, esize: (3, True))
    with pytest.raises(ValueError, match="cluster size 3"):
        ne_ops.neumann_propagate(w, b, hops=3)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):  # cols has its own cluster
        ne_ops.neumann_propagate(w, b, hops=3, transpose=True)
    monkeypatch.setattr(ne_ops, "_cols_cluster", lambda v: (3, True))
    with pytest.raises(ValueError, match="cluster size 3"):
        ne_ops.neumann_propagate(w, b, hops=3, transpose=True)
    monkeypatch.setattr(ne_ops, "_cols_cluster", lambda v: (16, True))
    with pytest.raises(ValueError, match="cluster size 16"):
        ne_ops.neumann_propagate(w, b, hops=3, transpose=True)
    monkeypatch.setattr(ne_ops, "_rows_cluster", lambda v, esize: (1, True))
    monkeypatch.setattr(ne_ops, "_SMEM_MAX", 16 * 1024)
    with pytest.raises(ValueError, match="shared memory"):
        ne_ops.neumann_propagate(w, b, hops=3)
    monkeypatch.setattr(ne_ops, "_cols_cluster", lambda v: (8, False))
    with pytest.raises(ValueError, match="shared memory"):  # x and the partial sums: 19.6 KB at V = 2000
        ne_ops.neumann_propagate(_FakeCuda(torch.empty(1, 2000, 2000, device="meta")), _FakeCuda(torch.ones(1, 2000)),
                                 hops=3, transpose=True)


def test_placement_sweep_wrapper_raises_instead_of_plain_on_cuda(monkeypatch):
    """A CUDA problem reaches the sweep kernel's launch (which raises
    without a card) and never the plain scan; shapes it cannot take raise
    first."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pl_ops, "sequential_sweep", _no_plain)
    monkeypatch.setattr(_build, "_LIBS", {})
    problem = fleet.stack_problems([scenarios.iot(device="cpu")])[0]
    b, a, p, v = 1, problem.apps.n_apps, problem.apps.n_parts, problem.net.n_nodes
    hosts = _FakeCuda(torch.zeros(b, a, p, dtype=torch.int64))
    dist, G = _FakeCuda(torch.zeros(b, v, v)), _FakeCuda(torch.zeros(b, v))
    kw = dict(colocate=False, move_margin=0.02)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        pl_ops.placement_sweep(problem, hosts, dist, G, None, **kw)
    with pytest.raises(TypeError, match="float32"):
        pl_ops.placement_sweep(problem, hosts, _FakeCuda(torch.zeros(b, v, v, dtype=torch.float64)), G, None, **kw)
    with pytest.raises(ValueError, match="dist"):
        pl_ops.placement_sweep(problem, hosts, _FakeCuda(torch.zeros(b, v, v + 1)), G, None, **kw)


@pytest.mark.parametrize("n, shape", [
    (1, (32, 1)), (12, (32, 1)), (64, (64, 1)), (65, (96, 1)), (256, (256, 1)), (1024, (1024, 1)),
    (1025, (1024, 2)), (3000, (1024, 4)), (8192, (1024, 8)),
])
def test_placement_sweep_geometry(n, shape):
    """Threads a CTA are the lane's nodes in whole warps up to 1,024, then
    each thread owns 2, 4 or 8 nodes; past 8,192 nodes the wrapper raises."""
    assert pl_ops._geometry(n) == shape
    threads, npt = shape
    assert threads % 32 == 0 and threads * npt >= n and (npt == 1 or threads == 1024)
    with pytest.raises(ValueError, match="exceed"):
        pl_ops._geometry(8193)


def test_forwarding_sweep_wrapper_raises_instead_of_plain_on_cuda(monkeypatch):
    """CUDA operands reach the forwarding kernel's launch (which raises
    without a card) and never the plain tail; dtypes and shapes it cannot
    take raise first."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(fw_ops, "update_phi_ref", _no_plain)
    monkeypatch.setattr(_build, "_LIBS", {})
    b, a, k, v = 2, 3, 3, 40

    def operands(**swap):
        shapes = {"phi": (b, a, k, v, v), "q": (b, a, k, v), "dp": (b, v, v), "L": (b, a, k),
                  "adj": (b, v, v), "mass": (b, a, k, v)}
        ts = {n: torch.zeros(s) for n, s in shapes.items()}
        ts.update(swap)
        return [_FakeCuda(ts[n]) for n in shapes] + [0.5]

    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        fw_ops.update_phi(*operands())
    with pytest.raises(TypeError, match="float32"):
        fw_ops.update_phi(*operands(q=torch.zeros(b, a, k, v, dtype=torch.float64)))
    with pytest.raises(ValueError, match="dp"):
        fw_ops.update_phi(*operands(dp=torch.zeros(b, v, v + 1)))
    with pytest.raises(ValueError, match="phi"):
        fw_ops.update_phi(*operands(phi=torch.zeros(b, a, k, v)))
    with pytest.raises(ValueError, match="shared memory"):
        fw_ops.update_phi(*operands(phi=torch.empty(1, 1, 1, 30000, 30000, device="meta"),
                                    q=torch.zeros(1, 1, 1, 30000), dp=torch.zeros(1, 30000, 30000, device="meta"),
                                    L=torch.zeros(1, 1, 1), adj=torch.zeros(1, 30000, 30000, device="meta"),
                                    mass=torch.zeros(1, 1, 1, 30000)))


@pytest.mark.parametrize("fn", ["phi_loads", "phi_link_term"])
def test_phi_contract_wrappers_raise_instead_of_plain_on_cuda(fn, monkeypatch):
    """CUDA operands reach the contraction kernels' launch (which raises
    without a card) and never the plain versions, with or without a
    gradient to take; dtypes, shapes and devices they cannot take raise
    first."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pc_ops, "phi_loads_ref", _no_plain)
    monkeypatch.setattr(pc_ops, "phi_link_term_ref", _no_plain)
    monkeypatch.setattr(_build, "_LIBS", {})
    b, a, k, v = 2, 3, 3, 40
    other = "t" if fn == "phi_loads" else "dp"
    call = getattr(pc_ops, fn)

    def operands(**swap):
        shapes = {"phi": (b, a, k, v, v), other: (b, a, k, v) if other == "t" else (b, v, v), "L": (b, a, k)}
        ts = {n: torch.zeros(s) for n, s in shapes.items()}
        ts.update(swap)
        return [t if isinstance(t, _FakeCuda) else _FakeCuda(t) for t in (ts[n] for n in shapes)]

    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        call(*operands())
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        with torch.enable_grad():
            call(*operands(L=torch.zeros(b, a, k, requires_grad=True)))
    with pytest.raises(TypeError, match="float32"):
        call(*operands(L=torch.zeros(b, a, k, dtype=torch.float64)))
    with pytest.raises(ValueError, match=other):
        call(*operands(**{other: torch.zeros(b, v, v + 1)}))
    with pytest.raises(ValueError, match="phi"):
        call(*operands(phi=torch.zeros(b, a, k, v)))
    with pytest.raises(ValueError, match="device"):
        away = torch.zeros(b, a, k)
        call(*operands(L=away)[:-1], away)


@pytest.mark.parametrize("v", [1, 31, 32, 33, 64, 256, 1024, 1025, 5000])
def test_forwarding_sweep_geometry(v):
    """Up to 1,024 nodes a row lies in registers on the fewest lanes (4 to
    32) that hold it at 8 values a lane, npl values a lane in vectors of
    vec columns dividing V, at most 4 warps a CTA and none without a row;
    past that the streamed kernel, one row a warp."""
    npl, vec, seg, warps = fw_ops._geometry(v)
    assert 1 <= warps <= 4
    if v > 1024:
        assert (npl, vec, warps) == (0, 1, 4) and fw_ops._variant(npl, seg) == "streamed"
        return
    assert seg in (4, 8, 16, 32) and (seg == 4 or 4 * seg < v)
    assert npl in (8, 16, 32) and seg * npl >= v and (npl == 8 or seg * npl < 2 * v) and (seg == 32 or npl == 8)
    assert vec in (1, 4) and v % vec == 0 and (vec == 4 or v % 4)
    rows_warp = 32 // seg
    assert (warps - 1) * rows_warp < v and (warps == 4 or warps * rows_warp >= v)
    assert fw_ops._variant(npl, seg) == f"s{seg}_w{npl}_resident"


def test_launch_counts_by_variant(monkeypatch):
    empty = {"neumann_cols": {}, "neumann_rows": {}, "minplus_argmin": {}, "flash_attention": {},
             "forwarding_sweep": {}, "phi_loads": {}, "phi_link_term": {}}
    assert _build.VARIANT_LAUNCHES.keys() == empty.keys()
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    monkeypatch.setattr(_build, "VARIANT_LAUNCHES", {k: {} for k in empty})
    _build.count("flash_attention", "wgmma")
    _build.count("flash_attention", "wgmma")
    _build.count("neumann_rows", "c4_resident")
    _build.count("neumann_cols", "c4_resident")
    _build.count("neumann_cols", "c8_streamed")
    _build.count("minplus")
    _build.count("minplus_argmin", mp_ops._argmin_variant(2, False))
    _build.count("minplus_argmin", mp_ops._argmin_variant(1, True))
    _build.count("minplus_argmin", mp_ops._argmin_variant(2, False))
    _build.count("forwarding_sweep", fw_ops._variant(8, 8))
    _build.count("forwarding_sweep", fw_ops._variant(0, 32))
    _build.count("phi_loads", "vec4")
    _build.count("phi_loads", "vec1")
    _build.count("phi_loads", "vec4")
    _build.count("phi_link_term", fw_ops._variant(*fw_ops._geometry(256)[::2]))
    assert _build.LAUNCHES["flash_attention"] == 2 and _build.LAUNCHES["minplus"] == 1
    assert _build.LAUNCHES["forwarding_sweep"] == 2
    assert _build.LAUNCHES["phi_loads"] == 3 and _build.LAUNCHES["phi_link_term"] == 1
    assert _build.LAUNCHES["neumann_cols"] == 2 and _build.LAUNCHES["minplus_argmin"] == 3
    assert _build.VARIANT_LAUNCHES == {
        "neumann_cols": {"c4_resident": 1, "c8_streamed": 1}, "neumann_rows": {"c4_resident": 1},
        "minplus_argmin": {"s2_u8": 2, "s1_u32": 1}, "flash_attention": {"wgmma": 2},
        "forwarding_sweep": {"s8_w8_resident": 1, "streamed": 1},
        "phi_loads": {"vec4": 2, "vec1": 1}, "phi_link_term": {"s32_w8_resident": 1},
    }
    _build.reset_launches()
    assert not any(_build.LAUNCHES.values()) and _build.VARIANT_LAUNCHES == empty


def test_argmin_wrapper_checks_its_split(monkeypatch):
    """The argmin wrapper launches only splits that cover K with non-empty
    ranges of whole 16-deep stages, and byte chunk ids only up to 256
    4-deep chunks a range; what the chooser gives passes those checks and
    reaches the launch, which raises without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(mp_ops, "minplus_matmul_argmin_blocked", _no_plain)
    a, b = _FakeCuda(torch.zeros(1, 64, 4200)), _FakeCuda(torch.zeros(1, 4200, 64))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        mp_ops.minplus_matmul_argmin(a, b)
    for forced in ((1, 4208, True), (2, 2112, True), (6, 704, False)):  # word ids; six byte-id splits
        monkeypatch.setattr(mp_ops, "_argmin_split", lambda *_a, f=forced: f)
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            mp_ops.minplus_matmul_argmin(a, b)
    # 1052 and 352 chunks in a byte; a range past K; an empty range; ranges of part of a stage
    for bad in ((1, 4208, False), (3, 1408, False), (2, 2000, True), (9, 528, False), (3, 1400, True)):
        monkeypatch.setattr(mp_ops, "_argmin_split", lambda *_a, f=bad: f)
        with pytest.raises(ValueError, match="no launch"):
            mp_ops.minplus_matmul_argmin(a, b)


def test_build_key_tracks_sources():
    """Each CUDA source builds into its own hashed library under build/kernels."""
    paths = {n: _build._lib_path(n) for n in _build.SOURCES}
    assert set(paths) == {"neumann", "minplus", "flash_attention", "placement", "forwarding", "phi_contract"}
    for n, p in paths.items():
        assert p.parent == ROOT / "build" / "kernels" and p.name.startswith(n + "-")
        assert (PORT / "csrc" / f"{n}.cu").exists()
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
