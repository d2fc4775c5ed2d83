"""Package rules of the PyTorch port: it imports neither JAX nor the JAX
package, its entry points default to the GPU and never fall back to the
CPU on their own, and its kernel wrappers never stand the plain version in
for the kernel on a CUDA tensor."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import alt, engine, scenarios, structs
from repro_torch.kernels import _build
from repro_torch.kernels.minplus import ops as mp_ops
from repro_torch.kernels.neumann import ops as ne_ops

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
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


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


def test_constructors_and_solvers_default_to_cuda(monkeypatch):
    """Without a GPU, every entry point called without device= raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cpu_problem = scenarios.iot(device="cpu")
    arrays = cpu_problem.to_numpy()
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


def test_build_key_tracks_sources():
    """Each CUDA source builds into its own hashed library under build/kernels."""
    paths = {n: _build._lib_path(n) for n in _build.SOURCES}
    assert set(paths) == {"neumann", "minplus"}
    for n, p in paths.items():
        assert p.parent == ROOT / "build" / "kernels" and p.name.startswith(n + "-")
        assert (PORT / "csrc" / f"{n}.cu").exists()
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
