"""The port's GPipe schedule (`repro_torch.distributed.pipeline_apply`)
against the sequential stages and JAX's `pipeline_apply`, over 4 gloo
ranks on the CPU.

One module-scoped launch runs `tests/_torch_ranks.py pipeline` under
`torch.distributed.run`: P=4 stages of `tanh(x @ w[s])` over M=6 and M=2
(fewer microbatches than stages) microbatches of 8 x 16, and P=1 on a
(4, 1) mesh. Meanwhile a subprocess with 4 fake host devices runs JAX's
`pipeline_apply` on the same seeded inputs, as `tests/test_pipeline.py`
runs it."""
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_bridge  # noqa: F401  (pins torch to one CPU thread)
import _torch_ranks as R

_JAX = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
import jax, jax.numpy as jnp, numpy as np
from repro.distributed.pipeline import pipeline_apply
from _torch_ranks import PIPE_CASES, pipe_inputs

out = {}
for p, m in PIPE_CASES:
    w, x = pipe_inputs(p, m)
    mesh = jax.make_mesh((p,), ("pod",), devices=jax.devices()[:p])
    got = pipeline_apply(lambda q, v: jnp.tanh(v @ q["w"]), {"w": jnp.asarray(w)}, jnp.asarray(x),
                         mesh=mesh, axis="pod")
    out[f"P{p}_M{m}"] = np.asarray(got)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline_ranks")
    proc = R.launch("pipeline", out)
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(R.REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    try:
        jax_run = subprocess.run([sys.executable, "-c", _JAX, str(out / "jax.npz")], env=env,
                                 cwd=str(R.REPO), capture_output=True, text=True, timeout=300)
    finally:
        res = R.finish(proc, out, "pipeline")
    assert jax_run.returncode == 0, jax_run.stderr[-3000:]
    with np.load(out / "jax.npz") as z:
        return res, {k: z[k] for k in z.files}


CASES = [f"P{p}_M{m}" for p, m in R.PIPE_CASES]


@pytest.mark.parametrize("case", CASES)
def test_pipeline_matches_sequential(runs, case):
    res, _ = runs
    assert bool(res[f"check.{case}_matches_sequential"]), str(res[f"detail.{case}_matches_sequential"])
    assert res[f"{case}.got"].shape == (int(case.split("_M")[1]), R.PIPE_MB, R.PIPE_D)


@pytest.mark.parametrize("case", CASES)
def test_pipeline_matches_jax(runs, case):
    res, jax_out = runs
    np.testing.assert_allclose(res[f"{case}.got"], jax_out[case], rtol=0, atol=1e-5)


def test_pipeline_every_rank_and_reference(runs):
    """Every rank returns the last stage's outputs, the ranks never load
    JAX, and the outputs match the committed reference run."""
    res, _ = runs
    assert not R.failed_checks(res)
    assert bool(res["check.same_result_on_every_rank"]) and bool(res["check.ranks_import_neither_jax_nor_repro"])
    err = R.against_reference("pipeline", res)
    assert all(e <= 1e-5 for e in err.values()), err
