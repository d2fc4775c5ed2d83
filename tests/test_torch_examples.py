"""The port's examples (`repro_torch.examples.quickstart`, `.edge_serving`)
against the JAX package's scripts (`examples/quickstart.py`,
`examples/edge_serving.py`) run through `runpy`, on the CPU: the same J at
rtol 1e-5, the same hosts, the same bytes on the wire, and the data plane's
split against the monolithic model on JAX's own weights at
`test_partition.py`'s 2e-3. The port's bf16 logits against JAX's are held
to `test_torch_models.py`'s cross-package bf16 bound (rtol 2e-3, atol
1e-2): PyTorch rounds each op to bf16 where XLA fuses in fp32."""
import runpy

import numpy as np
import pytest
import torch

import _torch_bridge  # noqa: F401  (pins torch to one CPU thread)
from repro_torch.configs import reduced_config
from repro_torch.examples import edge_serving, quickstart
from repro_torch.models.convert import params_from_jax

from _torch_ranks import REPO

JAX_BF16_TOL = dict(rtol=2e-3, atol=1e-2)


def _run_jax(name):
    return runpy.run_path(str(REPO / "examples" / f"{name}.py"), run_name="__main__")


@pytest.fixture(scope="module")
def quick():
    return _run_jax("quickstart"), quickstart.main(device="cpu")


@pytest.fixture(scope="module")
def edge():
    return _run_jax("edge_serving"), edge_serving.main(device="cpu")


def test_quickstart_J_and_bars(quick):
    want, got = quick
    for name, r in want["results"].items():
        np.testing.assert_allclose(got["J"][name], r.J, rtol=1e-5)
        np.testing.assert_allclose(got["normalized"][name], r.J / want["worst"], rtol=1e-5)


def test_quickstart_hosts_and_wire_bytes(quick):
    """ALT's placement (every app, not only the 8 printed) equal: no
    decision of the iot scenario sits within move_margin. The bytes on the
    wire per stage at rtol 1e-5."""
    want, got = quick
    np.testing.assert_array_equal(got["hosts"], want["hosts"])
    np.testing.assert_allclose(got["wire"], want["wire"], rtol=1e-5)


def test_edge_serving_control_plane(edge):
    want, got = edge
    np.testing.assert_allclose(got["J"], want["res"].J, rtol=1e-5)
    np.testing.assert_array_equal(got["hosts"], want["hosts"])


def test_edge_serving_straggler(edge):
    """The same straggler, the same re-solve, and the stale routing's cost
    above the re-solved J, both at rtol 1e-5 against JAX's."""
    want, got = edge
    assert got["hot"] == want["hot"]
    np.testing.assert_allclose(got["J2"], want["res2"].J, rtol=1e-5)
    np.testing.assert_allclose(got["stale_J"], want["stale_J"], rtol=1e-5)
    np.testing.assert_array_equal(got["hosts2"], want["hosts2"])
    assert got["J2"] < got["stale_J"]


def test_edge_serving_data_plane_on_jax_weights(edge):
    """`data_plane` on JAX's weights and tokens: the split at the same layer,
    the same activation bytes, partitioned vs monolithic logits and both
    against JAX's at the cross-package bf16 bound."""
    want, got = edge
    cfg = reduced_config("qwen1.5-0.5b")
    params = params_from_jax(cfg, want["params"], device="cpu")
    tokens = torch.from_numpy(np.array(want["batch"]["tokens"]))
    dp = edge_serving.data_plane(cfg, params, tokens, device="cpu")
    assert dp["k"] == want["k"] == got["data_plane"]["k"]
    assert dp["act"].numel() * dp["act"].element_size() == want["act"].size * want["act"].dtype.itemsize
    logits, mono = dp["logits"].float().numpy(), dp["want"].float().numpy()
    np.testing.assert_allclose(logits, mono, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(logits, np.asarray(want["logits"], np.float32), **JAX_BF16_TOL)
    np.testing.assert_allclose(mono, np.asarray(want["want"], np.float32), **JAX_BF16_TOL)
    assert dp["err"] < 1e-2 and got["data_plane"]["err"] < 1e-2
