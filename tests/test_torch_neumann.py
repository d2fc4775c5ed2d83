"""Port parity: the Neumann propagation solve (repro_torch.kernels.neumann)
against the JAX package's Pallas kernel (interpret mode) and LU, on the CPU,
where the wrapper runs the CUDA kernel's plain version."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_bridge  # noqa: F401  (pins torch to one CPU thread)
from repro.kernels.neumann import lu_solve_ref as j_lu
from repro.kernels.neumann.kernel import neumann_solve_pallas
from repro_torch.core import (
    cost_to_go,
    forwarding_update,
    mesh,
    stack_single,
    structured_init,
)
from repro_torch.core.flow import objective_with_injection
from repro_torch.kernels.neumann import (
    effective_hops,
    lu_solve_ref,
    neumann_propagate,
    neumann_propagate_ref,
    neumann_solve,
)
from repro_torch.kernels.neumann.ops import (
    _batch_stride,
    _cols_cluster,
    _cols_layout,
    _cols_smem,
    _rows_cluster,
    _rows_smem,
)

jax.config.update("jax_enable_x64", False)


def _phi_like(rng, n_batch, v, density=0.3):
    """Row-substochastic strictly upper-triangular operators: nilpotent like
    loop-free forwarding, with realistic (< 1) gains."""
    m = np.triu(rng.uniform(0.0, 1.0, (n_batch, v, v)).astype(np.float32), 1)
    m *= rng.rand(n_batch, v, v) < density
    m /= np.maximum(m.sum(axis=-1, keepdims=True), 1.0)
    return m.astype(np.float32)


@pytest.mark.parametrize("v", [40, 72])
def test_plain_matches_pallas_kernel(v):
    """Same contract as `neumann_solve_pallas`: hop cap below V so the
    freeze and the cap both matter; both operator layouts."""
    rng = np.random.RandomState(v)
    m = _phi_like(rng, 6, v)
    b = rng.uniform(0.0, 2.0, (6, v)).astype(np.float32)
    b[0] = 0.0  # all-zero rhs: done after one hop
    hops = 12
    want = np.asarray(neumann_solve_pallas(jnp.asarray(m), jnp.asarray(b), hops=hops, interpret=True))
    mt = torch.from_numpy(m)
    got = neumann_propagate(mt, torch.from_numpy(b), hops=hops)
    got_t = neumann_propagate(mt.mT.contiguous(), torch.from_numpy(b), hops=hops, transpose=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got_t.numpy(), want, rtol=1e-6, atol=1e-7)


def test_plain_matches_pallas_tiled_kernel():
    """The TPU's K-tiled kernel (block_k=128, V=200) computes the same
    recurrence; the port serves every V with one contract."""
    rng = np.random.RandomState(7)
    v = 200
    m = _phi_like(rng, 3, v, density=0.1)
    b = rng.uniform(0.0, 1.0, (3, v)).astype(np.float32)
    hops = 30
    want = np.asarray(neumann_solve_pallas(
        jnp.asarray(m), jnp.asarray(b), hops=hops, interpret=True, block_k=128
    ))
    got = neumann_solve(torch.from_numpy(m), torch.from_numpy(b), hops=hops, block_k=128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_bf16_operands_within_tolerance_and_keep_zeros():
    rng = np.random.RandomState(8)
    v = 200
    m = _phi_like(rng, 2, v, density=0.1)
    b = rng.uniform(0.0, 1.0, (2, v)).astype(np.float32)
    b[:, 100:] = 0.0
    m[:, :, 150:] = 0.0  # nodes 150.. receive nothing: exact zeros
    hops = 40
    want = np.asarray(neumann_solve_pallas(
        jnp.asarray(m), jnp.asarray(b), hops=hops, interpret=True,
        operand_dtype=jnp.bfloat16,
    ))
    got = neumann_solve(
        torch.from_numpy(m), torch.from_numpy(b), hops=hops, operand_dtype=torch.bfloat16
    ).numpy()
    exact = neumann_propagate_ref(torch.from_numpy(m), torch.from_numpy(b), hops).numpy()
    scale = np.abs(exact).max()
    assert np.abs(got - want).max() <= 2e-2 * scale
    assert np.abs(got - exact).max() <= 2e-2 * scale
    assert np.all(got[:, 150:] == 0.0) and np.all(want[:, 150:] == 0.0)


def test_block_k_contract():
    m = torch.zeros(1, 4, 4)
    b = torch.ones(1, 4)
    with pytest.raises(ValueError, match="multiple of 128"):
        neumann_solve(m, b, hops=3, block_k=100)


def test_matches_lu_on_nilpotent_operators():
    rng = np.random.RandomState(0)
    m = torch.from_numpy(_phi_like(rng, 5, 23))
    b = torch.from_numpy(rng.uniform(0.0, 2.0, (5, 23)).astype(np.float32))
    want = lu_solve_ref(m, b)
    np.testing.assert_allclose(
        neumann_solve(m, b, hops=24).numpy(), want.numpy(), rtol=1e-6, atol=1e-6
    )
    np.testing.assert_allclose(
        want.numpy(), np.asarray(j_lu(jnp.asarray(m.numpy()), jnp.asarray(b.numpy()))),
        rtol=1e-5,
    )


def test_small_magnitude_element_not_truncated():
    """Convergence is judged per batch element: a huge element that settles
    in one hop must not freeze a tiny one that needs every hop."""
    v = 24
    chain = np.zeros((v, v), np.float32)
    for i in range(v - 1):
        chain[i, i + 1] = 1.0
    m = torch.from_numpy(np.stack([np.zeros((v, v), np.float32), chain.T]))
    b = np.zeros((2, v), np.float32)
    b[0, 0] = 1e6
    b[1, 0] = 1e-3
    b = torch.from_numpy(b)
    got = neumann_solve(m, b, hops=v + 1)
    np.testing.assert_allclose(got.numpy(), lu_solve_ref(m, b).numpy(), rtol=1e-5)
    assert float(got[1, v - 1]) == pytest.approx(1e-3, rel=1e-4)


def test_freeze_applies_the_converging_iterate():
    """The hop that meets the tolerance is applied, later hops are not: on a
    geometric chain the result is exactly the partial sum at that hop."""
    m = torch.full((1, 1, 1), 0.5)
    b = torch.ones(1, 1)
    x = neumann_propagate(m, b, hops=100, tol=1e-3)
    # x_h = 2 - 0.5^h; |x_h - x_{h-1}| = 0.5^h <= 1e-3 * x_h first at h = 9.
    assert float(x[0, 0]) == 2.0 - 0.5 ** 9
    x_cap = neumann_propagate(m, b, hops=4, tol=1e-3)
    assert float(x_cap[0, 0]) == 2.0 - 0.5 ** 4
    for hops, got in ((100, x), (4, x_cap)):
        want = neumann_solve_pallas(jnp.asarray(m.numpy()), jnp.asarray(b.numpy()),
                                    hops=hops, tol=1e-3, interpret=True)
        assert float(want[0, 0]) == float(got[0, 0])


def test_contractive_cycles_converge():
    rng = np.random.RandomState(2)
    v = 12
    m = _phi_like(rng, 1, v, density=0.5)
    m[0, v - 1, 0] = 0.4  # a blocking-rule-sized back edge closes a cycle
    mt = torch.from_numpy(m)
    b = torch.from_numpy(rng.uniform(0.0, 2.0, (1, v)).astype(np.float32))
    got = neumann_solve(mt, b, hops=effective_hops(v + 2, v))
    np.testing.assert_allclose(got.numpy(), lu_solve_ref(mt, b).numpy(), rtol=1e-4)


def test_strided_views_take_the_storage_layout():
    """phi[..., k, :, :] views and their transposes solve like contiguous
    copies (the kernel reads phi column-wise instead of copying phi^T)."""
    rng = np.random.RandomState(3)
    phi = torch.from_numpy(_phi_like(rng, 2 * 4 * 3, 9).reshape(2, 4, 3, 9, 9))
    b = torch.from_numpy(rng.uniform(0.0, 1.0, (2, 4, 9)).astype(np.float32))
    view = phi[:, :, 1]
    assert _batch_stride(view, 2) == 3 * 81
    assert _batch_stride(phi.permute(1, 0, 2, 3, 4)[:, :, 1], 2) is None
    for m in (view, view.mT):
        got = neumann_solve(m, b, hops=12)
        want = neumann_solve(m.contiguous(), b, hops=12)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


def test_grad_matches_lu():
    """The autograd backward is the transpose solve (grad_b) and its outer
    product with x (grad_m)."""
    rng = np.random.RandomState(3)
    m = torch.from_numpy(_phi_like(rng, 2, 11, density=0.5))
    b = torch.from_numpy(rng.uniform(0.0, 2.0, (2, 11)).astype(np.float32))
    for op in (lambda t: t, lambda t: t.mT):  # both kernel layouts
        mb = op(m).clone().requires_grad_(True)
        bb = b.clone().requires_grad_(True)
        (neumann_solve(mb, bb, hops=12) ** 2).sum().backward()
        ml = op(m).clone().requires_grad_(True)
        bl = b.clone().requires_grad_(True)
        (lu_solve_ref(ml, bl) ** 2).sum().backward()
        np.testing.assert_allclose(bb.grad.numpy(), bl.grad.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(mb.grad.numpy(), ml.grad.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_cost_to_go_is_gradient(stage):
    """Gallager's identity grad_inj J = q^{a,k} on the port: the gradient
    runs through the Neumann solve's transpose-solve backward."""
    p = stack_single(mesh(device="cpu"))
    s = forwarding_update(p, structured_init(p), t_phi=4)
    q = cost_to_go(p, s)[0]
    a = 3
    inj = torch.zeros(1, p.net.n_nodes, requires_grad=True)
    objective_with_injection(p, s, a, stage, inj).sum().backward()
    np.testing.assert_allclose(inj.grad[0].numpy(), q[0, a, stage].numpy(), rtol=2e-3, atol=1e-4)


@pytest.mark.parametrize("v", [17, 64, 256, 512, 1024, 1280])
@pytest.mark.parametrize("esize", [4, 2], ids=["fp32", "bf16"])
def test_rows_cluster_fits(v, esize):
    """The rows kernel's cluster: at most 8 CTAs, their row blocks cover V,
    and one CTA's shared memory stays within the 227 KB a block can have."""
    c, resident = _rows_cluster(v, esize)
    rows = -(-v // c)
    assert c in (1, 2, 4, 8) and c * rows >= v
    assert _rows_smem(v, esize, c, resident) <= 227 * 1024
    if resident and c > 1:  # the smallest cluster whose rows fit the budget
        assert -(-v // (c // 2)) * v * esize > 64 * 1024
    if (v, esize) == (256, 4):  # the batched engine's cost-to-go solves
        assert (c, resident) == (4, True)
    if v <= 30:  # the paper's topologies: one CTA, as before the cluster split
        assert (c, resident) == (1, True)


def _row_block_split(w, b, hops, tol, c):
    """The cluster kernel's schedule on the CPU: x_new assembled from C row
    blocks, each computed from the full previous iterate; the residual pair
    as the NaN-propagating max of the blocks' maxima; every block takes the
    same break decision."""
    v = w.shape[-1]
    rows = -(-v // c)
    blocks = [slice(r, min(v, r + rows)) for r in range(0, v, rows)]
    x = b
    done = torch.zeros(b.shape[:-1], dtype=torch.bool)
    for _ in range(hops):
        x_new = torch.cat([b[..., blk] + (w[..., blk, :] @ x[..., None])[..., 0] for blk in blocks], -1)
        resid = torch.stack([(x_new[..., blk] - x[..., blk]).abs().amax(-1) for blk in blocks]).amax(0)
        scale = torch.stack([x_new[..., blk].abs().amax(-1) for blk in blocks]).amax(0) + 1e-30
        x = torch.where(done[..., None], x, x_new)
        done = done | (resid <= tol * scale)
        if bool(done.all()):
            break
    return x


@pytest.mark.parametrize("c", [1, 2, 4, 8])
def test_row_block_split_is_bitwise_the_plain_solve(c):
    """Splitting the rows over a cluster changes no bit of the solve: the
    emulation equals `neumann_propagate_ref`, including a NaN element that
    never converges, a zero right-hand side that stops after one hop and a
    hop cap that cuts the rest short. Integer operators keep every sum exact,
    so the comparison sees the split and not the summation order."""
    rng = np.random.RandomState(11 + c)
    v = 37
    m = np.triu((rng.rand(4, v, v) < 0.08) * rng.randint(1, 3, (4, v, v)), 1).astype(np.float32)
    m = torch.from_numpy(m)
    b = torch.from_numpy(rng.randint(0, 4, (4, v)).astype(np.float32))
    b[1] = 0.0
    m[2, 5, 9] = float("nan")
    for hops in (40, 5):
        got = _row_block_split(m, b, hops, 1e-6, c)
        want = neumann_propagate_ref(m, b, hops)
        assert torch.equal(got.isnan(), want.isnan()) and bool(got.isnan().any())
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
        assert torch.nan_to_num(want).abs().max() < 2**24  # exact in fp32


@pytest.mark.parametrize("v", [1, 17, 30, 64, 128, 256, 258, 512, 1024, 1280, 8200, 28928])
def test_cols_cluster_fits(v):
    """The cols kernel's cluster: at most 8 CTAs whose column blocks cover V
    in whole quads, row groups that cover V, every quad with a thread (past
    256 quads a thread takes several), shared memory within 227 KB, and
    `resident` exactly when every row group fits its registers."""
    c, resident = _cols_cluster(v)
    r, q, g, p = _cols_layout(v, c)
    assert c in (1, 2, 4, 8) and c * r >= v and 4 * q >= r and g * p >= v
    assert 1 <= g * min(q, 256) <= 256 and (g == 1 or q <= 256)
    if v % 4 == 0:
        assert r % 4 == 0 and p % 4 == 0
    assert _cols_smem(v, c) <= 227 * 1024
    assert resident == (p <= 16)
    if resident and c > 1:  # the smallest cluster whose blocks fit the registers
        assert _cols_layout(v, c // 2)[3] > 16
    if v == 256:  # the batched engine's traffic solves
        assert (c, resident) == (4, True)
    if v <= 30:  # the paper's topologies: one CTA
        assert (c, resident) == (1, True)
    if v >= 1024:  # phase 4 and the tiled kernel's sizes: rows past 16 from L2
        assert (c, resident) == (8, False)
    if v == 28928:  # the largest V whose two iterates fit a CTA's shared memory
        assert _cols_smem(v + 1, 8) > 227 * 1024


def _col_block_split(w, b, hops, tol, c):
    """The cols kernel's schedule on the CPU: CTA k owns a column block of
    x_new; within it, row group g's thread sums rows [g P, (g + 1) P) of its
    column quad, group 0 adds the other groups' partial sums in order, and
    the residual pair is the NaN-propagating max of the blocks' maxima, so
    every block takes the same break decision."""
    v = w.shape[-1]
    r, _, _, p = _cols_layout(v, c)
    blocks = [slice(c0, min(v, c0 + r)) for c0 in range(0, v, r)]

    def block(x, blk):
        parts = [(w[..., j:j + p, blk] * x[..., j:j + p, None]).sum(-2) for j in range(0, v, p)]
        return b[..., blk] + torch.stack(parts).sum(0)

    x = b
    done = torch.zeros(b.shape[:-1], dtype=torch.bool)
    for _ in range(hops):
        x_new = torch.cat([block(x, blk) for blk in blocks], -1)
        resid = torch.stack([(x_new[..., blk] - x[..., blk]).abs().amax(-1) for blk in blocks]).amax(0)
        scale = torch.stack([x_new[..., blk].abs().amax(-1) for blk in blocks]).amax(0) + 1e-30
        x = torch.where(done[..., None], x, x_new)
        done = done | (resid <= tol * scale)
        if bool(done.all()):
            break
    return x


@pytest.mark.parametrize("c", [1, 2, 4, 8])
@pytest.mark.parametrize("v", [37, 64])
def test_col_block_split_is_bitwise_the_plain_solve(c, v):
    """Splitting the columns over a cluster and the rows over row groups
    changes no bit of the traffic solve (M = W^T): the emulation equals
    `neumann_propagate_ref` with transpose, including a NaN element that
    never converges, a zero right-hand side that stops after one hop and a
    hop cap that cuts the rest short. Integer operators keep every sum
    exact. V = 37 takes ragged quads, V = 64 whole ones."""
    rng = np.random.RandomState(23 + c + v)
    m = np.triu((rng.rand(4, v, v) < 0.08) * rng.randint(1, 3, (4, v, v)), 1).astype(np.float32)
    m = torch.from_numpy(m)
    b = torch.from_numpy(rng.randint(0, 4, (4, v)).astype(np.float32))
    b[1] = 0.0
    m[2, 9, 5] = float("nan")
    for hops in (40, 5):
        got = _col_block_split(m, b, hops, 1e-6, c)
        want = neumann_propagate_ref(m, b, hops, transpose=True)
        assert torch.equal(got.isnan(), want.isnan()) and bool(got.isnan().any())
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
        assert torch.nan_to_num(want).abs().max() < 2**24  # exact in fp32
