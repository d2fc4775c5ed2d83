"""Port parity: min-plus products, APSP and next-hop tables
(repro_torch.kernels.minplus) against the JAX package, bitwise, on the CPU,
where the wrappers run the CUDA kernel's plain versions."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.minplus import apsp as j_apsp
from repro.kernels.minplus import apsp_with_nexthop as j_apsp_nh
from repro.kernels.minplus.kernel import minplus_matmul_argmin_pallas
from repro.kernels.minplus.ref import minplus_matmul_ref as j_ref
from repro_torch.kernels.minplus import (
    apsp,
    apsp_with_nexthop,
    minplus_closure,
    minplus_matmul,
    minplus_matmul_argmin,
    minplus_matmul_argmin_blocked,
    minplus_matmul_argmin_ref,
    minplus_matmul_blocked,
    minplus_matmul_ref,
    squaring_bound,
)

jax.config.update("jax_enable_x64", False)


def _weights(n, n_edges, seed, integer=False):
    rng = np.random.RandomState(seed)
    w = np.full((n, n), 1e18, np.float32)
    for _ in range(n_edges):
        u, v = rng.randint(0, n, 2)
        if u != v:
            w[u, v] = float(rng.randint(1, 5)) if integer else rng.uniform(0.1, 4.0)
    return w


def _eq(got: torch.Tensor, want) -> bool:
    return np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize(
    "m,k,n,seed", [(24, 24, 24, 0), (17, 40, 9, 1), (72, 72, 72, 2), (130, 200, 129, 3)]
)
def test_product_bitwise_vs_jax_ref(m, k, n, seed):
    rng = np.random.RandomState(seed)
    a = rng.uniform(0, 10, (m, k)).astype(np.float32)
    b = rng.uniform(0, 10, (k, n)).astype(np.float32)
    a[rng.rand(m, k) < 0.3] = 1e18
    b[rng.rand(k, n) < 0.3] = 1e18
    a[3, :] = 1e18  # an all-BIG row
    b[:, 2] = 1e18  # an all-BIG column
    want = j_ref(jnp.asarray(a), jnp.asarray(b))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert _eq(minplus_matmul(ta, tb), want)
    assert _eq(minplus_matmul_ref(ta, tb), want)
    for bk in (1, 8, 13, k):  # chunked streaming, ragged last chunk
        assert _eq(minplus_matmul_blocked(ta, tb, block_k=bk), want)


def test_argmin_bitwise_vs_pallas_kernel():
    n = 72
    w = _weights(n, 400, seed=9)
    dist = np.array(j_apsp(jnp.asarray(w)))
    val, idx = minplus_matmul_argmin_pallas(jnp.asarray(w), jnp.asarray(dist), interpret=True)
    got_v, got_i = minplus_matmul_argmin(torch.from_numpy(w), torch.from_numpy(dist))
    assert _eq(got_v, val) and _eq(got_i, idx)
    assert got_i.dtype == torch.int64


def test_argmin_integer_ties_first_minimum():
    """Integer weights force exact ties; the first minimising k wins in the
    one-broadcast oracle, the chunked carry and the Pallas kernel alike."""
    n = 40
    w = _weights(n, 300, seed=11, integer=True)
    dist = np.array(j_apsp(jnp.asarray(w)))
    cand = w[:, :, None] + dist[None, :, :]
    want = cand.argmin(axis=1)
    _, pl = minplus_matmul_argmin_pallas(jnp.asarray(w), jnp.asarray(dist), interpret=True)
    assert np.array_equal(np.asarray(pl), want)
    tw, td = torch.from_numpy(w), torch.from_numpy(dist)
    assert np.array_equal(minplus_matmul_argmin(tw, td)[1].numpy(), want)
    assert np.array_equal(minplus_matmul_argmin_ref(tw, td)[1].numpy(), want)
    for bk in (1, 7, 16):
        v, i = minplus_matmul_argmin_blocked(tw, td, block_k=bk)
        assert np.array_equal(i.numpy(), want)
        assert np.array_equal(v.numpy(), cand.min(axis=1))


def test_apsp_squaring_bitwise_vs_jax_on_real_weights():
    """Same squaring algorithm as JAX's `apsp(w, n_iter=squaring_bound(V))`,
    so real-valued path sums associate identically."""
    n = 48
    w = _weights(n, 250, seed=4)
    want = j_apsp(jnp.asarray(w), n_iter=squaring_bound(n))
    assert _eq(apsp(torch.from_numpy(w)), want)
    assert _eq(apsp(torch.from_numpy(w), n_iter=squaring_bound(n), early_exit=False), want)


def test_apsp_with_nexthop_vs_both_jax_paths():
    """Integer weights keep Floyd-Warshall (JAX default) and squaring exact,
    so distances and first-minimum next hops agree bitwise with both."""
    n = 60
    w = _weights(n, 500, seed=13, integer=True)
    d, nh = apsp_with_nexthop(torch.from_numpy(w))
    for kw in ({}, {"use_pallas": True, "interpret": True}):
        jd, jnh = j_apsp_nh(jnp.asarray(w), **kw)
        assert _eq(d, jd) and _eq(nh, jnh), kw


def test_batched_equals_single_calls():
    ws = np.stack([_weights(30, 120, seed=s) for s in range(3)])
    tw = torch.from_numpy(ws)
    d, nh = apsp_with_nexthop(tw)
    prod = minplus_matmul(tw, tw)
    for i in range(3):
        di, nhi = apsp_with_nexthop(tw[i])
        assert torch.equal(d[i], di) and torch.equal(nh[i], nhi)
        assert torch.equal(prod[i], minplus_matmul(tw[i], tw[i]))


def test_closure_early_exit_is_bitwise_noop():
    """Stopping one sweep after the fixpoint equals the worst-case sweep
    count (integer weights: every path sum is exact)."""
    n = 33
    w = torch.from_numpy(_weights(n, 90, seed=5, integer=True))
    d = torch.where(torch.eye(n, dtype=torch.bool), 0.0, w)
    assert torch.equal(
        minplus_closure(d), minplus_closure(d, n_iter=math.ceil(math.log2(n)), early_exit=False)
    )
