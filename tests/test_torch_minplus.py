"""Port parity: min-plus products, APSP and next-hop tables
(repro_torch.kernels.minplus) against the JAX package, bitwise, on the CPU,
where the wrappers run the CUDA kernel's plain versions."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_bridge  # noqa: F401  (pins torch to one CPU thread)
from repro.kernels.minplus import apsp as j_apsp
from repro.kernels.minplus import apsp_with_nexthop as j_apsp_nh
from repro.kernels.minplus.kernel import minplus_matmul_argmin_pallas
from repro.kernels.minplus.ref import minplus_matmul_ref as j_ref
from repro_torch.kernels.minplus import ops as mp_ops
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


def _argmin_kernel_order(a, b, splits, kc=4, kt=16):
    """The argmin kernel's order of work (csrc/minplus.cu) in plain torch:
    K in `splits` ranges of whole `kt`-deep stages; per `kc`-deep chunk the
    minimum alone, then one strict update of the running minimum that keeps
    the chunk's number; after the last chunk, the first k of the kept chunk
    whose recomputed sum equals the minimum; then the ranges merged in
    ascending order with strict `<`."""
    m, k = a.shape[-2:]
    n = b.shape[-1]
    per = -(-(-(-k // kt)) // splits) * kt
    assert (splits - 1) * per < k <= splits * per
    inf = torch.tensor(float("inf"))
    parts = []
    for kb in range(0, k, per):
        ke = min(k, kb + per)
        acc = torch.full(a.shape[:-2] + (m, n), float("inf"))
        cid = torch.zeros(acc.shape, dtype=torch.int64)
        for c, k0 in enumerate(range(kb, ke, kc)):
            pad = max(0, k0 + kc - ke)
            ap = torch.cat([a[..., k0:ke][..., :kc], torch.full(a.shape[:-1] + (pad,), inf)], -1)
            bp = torch.cat([b[..., k0:ke, :][..., :kc, :], torch.full(b.shape[:-2] + (pad, n), inf)], -2)
            cmin = (ap[..., :, :, None] + bp[..., None, :, :]).amin(-2)
            upd = cmin < acc
            acc, cid = torch.where(upd, cmin, acc), torch.where(upd, c, cid)
        k0 = kb + kc * cid
        ks = k0[..., None] + torch.arange(kc)  # [..., m, n, kc]
        kcl = ks.clamp(max=k - 1)
        av = a[..., :, None, :].expand(ks.shape[:-1] + (k,)).gather(-1, kcl)
        bv = b.mT[..., None, :, :].expand(ks.shape[:-1] + (k,)).gather(-1, kcl)
        eq = torch.where(ks < ke, av + bv, inf) == acc[..., None]
        parts.append((acc, k0 + eq.int().argmax(-1)))
    val, idx = parts[0]
    for v, i in parts[1:]:
        upd = v < val
        val, idx = torch.where(upd, v, val), torch.where(upd, i, idx)
    return val, idx


def _tie_operands(m, k, n, seed, with_inf):
    """Integer operands full of exact ties whose minimum first appears past
    chunk 0 (chunk 0's A is raised by 10) and recurs in later chunks and
    splits, with all-BIG rows and columns, and all-+INF ones `with_inf`."""
    rng = np.random.RandomState(seed)
    a = rng.randint(1, 5, (m, k)).astype(np.float32)
    b = rng.randint(1, 5, (k, n)).astype(np.float32)
    a[rng.rand(m, k) < 0.4] = 1e18
    b[rng.rand(k, n) < 0.4] = 1e18
    a[:, :16] += 10
    a[1, :], b[:, 1] = 1e18, 1e18
    if with_inf:
        a[3, :], b[:, 3] = np.inf, np.inf
    return a, b


@pytest.mark.parametrize("m,k,n,seed", [(20, 77, 19, 0), (33, 100, 17, 1), (9, 1, 7, 2), (12, 16, 12, 3)])
@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("kc", [4, 16])
def test_argmin_kernel_order_bitwise_vs_pallas_and_ref(m, k, n, seed, splits, kc):
    """Chunk minima, the strict chunk update, the deferred search and the
    split combine give the first minimum bitwise, value and index, on
    integer ties with ragged K (K = 77 and 100: a ragged last stage and
    chunk; K = 1; K = 16: one stage), at the kernel's 4-deep chunks and at
    stage-deep ones. The Pallas kernel pads K with BIG, which beats an
    all-+INF row, so it is held to the order on the operands without +INF;
    the oracle on both."""
    splits = min(splits, -(-k // 16))
    for with_inf in (False, True):
        a, b = _tie_operands(m, k, n, seed, with_inf)
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        val, idx = _argmin_kernel_order(ta, tb, splits, kc)
        want_v, want_i = minplus_matmul_argmin_ref(ta, tb)
        assert torch.equal(val, want_v) and torch.equal(idx, want_i)
        if with_inf:
            assert bool((val[3] == np.inf).all()) and bool((idx[3] == 0).all())
        else:
            pv, pi = minplus_matmul_argmin_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True)
            assert _eq(val, pv) and _eq(idx, pi)
        if k > 16:  # the minimum first appears past chunk 0
            assert bool((want_i[want_v < 1e18] >= 16).all())


def test_argmin_kernel_order_batched_nexthop():
    """A batch of next-hop products (w (x) dist) through the same order."""
    ws = np.stack([_weights(40, 300, seed=s, integer=True) for s in range(2)])
    tw = torch.from_numpy(ws)
    dist = apsp(tw)
    want = minplus_matmul_argmin_ref(tw, dist)
    for splits in (1, 3):
        got = _argmin_kernel_order(tw, dist, splits)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("shape,want", [
    ((64, 256, 256, 256), (1, 256, False)),  # phase 3: 512 tiles fill the card
    ((1, 1024, 1024, 1024), (2, 512, False)),  # phase 4: 128 tiles, K split in two
    ((1, 256, 256, 256), (4, 64, False)),  # phase 3's lane-0 solve
    ((1, 17, 17, 17), (1, 32, False)),  # the paper's iot: two chunks, no split
    ((1, 200, 200, 200), (3, 80, False)),
    ((3, 130, 129, 200), (3, 80, False)),
    ((1, 64, 64, 1), (1, 16, False)),
    ((1, 64, 64, 4200), (8, 528, False)),
    ((64, 256, 256, 1024), (1, 1024, False)),  # 256 chunks: the last that a byte numbers
    ((64, 256, 256, 5000), (1, 5008, True)),  # 1252 chunks in one range: word ids
])
def test_argmin_split_chooser(shape, want):
    assert mp_ops._argmin_split(*shape) == want


def test_argmin_split_ranges_cover_k():
    """Every choice covers K with non-empty ranges of whole stages, and
    takes word ids exactly where a range has more than 256 4-deep chunks."""
    for batch, m, n in ((1, 1, 1), (1, 64, 64), (2, 300, 70), (64, 256, 256)):
        for k in (1, 15, 16, 17, 144, 1000, 4096, 4097, 4113, 40000):
            s, per, wide = mp_ops._argmin_split(batch, m, n, k)
            assert 1 <= s <= 8 and per % 16 == 0
            assert (s - 1) * per < k <= s * per, (batch, m, n, k)
            assert wide == (per // 4 > 256)
