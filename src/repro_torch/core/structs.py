"""Core data structures for the joint placement/routing problem (paper Eq. 1-7).

Frozen dataclasses of tensors, mirroring `repro.core.structs`. Shapes use
the conventions

    V  = number of nodes
    A  = number of applications (DNN inference services)
    P  = structural partition-axis length (per-app depth lives in Apps.parts)
    K  = P + 1 traffic stages

A problem built by a scenario constructor is unbatched. The solver core
(flow, marginals, forwarding, placement, engine) works on STACKED problems
with a leading instance axis B written out (`engine.stack_single`,
`fleet.pad.stack_problems`): JAX's `vmap` over instances becomes that
explicit axis. After stacking, the `CostModel` scalars are `[B]` tensors;
`bview` views them against `[B, ...]` arrays.

Index tensors (src, dst, parts, hosts) are int64, PyTorch's index type;
`to_numpy` hands them out as int32 like the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device

# A large-but-finite stand-in for +inf: safe under addition in the tropical
# (min,+) semiring without producing inf-inf NaNs inside kernels.
BIG = 1e18
# Threshold above which a distance is considered unreachable.
BIG_THRESHOLD = 1e17


def bview(c, ndim: int):
    """A CostModel scalar (float, or `[B]` tensor after stacking) viewed to
    broadcast against a `[B, ...]` array of `ndim` dims."""
    if isinstance(c, torch.Tensor):
        return c.reshape(c.shape + (1,) * (ndim - c.ndim))
    return c


@dataclasses.dataclass(frozen=True)
class Network:
    """adj [V, V] {0,1}; mu [V, V] link rate (BIG off-edge); nu [V] compute rate."""

    adj: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor

    @property
    def n_nodes(self) -> int:
        return self.adj.shape[-1]


@dataclasses.dataclass(frozen=True)
class Apps:
    """src/dst [A] int64, lam [A], L [A, K], w [A, P], parts [A] int64
    (defaults to the structural P)."""

    src: torch.Tensor
    dst: torch.Tensor
    lam: torch.Tensor
    L: torch.Tensor
    w: torch.Tensor
    parts: torch.Tensor | None = None

    def __post_init__(self):
        if self.parts is None:
            w = self.w
            object.__setattr__(
                self,
                "parts",
                torch.full(w.shape[:-1], w.shape[-1], dtype=torch.int64, device=w.device),
            )

    @property
    def n_apps(self) -> int:
        return self.src.shape[-1]

    @property
    def n_parts(self) -> int:
        return self.w.shape[-1]


@dataclasses.dataclass(frozen=True)
class CostModel:
    """kind "mm1" or "linear"; rho_max / w_comm / w_comp are floats, or `[B]`
    tensors once stacked (they may differ per instance; `kind` may not)."""

    kind: str = "mm1"
    rho_max: float | torch.Tensor = 0.95
    w_comm: float | torch.Tensor = 1.0
    w_comp: float | torch.Tensor = 1.0


_ARRAY_FIELDS = {
    "net.adj": torch.float32,
    "net.mu": torch.float32,
    "net.nu": torch.float32,
    "apps.src": torch.int64,
    "apps.dst": torch.int64,
    "apps.lam": torch.float32,
    "apps.L": torch.float32,
    "apps.w": torch.float32,
    "apps.parts": torch.int64,
}
_COST_FIELDS = ("cost.rho_max", "cost.w_comm", "cost.w_comp")


def _np_out(t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.astype(np.int32) if t.dtype == torch.int64 else a


@dataclasses.dataclass(frozen=True)
class Problem:
    """One placement/routing instance (or a stacked batch of them).

    hop_bound : unweighted diameter + 2 host re-injections; sizes the Neumann
        hop cap (`kernels.neumann.effective_hops`). Python metadata, unified
        to the batch max when instances are stacked."""

    net: Network
    apps: Apps
    cost: CostModel
    hop_bound: int | None = None

    @property
    def device(self) -> torch.device:
        return self.net.adj.device

    @classmethod
    def from_numpy(
        cls, arrays: dict, *, hop_bound: int | None, kind: str = "mm1",
        device: str | torch.device = "cuda",
    ) -> "Problem":
        """Build from a dict keyed by the JAX dataclass field paths
        (`net.adj`, `apps.L`, `cost.rho_max`, ...). 0-d cost entries become
        floats, batched ones `[B]` float32 tensors."""
        dev = resolve_device(device)
        t = {
            k: torch.tensor(np.asarray(arrays[k]), dtype=dt, device=dev)
            for k, dt in _ARRAY_FIELDS.items()
        }
        cost = {}
        for k in _COST_FIELDS:
            v = np.asarray(arrays[k])
            cost[k.split(".")[1]] = (
                float(v) if v.ndim == 0
                else torch.tensor(v, dtype=torch.float32, device=dev)
            )
        return cls(
            net=Network(adj=t["net.adj"], mu=t["net.mu"], nu=t["net.nu"]),
            apps=Apps(
                src=t["apps.src"], dst=t["apps.dst"], lam=t["apps.lam"],
                L=t["apps.L"], w=t["apps.w"], parts=t["apps.parts"],
            ),
            cost=CostModel(kind=kind, **cost),
            hop_bound=hop_bound,
        )

    def to_numpy(self) -> dict:
        """Inverse of `from_numpy` (arrays only; hop_bound and kind are
        attributes)."""
        out = {}
        for k in _ARRAY_FIELDS:
            grp, name = k.split(".")
            out[k] = _np_out(getattr(getattr(self, grp), name))
        for k in _COST_FIELDS:
            v = getattr(self.cost, k.split(".")[1])
            out[k] = _np_out(v) if isinstance(v, torch.Tensor) else np.asarray(v)
        return out


def _unweighted_seed(adj: torch.Tensor) -> torch.Tensor:
    """[..., V, V] reflexive 1/BIG hop weights for the unweighted closure."""
    v = adj.shape[-1]
    w = torch.where(adj > 0, 1.0, BIG).to(torch.float32)
    eye = torch.eye(v, dtype=torch.bool, device=adj.device)
    return torch.where(eye, 0.0, w)


def infer_hop_bound(net: Network) -> int:
    """Unweighted graph diameter plus 2 (one host re-injection per stage
    hand-off), from the min-plus squaring closure of the 1/BIG hop seed.
    Hop counts are integers, so the closure is exact in fp32. Unbatched
    networks only: call at problem build time."""
    from ..kernels.minplus import apsp

    dist = apsp(_unweighted_seed(net.adj)[None])[0]
    diam = float(torch.where(dist < BIG_THRESHOLD, dist, 0.0).max())
    return int(diam) + 2


def with_hop_bound(problem: Problem) -> Problem:
    """Attach the inferred hop bound (no-op if already carried)."""
    if problem.hop_bound is not None:
        return problem
    return dataclasses.replace(problem, hop_bound=infer_hop_bound(problem.net))


def one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot over the last axis. An index outside [0, n) gives an
    all-zero row, as `jax.nn.one_hot` does (F.one_hot would raise)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class State:
    """Decision variables of problem (7): x [..., A, P, V] one-hot placement,
    phi [..., A, K, V, V] forwarding fractions."""

    x: torch.Tensor
    phi: torch.Tensor

    def hosts(self) -> torch.Tensor:
        """[..., A, P] int64 host node of each partition."""
        return torch.argmax(self.x, dim=-1)

    @classmethod
    def from_numpy(cls, arrays: dict, *, device: str | torch.device = "cuda") -> "State":
        dev = resolve_device(device)
        return cls(
            x=torch.tensor(np.asarray(arrays["x"]), dtype=torch.float32, device=dev),
            phi=torch.tensor(np.asarray(arrays["phi"]), dtype=torch.float32, device=dev),
        )

    def to_numpy(self) -> dict:
        return {"x": _np_out(self.x), "phi": _np_out(self.phi)}


def app_live_mask(apps: Apps) -> torch.Tensor:
    """[..., A] 1.0 for apps with positive arrival rate, else 0.0 (zero-rate
    apps carry zero forwarding mass, which keeps padding inert)."""
    return (apps.lam > 0).to(torch.float32)


def partition_live_mask(apps: Apps) -> torch.Tensor:
    """[..., A, P] 1.0 where partition p < parts, 0.0 on phantom partitions."""
    p = torch.arange(apps.w.shape[-1], device=apps.w.device)
    return (p < apps.parts[..., None]).to(torch.float32)


def stage_live_mask(apps: Apps) -> torch.Tensor:
    """[..., A, K] 1.0 where stage k <= parts, 0.0 on phantom stages."""
    k = torch.arange(apps.L.shape[-1], device=apps.L.device)
    return (k <= apps.parts[..., None]).to(torch.float32)


def stage_targets(apps: Apps, hosts: torch.Tensor) -> torch.Tensor:
    """[..., A, K] int64 absorption target of each stage: the partition-(k+1)
    host for k < parts, the destination for every later stage."""
    k = torch.arange(apps.L.shape[-1], device=hosts.device)
    hosts_pad = torch.cat([hosts, hosts[..., -1:]], dim=-1)  # [..., A, K]
    return torch.where(k < apps.parts[..., None], hosts_pad, apps.dst[..., None])


def forwarding_mass(state: State, apps: Apps, n: int) -> torch.Tensor:
    """[..., A, K, V] total forwarding fraction each node must emit per stage.

    Eq. (2a): 1 - x^{a,k+1}_i for k < parts (the partition host absorbs);
    Eq. (2b): 0 at d_a else 1 on the final stage k = parts; phantom stages
    and zero-rate apps carry zero mass."""
    dst_oh = one_hot(apps.dst, n)  # [..., A, V]
    k = torch.arange(state.phi.shape[-3], device=state.phi.device)[:, None]  # [K, 1]
    parts = apps.parts[..., None, None]  # [..., A, 1, 1]
    x_pad = torch.cat([state.x, torch.zeros_like(state.x[..., :1, :])], dim=-2)
    m = torch.where(
        k < parts,
        1.0 - x_pad,
        torch.where(k == parts, 1.0 - dst_oh[..., None, :], 0.0),
    )
    return m * app_live_mask(apps)[..., None, None]
