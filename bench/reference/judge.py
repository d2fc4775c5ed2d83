"""The plain reference that decides `correct`: it judges one network's
answer (placement x, forwarding fractions phi, the J reported for them)
from the benchmark's own inputs.

The model is the paper's (arXiv 2604.25571, Eqs. 1-7): per application a
and stage k the node traffic solves t_k = (I - Phi_k^T)^-1 b_k, with
b_0 = lam_a e_src, b_k = x_k-1 * t_k-1 (the host of partition k converts
stage k-1 traffic); link loads F = sum_a,k L_k t_k,i phi_k,ij, node loads
G = sum_a,p w_p x_p,i t_p,i, and J = sum over edges of D(F) + sum over
nodes of C(G), with D, C the M/M/1 queue length load / (cap - load)
continued past 0.95 cap by the quadratic that matches value, slope and
curvature there.

Plain PyTorch, dense LU solves in float64, nothing of the program: the
reference works the traffic, the loads and J out again from the inputs and
the answer, and reads the answer only to judge it. The numbers it gives a
network:

  j_gap      |J reported - J| / J
  mass_err   the largest departure of a row of phi from the mass its node
             must forward (1, or 0 where the stage is absorbed)
  leak       the largest phi entry of a row that must be 0: negative, or
             along anything but an edge of this epoch's live graph (to a
             dead or padded node among them)

Both read only the rows of the nodes that carry the stage's traffic: the
routing the traffic takes. Rows of nodes it never reaches do not change J
and are not read (dead and padded nodes, and live nodes off every path).
  bad_hosts  partitions whose x is not one-hot, whose host is not the one
             reported, or is not a live real node

and, over a whole batch of networks,

  unimproved the share of networks whose J is not at least 0.1% below the
             J of the reference's own congestion-unaware plan for the same
             network (`baseline`): the shortest extended path under
             zero-load marginal costs, routed along shortest-path trees,
             the paper's CongUnaware method and the alternating method's
             starting point
"""
from __future__ import annotations

import numpy as np
import torch

RHO_MAX = 0.95


def _mm1(load, cap):
    knee = RHO_MAX * cap
    gap = cap - knee
    v = knee / gap
    s = cap / (gap * gap)
    c = 2.0 * cap / (gap * gap * gap)
    d = load - knee
    safe = torch.minimum(load, knee)
    return torch.where(load <= knee, safe / (cap - safe), v + s * d + 0.5 * c * d * d)


def apply_health(net: dict, health) -> dict:
    """One network's arrays under a fault state (None: pristine): dead nodes
    lose every edge, a degraded edge's rate is scaled in both directions,
    a flash crowd scales every arrival rate. Adds `live` [n] bool."""
    n = net["adj"].shape[0]
    out = dict(net, live=np.ones(n, bool))
    if health is None:
        return out
    adj, mu = net["adj"].copy(), net["mu"].copy()
    for (u, v), scale in health.links:
        for a, b in ((u, v), (v, u)):
            if adj[a, b] > 0:
                mu[a, b] = mu[a, b] * scale
    live = np.ones(n, bool)
    for d in sorted(health.down):
        live[d] = False
        adj[d, :] = 0.0
        adj[:, d] = 0.0
    out.update(adj=adj, mu=mu, live=live)
    if health.rate != 1.0:
        out["lam"] = net["lam"] * np.float32(health.rate)
    return out


def _traffic(phi, gates, src_inj, dtype, hops: int):
    """[A, K, n] stage traffic: LU in float64, else the propagation
    t <- b + Phi^T t in `dtype` (`hops` steps; exact for loop-free phi)."""
    ts = []
    t_prev = torch.zeros_like(src_inj[:, 0])
    n = phi.shape[-1]
    eye = torch.eye(n, dtype=phi.dtype, device=phi.device)
    for k in range(phi.shape[1]):
        b = src_inj[:, k] + gates[:, k] * t_prev
        if dtype == torch.float64:
            t_prev = torch.linalg.solve(eye - phi[:, k].mT, b[..., None])[..., 0]
        else:
            m = phi[:, k].mT
            t = b
            for _ in range(hops):
                t = b + (m @ t[..., None])[..., 0]
            t_prev = t
        ts.append(t_prev)
    return torch.stack(ts, dim=1)


def objective(net: dict, x, phi, *, dtype=torch.float64, hops: int | None = None):
    """J and the stage traffic of one network's (x [A, P, n], phi
    [A, K, n, n]) over its real block, computed in `dtype`."""
    dev = phi.device
    f = {k: torch.as_tensor(np.asarray(net[k]), device=dev) for k in ("adj", "mu", "nu", "lam", "L", "w")}
    adj, mu, nu = (f[k].to(dtype) for k in ("adj", "mu", "nu"))
    lam, L, w = (f[k].to(dtype) for k in ("lam", "L", "w"))
    A, K, n = phi.shape[0], phi.shape[1], phi.shape[-1]
    src = torch.as_tensor(net["src"], device=dev)
    src_inj = torch.zeros((A, K, n), dtype=dtype, device=dev)
    src_inj[torch.arange(A, device=dev), 0, src] = lam
    gates = torch.cat([torch.zeros_like(x[:, :1]), x], dim=1)
    t = _traffic(phi, gates, src_inj, dtype, hops or n)
    F = torch.einsum("ak,akij->ij", L, t[..., :, None] * phi)
    G = torch.einsum("ap,api->i", w, x * t[:, : x.shape[1]])
    on = adj > 0
    big = torch.ones_like(mu)
    D = torch.where(on, _mm1(F, torch.where(on, mu, big)), torch.zeros_like(F))
    live = torch.as_tensor(net["live"], device=dev)
    C = torch.where(live, _mm1(G, torch.where(live, nu, torch.ones_like(nu))), torch.zeros_like(G))
    return D.sum() + C.sum(), t


def stage_mass(net: dict, x):
    """[A, K, n] forwarding mass each node must emit: 1 - x_k for k < P,
    1 - [i == dst] on the final stage."""
    A, P, n = x.shape
    dst = torch.as_tensor(net["dst"], device=x.device)
    dst_oh = torch.zeros((A, n), dtype=x.dtype, device=x.device)
    dst_oh[torch.arange(A, device=x.device), dst] = 1.0
    return torch.cat([1.0 - x, (1.0 - dst_oh)[:, None]], dim=1)


def judge_network(net: dict, x_env, phi_env, J_reported: float, hosts_reported) -> dict:
    """The numbers of one network (module doc). `x_env` [A_env, P_env,
    V_env] and `phi_env` [A_env, K_env, V_env, V_env] are the program's
    answer over the padded envelope, on the device the check runs on;
    `net` is the network under this epoch's health (`apply_health`)."""
    n, A = net["adj"].shape[0], net["src"].shape[0]
    P = int(net["parts"][0])
    K = P + 1
    live = torch.as_tensor(net["live"], device=phi_env.device)
    adj = torch.as_tensor(net["adj"], device=phi_env.device) > 0

    phi32 = phi_env[:A, :K, :n, :n]
    x = x_env[:A, :P, :n].to(torch.float64)
    hosts = x_env[:A, :P].argmax(dim=-1)
    one_hot = ((x == 0) | (x == 1)).all(dim=-1) & (x.sum(dim=-1) == 1)
    one_hot &= x_env[:A, :P, n:].eq(0).all(dim=-1)
    rep = torch.as_tensor(np.asarray(hosts_reported)[:A, :P], device=hosts.device)
    ok = one_hot & (hosts == rep) & (hosts < n) & live[hosts.clamp_max(n - 1)]
    bad_hosts = int((~ok).sum())

    phi = torch.where(live[:, None], phi32.to(torch.float64), 0.0)  # dead rows are not read
    J, t = objective(net, x, phi)
    J = float(J)
    mass = stage_mass(net, x)
    carrying = (t > 1e-9 * float(np.max(net["lam"]))) & live
    mass_err = float(torch.where(carrying, (phi.sum(dim=-1) - mass).abs(), 0.0).max())
    off_edge = torch.where(adj, 0.0, phi32.abs()).amax(dim=-1)
    if n < phi_env.shape[-1]:
        off_edge = torch.maximum(off_edge, phi_env[:A, :K, :n, n:].abs().amax(dim=-1))
    off_edge = torch.maximum(off_edge, (-phi32).clamp_min(0).amax(dim=-1))
    leak = float(torch.where(carrying, off_edge, 0.0).max())
    return {
        "J": J,
        "j_gap": abs(float(J_reported) - J) / J,
        "mass_err": mass_err,
        "leak": leak,
        "bad_hosts": bad_hosts,
    }


def baseline(net: dict, device) -> float:
    """J of the congestion-unaware plan (module doc) for one network under
    its health: hosts by a dynamic program over the stage chain on
    zero-load shortest-path distances (links 1/mu, compute w_p/nu, only
    live nodes host), every stage routed along the shortest-path tree to
    its target."""
    dt = torch.float64
    n, A = net["adj"].shape[0], net["src"].shape[0]
    P = int(net["parts"][0])
    adj = torch.as_tensor(net["adj"], device=device) > 0
    live = torch.as_tensor(net["live"], device=device)
    mu = torch.as_tensor(net["mu"], device=device).to(dt)
    nu = torch.as_tensor(net["nu"], device=device).to(dt)
    L = torch.as_tensor(net["L"], device=device).to(dt)
    w = torch.as_tensor(net["w"], device=device).to(dt)
    src = torch.as_tensor(net["src"], device=device)
    dst = torch.as_tensor(net["dst"], device=device)
    edge = torch.where(adj, 1.0 / mu, torch.inf)
    d = torch.where(torch.eye(n, dtype=torch.bool, device=device), 0.0, edge)
    for k in range(n):
        d = torch.minimum(d, d[:, k, None] + d[None, k, :])
    comp = torch.where(live, 1.0 / nu, torch.inf)
    apps = torch.arange(A, device=device)
    M = L[:, 0, None] * d[src] + w[:, 0, None] * comp  # [A, n]
    back = []
    for p in range(1, P):
        cand = M[:, :, None] + L[:, p, None, None] * d[None]  # [A, from, to]
        back.append(cand.argmin(dim=1))
        M = cand.amin(dim=1) + w[:, p, None] * comp
    hosts = [(M + L[:, P, None] * d[:, dst].T).argmin(dim=1)]
    for p in range(P - 1, 0, -1):
        hosts.insert(0, back[p - 1][apps, hosts[0]])
    hosts = torch.stack(hosts, dim=1)  # [A, P]
    x = torch.zeros((A, P, n), dtype=dt, device=device)
    x[apps[:, None], torch.arange(P, device=device)[None], hosts] = 1.0
    targets = torch.cat([hosts, dst[:, None]], dim=1)  # [A, K]
    # Next hop of node i towards target t: argmin over i's edges of w_ij + d_jt.
    nexthop = (edge[:, :, None] + d[None, :, :]).argmin(dim=1)  # [i, t]
    phi = torch.zeros((A, P + 1, n, n), dtype=dt, device=device)
    nodes = torch.arange(n, device=device)
    for k in range(P + 1):
        tgt = targets[:, k]
        hop = nexthop[:, tgt].T  # [A, n]
        mass = (nodes[None] != tgt[:, None]) & live[None]
        phi[apps[:, None], k, nodes[None], hop] = mass.to(dt)
    return float(objective(net, x, phi)[0])


def judge_fleet(nets: list, x, phi, J, hosts, base: list | None = None) -> tuple[list, float]:
    """`judge_network` for every lane of a stacked answer (`nets[b]` is the
    network, under its health, that lane b solved), and the batch's
    `unimproved` share. `base` holds each network's `baseline` where it is
    known already."""
    rows = [judge_network(net, x[b], phi[b], float(J[b]), hosts[b]) for b, net in enumerate(nets)]
    if base is None:
        base = [baseline(net, phi.device) for net in nets]
    worse = sum(row["J"] > (1.0 - 1e-3) * b for row, b in zip(rows, base))
    return rows, worse / len(rows)


def control_answer(net: dict, x_env, phi_env, *, dtype=torch.bfloat16):
    """The control: the reference in the program's place one precision
    below the configuration's float32. Its J is computed in `dtype` from the
    same placement and forwarding fractions, and its phi is those fractions
    rounded to `dtype`; the comparison must find it wrong."""
    n, A = net["adj"].shape[0], net["src"].shape[0]
    K = int(net["parts"][0]) + 1
    phi_lo = phi_env.to(dtype)
    x_lo = x_env[:A, : K - 1, :n].to(dtype)
    J, _ = objective(net, x_lo, phi_lo[:A, :K, :n, :n], dtype=dtype)
    return float(J), phi_lo.to(phi_env.dtype)
