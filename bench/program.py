"""The benchmark's only door into the program under test, `repro_torch`:
its inputs are handed over through the program's public structures, and
its answers read back for the reference to judge."""
from __future__ import annotations

import numpy as np
import torch


def to_problem(net: dict, device):
    """One network's arrays as the program's `Problem` on `device`, with
    the hop bound the program derives for it."""
    from repro_torch.core.structs import Apps, CostModel, Network, Problem, with_hop_bound

    def t(key, dtype):
        return torch.as_tensor(np.asarray(net[key]), dtype=dtype).to(device)

    prob = Problem(
        net=Network(adj=t("adj", torch.float32), mu=t("mu", torch.float32),
                    nu=t("nu", torch.float32)),
        apps=Apps(src=t("src", torch.int64), dst=t("dst", torch.int64),
                  lam=t("lam", torch.float32), L=t("L", torch.float32),
                  w=t("w", torch.float32), parts=t("parts", torch.int64)),
        cost=CostModel(),
    )
    return with_hop_bound(prob)


def solver_kwargs(config: dict) -> dict:
    """The configuration's solver budget as `solve_fleet` / `run_control`
    keyword arguments."""
    s = config["solver"]
    return dict(m_max=s["m_max"], t_phi=s["t_phi"], tol=s["tol"], patience=s["patience"],
                block_apps=s["block_apps"], solver=s["linear_solver"], round_to=s["round_to"])


def launches() -> int:
    """Kernel launches counted by the program so far, all kernels."""
    from repro_torch.kernels import _build
    return sum(_build.LAUNCHES.values())


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
