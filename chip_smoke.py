#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from `src/repro_torch/csrc/` (into
`build/kernels/`), then runs four phases, each printing one JSON line:

  1. kernels vs their plain PyTorch versions on the card, at the main
     path's shapes (Neumann rtol 1e-5, bf16 operands 2e-2, min-plus and
     its argmin bitwise), with CUDA-event times, the plain version's time,
     a PyTorch-call yardstick where one exists, and the card's bound;
  2. the paper's four scenarios through `compare_all` on the card, with
     `iot` and `geant` also solved on the CPU and compared, and the paper's
     claims checked;
  3. `engine_solve` on 64 stacked `random_connected(256, 32)` instances
     (the batched engine at realistic scale), with the per-round split of
     placement / forwarding / round_eval;
  4. one large instance, `solve_alt(random_connected(1024, 4))`.

Kernel launches are counted only while the main path runs (phases 2-4);
every kernel must have launched there. Any failed check raises, so the
script exits non-zero. It exits non-zero without a GPU or without the
repository's `src/repro_torch` beside it. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet) used for the bound column.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # CUDA cores, an FMA counted as two operations

NEUMANN_RTOL = 1e-5  # same algorithm, different fp32 summation order
BF16_TOL = 2e-2  # bf16 operands vs the fp32 plain version


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of `fn()` on the device, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Counter:
    """Sums kernel launch counts over the main-path runs only."""

    def __init__(self, build):
        self.build = build
        self.total = {k: 0 for k in build.LAUNCHES}
        self.last = dict(self.total)

    def run(self, fn):
        import torch

        torch.cuda.synchronize()
        self.build.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        self.last = dict(self.build.LAUNCHES)
        for k, v in self.last.items():
            self.total[k] += v
        self.build.reset_launches()
        return out


def neumann_hops_used(w, b, hops, tol, transpose):
    """Per-element hop count the early exit stops at (the kernel's work)."""
    import torch

    m = w.float().mT if transpose else w.float()
    x, done = b, torch.zeros(b.shape[:-1], dtype=torch.bool, device=b.device)
    used = torch.zeros(b.shape[:-1], dtype=torch.int64, device=b.device)
    for _ in range(hops):
        x_new = b + (m @ x[..., None])[..., 0]
        used += (~done).long()
        conv = (x_new - x).abs().amax(-1) <= tol * (x_new.abs().amax(-1) + 1e-30)
        x = torch.where(done[..., None], x, x_new)
        done = done | conv
        if bool(done.all()):
            break
    return int(used.sum())


def profile_round(fn, wall_ms: float) -> dict:
    """Device time of `fn()` by kernel family under torch.profiler, and the
    device's idle share of `wall_ms` (the same work timed without the
    profiler). Only device-side kernel events are summed: CPU operator
    ranges also carry their children's device time. Reports "not measured"
    if the profiler records no device time on this machine."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fam = {"neumann": 0.0, "minplus": 0.0, "other": 0.0}
    top = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_ms = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        if dev_ms <= 0:
            continue
        name = e.key
        key = "neumann" if "neumann_kernel" in name else "minplus" if "minplus_kernel" in name else "other"
        fam[key] += dev_ms
        top.append((dev_ms, name[:90], e.count))
    busy = sum(fam.values())
    if busy <= 0:
        return {"device_ms": "not measured", "wall_ms": wall_ms}
    top.sort(reverse=True)
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": max(0.0, 1.0 - busy / wall_ms),
        "device_ms_by_family": fam,
        "top_kernels": [{"ms": t, "name": n, "calls": c} for t, n, c in top[:10]],
    }


def phase1(scen, build, stacked256):
    """Each kernel vs its plain version at the main path's shapes."""
    import torch
    from repro_torch.core import forwarding_update, stack_single, stage_traffic, structured_init
    from repro_torch.core.placement import zero_load_dp
    from repro_torch.kernels.minplus import (
        apsp, minplus_matmul, minplus_matmul_argmin, minplus_matmul_argmin_ref,
        minplus_matmul_ref,
    )
    from repro_torch.kernels.neumann import (
        effective_hops, neumann_propagate, neumann_propagate_ref, neumann_solve,
    )

    rows, summary = [], {}

    def keep(name, row, headline):
        rows.append(row)
        s = summary.setdefault(name, {"max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], row["max_abs_err"])
        if headline:
            s.update({k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")})

    def bound(bytes_, ops_):
        t_b, t_o = bytes_ / HBM_BYTES_PER_S, ops_ / FP32_OPS_PER_S
        return {"bound_ms": 1e3 * max(t_b, t_o), "bound_by": "bytes" if t_b >= t_o else "operations"}

    rc64 = stack_single(scen.random_connected(64, 24, seed=0))
    rc1024 = stack_single(scen.random_connected(1024, 4, seed=1))
    # (V, stacked problem, is the phase-3 shape that heads the kernels line)
    cases = [
        (17, stack_single(scen.iot()), False),
        (64, rc64, False),
        (256, stacked256, True),
        (1024, rc1024, False),
        (1280, stack_single(scen.random_connected(1280, 4, seed=1)), False),
    ]
    for v, prob, headline in cases:
        state = forwarding_update(prob, structured_init(prob), t_phi=2)
        hops = effective_hops(prob.hop_bound, v, fixed_loop=True)
        # Stage 1 (partition-1 host -> partition-2 host) as the traffic scan
        # solves it: operators [B, A, V, V] as a strided view of phi, and the
        # right-hand side gate * t_0.
        w = state.phi[..., 1, :, :]
        b = (state.x[..., 0, :] * stage_traffic(prob, state)[..., 0, :]).contiguous()
        n_ops = b.numel() // v
        for dt in (torch.float32, torch.bfloat16) if v == 1280 else (torch.float32,):
            wd = w if dt == torch.float32 else w.to(dt)
            for transpose, name in ((True, "neumann_cols"), (False, "neumann_rows")):
                got = neumann_propagate(wd, b, hops=hops, transpose=transpose)
                want = neumann_propagate_ref(wd, b, hops, 1e-6, transpose)
                err = (got - want).abs().max().item()
                scale = want.abs().max().item()
                if not err <= NEUMANN_RTOL * scale:
                    raise AssertionError(f"{name} V={v} {dt}: max err {err} > {NEUMANN_RTOL} * {scale}")
                if dt == torch.bfloat16:  # bf16 operands vs the fp32 solve
                    exact = neumann_propagate_ref(w, b, hops, 1e-6, transpose)
                    dev_ = (got - exact).abs().max().item()
                    if not dev_ <= BF16_TOL * exact.abs().max().item():
                        raise AssertionError(f"{name} V={v} bf16 vs fp32: {dev_}")
                    if bool((got[exact == 0] != 0).any()):
                        raise AssertionError(f"{name} V={v} bf16: exact zeros not kept")
                used = neumann_hops_used(wd, b, hops, 1e-6, transpose)
                esize = 2 if dt == torch.bfloat16 else 4
                reps = 20 if v <= 256 else 5
                keep(name, {
                    "kernel": name, "shape": f"N={n_ops} V={v} {str(dt)[6:]}", "hops_cap": hops,
                    "hops_used_mean": used / n_ops, "max_abs_err": err,
                    "ms": cuda_ms(lambda: neumann_propagate(wd, b, hops=hops, transpose=transpose), reps),
                    "plain_ms": cuda_ms(lambda: neumann_propagate_ref(wd, b, hops, 1e-6, transpose), 2, 1),
                    **bound(n_ops * v * v * esize + 2 * n_ops * v * 4, 2 * v * v * used),
                    "library_ms": None,
                }, headline and dt == torch.float32)
        if v == 256:  # backward: the transpose solve through the kernel
            bb = b.clone().requires_grad_(True)
            x = neumann_solve(w.mT, bb, hops=hops)
            g = torch.rand_like(x)
            (x * g).sum().backward()
            want = neumann_propagate_ref(w, g, hops, 1e-6, False)
            err = (bb.grad - want).abs().max().item()
            if not err <= NEUMANN_RTOL * want.abs().max().item():
                raise AssertionError(f"neumann backward V={v}: max err {err}")
            rows.append({"kernel": "neumann_rows", "shape": f"backward N={n_ops} V={v}", "max_abs_err": err})
        del state, w, b
        torch.cuda.empty_cache()

    # Min-plus: the APSP squaring product d (x) d and the next-hop argmin
    # (w, dist) on each batch's zero-load metric, plus an integer-weight
    # batch whose exact ties pin the first-minimum rule.
    gen = torch.Generator(device="cuda").manual_seed(0)
    for v, prob, headline in ((64, rc64, False), (256, stacked256, True), (1024, rc1024, False)):
        w = zero_load_dp(prob)
        eye = torch.eye(v, dtype=torch.bool, device="cuda")
        d = torch.where(eye, 0.0, w)
        dist = apsp(w)
        ints = torch.randint(1, 5, w.shape, generator=gen, device="cuda").float()
        ints = torch.where(torch.rand(w.shape, generator=gen, device="cuda") < 0.5, ints, 1e18)
        nb = w.shape[0]
        for tag, a_, b_ in (("apsp", d, d), ("nexthop", w, dist), ("integer ties", ints, ints)):
            for name in ("minplus", "minplus_argmin"):
                if name == "minplus":
                    fn = lambda: minplus_matmul(a_, b_)  # noqa: E731
                    plain = lambda: minplus_matmul_ref(a_, b_)  # noqa: E731
                    lib = lambda: torch.amin(a_[..., :, :, None] + b_[..., None, :, :], -2)  # noqa: E731
                else:
                    fn = lambda: minplus_matmul_argmin(a_, b_)  # noqa: E731
                    plain = lambda: minplus_matmul_argmin_ref(a_, b_)  # noqa: E731
                    lib = lambda: torch.min(a_[..., :, :, None] + b_[..., None, :, :], -2)  # noqa: E731
                got, want = fn(), plain()
                if name == "minplus":
                    ok, err = torch.equal(got, want), (got - want).abs().max().item()
                else:
                    ok = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                    err = (got[0] - want[0]).abs().max().item()
                if not ok:
                    raise AssertionError(f"{name} V={v} {tag}: not bitwise equal to the plain version")
                del got, want
                row = {"kernel": name, "shape": f"B={nb} V={v} {tag}", "max_abs_err": err}
                if tag != "integer ties":
                    out_bytes = nb * v * v * (12 if name == "minplus_argmin" else 4)
                    row.update({
                        "ms": cuda_ms(fn, 10 if v <= 256 else 3),
                        "plain_ms": cuda_ms(plain, 2, 1),
                        **bound(2 * nb * v * v * 4 + out_bytes, 2 * nb * v ** 3),
                        "library_ms": cuda_ms(lib, 2, 1),
                    })
                keep(name, row, headline and tag == ("apsp" if name == "minplus" else "nexthop"))
        torch.cuda.empty_cache()
    build.reset_launches()
    emit({"phase": 1, "name": "kernels_vs_plain", "rows": rows})
    return summary


def phase2(scen, alt, counter):
    """The paper's scenarios through compare_all on the card (and CPU)."""
    import torch

    out = {}
    for name, make in scen.SCENARIOS.items():
        t0 = time.perf_counter()
        res = counter.run(lambda: alt.compare_all(make()))
        t_gpu = time.perf_counter() - t0
        line = {"scenario": name, "gpu_s": t_gpu}
        line.update({m: {"J": r.J, "iters": r.iters} for m, r in res.items()})
        for m, r in res.items():
            if not math.isfinite(r.J):
                raise AssertionError(f"{name} {m}: J not finite")
            if m != "ALT" and not res["ALT"].J <= r.J * 1.001:
                raise AssertionError(f"{name}: ALT {res['ALT'].J} above {m} {r.J}")
        if name in ("iot", "geant"):
            t0 = time.perf_counter()
            cpu = alt.compare_all(make(device="cpu"), device="cpu")
            line["cpu_s"] = time.perf_counter() - t0
            near_ties = {}
            for m in res:
                rel = abs(res[m].J / cpu[m].J - 1.0)
                line[m]["rel_vs_cpu"] = rel
                if rel > 1e-5:
                    same_hosts = torch.equal(res[m].state.hosts().cpu(), cpu[m].state.hosts())
                    if same_hosts:
                        raise AssertionError(f"{name} {m}: GPU J {res[m].J} vs CPU {cpu[m].J}, same hosts")
                    near_ties[m] = "hosts differ on a placement near-tie"
            line["near_ties"] = near_ties
        out[name] = res
        emit({"phase": 2, **line})
    # Paper claims beyond the per-topology ordering.
    ratio = {n: out[n]["CoLocated"].J / out[n]["ALT"].J for n in ("iot", "geant")}
    if not ratio["iot"] > ratio["geant"]:
        raise AssertionError(f"split flexibility: CoLocated/ALT iot {ratio['iot']} <= geant {ratio['geant']}")
    half = counter.run(lambda: alt.compare_all(scen.iot(load_scale=0.5)))
    gaps = [half["CongUnaware"].J - half["ALT"].J, out["iot"]["CongUnaware"].J - out["iot"]["ALT"].J]
    if not gaps[1] > gaps[0] > 0:
        raise AssertionError(f"load should widen the CongUnaware-ALT gap: {gaps}")
    emit({"phase": 2, "claims": {"colocated_over_alt": ratio, "gap_load_0.5_1.0": gaps}})


def phase3(core, pad, counter, stacked, lane0):
    """The batched engine at realistic scale, plus the per-round split."""
    import torch

    kw = dict(m_max=4, t_phi=5, alpha=0.5, tol=1e-3, patience=4)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = counter.run(lambda: core.engine_solve(stacked, **kw))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = counter.last
    J, hist = out["J"], out["history"]
    if J.shape != (64,) or not bool(torch.isfinite(J).all()):
        raise AssertionError("phase 3: J not finite or wrong shape")
    best = torch.where(torch.isnan(hist), torch.inf, hist).amin(dim=1)
    if not torch.equal(best, J) or not bool((J <= hist[:, 0]).all()):
        raise AssertionError("phase 3: returned J is not the best of the history")
    absorbed = core.total_absorbed(stacked, out["state"])
    cons = ((absorbed - stacked.apps.lam).abs() / stacked.apps.lam).max().item()
    if not cons <= 1e-3:
        raise AssertionError(f"phase 3: conservation violated by {cons}")
    one = counter.run(lambda: core.engine_solve(pad.stack_problems([lane0]), **kw))
    rel0 = abs(one["J"][0].item() / J[0].item() - 1.0)
    same_hosts = torch.equal(one["hosts"][0], out["hosts"][0])
    if not (rel0 <= 1e-5 or not same_hosts):
        raise AssertionError(f"phase 3: lane 0 J {J[0].item()} vs B=1 {one['J'][0].item()}")

    # Per-round split: one more round, each step timed with CUDA events,
    # then the same round under torch.profiler for device time by kernel.
    state = out["state"]

    def one_round(ev=None):
        mark = (lambda i: ev[i].record()) if ev else (lambda i: None)
        with torch.no_grad():
            mark(0)
            _, aux = core.round_eval(stacked, state)
            mark(1)
            nxt = core.placement_update(stacked, state, aux["ctg"])
            mark(2)
            core.forwarding_update(stacked, nxt, t_phi=kw["t_phi"], alpha=kw["alpha"])
            mark(3)

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    one_round(ev)
    torch.cuda.synchronize()
    split = {
        "round_eval_ms": ev[0].elapsed_time(ev[1]),
        "placement_ms": ev[1].elapsed_time(ev[2]),
        "forwarding_ms": ev[2].elapsed_time(ev[3]),
    }
    split["profile"] = profile_round(one_round, sum(split.values()))
    emit({
        "phase": 3, "B": 64, "V": 256, "A": 32, "K": 3, **kw,
        "rounds": out["rounds"], "wall_s": wall, "ms_per_round": 1e3 * wall / max(out["rounds"], 1),
        "peak_gb": peak / 1e9, "J_mean": J.mean().item(), "conservation_rel": cons,
        "lane0_rel_vs_B1": rel0, "lane0_same_hosts": same_hosts, "launches": launches,
        "split": split,
    })


def phase4(scen, alt, core, counter):
    """One large instance: the V = 1024 workload of the JAX kernel bench."""
    import torch

    prob = scen.random_connected(1024, 4, seed=1)
    t0 = time.perf_counter()
    res = counter.run(lambda: alt.solve_alt(prob, m_max=1, t_phi=2))
    wall = time.perf_counter() - t0
    launches = counter.last
    if not math.isfinite(res.J):
        raise AssertionError("phase 4: J not finite")
    st = core.stack_single(prob)
    s1 = type(res.state)(x=res.state.x[None], phi=res.state.phi[None])
    absorbed = core.total_absorbed(st, s1)
    cons = ((absorbed - st.apps.lam).abs() / st.apps.lam).max().item()
    if not cons <= 1e-3:
        raise AssertionError(f"phase 4: conservation violated by {cons}")
    emit({
        "phase": 4, "V": 1024, "A": 4, "m_max": 1, "t_phi": 2, "J": res.J,
        "iters": res.iters, "wall_s": wall, "ms_per_round": 1e3 * wall / max(res.iters, 1),
        "hop_bound": prob.hop_bound, "conservation_rel": cons, "launches": launches,
    })


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import core
    from repro_torch.core import alt, scenarios as scen
    from repro_torch.fleet import pad
    from repro_torch.kernels import _build

    card = gpu_line()
    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": 0, "name": "build", "build_s": time.perf_counter() - t0,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "ptxas": {n: [ln.split(":", 1)[1].strip() for ln in _build.build_log(n).splitlines()
                        if "registers" in ln] for n in _build.SOURCES}})

    problems = [scen.random_connected(256, 32, seed=s) for s in range(64)]
    stacked = pad.stack_problems(problems)

    summary = phase1(scen, _build, stacked)
    counter = Counter(_build)
    phase2(scen, alt, counter)
    phase3(core, pad, counter, stacked, problems[0])
    phase4(scen, alt, core, counter)

    sources = {"neumann": "src/repro_torch/csrc/neumann.cu", "minplus": "src/repro_torch/csrc/minplus.cu"}
    replaces = {
        "neumann_cols": "src/repro/kernels/neumann/kernel.py:52",
        "neumann_rows": "src/repro/kernels/neumann/kernel.py:52",
        "minplus": "src/repro/kernels/minplus/kernel.py:36",
        "minplus_argmin": "src/repro/kernels/minplus/kernel.py:61",
    }
    kernels = []
    for name, launches in counter.total.items():
        if launches <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
        s = summary[name]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name.split("_")[0]],
            "replaces": replaces[name], "launches": launches, "max_abs_err": s["max_abs_err"],
            "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"], "shape": s["shape"],
        })
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
