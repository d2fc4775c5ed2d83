"""Multi-rank checks of the PyTorch port on the CPU: the fleet mesh
(`solve_fleet(shard=True)`, `run_control(shard=True)`) and the GPipe
schedule (`pipeline_apply`), each over 4 gloo ranks, one process a rank.

    PYTHONPATH=src OMP_NUM_THREADS=1 python -m torch.distributed.run --standalone \\
        --nproc-per-node 4 tests/_torch_ranks.py fleet OUT_DIR
    ... tests/_torch_ranks.py pipeline OUT_DIR

Every rank runs the same calls; rank 0 writes OUT_DIR/<what>.npz: the
results, the unsharded (or sequential) references it computed alone, and
`check.<name>` flags with their details, which `tests/test_torch_mesh.py`
and `tests/test_torch_pipeline.py` assert one by one and `chip_smoke.py`
asserts together on the GPU machine's host. `python tests/_torch_ranks.py
reference OUT_DIR` writes the numbers that a run on another host is held
to (`tests/torch_ranks_reference.json`).

This module imports only `repro_torch`, numpy and torch: the ranks never
load JAX.
"""
from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
REFERENCE = Path(__file__).resolve().parent / "torch_ranks_reference.json"
N_RANKS = 4
RTOL = 1e-5
# Small budgets: parity is structural, not about deep convergence.
SOLVE_KW = dict(m_max=3, t_phi=3, alpha=0.5, tol=1e-3, patience=4, device="cpu")
CONTROL_KW = dict(epochs=3, seed=1, m_max=2, t_phi=2, device="cpu",
                  trace_kwargs=dict(node_failures=2, link_degradations=1, flash_crowds=1,
                                    min_duration=1, max_duration=2))
# The pipeline cases: (stages, microbatches); MB x D microbatches of tanh(x @ w[s]).
PIPE_CASES = ((4, 6), (4, 2), (1, 6))
PIPE_MB, PIPE_D = 8, 16
FLEET_FIELDS = ("J", "J_comm", "J_comp", "history", "iters", "hosts")


def fleet_pool(scenarios, device="cpu"):
    """The mixed-size pool of the sharded-fleet contract (`mesh()` first, so
    every prefix shares one (V, A) envelope). `scenarios` is `repro.core`
    or `repro_torch.core`: both draw the same instances."""
    kw = {} if device is None else {"device": device}
    return [
        scenarios.mesh(**kw),
        scenarios.iot(**kw),
        *(scenarios.random_connected(n, a, seed=s, **kw)
          for n, a, s in ((12, 5, 3), (20, 8, 4), (16, 6, 5), (14, 7, 6), (18, 9, 7), (11, 4, 8))),
    ]


def pipe_inputs(n_stages: int, m: int):
    """Stage weights [P, D, D] and microbatches [M, MB, D], from a seed."""
    rng = np.random.default_rng(100 * n_stages + m)
    w = (rng.standard_normal((n_stages, PIPE_D, PIPE_D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((m, PIPE_MB, PIPE_D)).astype(np.float32)
    return w, x


def launch(what: str, out_dir, nproc: int = N_RANKS) -> subprocess.Popen:
    """Start the ranks under `torch.distributed.run` (a free rendezvous
    port on localhost, one torch thread a rank)."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc-per-node={nproc}",
           str(Path(__file__).resolve()), what, str(out_dir)]
    return subprocess.Popen(cmd, env=env, cwd=str(REPO), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish(proc: subprocess.Popen, out_dir, what: str, timeout: float = 300.0) -> dict:
    """Wait for the ranks; any rank that failed fails here. Returns the
    npz rank 0 wrote, as a dict."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"{what} ranks timed out after {timeout} s:\n{err[-3000:]}")
    if proc.returncode != 0:
        raise AssertionError(f"{what} ranks exited {proc.returncode}:\n{out[-2000:]}\n{err[-4000:]}")
    with np.load(Path(out_dir) / f"{what}.npz") as z:
        return {k: z[k] for k in z.files}


def failed_checks(res: dict) -> dict:
    """{check name: detail} of every check that did not hold."""
    return {k[len("check."):]: str(res["detail." + k[len("check."):]])
            for k in res if k.startswith("check.") and not bool(res[k])}


# ---------------------------------------------------------------------------
# Rank side
# ---------------------------------------------------------------------------
class _Checks:
    def __init__(self):
        self.out = {}

    def add(self, name: str, ok: bool, detail="") -> None:
        self.out[f"check.{name}"] = np.array(bool(ok))
        self.out[f"detail.{name}"] = np.array(str(detail))

    def close(self, name: str, got, want, rtol: float = RTOL) -> None:
        """Integers and booleans equal; floats at `rtol`, NaN where NaN."""
        got, want = np.asarray(got), np.asarray(want)
        if got.dtype.kind in "iub":
            ok = got.shape == want.shape and np.array_equal(got, want, equal_nan=got.dtype.kind == "f")
            self.add(name, ok, "" if ok else f"{got} != {want}")
            return
        ok = got.shape == want.shape and np.allclose(got, want, rtol=rtol, atol=0.0, equal_nan=True)
        err = (float(np.nanmax(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))
               if got.shape == want.shape else None)
        self.add(name, ok, f"max rel err {err}")


def _same_on_every_rank(arrays) -> bool:
    import torch.distributed as dist

    digest = b"".join(np.ascontiguousarray(a).tobytes() for a in arrays)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, digest)
    return all(d == every[0] for d in every)


def _keep(out: dict, name: str, r) -> None:
    for f in FLEET_FIELDS:
        out[f"{name}.{f}"] = np.asarray(getattr(r, f))
    out[f"{name}.rounds"] = np.array(r.rounds)
    out[f"{name}.plan"] = np.array([r.shard.n_devices, r.shard.batch, r.shard.padded_batch,
                                    int(r.shard.output_sharded)])
    out[f"{name}.reason"] = np.array(r.shard.reason)


def _fleet(out: dict, checks: _Checks) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch import core as T
    from repro_torch.distributed.sharding import (
        carries_fleet_sharding,
        fleet_sharding,
        shard_fleet,
        to_named_shardings,
    )
    from repro_torch.fleet import METHODS, solve_fleet, stack_problems
    from repro_torch.launch.control import run_control
    from repro_torch.launch.mesh import make_fleet_mesh

    rank = dist.get_rank()
    pool = fleet_pool(T)
    phantom = T.random_connected(8, 3, seed=100, device="cpu")
    sharded = {}

    def solve(name, fleet, **kw):
        r = solve_fleet(fleet, **{**SOLVE_KW, **kw})
        sharded[name] = r
        _keep(out, name, r)
        return r

    for m in METHODS:
        solve(f"sharded_{m}", pool, method=m, shard=True)
    solve("pad10", pool + pool[:2], shard=True)
    solve("chunked", pool + pool[:4], shard=True, chunk_size=3)
    solve("tail6", pool[:6], shard=True)
    solve("tail6_explicit", pool[:6] + [pool[0], pool[0]], shard=True)
    solve("phantom", pool + [phantom], shard=True)
    solve("rotated", pool[3:] + pool[:3], shard=True)
    solve("submesh", pool, shard=True, devices=2)
    checks.add("same_result_on_every_rank",
               _same_on_every_rank([r.J for r in sharded.values()] + [r.hosts for r in sharded.values()]))
    alt = sharded["sharded_ALT"]
    out["sharded_ALT.trace_live"] = alt.trace.live
    out["sharded_ALT.trace_J_comm"] = alt.trace.J_comm

    # The engine's outputs, driven directly, carry the fleet layout.
    mesh = make_fleet_mesh(device="cpu")
    stacked, info = stack_problems(pool)
    st_s, info_s = shard_fleet((stacked, info), mesh)
    checks.add("shard_fleet_leaves_are_dtensors",
               isinstance(st_s.net.adj, DTensor) and st_s.net.adj.placements == tuple(fleet_sharding(mesh))
               and tuple(st_s.net.adj.to_local().shape) == (len(pool) // N_RANKS,) + tuple(stacked.net.adj.shape[1:])
               and st_s.hop_bound == stacked.hop_bound and bool(torch.equal(st_s.net.adj.full_tensor(), stacked.net.adj)))
    x = DTensor.from_local(torch.arange(2.0) + 2 * rank, mesh, fleet_sharding(mesh))
    one = make_fleet_mesh(1, device="cpu")
    on_one = DTensor.from_local(torch.arange(8.0), one, fleet_sharding(one)) if rank == 0 else None
    replicated = DTensor.from_local(torch.arange(8.0), mesh, [Replicate()])
    other = init_device_mesh("cpu", (N_RANKS,), mesh_dim_names=("pod",))
    checks.add("carries_fleet_sharding_accepts_the_fleet_layout", carries_fleet_sharding(x))
    checks.add("carries_fleet_sharding_rejects_a_plain_tensor", not carries_fleet_sharding(torch.arange(8.0)))
    checks.add("carries_fleet_sharding_rejects_a_one_rank_mesh",
               rank != 0 or not carries_fleet_sharding(on_one))
    checks.add("carries_fleet_sharding_rejects_replicate", not carries_fleet_sharding(replicated))
    try:
        fleet_sharding(other)
        checks.add("fleet_sharding_needs_a_fleet_dim", False, "no error")
    except ValueError as e:
        checks.add("fleet_sharding_needs_a_fleet_dim", "fleet" in str(e), e)

    grid = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    specs = {"a": ("data", None), "b": [(None, "model"), (("data", "model"),)], "c": ()}
    want = {"a": [Shard(0), Replicate()], "b": [[Replicate(), Shard(1)], [Shard(0), Shard(0)]],
            "c": [Replicate(), Replicate()]}
    got = to_named_shardings(grid, specs)
    checks.add("to_named_shardings", got == want, got)

    # The explicit layout decisions.
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logging.getLogger("repro_torch.fleet").addHandler(handler)
    one_rank = solve_fleet(pool[:2], shard=True, devices=1, **SOLVE_KW)
    logging.getLogger("repro_torch.fleet").removeHandler(handler)
    checks.add("one_rank_plan_is_single_device_and_logged",
               one_rank.shard.reason == "single-device" and one_rank.shard.n_devices == 1
               and not one_rank.shard.output_sharded
               and any("reason=single-device" in r.getMessage() for r in records), one_rank.shard)
    for name, call, pattern in (
        ("lane_chunk_with_a_mesh_raises", lambda: solve_fleet(pool, shard=True, lane_chunk=1, **SOLVE_KW),
         "lane_chunk=1"),
        ("mesh_wider_than_the_world_raises", lambda: make_fleet_mesh(N_RANKS + 1, device="cpu"),
         f"requested {N_RANKS + 1} devices"),
        ("devices_wider_than_the_world_raises",
         lambda: solve_fleet(pool, shard=True, devices=N_RANKS + 1, **SOLVE_KW), "process group has"),
    ):
        try:
            call()
            checks.add(name, False, "no error")
        except ValueError as e:
            checks.add(name, pattern in str(e), e)

    # The control loop over the mesh: 2 instances x 3 epochs, warm starts.
    from repro_torch.fleet import sample_fleet

    cfleet = sample_fleet(2, families=["iot_hierarchy"], seed=0, device="cpu")
    ctl = run_control(cfleet, shard=True, **CONTROL_KW)
    out["control.J_median"] = np.array([r.J_median for r in ctl.reports])
    out["control.rounds"] = np.array([r.rounds for r in ctl.reports])
    out["control.outcomes"] = np.array([f"{r.mode}:{r.outcome}:{r.perturbed}" for r in ctl.reports])
    out["control.hosts"] = ctl.state.hosts().numpy()
    out["control.events"] = np.array(sum(len(r.events) for r in ctl.reports))

    # The flag reduction a round: one all_reduce(MAX) of an int32 over the mesh.
    from repro_torch.core.engine import _any_active

    group = mesh.get_group("fleet")
    flag = torch.ones(3, dtype=torch.bool)
    for _ in range(20):
        _any_active(flag, group)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(200):
        _any_active(flag, group)
    out["flag_allreduce_us"] = np.array(1e6 * (time.perf_counter() - t0) / 200)

    if rank != 0:
        return
    # The unsharded references, on rank 0 alone (no collective).
    ref = {}
    for m in METHODS:
        ref[m] = solve_fleet(pool, method=m, **SOLVE_KW)
        _keep(out, f"unsharded_{m}", ref[m])
    ref_pad = solve_fleet(pool + pool[:2], **SOLVE_KW)
    ref_chunk = solve_fleet(pool + pool[:4], **SOLVE_KW)
    ref_ctl = run_control(cfleet, **CONTROL_KW)
    for m in METHODS:
        for f in FLEET_FIELDS:
            checks.close(f"sharded_{m}_{f}", getattr(sharded[f"sharded_{m}"], f), getattr(ref[m], f))
        checks.add(f"sharded_{m}_plan", sharded[f"sharded_{m}"].shard.reason == "sharded"
                   and sharded[f"sharded_{m}"].shard.n_devices == N_RANKS
                   and sharded[f"sharded_{m}"].shard.output_sharded, sharded[f"sharded_{m}"].shard)
        checks.add(f"sharded_{m}_rounds", sharded[f"sharded_{m}"].rounds == ref[m].rounds,
                   (sharded[f"sharded_{m}"].rounds, ref[m].rounds))
    pad = sharded["pad10"]
    checks.add("pad10_plan", pad.n_instances == 10 and pad.shard.padded_batch == 12 and pad.shard.batch == 10
               and pad.shard.reason == "sharded" and pad.shard.output_sharded, pad.shard)
    for f in FLEET_FIELDS:
        checks.close(f"pad10_{f}", getattr(pad, f), getattr(ref_pad, f))
    ch = sharded["chunked"]
    checks.add("chunked_plan", ch.shard.padded_batch == 12 and ch.shard.output_sharded
               and ch.shard.reason == "sharded", ch.shard)
    for f in FLEET_FIELDS:
        checks.close(f"chunked_{f}", getattr(ch, f), getattr(ref_chunk, f))
    t6, t6x = sharded["tail6"], sharded["tail6_explicit"]
    checks.add("tail_repeats_bitwise_inert", np.array_equal(t6x.J[:6], t6.J) and np.array_equal(t6x.hosts[:6], t6.hosts)
               and np.array_equal(t6x.J[6:], np.repeat(t6.J[:1], 2)) and t6.shard.padded_batch == 8)
    base = sharded["sharded_ALT"]
    ph = sharded["phantom"]
    checks.add("phantom_bitwise_inert", np.array_equal(ph.J[:8], base.J) and np.array_equal(ph.hosts[:8], base.hosts))
    rot = sharded["rotated"]
    checks.add("rotation_across_ranks_bitwise", np.array_equal(np.concatenate([rot.J[-3:], rot.J[:-3]]), base.J)
               and np.array_equal(np.concatenate([rot.hosts[-3:], rot.hosts[:-3]]), base.hosts))
    sub = sharded["submesh"]
    checks.add("submesh_of_two_ranks", sub.shard.n_devices == 2 and sub.shard.output_sharded
               and np.array_equal(sub.J, base.J) and np.array_equal(sub.hosts, base.hosts), sub.shard)
    checks.add("trace_one_length", alt.trace.live.shape == (len(pool), SOLVE_KW["m_max"] + 1)
               and np.array_equal(alt.trace.live, ref["ALT"].trace.live))
    checks.close("control_J_median", out["control.J_median"], [r.J_median for r in ref_ctl.reports])
    checks.add("control_epochs", [f"{r.mode}:{r.outcome}:{r.perturbed}" for r in ref_ctl.reports]
               == out["control.outcomes"].tolist() and out["control.events"] > 0,
               (out["control.outcomes"], out["control.events"]))
    checks.close("control_rounds", out["control.rounds"], [r.rounds for r in ref_ctl.reports])
    checks.close("control_final_hosts", out["control.hosts"], ref_ctl.state.hosts().numpy())


def _pipeline(out: dict, checks: _Checks) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.pipeline import pipeline_apply

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"])

    every = []
    for n_stages, m in PIPE_CASES:
        w, x = pipe_inputs(n_stages, m)
        mesh = init_device_mesh("cpu", (N_RANKS // n_stages, n_stages), mesh_dim_names=("dp", "pod"))
        got = pipeline_apply(stage_fn, {"w": torch.from_numpy(w)}, torch.from_numpy(x), mesh=mesh, axis="pod",
                             device="cpu").numpy()
        ref = torch.from_numpy(x)
        for s in range(n_stages):
            ref = torch.tanh(ref @ torch.from_numpy(w[s]))
        name = f"P{n_stages}_M{m}"
        out[f"{name}.got"] = got
        err = float(np.abs(got - ref.numpy()).max())
        checks.add(f"{name}_matches_sequential", err < 1e-5, f"max abs err {err}")
        every.append(got)
    checks.add("same_result_on_every_rank", _same_on_every_rank(every))
    # One point-to-point hop: a [MB, D] fp32 activation between two ranks.
    mesh = init_device_mesh("cpu", (N_RANKS,), mesh_dim_names=("pod",))
    y = torch.ones(PIPE_MB, PIPE_D)
    rank = dist.get_rank()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(200):
        if rank == 0:
            dist.send(y, 1)
        elif rank == 1:
            dist.recv(y, 0)
    dist.barrier()
    out["hop_us"] = np.array(1e6 * (time.perf_counter() - t0) / 200)
    del mesh


def rank_main(what: str, out_dir: str) -> int:
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_from_env

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    init_from_env("cpu")
    if dist.get_world_size() != N_RANKS:
        raise SystemExit(f"{what}: needs {N_RANKS} ranks, got {dist.get_world_size()}")
    out, checks = {}, _Checks()
    {"fleet": _fleet, "pipeline": _pipeline}[what](out, checks)
    checks.add("ranks_import_neither_jax_nor_repro",
               not any(m == "jax" or m.startswith(("jax.", "repro.")) or m == "repro" for m in sys.modules))
    out["wall_s"] = np.array(time.perf_counter() - t0)
    out["torch"] = np.array(torch.__version__)
    dist.barrier()
    if dist.get_rank() == 0:
        np.savez(Path(out_dir) / f"{what}.npz", **out, **checks.out)
    dist.destroy_process_group()
    return 0


# The numbers a run on another host is held to, at RTOL.
REFERENCE_KEYS = {
    "fleet": [f"sharded_{m}.J" for m in ("ALT", "OneShot", "CongUnaware", "CoLocated")]
    + ["pad10.J", "chunked.J", "control.J_median"],
    "pipeline": [f"P{p}_M{m}.got" for p, m in PIPE_CASES],
}


def reference_of(what: str, run: dict) -> dict:
    return {k: np.asarray(run[k], np.float64).ravel().tolist() for k in REFERENCE_KEYS[what]}


def against_reference(what: str, run: dict) -> dict:
    """{key: max relative error} of a run against the committed reference
    (`REFERENCE`); a key of another length is an infinite error."""
    want_all = json.loads(REFERENCE.read_text())[what]
    got = reference_of(what, run)
    err = {}
    for k, want in want_all.items():
        g, w = np.asarray(got[k]), np.asarray(want)
        # Relative to each value, floored at 1% of the array's largest (a
        # tanh output near 0 is held to the array's scale).
        err[k] = (float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-2 * np.abs(w).max())))
                  if g.shape == w.shape else float("inf"))
    return err


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        ref = {}
        for what in REFERENCE_KEYS:
            with np.load(Path(sys.argv[2]) / f"{what}.npz") as z:
                ref[what] = reference_of(what, {k: z[k] for k in z.files})
        REFERENCE.write_text(json.dumps(ref) + "\n")
        sys.exit(0)
    sys.exit(rank_main(sys.argv[1], sys.argv[2]))
