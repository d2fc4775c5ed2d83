"""Multi-rank checks of the PyTorch port on the CPU: the fleet mesh
(`solve_fleet(shard=True)`, `run_control(shard=True)`), the GPipe
schedule (`pipeline_apply`) and model parallelism (the train step and
the train CLI over a (data=2, model=2) `build_mesh`), each over 4 gloo
ranks, one process a rank.

    PYTHONPATH=src OMP_NUM_THREADS=1 python -m torch.distributed.run --standalone \\
        --nproc-per-node 4 tests/_torch_ranks.py fleet OUT_DIR
    ... tests/_torch_ranks.py pipeline OUT_DIR
    ... tests/_torch_ranks.py model_parallel OUT_DIR

Every rank runs the same calls; rank 0 writes OUT_DIR/<what>.npz: the
results, the unsharded (or sequential, or one-process) references it
computed alone, and `check.<name>` flags with their details, which
`tests/test_torch_mesh.py`, `tests/test_torch_pipeline.py` and
`tests/test_torch_model_parallel.py` assert one by one; `chip_smoke.py`
asserts the first two together on the GPU machine's host. `python tests/_torch_ranks.py
reference OUT_DIR` writes the numbers that a run on another host is held
to (`tests/torch_ranks_reference.json`).

This module imports only `repro_torch`, numpy and torch: the ranks never
load JAX.
"""
from __future__ import annotations

import dataclasses
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
# Model parallelism: the reduced qwen1.5-0.5b in fp32, global batch MP_B x MP_S,
# MP_STEPS steps at MP_LR; the CLI at its reduced config.
MP_B, MP_S, MP_STEPS, MP_LR = 4, 32, 3, 3e-4
# Serving over the mesh: a prefill of MP_PREFILL tokens, MP_DECODE greedy
# decode steps; logits within MP_DECODE_TOL of the largest one.
MP_PREFILL, MP_DECODE, MP_DECODE_TOL = 16, 3, 1e-5
MP_CLI = ["--arch", "qwen1.5-0.5b", "--reduced", "--global-batch", str(MP_B), "--seq-len", str(MP_S),
          "--ckpt-every", "4", "--log-every", "1", "--device", "cpu"]
# MoE over the mesh, at MP_B x MP_S, MP_STEPS steps, fp32 and the default
# capacity factor (which drops tokens): the reduced qwen2-moe-a2.7b (E=8
# split over "model", a shared expert) and the reduced mixtral-8x22b with 3
# experts (3 does not divide "model": ff split; the sliding window), two
# dispatch groups each.
MOE_CONFIGS = {"qwen2-moe-a2.7b": dict(moe_groups=2), "mixtral-8x22b": dict(n_experts=3, moe_groups=2)}
# An SSM model's first gradients over the mesh (fp32, reduced).
SSM_ARCH = "mamba2-370m"
# The train CLI on the reduced qwen2-moe-a2.7b (its one replicated dispatch
# group), fp32 compute (`cli_losses`).
MOE_CLI = ["--arch", "qwen2-moe-a2.7b", "--reduced", "--global-batch", str(MP_B), "--seq-len", str(MP_S),
           "--steps", str(MP_STEPS), "--log-every", "1", "--device", "cpu"]
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


def mp_config():
    from repro_torch.configs import reduced_config

    return dataclasses.replace(reduced_config("qwen1.5-0.5b"), compute_dtype="float32")


def moe_config(arch: str):
    from repro_torch.configs import reduced_config

    return dataclasses.replace(reduced_config(arch), compute_dtype="float32", **MOE_CONFIGS[arch])


def mp_batches(vocab: int) -> list:
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, (MP_B, MP_S), dtype=np.int32) for _ in range(MP_STEPS)]


def _full_params(params) -> dict:
    from torch.distributed.tensor import DTensor

    return {n: (p.full_tensor() if isinstance(p, DTensor) else p).detach().numpy().copy()
            for n, p in params.named_parameters()}


def _laid_out(cfg, mesh):
    """init_params(cfg, 0) and its AdamW state, laid out over `mesh` by
    the sharding rules (one process: as they are)."""
    from repro_torch.distributed.sharding import ShardingRules, distribute_params, param_pspecs
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import init_params, trainable
    from repro_torch.optim import adamw_init

    params = init_params(cfg, 0, device="cpu")
    if mesh is not None:
        distribute_params(params, mesh, param_pspecs(cfg, params, MeshShape.of(mesh), ShardingRules()))
    return params, adamw_init(trainable(params))


def _batch(tokens, mesh) -> dict:
    import torch

    from repro_torch.distributed.sharding import ShardingRules, distribute_batch

    batch = {"tokens": torch.from_numpy(tokens)}
    return batch if mesh is None else distribute_batch(batch, mesh, ShardingRules())


def _mp_train(cfg, mesh, microbatches: int = 1):
    """MP_STEPS steps from `_laid_out(cfg, mesh)`: (losses, grad norms,
    final params as numpy, params, optimizer state)."""
    from repro_torch.launch.steps import make_train_step

    params, opt = _laid_out(cfg, mesh)
    step = make_train_step(cfg, lr=MP_LR, microbatches=microbatches, mesh=mesh)
    losses, norms = [], []
    for b in mp_batches(cfg.vocab):
        params, opt, m = step(params, opt, _batch(b, mesh))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return np.array(losses), np.array(norms), _full_params(params), params, opt


def _first_grads(cfg, mesh) -> dict:
    """{name: numpy gradient} of the first batch's loss at init."""
    import contextlib

    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.act import activation_sharding
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch.steps import value_and_grad

    params, _ = _laid_out(cfg, mesh)
    ctx = contextlib.nullcontext() if mesh is None else activation_sharding(mesh, ShardingRules())
    with ctx:
        _, grads = value_and_grad(cfg, params, _batch(mp_batches(cfg.vocab)[0], mesh))
    return {n: (g.full_tensor() if isinstance(g, DTensor) else g).numpy() for n, g in grads.items()}


def _mp_decode(cfg, mesh) -> np.ndarray:
    """The last-position logits of a prefill of MP_PREFILL tokens and of
    MP_DECODE decode steps after it (greedy), [1 + MP_DECODE, B, vocab]."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import ShardingRules, distribute_caches, distribute_params, param_pspecs
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.steps import make_prefill_step, make_serve_step, serve_config
    from repro_torch.models import init_params

    scfg = dataclasses.replace(serve_config(cfg), param_dtype="float32")
    total = MP_PREFILL + MP_DECODE
    params = init_params(scfg, 0, device="cpu")
    tokens = np.ascontiguousarray(mp_batches(scfg.vocab)[0][:, :MP_PREFILL])
    if mesh is not None:
        distribute_params(params, mesh, param_pspecs(scfg, params, MeshShape.of(mesh), ShardingRules()))

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    caches, logits = make_prefill_step(scfg, total, mesh=mesh)(params, _batch(tokens, mesh))
    if mesh is not None:
        plain = [{k: ({kk: full(vv) for kk, vv in v.items()} if isinstance(v, dict) else full(v))
                  for k, v in layer.items()} for layer in caches]
        caches = distribute_caches(scfg, plain, mesh, ShardingRules())
    out = [full(logits)[:, -1].numpy().copy()]
    step = make_serve_step(scfg, mesh=mesh)
    for i in range(MP_DECODE):
        token = out[-1].argmax(-1).astype(np.int32)[:, None]
        logits, caches = step(params, caches, _batch(token, mesh)["tokens"], MP_PREFILL + i)
        out.append(full(logits)[:, -1].numpy().copy())
    return np.stack(out)


def _cli(args) -> tuple[int | str, str]:
    """The train CLI in this rank: (exit code or the error raised, stdout)."""
    import contextlib
    import io

    from repro_torch.launch import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            rc = train.main(args)
        except ValueError as e:
            rc = f"ValueError: {e}"
    return rc, buf.getvalue()


def cli_losses(args) -> tuple[int | str, list]:
    """The train CLI in this process with fp32 compute (`reduced_config`
    in fp32): (exit code or the error raised, every step's loss unrounded,
    as the step returned it)."""
    from repro_torch.configs import reduced_config
    from repro_torch.launch import steps, train

    losses, make = [], steps.make_train_step

    def recording(*a, **kw):
        step = make(*a, **kw)

        def run(*sa):
            out = step(*sa)
            losses.append(float(out[2]["loss"]))
            return out

        return run

    steps.make_train_step = recording
    train.reduced_config = lambda name: dataclasses.replace(reduced_config(name), compute_dtype="float32")
    try:
        return _cli(args)[0], losses
    finally:
        steps.make_train_step, train.reduced_config = make, reduced_config


def _one_process_cli_losses(args, out_dir: Path) -> tuple:
    """`cli_losses(args)` in a process of its own, outside the group (no
    launcher environment): one process, the plain step."""
    out = out_dir / "one_process_cli.json"
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "GROUP_RANK", "ROLE_RANK",
                        "MASTER_ADDR", "MASTER_PORT")}
    r = subprocess.run([sys.executable, str(Path(__file__).resolve()), "cli_losses", str(out), *args],
                       env=env, cwd=str(REPO), capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        return f"exit {r.returncode}: {r.stderr[-500:]}", []
    rc, losses = json.loads(out.read_text())
    return rc, losses


def _route_drops(cfg) -> int:
    """Token-expert entries the one-process forward of the first batch
    drops at capacity, summed over layers and dispatch groups."""
    import torch

    from repro_torch.models import loss_fn
    from repro_torch.models.layers import moe_capacity
    from repro_torch.models.routes import record_routes

    params, _ = _laid_out(cfg, None)
    with torch.no_grad(), record_routes() as routes:
        loss_fn(cfg, params, _batch(mp_batches(cfg.vocab)[0], None))
    return sum(int((torch.bincount(r.experts.flatten(), minlength=cfg.n_experts)
                    - moe_capacity(cfg, r.experts.shape[0])).clamp_min(0).sum()) for r in routes)


def _moe(out: dict, checks: _Checks, mesh, out_dir: Path) -> None:
    """The MoE configs over the mesh against one process: steps, first
    gradients, prefill and decode; an SSM model's first gradients; then
    the MoE train CLI."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.configs import reduced_config

    rank = dist.get_rank()
    for arch in MOE_CONFIGS:
        cfg = moe_config(arch)
        losses, norms, params, live, _ = _mp_train(cfg, mesh)
        grads = _first_grads(cfg, mesh)
        decode_logits = _mp_decode(cfg, mesh)
        wi = live.get_submodule("blocks.0.moe").wi_e
        out[f"{arch}.losses"], out[f"{arch}.grad_norms"] = losses, norms
        out[f"{arch}.wi_e_placements"] = np.array(str(wi.placements))
        # E=8 splits over "model" (2); 3 experts do not, and ff does.
        want = 0 if cfg.n_experts % 2 == 0 else 2
        checks.add(f"{arch}.expert_weights_split_as_the_rules_say",
                   isinstance(wi, DTensor) and wi.placements[1] == Shard(want), wi.placements)
        if rank != 0:
            continue
        ref_losses, ref_norms, ref_params, _, _ = _mp_train(cfg, None)
        out[f"{arch}.one.losses"] = ref_losses
        checks.close(f"{arch}.loss_vs_one_process", losses, ref_losses)
        checks.close(f"{arch}.grad_norm_vs_one_process", norms, ref_norms)
        ref_grads = _first_grads(cfg, None)
        rel = {n: float(np.linalg.norm(grads[n] - g) / np.linalg.norm(g)) for n, g in ref_grads.items()}
        checks.add(f"{arch}.first_gradients_vs_one_process", max(rel.values()) <= 1e-5,
                   max(rel.items(), key=lambda kv: kv[1]))
        worst = max(float(np.max(np.abs(params[n] - ref_params[n]) - (1e-5 * np.abs(ref_params[n]) + 0.1 * MP_LR)))
                    for n in ref_params)
        checks.add(f"{arch}.params_vs_one_process", worst <= 0, f"worst excess over rtol 1e-5 + 0.1 lr: {worst}")
        ref_decode = _mp_decode(cfg, None)
        err = float(np.abs(decode_logits - ref_decode).max() / np.abs(ref_decode).max())
        checks.add(f"{arch}.prefill_and_decode_vs_one_process", err <= MP_DECODE_TOL
                   and np.array_equal(decode_logits.argmax(-1), ref_decode.argmax(-1)),
                   f"max abs error / max |logit|: {err}")
        drops = _route_drops(cfg)
        out[f"{arch}.dropped_entries"] = np.array(drops)
        checks.add(f"{arch}.capacity_drops_present", drops > 0, f"{drops} token-expert entries dropped")

    # The SSD scan runs on each rank's slab (`ssm._ssd`): its shared inputs'
    # gradients are partial sums over the ranks that split its output.
    cfg = dataclasses.replace(reduced_config(SSM_ARCH), compute_dtype="float32")
    grads = _first_grads(cfg, mesh)
    if rank == 0:
        ref_grads = _first_grads(cfg, None)
        rel = {n: float(np.linalg.norm(grads[n] - g) / np.linalg.norm(g)) for n, g in ref_grads.items()}
        checks.add(f"{SSM_ARCH}.first_gradients_vs_one_process", max(rel.values()) <= 1e-5,
                   max(rel.items(), key=lambda kv: kv[1]))

    # The train CLI over the mesh (one dispatch group, replicated) against
    # the same CLI in one process.
    rc, losses = cli_losses(MOE_CLI + ["--model-parallel", "2"])
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, rc)
    checks.add("moe_cli_runs_exit_0", every == [0] * len(every), every)
    if rank == 0:
        rc1, ref = _one_process_cli_losses(MOE_CLI, out_dir)
        out["moe_cli.losses"], out["moe_cli.one.losses"] = np.array(losses), np.array(ref)
        checks.add("moe_cli_one_process_exit_0", rc1 == 0, rc1)
        checks.close("moe_cli_losses_vs_one_process", np.array(losses), np.array(ref))
    dist.barrier()


def _leaf_files(step_dir: Path) -> dict:
    manifest = json.loads((step_dir / "manifest.json").read_text())
    return {e["name"]: np.load(step_dir / e["file"]) for e in manifest["leaves"]}


def _model_parallel(out: dict, checks: _Checks, out_dir: Path) -> None:
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import build_mesh

    rank = dist.get_rank()
    cfg = mp_config()
    mesh = build_mesh(2, "cpu")
    checks.add("mesh_is_data2_model2", mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (2, 2),
               mesh)
    t0 = time.perf_counter()
    losses, norms, params, live, opt = _mp_train(cfg, mesh)
    out["mp_step_s"] = np.array((time.perf_counter() - t0) / MP_STEPS)
    out["mp.losses"], out["mp.grad_norms"] = losses, norms
    wq = live.get_submodule("blocks.0.attn").wq
    checks.add("params_and_moments_are_dtensors",
               isinstance(wq, DTensor) and isinstance(opt["mu"]["blocks.0.attn.wq"], DTensor)
               and opt["mu"]["blocks.0.attn.wq"].placements == wq.placements, wq.placements)
    mb_losses = _mp_train(cfg, mesh, microbatches=2)[0]
    out["mp_mb2.losses"] = mb_losses
    checks.close("microbatches_2_vs_1_loss", mb_losses, losses, rtol=1e-4)

    # The CLI: 4 steps then a resume to 8, against 8 uninterrupted steps.
    a, b = out_dir / "cli_uninterrupted", out_dir / "cli_resumed"
    mp2 = MP_CLI + ["--model-parallel", "2"]
    rc_a, _ = _cli(mp2 + ["--steps", "8", "--ckpt-dir", str(a)])
    rc_b1, _ = _cli(mp2 + ["--steps", "4", "--ckpt-dir", str(b)])
    rc_b2, said = _cli(mp2 + ["--steps", "8", "--resume", "--ckpt-dir", str(b)])
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, said)
    checks.add("cli_runs_exit_0", (rc_a, rc_b1, rc_b2) == (0, 0, 0), (rc_a, rc_b1, rc_b2))
    checks.add("cli_resumed_from_step_4_on_rank_0_only",
               "resumed from step 4" in every[0] and '"step": 4,' in every[0]
               and '"step": 3,' not in every[0] and not any(every[1:]), [e[:200] for e in every])
    rc3, said3 = _cli(MP_CLI + ["--model-parallel", "3", "--steps", "1"])
    checks.add("cli_model_parallel_3_on_4_ranks_raises_before_a_step",
               isinstance(rc3, str) and "does not divide" in rc3 and '"step"' not in said3, (rc3, said3[:200]))

    # Serving over the mesh: a prefill, its caches laid out by
    # `cache_pspecs` (the sequence split over "model"), then decode steps.
    decode_logits = _mp_decode(cfg, mesh)

    # A checkpoint moves between mesh shapes: written at (2, 2), restored at
    # (4, 1) and written there, restored at (2, 2).
    grads = _first_grads(cfg, mesh)
    one = build_mesh(1, "cpu")
    c2, c1 = CheckpointManager(out_dir / "ckpt_mp2"), CheckpointManager(out_dir / "ckpt_mp1")
    c2.save(MP_STEPS, {"params": live, "opt": opt})
    live1, opt1 = _laid_out(cfg, one)
    tree1 = c2.restore(None, {"params": live1, "opt": opt1}, device="cpu")[0]
    live1.load_state_dict(tree1["params"])
    restored_1 = {**{"params." + n: a for n, a in _full_params(live1).items()},
                  **{"opt.mu." + n: t.full_tensor().numpy() for n, t in tree1["opt"]["mu"].items()}}
    layouts = [t.placements == live1.get_parameter(n).placements for n, t in tree1["params"].items()]
    c1.save(MP_STEPS, {"params": live1, "opt": tree1["opt"]})
    live2, opt2 = _laid_out(cfg, mesh)
    tree2 = c1.restore(None, {"params": live2, "opt": opt2}, device="cpu")[0]
    live2.load_state_dict(tree2["params"])
    restored_2 = {**{"params." + n: a for n, a in _full_params(live2).items()},
                  **{"opt.mu." + n: t.full_tensor().numpy() for n, t in tree2["opt"]["mu"].items()}}
    layouts += [t.placements == live2.get_parameter(n).placements for n, t in tree2["params"].items()]
    checks.add("restored_leaves_take_the_running_layout", all(layouts))
    _moe(out, checks, mesh, out_dir)
    if rank != 0:
        return

    # The one-process references, on rank 0 alone (no collective).
    ref_losses, ref_norms, ref_params, _, _ = _mp_train(cfg, None)
    out["one.losses"], out["one.grad_norms"] = ref_losses, ref_norms
    checks.close("loss_vs_one_process", losses, ref_losses)
    checks.close("grad_norm_vs_one_process", norms, ref_norms)
    ref_decode = _mp_decode(cfg, None)
    err = float(np.abs(decode_logits - ref_decode).max() / np.abs(ref_decode).max())
    checks.add("prefill_and_decode_vs_one_process", err <= MP_DECODE_TOL
               and np.array_equal(decode_logits.argmax(-1), ref_decode.argmax(-1)),
               f"max abs error / max |logit|: {err}")
    ref_grads = _first_grads(cfg, None)
    rel = {n: float(np.linalg.norm(grads[n] - g) / np.linalg.norm(g)) for n, g in ref_grads.items()}
    checks.add("first_gradients_vs_one_process", max(rel.values()) <= 1e-5, max(rel.items(), key=lambda kv: kv[1]))
    # 0.1 lr: a step-1 gradient within its reorder error of AdamW's eps
    # (blocks.0.mlp.wo[195, 92]: 2.8e-9 against 4.6e-9) moves by a
    # fraction of lr, ROADMAP section 3's AdamW-near-eps rule.
    worst = max(float(np.max(np.abs(params[n] - ref_params[n]) - (1e-5 * np.abs(ref_params[n]) + 0.1 * MP_LR)))
                for n in ref_params)
    checks.add("params_vs_one_process", worst <= 0, f"worst excess over rtol 1e-5 + 0.1 lr: {worst}")
    fa, fb = _leaf_files(a / "step_00000008"), _leaf_files(b / "step_00000008")
    checks.add("cli_resume_bitwise_uninterrupted",
               fa.keys() == fb.keys() and all(np.array_equal(fa[k], fb[k]) for k in fa),
               [k for k in fa if not np.array_equal(fa[k], fb.get(k))][:5])
    saved2 = _leaf_files(out_dir / "ckpt_mp2" / f"step_{MP_STEPS:08d}")
    saved1 = _leaf_files(out_dir / "ckpt_mp1" / f"step_{MP_STEPS:08d}")
    checks.add("ckpt_mp2_restores_under_mp1_bitwise", all(np.array_equal(v, saved2[k]) for k, v in restored_1.items()))
    checks.add("ckpt_mp1_restores_under_mp2_bitwise", all(np.array_equal(v, saved1[k]) for k, v in restored_2.items())
               and saved1.keys() == saved2.keys()
               and all(np.array_equal(saved1[k], saved2[k]) for k in saved1))


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
    if what == "model_parallel":
        _model_parallel(out, checks, Path(out_dir))
    else:
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
    if sys.argv[1] == "cli_losses":  # cli_losses OUT_JSON CLI_ARGS...
        Path(sys.argv[2]).write_text(json.dumps(cli_losses(sys.argv[3:])))
        sys.exit(0)
    if sys.argv[1] == "reference":
        ref = {}
        for what in REFERENCE_KEYS:
            with np.load(Path(sys.argv[2]) / f"{what}.npz") as z:
                ref[what] = reference_of(what, {k: z[k] for k in z.files})
        REFERENCE.write_text(json.dumps(ref) + "\n")
        sys.exit(0)
    sys.exit(rank_main(sys.argv[1], sys.argv[2]))
