"""The port's dry run (`repro_torch.launch.dryrun`) against the JAX
package's (`repro.launch.dryrun`, `hlo_cost`, `steps`, `distributed/
sharding.py`): the flash kernel as a dispatcher op (fake shapes, FLOP
formula, autograd), the input specs and partition specs of every
applicable (arch, shape, mesh) cell, the per-device argument bytes, the
FLOP count of one train step, the layer scaling of the op-level count and
the CLI.

On a mesh of more than one device the dry run also traces the step on
DTensors under a `fake` process group (`launch.mesh.fake_mesh`): its
per-device FLOPs, collectives and temporaries are held to analytic
counts on hand-built layouts and beside JAX's record of the same cell.

FLOPs. JAX costs the compiled HLO (`hlo_cost.analyze`); the port counts the
ops it dispatches (`op_cost`, FlopCounterMode's formulas). On the CPU the
port's attention is the plain call, differentiated by autograd, and its
count equals JAX's exactly. On `meta` (the dry run) and on the card the
attention is the flash op, whose backward recomputes the forward's scores:
4 * B * H * Sq * Sk * D more a call, exactly.

`repro.launch.dryrun` sets XLA_FLAGS when imported (512 host devices), so
this file never imports it; the JAX side's partition specs run on
`jax.sharding.AbstractMesh`, and its per-device bytes are its
`_sharded_arg_bytes` arithmetic, written out below.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

import _torch_bridge  # noqa: F401  (pins torch to one CPU thread)
from repro.configs import get_config as j_get_config
from repro.distributed import sharding as j_sharding
from repro.launch import hlo_cost
from repro.launch import steps as J_St
from repro.models.config import SHAPES as J_SHAPES
from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.distributed import sharding as t_sharding
from repro_torch.kernels.flash_attention import attention_chunked, attention_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import dryrun, op_cost
from repro_torch.launch import steps as St
from repro_torch.launch.mesh import MeshShape, fake_mesh, make_debug_mesh, make_production_mesh
from repro_torch.models import init_params
from repro_torch.models.config import SHAPES, shape_applicable
from repro_torch.models.model import ParamTree
from repro_torch.models.quant import STACKED

ROOT = Path(__file__).resolve().parents[1]
META = torch.device("meta")
CELLS = [(a, s) for a in ARCHS for s in SHAPES if shape_applicable(get_config(a), SHAPES[s])[0]]
MESHES = {False: AbstractMesh((16, 16), ("data", "model")),
          True: AbstractMesh((2, 16, 16), ("pod", "data", "model"))}


def _flops(fn, *args, **kwargs) -> int:
    with FlopCounterMode(display=False) as fc:
        fn(*args, **kwargs)
    return fc.get_total_flops()


# ---------------------------------------------------------------------------
# the flash kernel as a dispatcher op
# ---------------------------------------------------------------------------
# (B, H, Kv, Sq, Sk, D, causal, window): both sides of the 2048^2 score
# threshold of the plain route, causal and windowed, GQA.
FLASH_CASES = [
    (2, 4, 2, 64, 64, 32, True, None),
    (1, 8, 2, 48, 80, 64, False, None),
    (2, 4, 4, 128, 128, 16, True, 24),
    (1, 4, 1, 2048, 2048, 64, True, None),
    (1, 8, 2, 3072, 2048, 64, True, 512),
    (1, 2, 1, 4096, 1536, 128, False, None),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_op_fake_shapes_and_flop_formula(case):
    """On `meta` the op returns q's shape, dtype and layout (a transposed
    [B, S, H, D] view stays one) and counts its formula, which equals the
    plain route's count: `attention_ref` up to 2048^2 scores, the streaming
    `attention_chunked` above."""
    b, h, kv, sq, sk, d, causal, window = case
    q = torch.empty(b, sq, h, d, dtype=torch.bfloat16, device=META).transpose(1, 2)
    k = torch.empty(b, kv, sk, d, dtype=torch.bfloat16, device=META)
    kw = dict(causal=causal, window=window)
    out = fa_ops.flash_attention(q, k, k, **kw)
    assert (out.shape, out.dtype, out.stride(), out.device) == (q.shape, q.dtype, q.stride(), META)
    plain = attention_ref if sq * sk <= fa_ops._CHUNKED_THRESHOLD else attention_chunked
    want = _flops(plain, q, k, k, **kw)
    assert want == 4 * b * h * sq * sk * d
    assert _flops(fa_ops.flash_attention, q, k, k, **kw) == want
    assert fa_ops.flash_attention_flop(q.shape, k.shape) == want


def test_flash_op_autograd_is_the_plain_backward(monkeypatch):
    """The op's registered autograd on CPU tensors (its implementation there
    stood in by the plain function the kernel computes) gives
    `flash_attention_backward`'s gradients bitwise; on `meta` the backward
    counts the recompute plus the two products' gradients,
    12 * B * H * Sq * Sk * D."""
    monkeypatch.setattr(fa_ops, "_plain", lambda q, k, v, c, w, off: fa_ops._attention_rows(q, k, v, c, w, off))
    rng = np.random.RandomState(0)
    b, h, kv, sq, sk, d = 2, 4, 2, 24, 24, 16
    q0, k0, v0, do = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                      for s in ((b, h, sq, d), (b, kv, sk, d), (b, kv, sk, d), (b, h, sq, d)))
    q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
    out = torch.ops.repro_torch.flash_attention(q, k, v, True, 8, 3)
    out.backward(do)
    want = fa_ops.flash_attention_backward(q0, k0, v0, do, causal=True, window=8, q_offset=3)
    for got, w in zip((q.grad, k.grad, v.grad), want, strict=True):
        assert torch.equal(got, w)
    qm, km = (torch.empty(t.shape, device=META, requires_grad=True) for t in (q0, k0))
    om = fa_ops.flash_attention(qm, km, km, window=8)
    assert _flops(om.backward, torch.empty(om.shape, device=META)) == 12 * b * h * sq * sk * d


# ---------------------------------------------------------------------------
# input specs and partition specs against JAX's, every applicable cell
# ---------------------------------------------------------------------------
def _jax_leaves(tree) -> dict:
    """{JAX path ("blocks/attn/wq"): leaf} of a JAX tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf for path, leaf in flat}


def _paths(tree, prefix="") -> dict:
    """{path: leaf} of the port's nested dicts (a partition spec, a tuple,
    is a leaf)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    return {p: leaf for k, v in tree.items() for p, leaf in _paths(v, f"{prefix}/{k}" if prefix else k).items()}


def _port_params_stacked(named: dict, n_layers: dict) -> dict:
    """{JAX path: [per-layer values]} of the port's {name: value}, layer
    stacks keyed without the layer index, in layer order."""
    out: dict = {}
    for name, value in named.items():
        parts = name.split(".")
        key = "/".join([parts[0], *parts[2:]]) if parts[0] in n_layers else "/".join(parts)
        out.setdefault(key, []).append(value)
    return out


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def _check_params(t_params, j_params):
    n_layers = {name: len(m) for name, m in t_params.named_children() if name in STACKED}
    got = _port_params_stacked(dict(t_params.named_parameters()), n_layers)
    want = _jax_leaves(j_params)
    assert got.keys() == want.keys()
    for path, leaves in got.items():
        stacked = path.split("/")[0] in n_layers
        assert len(leaves) == (n_layers[path.split("/")[0]] if stacked else 1), path
        assert len({(tuple(t.shape), t.dtype) for t in leaves}) == 1, path
        shape = (len(leaves), *leaves[0].shape) if stacked else tuple(leaves[0].shape)
        assert (shape, _dtype_name(leaves[0].dtype)) == (tuple(want[path].shape), want[path].dtype.name), path
        assert leaves[0].device == META


def _check_caches(t_caches, j_caches):
    want = _jax_leaves(j_caches)
    for l, layer in enumerate(t_caches):
        got = _paths(layer)
        assert got.keys() == want.keys()
        for path, t in got.items():
            assert ((len(t_caches), *t.shape), _dtype_name(t.dtype)) == (tuple(want[path].shape),
                                                                          want[path].dtype.name), (l, path)


def _j_cfg(arch, shape):
    cfg = j_get_config(arch)
    return cfg if J_SHAPES[shape].kind == "train" else J_St.serve_config(cfg)


def _t_cfg(arch, shape):
    cfg = get_config(arch)
    return cfg if SHAPES[shape].kind == "train" else St.serve_config(cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_jax(arch):
    """batch/param/opt/cache specs, shape for shape and dtype for dtype, at
    every applicable shape of the arch (train: the config's params and
    AdamW state; prefill and decode: the serving config's, also int8)."""
    for shape in (s for a, s in CELLS if a == arch):
        tc, jc = _t_cfg(arch, shape), _j_cfg(arch, shape)
        batch = St.batch_specs(tc, SHAPES[shape])
        jbatch = J_St.batch_specs(jc, J_SHAPES[shape])
        assert {k: (tuple(t.shape), _dtype_name(t.dtype)) for k, t in batch.items()} == \
            {k: (tuple(t.shape), t.dtype.name) for k, t in jbatch.items()}
        if SHAPES[shape].kind == "decode":
            _check_caches(St.cache_specs(tc, SHAPES[shape]), J_St.cache_specs(jc, J_SHAPES[shape]))
    cfg, jcfg = get_config(arch), j_get_config(arch)
    _check_params(St.param_specs(cfg), J_St.param_specs(jcfg))
    opt, jopt = St.opt_specs(cfg), J_St.opt_specs(jcfg)
    assert (tuple(opt["step"].shape), opt["step"].dtype) == ((), torch.int32) and jopt["step"].dtype.name == "int32"
    for moment in ("mu", "nu"):
        _check_params(ParamTree(_nest(opt[moment])), jopt[moment])
    for quant in (False, True):
        scfg = dataclasses.replace(St.serve_config(cfg), quantize_int8=quant)
        sj = dataclasses.replace(J_St.serve_config(jcfg), quantize_int8=quant)
        _check_params(St.param_specs(scfg), J_St.param_specs(sj))


def _nest(named: dict) -> dict:
    """{dotted name: tensor} as the nested dict a `ParamTree` takes."""
    tree: dict = {}
    for name, t in named.items():
        *path, leaf = name.split(".")
        d = tree
        for k in path:
            d = d.setdefault(k, {})
        d[leaf] = t
    for name in STACKED:
        if name in tree:
            tree[name] = [tree[name][str(l)] for l in range(len(tree[name]))]
    return tree


def _j_spec(spec, stacked: bool) -> tuple:
    spec = tuple(spec)
    return (spec[1:] if spec else ()) if stacked else spec


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_partition_specs_and_argument_bytes_match_jax(multi_pod):
    """`param_pspecs`, `cache_pspecs` and `batch_pspec_for` equal JAX's
    (specs of layer stacks without their layer entry), and the dry run's
    per-device argument bytes equal JAX's `_sharded_arg_bytes` arithmetic
    exactly, in every applicable cell on the production mesh."""
    jmesh, tmesh = MESHES[multi_pod], make_production_mesh(multi_pod=multi_pod)
    assert dict(jmesh.shape) == tmesh.shape
    jrules = j_sharding.ShardingRules(pod_axis="pod" if multi_pod else None)
    trules = t_sharding.ShardingRules(pod_axis="pod" if multi_pod else None)
    for arch, shape in CELLS:
        sh, jsh = SHAPES[shape], J_SHAPES[shape]
        jc = _j_cfg(arch, shape)
        step, arg_specs, arg_pspecs = dryrun.build_cell(arch, shape, tmesh, trules)
        jp = J_St.param_specs(jc)
        jp_sh = j_sharding.param_pspecs(jc, jp, jmesh, jrules)
        got = _port_params_stacked(arg_pspecs[0], {n: 0 for n in STACKED})
        for path, spec in _jax_leaves(jp_sh).items():
            want = _j_spec(spec, path.split("/")[0] in STACKED)
            assert all(s == want for s in got[path]), (arch, shape, path, got[path][0], want)
        jb = j_sharding.batch_pspec_for(jmesh, jrules, jsh.global_batch)
        assert t_sharding.batch_pspec_for(tmesh, trules, sh.global_batch) == tuple(jb)
        if sh.kind == "train":
            jargs = (jp, J_St.opt_specs(jc), J_St.batch_specs(jc, jsh))
            jsh_args = (jp_sh, {"mu": jp_sh, "nu": jp_sh, "step": P()}, jax.tree.map(lambda _: jb, jargs[2]))
        elif sh.kind == "prefill":
            jargs = (jp, J_St.batch_specs(jc, jsh))
            jsh_args = (jp_sh, jax.tree.map(lambda _: jb, jargs[1]))
        else:
            jc_specs = J_St.cache_specs(jc, jsh)
            jc_sh = j_sharding.cache_pspecs(jc, jc_specs, jmesh, jrules)
            for layer in arg_pspecs[1]:
                assert _paths(layer) == {p: _j_spec(s, True) for p, s in _jax_leaves(jc_sh).items()}, (arch, shape)
            jargs = (jp, jc_specs, jax.ShapeDtypeStruct((jsh.global_batch, 1), "int32"),
                     jax.ShapeDtypeStruct((), "int32"))
            jsh_args = (jp_sh, jc_sh, jb, P())
        want = _j_sharded_arg_bytes(jargs, jsh_args, jmesh)
        got_bytes = dryrun._sharded_arg_bytes(arg_specs, arg_pspecs, tmesh)
        assert got_bytes == want and round(got_bytes / 2**30, 3) == round(want / 2**30, 3), (arch, shape)


def _j_sharded_arg_bytes(arg_specs, arg_pspecs, mesh) -> float:
    """JAX's `repro.launch.dryrun._sharded_arg_bytes`, on partition specs
    in place of the NamedShardings that wrap them."""
    total = 0.0
    specs = jax.tree_util.tree_leaves(arg_specs)
    pspecs = jax.tree_util.tree_leaves(arg_pspecs, is_leaf=lambda x: isinstance(x, P))
    for spec, ps in zip(specs, pspecs, strict=True):
        n = int(np.prod(spec.shape)) if spec.shape else 1
        shards = 1
        for axis in jax.tree_util.tree_leaves(tuple(ps)):
            shards *= mesh.shape[axis]
        total += n * spec.dtype.itemsize / shards
    return total


# ---------------------------------------------------------------------------
# FLOPs of one train step: qwen1.5-0.5b at 4 layers, 4 x 512 tokens
# ---------------------------------------------------------------------------
JAX_TRAIN_FLOPS = 2_590_963_138_560  # hlo_cost.analyze of JAX's step (tests/test_dryrun.py's cell)


def _fake_cpu_tree(module) -> dict:
    out = {n: torch.empty(p.shape, dtype=p.dtype) for n, p in module.named_parameters(recurse=False)}
    for n, c in module.named_children():
        out[n] = [_fake_cpu_tree(l) for l in c] if isinstance(c, torch.nn.ModuleList) else _fake_cpu_tree(c)
    return out


def _cpu_step_flops(cfg, shape, *, fake: bool) -> int:
    """FlopCounterMode over one train step on CPU tensors: real ones, or
    FakeTensorMode's (the same ops dispatched, nothing computed)."""
    step = St.make_train_step(cfg)
    b = St.batch_specs(cfg, shape)
    if not fake:
        params = init_params(cfg, 0, device="cpu")
        opt = {"mu": {n: torch.zeros(p.shape) for n, p in params.named_parameters()},
               "nu": {n: torch.zeros(p.shape) for n, p in params.named_parameters()},
               "step": torch.zeros((), dtype=torch.int32)}
        batch = {k: torch.randint(0, cfg.vocab, v.shape, dtype=v.dtype) for k, v in b.items()}
        return _flops(step, params, opt, batch)
    with FakeTensorMode():
        params = ParamTree(_fake_cpu_tree(St.param_specs(cfg)))
        opt = {"mu": {n: torch.empty(p.shape) for n, p in params.named_parameters()},
               "nu": {n: torch.empty(p.shape) for n, p in params.named_parameters()},
               "step": torch.zeros((), dtype=torch.int32)}
        batch = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in b.items()}
        return _flops(step, params, opt, batch)


def test_train_step_flops_match_jax():
    """The port's CPU count of the step equals JAX's `hlo_cost` count of
    the compiled step exactly; the dry run's `meta` count equals it plus
    the flash backward's recompute, 4 * B * H * Sq * Sk * D for each of the
    4 layers; both lie within 0.5-2x of 6 * N * D, as JAX's test asks. The
    CPU count runs on fake CPU tensors; at the reduced width a real CPU
    step counts the same as a fake one."""
    small = dataclasses.replace(reduced_config("qwen1.5-0.5b"), remat=False)
    small_shape = dataclasses.replace(SHAPES["train_4k"], global_batch=2, seq_len=32)
    assert _cpu_step_flops(small, small_shape, fake=False) == _cpu_step_flops(small, small_shape, fake=True)

    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"), remat=False, n_layers=4)
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=4, seq_len=512)
    jcfg = dataclasses.replace(j_get_config("qwen1.5-0.5b"), remat=False, n_layers=4)
    jshape = dataclasses.replace(J_SHAPES["train_4k"], global_batch=4, seq_len=512)
    hlo = jax.jit(J_St.make_train_step(jcfg)).lower(
        J_St.param_specs(jcfg), J_St.opt_specs(jcfg), J_St.batch_specs(jcfg, jshape)).compile().as_text()
    assert hlo_cost.analyze(hlo)["flops"] == JAX_TRAIN_FLOPS

    cpu = _cpu_step_flops(cfg, shape, fake=True)
    assert cpu == JAX_TRAIN_FLOPS
    meta = op_cost.analyze(St.make_train_step(cfg), St.param_specs(cfg), St.opt_specs(cfg),
                           St.batch_specs(cfg, shape))["flops"]
    recompute = 4 * shape.global_batch * cfg.n_heads * shape.seq_len**2 * cfg.head_dim * cfg.n_layers
    assert recompute == 17_179_869_184
    assert meta == cpu + recompute == 2_608_143_007_744
    analytic = 6.0 * cfg.n_active_params() * shape.global_batch * shape.seq_len
    assert 0.5 < cpu / analytic < 2.0 and 0.5 < meta / analytic < 2.0


@pytest.mark.parametrize("kind", ["train_4k", "prefill_32k", "decode_32k"])
def test_op_cost_scales_with_layers(kind):
    """No loop trip count to scale (the layers are a Python loop): 4 layers
    minus 2 count exactly twice one layer (2 minus 1), FLOPs and bytes,
    train with remat, prefill and decode (the replacement of JAX's
    `test_scan_trip_scaling`)."""
    shape = dataclasses.replace(SHAPES[kind], global_batch=2, seq_len=64)
    costs = {}
    for n in (1, 2, 4):
        cfg = dataclasses.replace(reduced_config("qwen1.5-0.5b"), n_layers=n, remat=True)
        if shape.kind == "train":
            args = (St.make_train_step(cfg), St.param_specs(cfg), St.opt_specs(cfg), St.batch_specs(cfg, shape))
        elif shape.kind == "prefill":
            cfg = St.serve_config(cfg)
            args = (St.make_prefill_step(cfg, shape.seq_len), St.param_specs(cfg), St.batch_specs(cfg, shape))
        else:
            cfg = St.serve_config(cfg)
            step = St.make_serve_step(cfg)
            args = (lambda p, c, t: step(p, c, t, shape.seq_len - 1), St.param_specs(cfg),
                    St.cache_specs(cfg, shape), St.batch_specs(cfg, shape)["token"])
        r = op_cost.analyze(*args)
        costs[n] = (r["flops"], r["bytes"])
    for i in range(2):
        assert costs[4][i] - costs[2][i] == 2 * (costs[2][i] - costs[1][i]) > 0


def test_op_cost_peak_follows_storage():
    """Live storage rises with each new storage and falls when the last
    tensor holding it (a view, or autograd's saved copy) goes."""
    x = torch.empty(256, device=META, requires_grad=True)  # 1 KiB, the argument

    def step(x):
        a = x * 2  # 1 KiB; the product below saves it (through the view) for its backward
        view = a.view(16, 16)  # no new storage
        y = (view * view).sum()  # the product, 1 KiB, lives until the sum's 4 bytes exist
        del a, view
        return y, (x * 3).sum()  # a is still held by the graph: x * 3 finds 3 KiB + 4 B live

    r = op_cost.analyze(step, x)
    assert r["peak_bytes"] == 3 * 1024 + 4 + 4
    assert r["flops"] == 0 and r["collectives"] == {}


# ---------------------------------------------------------------------------
# the CLI and the matrix's skips
# ---------------------------------------------------------------------------
def test_dryrun_cli_writes_only_its_own_results(tmp_path):
    out = tmp_path / "results" / "dryrun_torch"
    jax_results = ROOT / "results" / "dryrun"
    before = sorted(jax_results.glob("*")) if jax_results.exists() else []
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen1.5-0.5b",
                        "--shape", "decode_32k", "--tag", "citest", "--out-dir", str(out)],
                       env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-1500:]
    assert "OK " in r.stdout and "1 ok, 0 skipped, 0 errors" in r.stdout
    rec = json.loads((out / "qwen1.5-0.5b__decode_32k__16x16-citest.json").read_text())
    assert [f.name for f in out.iterdir()] == ["qwen1.5-0.5b__decode_32k__16x16-citest.json"]
    assert rec["status"] == "ok" and rec["n_devices"] == 256 and rec["flops"] > 0
    # Per device on the 16x16 mesh: collectives by JAX's kind names, temporaries, FLOPs.
    assert set(rec["collective_bytes"]) <= set(op_cost._COLLECTIVES.values())
    assert rec["collective_bytes"]["all-gather"] > 0 and rec["collective_bytes"]["all-reduce"] > 0
    assert rec["memory"]["temp_bytes"] > 0 and rec["memory"]["argument_bytes"] > 0
    assert 0 < rec["flops_per_device"] < rec["flops"]
    assert (sorted(jax_results.glob("*")) if jax_results.exists() else []) == before
    assert not (tmp_path / "results" / "dryrun").exists()
    assert dryrun.RESULTS_DIR == ROOT / "results" / "dryrun_torch"


def test_dryrun_skips_match_design():
    """long_500k runs exactly the sub-quadratic archs, as JAX's dry run.
    On the 16x16 mesh every one of them, the MoE arch included, also runs
    its DTensor trace: no ok cell records a mesh error."""
    recs = {a: dryrun.run_cell(a, "long_500k", save=False) for a in ARCHS}
    assert {a for a, r in recs.items() if r["status"] == "ok"} == {"mamba2-370m", "hymba-1.5b", "mixtral-8x22b"}
    assert {a for a, r in recs.items() if r["status"] == "skipped"} == set(ARCHS) - {
        "mamba2-370m", "hymba-1.5b", "mixtral-8x22b"}
    for a, r in recs.items():
        if r["status"] == "ok":
            assert "mesh_error" not in r, (a, r.get("mesh_error"))
            assert r["flops"] > 0 and r["flops_per_device"] > 0, a


def test_one_device_mesh_records_temp_bytes():
    """On the one-device debug mesh the record carries temp_bytes, the
    step's peak less its arguments; the debug mesh spans JAX's 512 fake
    host devices by default."""
    assert make_debug_mesh().shape == {"data": 256, "model": 2}
    assert make_debug_mesh(multi_pod=True).shape == {"pod": 2, "data": 128, "model": 2}
    mesh = make_debug_mesh(n_devices=1, model=1)
    rec = dryrun.run_cell("qwen1.5-0.5b", dataclasses.replace(SHAPES["decode_32k"], global_batch=2, seq_len=256),
                          mesh=mesh, save=False)
    assert rec["status"] == "ok" and rec["mesh"] == "1x1" and rec["n_devices"] == 1
    mem = rec["memory"]
    assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"] > 0


# ---------------------------------------------------------------------------
# per-device counts under a fake process group (model parallelism)
# ---------------------------------------------------------------------------
def test_collective_bytes_of_hand_built_layouts():
    """Result bytes by JAX's kind, exactly, on a (data=4, model=2) fake
    mesh on `meta`: an FSDP all-gather of a [d, ff] weight split on d over
    data (and on ff over model); a row-parallel matmul, whose partial sum
    over model is all-reduced; a redistribute from Shard(1) to Shard(0)
    over model, which DTensor on a CPU mesh runs as all-gather + chunk."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    d, ff, b = 64, 96, 16
    with fake_mesh(MeshShape(("data", "model"), (4, 2))) as mesh:
        def laid(shape, placements):
            return distribute_tensor(torch.empty(shape, device=META), mesh, placements, src_data_rank=None)

        w = laid((d, ff), [Shard(0), Shard(1)])
        r = op_cost.analyze(lambda w: w.redistribute(mesh, [Replicate(), Shard(1)]), w)
        assert r["collectives"] == {"all-gather": d * (ff // 2) * 4}
        x, w2 = laid((b, ff), [Shard(0), Shard(1)]), laid((ff, d), [Replicate(), Shard(0)])
        r = op_cost.analyze(lambda x, w: (x @ w).redistribute(mesh, [Shard(0), Replicate()]), x, w2)
        assert r["collectives"] == {"all-reduce": (b // 4) * d * 4}
        assert r["flops"] == 2 * (b // 4) * (ff // 2) * d  # one rank's product
        t = laid((d, ff), [Replicate(), Shard(1)])
        r = op_cost.analyze(lambda t: t.redistribute(mesh, [Replicate(), Shard(0)]), t)
        assert r["collectives"] == {"all-gather": d * ff * 4}
    assert not dist.is_initialized()


@pytest.mark.parametrize("kv", [1, 2])
def test_flash_sharding_rule_keeps_the_gqa_grouping(monkeypatch, kv):
    """H=4 query heads split over model=2 beside Kv kv heads: with Kv=1
    (kv heads replicated) the op never runs on split query heads, with
    Kv=2 both split; every local call keeps H_local / Kv_local = H / Kv."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    seen = []
    check = fa_ops._check

    def spy(q, k, v, window, q_offset, *, on_device=True):
        if not isinstance(q, FakeTensor):  # a rank's local call, not DTensor's global shape propagation
            seen.append((q.shape[1], k.shape[1]))
        return check(q, k, v, window, q_offset, on_device=on_device)

    monkeypatch.setattr(fa_ops, "_check", spy)
    b, h, s, dh = 8, 4, 32, 16
    with fake_mesh(MeshShape(("data", "model"), (4, 2))) as mesh:
        q = distribute_tensor(torch.empty(b, h, s, dh, dtype=torch.bfloat16, device=META), mesh,
                              [Shard(0), Shard(1)], src_data_rank=None)
        k = distribute_tensor(torch.empty(b, kv, s, dh, dtype=torch.bfloat16, device=META), mesh,
                              [Shard(0), Shard(1) if kv == 2 else Replicate()], src_data_rank=None)
        out = fa_ops.flash_attention(q, k, k)
    assert out.shape == q.shape
    assert seen and all(hl * kv == h * kl for hl, kl in seen), seen
    assert out.placements == ((Shard(0), Shard(1)) if kv == 2 else (Shard(0), Replicate()))
    assert all(hl == (h // 2 if kv == 2 else h) for hl, _ in seen)
    assert fa_ops._heads_split_ok(4, 1, (4, 2)) is False and fa_ops._heads_split_ok(4, 2, (4, 2)) is True


def test_fake_mesh_leaves_no_process_group(monkeypatch):
    """The fake group is gone after a cell, also after a cell whose DTensor
    trace fails (forced here in a dense cell: the decode query's layout
    step raises DTensor's error for an op without a sharding rule): that
    cell keeps its global numbers, its per-device ones are null, and the
    error names the op. A second group is refused."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models import layers

    shape = dataclasses.replace(SHAPES["decode_32k"], global_batch=32, seq_len=256)
    ok = dryrun.run_cell("qwen1.5-0.5b", shape, save=False)
    assert ok["status"] == "ok" and not dist.is_initialized()
    assert "mesh_error" not in ok and ok["flops_per_device"] > 0

    def no_rule(x, like, dims):
        if isinstance(x, DTensor):
            raise NotImplementedError("Operator aten.searchsorted.Tensor does not have a sharding strategy registered.")
        return x

    monkeypatch.setattr(layers, "match_layout", no_rule)
    bad = dryrun.run_cell("qwen1.5-0.5b", shape, save=False)
    assert bad["status"] == "ok" and not dist.is_initialized()
    assert dryrun.missing_rule(bad["mesh_error"]) == "aten.searchsorted.Tensor"
    assert bad["flops"] == ok["flops"] and bad["flops_per_device"] is None and bad["collective_bytes"] is None
    assert bad["memory"]["temp_bytes"] is None and bad["memory"]["argument_bytes"] == ok["memory"]["argument_bytes"]
    with fake_mesh(MeshShape(("data", "model"), (2, 2))):
        with pytest.raises(RuntimeError, match="already initialised"):
            with fake_mesh(MeshShape(("data", "model"), (2, 2))):
                pass
    assert not dist.is_initialized()


MESH_CELLS = [(shape, multi_pod) for shape in ("train_4k", "prefill_32k", "decode_32k") for multi_pod in (False, True)]
MOE_MESH_CELLS = [("qwen2-moe-a2.7b", "train_4k"), ("qwen2-moe-a2.7b", "prefill_32k"),
                  ("qwen2-moe-a2.7b", "decode_32k"), ("mixtral-8x22b", "decode_32k")]

_JAX_CELLS = r"""
import json, sys
from repro.launch import dryrun
for arch, shape, multi_pod in json.loads(sys.argv[1]):
    r = dryrun.run_cell(arch, shape, multi_pod=multi_pod, save=False)
    print(json.dumps({k: r.get(k) for k in ("status", "hlo_flops", "collective_bytes", "memory",
                                              "per_device_argument_gib", "n_devices")}), flush=True)
"""


@pytest.fixture(scope="module")
def jax_mesh_records(tmp_path_factory):
    """JAX's records of `MESH_CELLS` (qwen1.5-0.5b) and `MOE_MESH_CELLS`
    (16x16), keyed (arch, shape, multi_pod) (`repro.launch.dryrun.run_cell`,
    which sets XLA_FLAGS when imported), in one process of their own."""
    cells = ([("qwen1.5-0.5b", shape, mp) for shape, mp in MESH_CELLS]
             + [(arch, shape, False) for arch, shape in MOE_MESH_CELLS])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _JAX_CELLS, json.dumps(cells)], env=env, capture_output=True,
                       text=True, timeout=600, cwd=tmp_path_factory.mktemp("jax_dryrun"))
    assert r.returncode == 0, r.stderr[-2000:]
    recs = [json.loads(line) for line in r.stdout.splitlines() if line.startswith("{")]
    return dict(zip(map(tuple, cells), recs, strict=True))


@pytest.mark.parametrize("shape,multi_pod", MESH_CELLS)
def test_mesh_record_beside_jax(jax_mesh_records, shape, multi_pod):
    """qwen1.5-0.5b on 16x16 and 2x16x16, the port's record beside JAX's,
    both printed (PERF.md's table of the mesh cells is built from them):
    every collective kind nonzero in JAX's among all-gather and all-reduce
    is nonzero in the port's; per-device argument bytes are equal; the
    per-device FLOPs times the devices cover the global count (no work
    lost), come to no more than JAX's per-device HLO FLOPs and equal them
    on decode; the port's per-device temporaries are no more than JAX's.
    The port's per-device numbers are DTensor's layouts, not the SPMD
    partitioner's (PERF.md, open questions)."""
    jrec = jax_mesh_records[("qwen1.5-0.5b", shape, multi_pod)]
    rec = dryrun.run_cell("qwen1.5-0.5b", shape, multi_pod=multi_pod, save=False)
    print("port", json.dumps({k: rec.get(k) for k in ("mesh", "flops", "flops_per_device", "collective_bytes",
                                                      "memory")}))
    print("jax ", json.dumps(jrec))
    assert rec["status"] == jrec["status"] == "ok" and "mesh_error" not in rec
    assert rec["n_devices"] == jrec["n_devices"] == (512 if multi_pod else 256)
    for kind in ("all-gather", "all-reduce"):
        if jrec["collective_bytes"].get(kind, 0) > 0:
            assert rec["collective_bytes"].get(kind, 0) > 0, kind
    assert rec["memory"]["argument_bytes"] == jrec["memory"]["argument_bytes"]
    assert rec["per_device_argument_gib"] == jrec["per_device_argument_gib"]
    assert rec["flops_per_device"] * rec["n_devices"] >= rec["flops"]
    assert rec["flops_per_device"] <= jrec["hlo_flops"]
    if shape == "decode_32k":
        assert rec["flops_per_device"] == jrec["hlo_flops"]  # one rank's products, as the partitioned HLO's
    assert 0 < rec["memory"]["temp_bytes"] <= jrec["memory"]["temp_bytes"]


@pytest.mark.parametrize("arch,shape", MOE_MESH_CELLS)
def test_moe_mesh_record_beside_jax(jax_mesh_records, arch, shape):
    """The MoE cells on 16x16, the port's record beside JAX's, both printed
    (PERF.md's table of the MoE mesh cells is built from them). Each rank
    dispatches its own token groups and runs the expert products in the
    parameter rules' layouts (`layers._moe_on_mesh`): the trace runs, the
    per-device argument bytes are JAX's, the per-device FLOPs times the
    devices cover the global count and come to no more than JAX's
    per-device HLO FLOPs, within 1% above them on decode (each model rank
    computes its groups' router product whole, where JAX splits it), the
    temporaries are no more than JAX's, and every collective kind nonzero
    in JAX's among all-gather and all-reduce is nonzero in the port's."""
    jrec = jax_mesh_records[(arch, shape, False)]
    rec = dryrun.run_cell(arch, shape, save=False)
    print("port", json.dumps({k: rec.get(k) for k in ("arch", "shape", "mesh", "flops", "flops_per_device",
                                                      "collective_bytes", "memory")}))
    print("jax ", json.dumps(jrec))
    assert rec["status"] == jrec["status"] == "ok" and "mesh_error" not in rec
    assert rec["n_devices"] == jrec["n_devices"] == 256
    assert rec["memory"]["argument_bytes"] == jrec["memory"]["argument_bytes"]
    assert rec["per_device_argument_gib"] == jrec["per_device_argument_gib"]
    assert rec["flops_per_device"] * rec["n_devices"] >= rec["flops"]
    if shape == "decode_32k":
        assert jrec["hlo_flops"] <= rec["flops_per_device"] <= 1.01 * jrec["hlo_flops"]
    else:
        assert rec["flops_per_device"] <= jrec["hlo_flops"]
    assert 0 < rec["memory"]["temp_bytes"] <= jrec["memory"]["temp_bytes"]
    for kind in ("all-gather", "all-reduce"):
        if jrec["collective_bytes"].get(kind, 0) > 0:
            assert rec["collective_bytes"].get(kind, 0) > 0, kind


def test_seq_shard_changes_the_collectives():
    """--seq-shard splits the residual stream's sequence over model: the
    record's collectives change and it carries no warning about it."""
    plain = dryrun.run_cell("qwen1.5-0.5b", "prefill_32k", save=False)
    seq = dryrun.run_cell("qwen1.5-0.5b", "prefill_32k", seq_shard=True, save=False)
    assert plain["status"] == seq["status"] == "ok"
    assert seq["collective_bytes"] != plain["collective_bytes"]
    assert not any("seq_shard" in w for w in seq["op_warnings"])
    assert seq["flops"] == plain["flops"]
