#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from `src/repro_torch/csrc/` (into
`build/kernels/`; phase 0 prints each kernel's registers, the count of
HGMMA (wgmma) instructions in the flash library and the min-plus kernels'
instruction mix where the toolkit has cuobjdump, and fails if
`neumann_cols_kernel` or an argmin kernel spills), then runs fourteen
phases, each printing JSON lines:

  1. kernels vs their plain PyTorch versions on the card, at the main
     paths' shapes (Neumann rtol 1e-5 at the traffic scan's stages 0-2 for
     V = 256, on a phase-7 fleet lane in the two-CTA cluster range, which
     must launch `c2_resident`, and for the cols kernel also at V = 8200, bf16 operands
     2e-2; min-plus and its argmin bitwise, ragged shapes included, and
     the argmin also on ties past its first chunk, all-BIG and all-+INF
     lines, K = 1 and K = 4200 in each of its variants; all four solver
     kernels at phase 9's first Pareto chunk (V = 32, 327 lanes) and
     min-plus at the warm hop-bound closure's masked product (B = 1,
     V = 256, operands almost all BIG); flash
     attention 1e-4 in fp32 and 2e-2 in bf16, fully masked rows exactly 0,
     also at phase 10's shapes: hymba's GQA 25:5 with its 1024 window at
     S = 2048, the seamless encoder, cross attention at Sq = 16 and 1
     against 1024 frames, qwen2-moe's D = 128; the placement sweep's hosts
     bitwise; the forwarding sweep's phi at the benchmark cells' shapes,
     bitwise off the minimum-marginal column and 1e-6 + 1e-5 |phi| on it),
     with CUDA-event times, the plain version's time, a PyTorch-call
     yardstick (for Neumann the dense LU solve), and the card's bound;
     each flash row names its variant (wgmma or cuda_core), each argmin
     row its split of K, each Neumann row its cluster size and whether
     the operator stays on chip, and the hops its early exit took;
  2. the paper's four scenarios through `compare_all` on the card, with
     `iot` and `geant` also solved on the CPU and compared, and the paper's
     claims checked;
  3. `engine_solve` on 64 stacked `random_connected(256, 32)` instances
     (the batched engine at realistic scale), with the per-round split of
     placement / forwarding / round_eval and the device time by kernel;
  4. one large instance, `solve_alt(random_connected(1024, 4))`;
  5. the serve loop on qwen1.5-0.5b at full width and depth (bf16
     parameters, random weights from a seed): 16 requests of 1024 prompt
     tokens, 8 slots, 64 new tokens each, with prefill and decode times,
     a profile of the device time, and two checks of the numbers
     (prefill-then-decode against the full forward; the card against the
     CPU on the same weights);
  6. the data plane: the same model split at layer 12, partition 1's
     activation fed to partition 2, against the monolithic logits;
  7. the fleet path: `solve_fleet` over 64 sampled instances of all four
     families (V up to 256, split depths 1-3, padded to V = 256, A = 40,
     K = 4) with the round trace, its per-round split, the placement
     sweep's time, and seven checks: J finite, best of its history and
     conserving traffic; trace=False bitwise the same; two chunks and B = 1 solves of lanes 0-3 at rtol 1e-5 (on at most two
     lanes whose hosts differ on a near-tie, 1e-3); one traced solve over
     the fleet bitwise the untraced one, its round phases read from the
     engine's own spans (`solve_fleet.round.*`: finite, within their
     round, one round span a round); the four methods finite on lanes 0-7 with
     hosts only on real nodes; `repair_placement` off two dead nodes (on
     lane 0, or the first lane that hosts a partition on a removable
     non-endpoint node), and the identity with every node live; every
     solver kernel launched. Each solver kernel is also held to its plain
     version on the inputs of one padded round (pad nodes, pad apps,
     phantom stages), and one sweep's device operations are counted;
  8. the control plane: `run_control` over phase 7's fleet for 50 fault
     epochs (trace seed 11: node kills, link degradations, a flash crowd;
     m_max 8, t_phi 5), with the warm hop-bound closure and the cached
     zero-load APSP held bitwise to from-scratch solves on every epoch and
     the cold comparison on; every epoch finite and feasible, the APSP
     cache hit, the warm closure swept on a node-churn epoch, warm rounds
     no more than cold ones; one node-churn epoch's min-plus inputs
     replayed through each kernel and its plain version, bitwise; one event
     epoch's device idle share; and a small control loop (4 iot_hierarchy
     instances, 12 epochs) on the card against the CPU, epoch for epoch;
  9. the Pareto sweep: `sweep_zoo()` at the CLI's defaults (12 archs, iot
     and mesh, 1,176 candidates in chunks under the 2 GB cap), its fronts
     checked (`check_fronts`, every J finite), and a two-arch sub-sweep on
     the card against the CPU (J at rtol 1e-5, fronts equal up to
     near-ties: points whose objectives agree to 1e-5 may swap);
 10. every model family at full width (bf16 parameters, random weights):
     `serve()` at phase 5's traffic on mamba2-370m, hymba-1.5b and
     qwen2-moe-a2.7b at full depth; mixtral-8x22b (4 of 56 layers) prefill
     of 8 x 1024 tokens and 8 decode steps; seamless-m4t-medium (8
     utterances of 1024 frames, a 16-token decoder prefix, 64 decode
     steps, and the executor's encoder / decoder split, bitwise the model);
     internvl2-76b (4 of 80 layers) on 1024 patch features;
     command-r-plus-104b (4 of 64 layers) quantized to int8 against its
     dequantized weights. Each with prefill and decode-step times, a
     profile of the device time by kernel family and model region (MoE
     dispatch, experts, combine; the SSD dual form) with the idle share,
     prefill-then-decode against the full forward (fp32; bf16 within 4
     bf16 ulps, 6.5 and 6 for mamba2 and hymba, made twice and equal
     bitwise; MoE at the no-drop capacity: a bf16 token routed to other
     experts must be a router near-tie, or follow from one, and is
     reported and left out),
     and the card against the CPU at 2 layers (rtol 1e-3, the same experts
     for every MoE token); the served families' and mixtral's 8 x 1024
     prefills repeat bitwise;
 11. training: the flash gradient route against autograd through the
     plain version at the training shapes; one model a family card vs CPU
     in fp32; 30 steps of qwen1.5-0.5b at full size (8 x 1024 tokens, bf16
     compute, remat) with checkpoints, a resume held bitwise, a card-to-CPU
     restore and the train CLI's resume in a subprocess;
 12. the dry run (`python -m repro_torch.launch.dryrun`): its whole matrix
     (10 archs x 4 shapes x 2 production meshes) runs on the host from the
     script's start, in the background (`DryrunMatrix`, it never touches
     the card); every cell must be ok with per-device FLOPs, temporaries
     and nonzero collectives (each cell traced a second time on DTensors
     under a fake process group of the mesh's size), skipped exactly where
     `shape_applicable` says, or an error naming the op DTensor has no
     sharding rule for (MoE's dispatch); then one train (phase
     11's shape), prefill (2 x 32768) and decode (8 x 32768 cache) step of
     qwen1.5-0.5b on the one-device mesh against the same step on the
     card: FLOPs equal exactly (FlopCounterMode with the flash op's
     formula), the dry run's peak within 15% of max_memory_allocated,
     every flash launch counted and wgmma;
 13. the mesh slice: (a) the two examples (`repro_torch.examples.quickstart`
     and `.edge_serving`) on the card against the same functions on the
     CPU (J, the straggler's re-solved and stale J and the wire bytes at
     rtol 1e-5, the partitioned logits within the example's 1e-2 of the
     monolithic ones), with every solver kernel and the flash kernel
     launched; (b) phase 7's fleet through `solve_fleet(shard=True)` over
     a one-rank NCCL group: the "single-device" plan with J bitwise phase
     7's, `make_fleet_mesh(2)` refused on the one GPU, and the cost of the
     round loop's exit flag as an all_reduce over that group; (c) one
     full-width qwen1.5-0.5b decoder layer (bf16) as the stage of
     `pipeline_apply` over that group, 4 microbatches of 2 x 1024 tokens,
     bitwise the layer applied to each microbatch, every flash launch
     wgmma; (d) the CPU tests' 4-rank gloo runs (`tests/_torch_ranks.py`:
     the sharded fleet and control loop, the GPipe schedule) on this
     host's CPU, every check held and the numbers within 1e-5 of the
     committed reference (`tests/torch_ranks_reference.json`);
 14. model parallelism: (a) 3 steps of phase 11's model and batches through
     the train step over a (data=1, model=1) `DeviceMesh` of a one-rank
     NCCL group, parameters, moments and batch as DTensors under
     `activation_sharding`, held bitwise (losses, grad norms, parameters)
     to the plain step from the same weights, the flash kernel launched
     through its DTensor sharding rule twice a layer a step, the step's
     p50 beside the plain one's and phase 11's (DTensor's host cost), and
     the flash wrapper on CUDA DTensors: the kernel's output bitwise, a
     dtype it refuses raised; (b) the dry run's per-device records of
     qwen1.5-0.5b (train_4k, prefill_32k, decode_32k on 16x16 and 2x16x16,
     from phase 12's matrix): collectives by kind, temporaries, FLOPs and
     argument GiB per device, none null; (c) the CPU tests' model-parallel
     gloo run (`tests/_torch_ranks.py model_parallel`: a (2, 2) mesh of 4
     ranks against one process, the CLI's resume, checkpoints across mesh
     shapes) on this host's torch, every check held.

Kernel launches are counted only while the main paths run (phases 2-14),
by kernel and by variant; every kernel must have launched there, every
phase-3 `neumann_cols` and `neumann_rows` launch must be a resident cluster
of more than one CTA, and every phase-5 and phase-10 bf16 flash launch
the wgmma variant. Any failed
check raises, so the script exits non-zero. It exits non-zero without a GPU or without the
repository's `src/repro_torch` beside it. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet) used for the bound column.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # CUDA cores, an FMA counted as two operations
# Thread-instructions a second: 132 SMs x 4 x 32 a clock x 1.98 GHz (the clock
# that 67 TFLOP/s implies). Min-plus has no fused add-min, so its bound counts
# issued instructions: 2 a candidate (FADD, FMNMX), the argmin's too, whose
# index costs no instruction a candidate (csrc/minplus.cu).
FP32_ISSUE_PER_S = 33.5e12
BF16_OPS_PER_S = 989e12  # dense bf16 tensor cores

# Phase 7's fleet: what a control plane re-solves at once, metro and
# backbone networks beside IoT-edge-cloud trees, split 1-3 ways.
FLEET_B, FLEET_N_RANGE, FLEET_APPS_RANGE = 64, (128, 256), (16, 32)
# Chunked and B=1 fleet solves against the single batch: J per lane at rtol
# 1e-5, except on at most this many lanes whose hosts differ on a near-tie,
# which still hold J to NEAR_TIE_RTOL.
NEAR_TIE_LANES, NEAR_TIE_RTOL = 2, 1e-3

NEUMANN_RTOL = 1e-5  # same algorithm, different fp32 summation order
BF16_TOL = 2e-2  # bf16 operands vs the fp32 plain version
FLASH_FP32_TOL = 1e-4  # max abs error: same fp32 softmax, other summation order
FLASH_BF16_TOL = 2e-2  # output rounded to bf16 after that arithmetic (test_flash_dtypes)


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
    """Sums kernel launch counts, and the counts of each kernel variant,
    over the main-path runs only."""

    def __init__(self, build):
        self.build = build
        self.total = {k: 0 for k in build.LAUNCHES}
        self.total_variants = {k: {} for k in build.VARIANT_LAUNCHES}
        self.last = dict(self.total)
        self.last_variants = {k: {} for k in build.VARIANT_LAUNCHES}

    def run(self, fn):
        import torch

        torch.cuda.synchronize()
        self.build.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        self.last = dict(self.build.LAUNCHES)
        self.last_variants = {k: dict(v) for k, v in self.build.VARIANT_LAUNCHES.items()}
        for k, v in self.last.items():
            self.total[k] += v
        for k, by in self.last_variants.items():
            for var, n in by.items():
                self.total_variants[k][var] = self.total_variants[k].get(var, 0) + n
        self.build.reset_launches()
        return out


def ptxas_summary(log: str) -> list[str]:
    """Registers and any spills of each kernel, from `-Xptxas=-v` output,
    by kernel name and template arguments as mangled (e.g.
    "neumann_cols_kernelIfLb1ELb1EE": fp32, vector loads, resident)."""
    import re

    out, name = [], ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            end = mangled.find("_kernel") + len("_kernel")
            m = re.search(r"[a-z_]+$", mangled[:end]) if end >= len("_kernel") else None
            args = re.match(r"I(?:[^LE]|L\w+?E)*E", mangled[end:]) if m else None
            name = m.group(0) + (args.group(0) if args else "") if m else mangled[:48]
        elif "registers" in ln:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}")
        elif "spill stores" in ln and ", 0 bytes spill stores" not in ln:
            out.append(f"{name}: {ln.strip()}")
    return out


def sass_opcodes(lib):
    """{function: {opcode: count}} of the SASS of a built library (opcode
    with its modifiers, e.g. "LDS.128"), or None where the toolkit has no
    cuobjdump."""
    import os
    import re
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    out, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = out.setdefault(ln.split("Function :", 1)[1].strip(), {})
            continue
        m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ln)
        if fn is not None and m:
            fn[m.group(1)] = fn.get(m.group(1), 0) + 1
    return out


def minplus_kernel_name(fn: str) -> str:
    """A min-plus kernel's name with its template arguments, from its
    mangled name: minplus_tile_kernel<vec>, minplus_argmin_kernel<vec, ids,
    index> (16-byte or 4-byte copies of B; u8 or u32 chunk ids; int64 final
    or int32 split partials) or minplus_argmin_combine_kernel."""
    import re

    if "combine" in fn:
        return "minplus_argmin_combine_kernel"
    m = re.search(r"minplus_argmin_kernelILb([01])ELb([01])E([xi])E", fn)
    if m:
        vec, wide, index = m.groups()
        return (f"minplus_argmin_kernel<{str(vec == '1').lower()},{'u32' if wide == '1' else 'u8'},"
                f"{'int64' if index == 'x' else 'int32'}>")
    return f"minplus_tile_kernel<{str('ILb1E' in fn).lower()}>"


def minplus_sass(ops) -> dict:
    """The min-plus kernels' instruction mix: the arithmetic (FADD, FMNMX),
    the shared loads (LDS.128 and the scalar rest), local-memory traffic
    (spills: LDL/STL) and cp.async (LDGSTS). The product and argmin
    kernels must be arithmetic fed by 16-byte shared loads; no kernel may
    spill."""
    out = {}
    for fn, counts in ops.items():
        if "minplus" not in fn:
            continue
        name = minplus_kernel_name(fn)
        pick = {op: sum(n for k, n in counts.items() if k == op or k.startswith(op + "."))
                for op in ("FADD", "FMNMX", "LDS", "LDL", "STL", "LDGSTS")}
        pick["LDS.128"] = counts.get("LDS.128", 0)
        pick["arithmetic_share_of_FADD_FMNMX_LDS"] = (pick["FADD"] + pick["FMNMX"]) / max(
            1, pick["FADD"] + pick["FMNMX"] + pick["LDS"])
        out[name] = pick
        loop = "combine" not in name and (pick["FMNMX"] < 64 or not pick["LDS.128"])
        if loop or pick["LDL"] or pick["STL"]:
            raise AssertionError(f"{name}: SASS is not the FADD/FMNMX loop on LDS.128 without spills: {pick}")
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


def phase1(scen, build, stacked256, fleet_problems, pareto_chunk, warm_mm):
    """Each kernel vs its plain version at the main path's shapes, with
    phase 9's first Pareto chunk (V = 32) and the warm hop-bound closure's
    masked product (B = 1, V = 256, operands almost all BIG)."""
    import torch
    from repro_torch.core import forwarding_update, stack_single, stage_traffic, structured_init
    from repro_torch.core.flow import _source_injection, _stage_gates
    from repro_torch.core.placement import zero_load_dp
    from repro_torch.kernels.minplus import (
        apsp, minplus_matmul, minplus_matmul_argmin, minplus_matmul_argmin_ref,
        minplus_matmul_ref,
    )
    from repro_torch.kernels.minplus import ops as mp_ops
    from repro_torch.kernels.neumann import (
        effective_hops, neumann_propagate, neumann_propagate_ref, neumann_solve,
    )
    from repro_torch.kernels.neumann.ops import _cols_cluster, _rows_cluster, _variant

    rows, summary = [], {}

    def keep(name, row, headline):
        rows.append(row)
        s = summary.setdefault(name, {"max_abs_err": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], row["max_abs_err"])
        if headline:
            s.update({k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")})

    def bound(bytes_, ops_, rate=FP32_OPS_PER_S):
        t_b, t_o = bytes_ / HBM_BYTES_PER_S, ops_ / rate
        return {"bound_ms": 1e3 * max(t_b, t_o), "bound_by": "bytes" if t_b >= t_o else "operations"}

    rc64 = stack_single(scen.random_connected(64, 24, seed=0))
    rc1024 = stack_single(scen.random_connected(1024, 4, seed=1))
    # The first phase-7 fleet lane in both Neumann kernels' two-CTA range
    # (129 <= V <= 180): phase 7's unpadded B=1 solves run that layout.
    c2 = "c2_resident"
    c2_lane = next(p for p in fleet_problems
                   if _variant(*_cols_cluster(p.net.n_nodes)) == _variant(*_rows_cluster(p.net.n_nodes, 4)) == c2)
    c2_v = c2_lane.net.n_nodes
    # (V, stacked problem, is the phase-3 shape that heads the kernels line, label)
    cases = [
        (17, stack_single(scen.iot()), False, ""),
        (32, pareto_chunk, False, "Pareto chunk 0: "),
        (64, rc64, False, ""),
        (c2_v, stack_single(c2_lane), False, ""),
        (256, stacked256, True, ""),
        (1024, rc1024, False, ""),
        (1280, stack_single(scen.random_connected(1280, 4, seed=1)), False, ""),
    ]
    for v, prob, headline, label in cases:
        state = forwarding_update(prob, structured_init(prob), t_phi=2)
        hops = effective_hops(prob.hop_bound, v, fixed_loop=True)
        # The traffic scan's solves: stage k's operators [B, A, V, V] as a
        # strided view of phi against inject_k + gate_k * t_{k-1}. Stage 1
        # (partition-1 host -> partition-2 host) heads the kernels line, as
        # in earlier runs; at V = 256 stages 0 (1 hop) and 2 (the most hops)
        # run too.
        t = stage_traffic(prob, state)
        inject, gates = _source_injection(prob), _stage_gates(state, prob.apps)
        for k in (1, 0, 2) if v == 256 else (1,):
            w = state.phi[..., k, :, :]
            t_prev = t[..., k - 1, :] if k else torch.zeros_like(t[..., 0, :])
            b = (inject[..., k, :] + gates[..., k, :] * t_prev).contiguous()
            n_ops = b.numel() // v
            for dt in (torch.float32, torch.bfloat16) if v == 1280 else (torch.float32,):
                wd = w if dt == torch.float32 else w.to(dt)
                for transpose, name in ((True, "neumann_cols"), (False, "neumann_rows")):
                    build.reset_launches()
                    got = neumann_propagate(wd, b, hops=hops, transpose=transpose)
                    launched = set(build.VARIANT_LAUNCHES[name])
                    if v == c2_v and launched != {c2}:
                        raise AssertionError(f"{name} V={v}: launched {launched}, not {c2}")
                    want = neumann_propagate_ref(wd, b, hops, 1e-6, transpose)
                    err = (got - want).abs().max().item()
                    scale = want.abs().max().item()
                    if not err <= NEUMANN_RTOL * scale:
                        raise AssertionError(f"{name} V={v} stage {k} {dt}: max err {err} > {NEUMANN_RTOL} * {scale}")
                    if dt == torch.bfloat16:  # bf16 operands vs the fp32 solve
                        exact = neumann_propagate_ref(w, b, hops, 1e-6, transpose)
                        dev_ = (got - exact).abs().max().item()
                        if not dev_ <= BF16_TOL * exact.abs().max().item():
                            raise AssertionError(f"{name} V={v} bf16 vs fp32: {dev_}")
                        if bool((got[exact == 0] != 0).any()):
                            raise AssertionError(f"{name} V={v} bf16: exact zeros not kept")
                    del got, want
                    used = neumann_hops_used(wd, b, hops, 1e-6, transpose)
                    esize = wd.element_size()
                    reps = 20 if v <= 256 else 5
                    variant = _variant(*(_cols_cluster(v) if transpose else _rows_cluster(v, esize)))
                    # The dense LU solve of the same systems, on a prebuilt
                    # I - M: the reference's `lu_solve_ref`, a yardstick and
                    # not the same hop-capped function.
                    lhs = torch.eye(v, device="cuda") - (wd.float().mT if transpose else wd.float())
                    keep(name, {
                        "kernel": name, "shape": f"{label}N={n_ops} V={v} {str(dt)[6:]} stage {k}", "variant": variant,
                        "hops_cap": hops, "hops_used_mean": used / n_ops, "max_abs_err": err,
                        "ms": cuda_ms(lambda: neumann_propagate(wd, b, hops=hops, transpose=transpose), reps),
                        "plain_ms": cuda_ms(lambda: neumann_propagate_ref(wd, b, hops, 1e-6, transpose), 2, 1),
                        **bound(n_ops * v * v * esize + 2 * n_ops * v * 4, 2 * v * v * used),
                        "library_ms": cuda_ms(lambda: torch.linalg.solve(lhs, b[..., None]), 2, 1),
                    }, headline and dt == torch.float32 and k == 1)
                    del lhs
            if v == 256 and k == 1:  # backward: the transpose solve through the kernel
                bb = b.clone().requires_grad_(True)
                x = neumann_solve(w.mT, bb, hops=hops)
                g = torch.rand_like(x)
                (x * g).sum().backward()
                want = neumann_propagate_ref(w, g, hops, 1e-6, False)
                err = (bb.grad - want).abs().max().item()
                if not err <= NEUMANN_RTOL * want.abs().max().item():
                    raise AssertionError(f"neumann backward V={v}: max err {err}")
                rows.append({"kernel": "neumann_rows", "shape": f"backward N={n_ops} V={v}",
                             "variant": _variant(*_rows_cluster(v, 4)), "max_abs_err": err})
                del bb, x, g, want
        del state, w, b, t, inject, gates
        torch.cuda.empty_cache()

    # Past 256 column quads a CTA (V > 8192) a neumann_cols thread sums
    # several quads: held to its plain version on a sparse operator, not timed.
    v, hops = 8200, 4
    gen = torch.Generator(device="cuda").manual_seed(1)
    w = torch.rand(1, v, v, generator=gen, device="cuda")
    w = torch.where(torch.rand(1, v, v, generator=gen, device="cuda") < 1e-3, w, 0.0).triu(1)
    b = torch.rand(1, v, generator=gen, device="cuda")
    for dt in (torch.float32, torch.bfloat16):
        wd = w.to(dt)
        got, want = neumann_propagate(wd, b, hops=hops, transpose=True), neumann_propagate_ref(wd, b, hops, 1e-6, True)
        err = (got - want).abs().max().item()
        if not err <= NEUMANN_RTOL * want.abs().max().item():
            raise AssertionError(f"neumann_cols V={v} {dt}: max err {err}")
        keep("neumann_cols", {"kernel": "neumann_cols", "shape": f"N=1 V={v} {str(dt)[6:]}",
                              "variant": _variant(*_cols_cluster(v)), "hops_cap": hops, "max_abs_err": err}, False)
        del wd, got, want
    del w, b
    torch.cuda.empty_cache()

    # Min-plus: the APSP squaring product d (x) d and the next-hop argmin
    # (w, dist) on each batch's zero-load metric, plus an integer-weight
    # batch whose exact ties pin the first-minimum rule; V = 17 (the paper's
    # iot) and V = 200 are ragged against the 128 x 128 tile, and one
    # integer product is ragged in all of M, K and N.
    gen = torch.Generator(device="cuda").manual_seed(0)

    def integers(shape):
        ints = torch.randint(1, 5, shape, generator=gen, device="cuda").float()
        return torch.where(torch.rand(shape, generator=gen, device="cuda") < 0.5, ints, 1e18)

    mp_cases = [
        (17, stack_single(scen.iot()), False), (32, pareto_chunk, False), (64, rc64, False),
        (200, stack_single(scen.random_connected(200, 8, seed=2)), False), (256, stacked256, True),
        (1024, rc1024, False), (None, None, False), (256, "warm", False),
    ]
    for v, prob, headline in mp_cases:
        if prob is None:
            products = [("ragged integer ties", integers((3, 130, 200)), integers((3, 200, 129)))]
        elif prob == "warm":
            # The warm closure's masked product: A keeps the touched nodes'
            # columns of the old distances, B their rows, the rest is BIG;
            # the data needs only the candidates through a touched node.
            products = [("warm hop-bound closure, masked", warm_mm[0][None], warm_mm[1][None])]
        else:
            w = zero_load_dp(prob)
            eye = torch.eye(v, dtype=torch.bool, device="cuda")
            d = torch.where(eye, 0.0, w)
            products = [("apsp", d, d), ("nexthop", w, apsp(w)), ("integer ties", integers(w.shape), integers(w.shape))]
        for tag, a_, b_ in products:
            (nb, m, kk), nn = a_.shape, b_.shape[-1]
            # The warm closure runs only the product; every other case both kernels.
            for name in ("minplus",) if "masked" in tag else ("minplus", "minplus_argmin"):
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
                    raise AssertionError(f"{name} {tuple(a_.shape)} (x) {tuple(b_.shape)} {tag}: "
                                         "not bitwise equal to the plain version")
                del got, want
                label = "Pareto chunk 0: " if prob is pareto_chunk else ""
                shape = f"{label}B={nb} V={v} {tag}" if v else f"B={nb} M={m} K={kk} N={nn} {tag}"
                row = {"kernel": name, "shape": shape, "max_abs_err": err}
                if name == "minplus_argmin":
                    row["variant"] = argmin_variant(nb, m, kk, nn)
                if "integer" not in tag:
                    out_bytes = nb * m * nn * (12 if name == "minplus_argmin" else 4)
                    # Candidates this data needs: every k, or for the masked
                    # product only the k (touched nodes) where A is finite.
                    live_k = int((a_ < 1e18).any(dim=-2).sum()) if "masked" in tag else nb * kk
                    instructions = 2 * m * live_k * nn
                    if "masked" in tag:
                        row.update(touched_nodes=live_k, big_share=float((a_ >= 1e18).float().mean()))
                    row.update({
                        "ms": cuda_ms(fn, 10 if m <= 256 else 3),
                        "plain_ms": cuda_ms(plain, 2, 1),
                        **bound(4 * (a_.numel() + b_.numel()) + out_bytes, instructions, FP32_ISSUE_PER_S),
                        "library_ms": cuda_ms(lib, 2, 1),
                    })
                keep(name, row, headline and tag == ("apsp" if name == "minplus" else "nexthop"))
        del products
        torch.cuda.empty_cache()

    # The argmin's own edge cases, bitwise: integer ties whose minimum first
    # appears past the first 16-deep stage (A's first 16 k raised by 10) and
    # recurs in later chunks and split ranges, with rows and columns all BIG
    # and all +INF, unsplit (B=64), in 4 and 2 ranges (V = 256, 1024); K = 1;
    # and K = 4200, past 256 byte-numbered 4-deep chunks: in the chooser's 8
    # ranges and, forced, in one range with word chunk ids (N = 63: 4-byte
    # copies of B), in two with word ids and in six with byte ones.
    def ties(nb, m, kk, nn):
        a_, b_ = integers((nb, m, kk)), integers((nb, kk, nn))
        a_[..., :16] += 10
        a_[:, 1, :], b_[:, :, 1] = 1e18, 1e18
        a_[:, 3, :], b_[:, :, 3] = math.inf, math.inf
        return a_, b_

    edge_cases = [
        ("ties past chunk 0, BIG and +INF lines", (64, 256, 256, 256), None),
        ("ties past chunk 0, BIG and +INF lines", (1, 256, 256, 256), None),
        ("ties past chunk 0, BIG and +INF lines", (1, 1024, 1024, 1024), None),
        ("K=1", (2, 64, 1, 64), None),
        ("K=4200", (1, 64, 4200, 64), None),
        ("K=4200 forced", (1, 64, 4200, 63), (1, 4208, True)),
        ("K=4200 forced", (1, 64, 4200, 64), (2, 2112, True)),
        ("K=4200 forced", (1, 64, 4200, 64), (6, 704, False)),
    ]
    chooser = mp_ops._argmin_split
    for tag, (nb, m, kk, nn), forced in edge_cases:
        a_, b_ = ties(nb, m, kk, nn)
        if forced:
            mp_ops._argmin_split = lambda *_a, f=forced: f
        try:
            got = minplus_matmul_argmin(a_, b_)
            variant = mp_ops._argmin_variant(*mp_ops._argmin_split(nb, m, nn, kk)[::2])
        finally:
            mp_ops._argmin_split = chooser
        want = minplus_matmul_argmin_ref(a_, b_)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"minplus_argmin B={nb} M={m} K={kk} N={nn} {tag} {variant}: "
                                 "not bitwise equal to the plain version")
        if kk > 16 and not bool((want[1][want[0] < 1e18] >= 16).all()):
            raise AssertionError(f"minplus_argmin {tag}: a minimum in the first chunk")
        if not (bool((want[0][:, 3, :] == math.inf).all()) and bool((got[1][:, 3, :] == 0).all())):
            raise AssertionError(f"minplus_argmin {tag}: an all-+INF row is not (+INF, 0)")
        finite = torch.isfinite(want[0])  # the +INF lines agree bitwise, but inf - inf is NaN
        keep("minplus_argmin", {"kernel": "minplus_argmin", "shape": f"B={nb} M={m} K={kk} N={nn} {tag}",
                                "variant": variant, "max_abs_err": (got[0] - want[0])[finite].abs().max().item()},
             False)
        del a_, b_, got, want
    torch.cuda.empty_cache()

    # The sequential placement sweep: the kernel against the plain scan on
    # the same CUDA tensors, hosts bitwise, at the refined state of the
    # batched V = 256 shape (the headline) and of one V = 64 instance.
    from repro_torch.core import round_eval
    from repro_torch.core.placement import comp_marginal
    from repro_torch.kernels.minplus import apsp_with_nexthop
    from repro_torch.kernels.placement import ops as pl_ops, ref as pl_ref

    for prob, headline in ((stacked256, True), (rc64, False)):
        state = forwarding_update(prob, structured_init(prob), t_phi=2)
        ctg = round_eval(prob, state)[1]["ctg"]
        args = (prob, state.hosts(), apsp_with_nexthop(ctg[1])[0], ctg[5], comp_marginal(prob))
        for colocate in (False, True):
            kw = dict(colocate=colocate, move_margin=0.02)
            got, want = pl_ops.placement_sweep(*args, **kw), pl_ref.sequential_sweep(*args, **kw)
            if not torch.equal(got, want):
                raise AssertionError(f"placement_sweep colocate={colocate}: {int((got != want).sum())} hosts differ")
            nb, na, np_ = got.shape
            v = prob.net.n_nodes
            steps = na if colocate else na * np_
            keep("placement_sweep", {
                "kernel": "placement_sweep", "shape": f"B={nb} V={v} A={na} P={np_}{' colocated' if colocate else ''}",
                "variant": "", "max_abs_err": 0.0,
                "ms": cuda_ms(lambda: pl_ops.placement_sweep(*args, **kw), 20),
                "plain_ms": cuda_ms(lambda: pl_ref.sequential_sweep(*args, **kw), 2, 1),
                **bound(nb * steps * 2 * v * 4, 0), "library_ms": None,
            }, headline and not colocate)
        del state, ctg, args, got, want
    torch.cuda.empty_cache()

    # One forwarding sweep's update of phi: the kernel against the plain
    # tail on the same CUDA tensors at the benchmark cells' shapes (fleet64,
    # tier256 the headline, backbone1024), bitwise off the j* column and
    # j* within 1e-6 + 1e-5 |want|; bound: phi read and written once.
    from repro_torch.kernels.forwarding import ops as fw_ops, ref as fw_ref

    for (nb, na, nk, v), headline in (((1024, 24, 3, 64), False), ((16, 128, 3, 256), True),
                                      ((1, 256, 3, 1024), False)):
        args = forwarding_operands(nb, na, nk, v, seed=v)
        got, want = fw_ops.update_phi(*args), fw_ref.update_phi_ref(*args)
        at = torch.nn.functional.one_hot(fw_ref.link_delta(*args[1:5]).argmin(dim=-1), v).bool()
        if not torch.equal(got[~at], want[~at]):
            raise AssertionError(f"forwarding_sweep V={v}: {int((got[~at] != want[~at]).sum())} entries off j* differ")
        err = (got[at] - want[at]).abs().max().item()
        if not err <= 1e-6 + 1e-5 * want[at].abs().max().item():
            raise AssertionError(f"forwarding_sweep V={v}: j* entries off by {err}")
        del got, want, at
        keep("forwarding_sweep", {
            "kernel": "forwarding_sweep", "shape": f"B={nb} A={na} K={nk} V={v}",
            "variant": fw_ops._variant(*fw_ops._geometry(v)[::2]), "max_abs_err": err,
            "ms": cuda_ms(lambda: fw_ops.update_phi(*args), 20),
            "plain_ms": cuda_ms(lambda: fw_ref.update_phi_ref(*args), 3, 1),
            **bound(2 * args[0].numel() * 4, 0), "library_ms": None,
        }, headline)
        del args
        torch.cuda.empty_cache()
    build.reset_launches()
    emit({"phase": 1, "name": "kernels_vs_plain", "rows": rows})
    return summary


def forwarding_operands(b, a, k, v, seed):
    """One forwarding sweep's operands on the card at [B, A, K, V]: a random
    graph of about 4 out-edges a node over a ring, the link weights on it
    (BIG off it), q, L, a mass whose last app and last stage are phantoms
    (mass 0), and phi on the edges summing to the mass; alpha 0.5."""
    import torch
    from repro_torch.core.structs import BIG

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=g, device="cuda")

    idx = torch.arange(v, device="cuda")
    adj = (rand(b, v, v) < min(1.0, 4.0 / v)) | ((idx[:, None] - idx[None, :]).abs() == 1)
    adj &= ~torch.eye(v, dtype=torch.bool, device="cuda")
    dp = torch.where(adj, 0.2 + 2.8 * rand(b, v, v), BIG)
    q, L, mass = 20.0 * rand(b, a, k, v), 0.1 + 1.9 * rand(b, a, k), rand(b, a, k, v)
    mass[:, -1], mass[:, :, -1] = 0.0, 0.0
    phi = torch.where(adj[:, None, None], rand(b, a, k, v, v), 0.0)
    phi = phi / phi.sum(dim=-1, keepdim=True).clamp_min(1e-30) * mass[..., None]
    return phi, q, dp, L, adj.float(), mass, 0.5


def pareto_first_chunk(fleet):
    """The first chunk `sweep_zoo()` solves at the CLI's defaults, stacked
    as `solve_fleet` stacks it (the whole sweep's envelope and hop bound)."""
    from repro_torch.configs import ZOO
    from repro_torch.partition import pareto

    cand = {a: pareto._normalized_candidates(a, seq_len=256, n_out_tokens=32, parts=(1, 2, 3, 4), max_per_p=16)
            for a in ZOO}
    problems, _ = pareto.candidate_fleet(cand, ("iot", "mesh"), (1.0,), (0.5,), "cuda")
    chunk = fleet.envelope_cap_chunk(problems, round_to=8, n_devices=1, cap_gb=2.0)
    stacked, _ = fleet.stack_problems(
        problems[:chunk], round_to=8, envelope=fleet.fleet_envelope(problems, round_to=8),
        hop_bound=fleet.unify_hop_bound(problems), n_parts=fleet.fleet_part_envelope(problems))
    return stacked


def warm_closure_operands(core, prob):
    """The masked product of the warm hop-bound closure after the first
    removable non-endpoint node of `prob` dies: (A, B), [V, V] each."""
    from repro_torch import chaos

    adj = prob.net.adj.cpu().numpy()
    ends = chaos.events._protected_nodes(prob)
    node = next(v for v in range(adj.shape[0]) if v not in ends and chaos.events._connected_without(adj, {v}))
    cache = core.hop_bound_cache(prob.net)
    broken, _ = chaos.apply_health(prob, chaos.InstanceHealth(down=frozenset({node})))
    return record_kernel_calls(lambda: core.hop_bound_cache(broken.net, cache))["minplus_matmul"][0][0]


def argmin_variant(nb, m, kk, nn) -> str:
    """The argmin variant the wrapper launches for [nb, m, kk] (x) [nb, kk, nn]."""
    from repro_torch.kernels.minplus import ops as mp_ops

    splits, _, wide = mp_ops._argmin_split(nb, m, nn, kk)
    return mp_ops._argmin_variant(splits, wide)


def flash_live_mask(sq, sk, causal, window, q_offset, device="cpu"):
    """[Sq, Sk] bool, True where query i sees key j: the (query, key) pairs
    of one (batch, head) the kernel must do for these inputs."""
    import torch

    qp = q_offset + torch.arange(sq, device=device)[:, None]
    kp = torch.arange(sk, device=device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    return mask


def sdpa_call(q, k, v, causal, window, q_offset):
    """One `scaled_dot_product_attention` call computing what the flash
    kernel computes on these inputs, or None where none does (a query that
    sees no key: the kernel writes 0, SDPA NaN). Plain causal attention
    takes `is_causal`; a window or an offset a boolean band mask, built
    here, before any timing."""
    import torch.nn.functional as F

    sq, sk = q.shape[2], k.shape[2]
    gqa = k.shape[1] != q.shape[1]
    if window is None and q_offset == 0 and (sq == sk or not causal):
        return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=gqa)
    band = flash_live_mask(sq, sk, causal, window, q_offset, device=q.device)
    if not bool(band.any(dim=1).all()):
        return None
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=band, enable_gqa=gqa)


def phase1_flash():
    """The flash-attention kernels vs their plain version (the streaming
    recurrence `attention_chunked`, which shares the kernels' treatment of
    rows that see no key), at the serve prefill shape, the other head shapes
    of the zoo, and the edge cases in both dtypes. Each row names the kernel
    variant that ran; at the serve prefill shape the CUDA-core kernel is also
    timed on the same bf16 inputs (`cuda_core_ms`). SDPA is timed, and held
    to the plain version, wherever one call computes the same function
    (`sdpa_call`: with a band mask for a window or an offset)."""
    import torch
    from repro_torch.kernels.flash_attention import attention_chunked, flash_attention
    from repro_torch.kernels.flash_attention import ops as fa_ops

    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16, fp32 = torch.bfloat16, torch.float32
    # (tag, B, H, Kv, Sq, Sk, D, causal, window, q_offset, dtype, model layout)
    cases = [
        ("serve prefill", 8, 16, 16, 1024, 1024, 64, True, None, 0, bf16, True),
        ("GQA 8:1 D=128", 1, 64, 8, 1024, 1024, 128, True, None, 0, bf16, True),
        ("MQA D=256", 1, 8, 1, 2048, 2048, 256, True, None, 0, bf16, True),
        # Phase 10's shapes: hymba's GQA 25:5 with its 1024 window, the
        # seamless encoder (bidirectional) and its cross attention in prefill
        # (16 decoder tokens) and decode (one) over 1024 frames, qwen2-moe.
        ("hymba window 1024", 8, 25, 5, 2048, 2048, 64, True, 1024, 0, bf16, True),
        ("seamless encoder", 8, 16, 16, 1024, 1024, 64, False, None, 0, bf16, True),
        ("seamless cross Sq=16", 8, 16, 16, 16, 1024, 64, False, None, 0, bf16, True),
        ("seamless cross Sq=1", 8, 16, 16, 1, 1024, 64, False, None, 0, bf16, True),
        ("qwen2-moe D=128", 8, 16, 16, 1024, 1024, 128, True, None, 0, bf16, True),
        # Phase 13's edge_serving data plane: reduced qwen1.5-0.5b, one
        # 64-token request, D=32 padded to 64 in the wgmma kernel.
        ("edge_serving D=32", 1, 4, 2, 64, 64, 32, True, None, 0, bf16, True),
    ]
    main_path = list(cases)
    for dt in (fp32, bf16):
        cases += [
            ("GQA 4:1 window 128 q_offset", 1, 8, 2, 256, 512, 64, True, 128, 256, dt, False),
            ("non-multiple S=100", 2, 4, 2, 100, 100, 64, True, None, 0, dt, False),
            ("bidirectional", 1, 4, 4, 512, 512, 64, False, None, 0, dt, True),
            ("fully masked q_offset=-100", 1, 2, 2, 8, 8, 64, True, None, -100, dt, False),
        ]
    rows = []
    for tag, b, h, kv, sq, sk, d, causal, window, q_offset, dt, model_layout in cases:
        def make(heads, s):
            if model_layout:  # the model's transposed [B, S, H, D] view
                return torch.randn(b, s, heads, d, generator=gen, device="cuda").to(dt).transpose(1, 2)
            return torch.randn(b, heads, s, d, generator=gen, device="cuda").to(dt)

        q, k, v = make(h, sq), make(kv, sk), make(kv, sk)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        got = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = attention_chunked(q, k, v, **kw)
        if got.dtype != dt or got.shape != q.shape or got.stride() != q.stride():
            raise AssertionError(f"flash {tag}: output {got.dtype} {tuple(got.stride())}")
        err = (got.float() - want.float()).abs().max().item()
        tol = FLASH_BF16_TOL if dt == bf16 else FLASH_FP32_TOL
        if not err <= tol:
            raise AssertionError(f"flash {tag} {dt}: max abs error {err} > {tol}")
        if q_offset < -sq and not bool((got == 0).all()):
            raise AssertionError(f"flash {tag} {dt}: fully masked rows are not exactly 0")
        live = int(flash_live_mask(sq, sk, causal, window, q_offset).sum()) * b * h
        esize = q.element_size()
        bytes_ = (2 * q.numel() + k.numel() + v.numel()) * esize  # q, k, v read once, o written once
        t_b, t_o = bytes_ / HBM_BYTES_PER_S, 4 * d * live / (BF16_OPS_PER_S if dt == bf16 else FP32_OPS_PER_S)
        library = sdpa_call(q, k, v, causal, window, q_offset)
        if library is not None:
            lib_err = (library().float() - want.float()).abs().max().item()
            if not lib_err <= tol:
                raise AssertionError(f"flash {tag} {dt}: SDPA computes another function ({lib_err})")
        reps = 10 if sq >= 1024 else 20
        row = {
            "kernel": "flash_attention", "shape": f"{tag}: B={b} H={h} Kv={kv} Sq={sq} Sk={sk} D={d} "
                                                 f"{str(dt)[6:]}{' causal' if causal else ''}",
            "variant": fa_ops._variant(dt, d), "max_abs_err": err, "live_scores": live,
            "ms": cuda_ms(lambda: flash_attention(q, k, v, **kw), reps),
            "plain_ms": cuda_ms(lambda: attention_chunked(q, k, v, **kw), 2, 1),
            "bound_ms": 1e3 * max(t_b, t_o), "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": None if library is None else cuda_ms(library, reps),
        }
        if tag == "serve prefill":  # the CUDA-core kernel on the same inputs, for comparison
            variant = fa_ops._variant
            fa_ops._variant = lambda dtype, dim: "cuda_core"
            try:
                row["cuda_core_ms"] = cuda_ms(lambda: flash_attention(q, k, v, **kw), 3)
            finally:
                fa_ops._variant = variant
        rows.append(row)
        del q, k, v, got, want, library
    torch.cuda.empty_cache()
    emit({"phase": 1, "name": "flash_vs_plain", "rows": rows})
    head = rows[0]
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    return {"flash_attention": {
        "max_abs_err": max(r["max_abs_err"] for r in rows), **{k: head[k] for k in timed},
        # the model shapes (phase 5's, the zoo's head shapes, phase 10's), for the kernels line
        "shapes": [{k: r[k] for k in timed} for r in rows[:len(main_path)]],
    }}


def phase2(scen, alt, counter):
    """The paper's scenarios through compare_all on the card (and CPU)."""
    import torch

    out = {}
    for name, make in scen.SCENARIOS.items():
        t0 = time.perf_counter()
        res = counter.run(lambda: alt.compare_all(make()))
        t_gpu = time.perf_counter() - t0
        line = {"scenario": name, "gpu_s": t_gpu, "launches": counter.last,
                "argmin_variants": counter.last_variants["minplus_argmin"]}
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
    # Every traffic and cost-to-go solve runs on a cluster of more than one
    # CTA that keeps its operator on chip for the whole solve.
    variants = {k: counter.last_variants[k] for k in ("neumann_cols", "neumann_rows")}
    argmin_variants = counter.last_variants["minplus_argmin"]
    for name, by in variants.items():
        if not by or sum(by.values()) != launches[name] or not all(
                k.endswith("_resident") and int(k[1:k.index("_")]) > 1 for k in by):
            raise AssertionError(f"phase 3: {name} variants {by}")
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
    one = counter.run(lambda: core.engine_solve(pad.stack_problems([lane0])[0], **kw))
    lane0_argmin_variants = counter.last_variants["minplus_argmin"]
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
    split["profile"] = profile(
        one_round, {"neumann_rows": ("neumann_rows_kernel",), "neumann_cols": ("neumann_cols_kernel",),
                    "minplus": ("minplus_tile_kernel",), "minplus_argmin": ("minplus_argmin",),
                    "forwarding_sweep": ("forwarding_sweep",)},
        sum(split.values())
    )
    emit({
        "phase": 3, "B": 64, "V": 256, "A": 32, "K": 3, **kw,
        "rounds": out["rounds"], "wall_s": wall, "ms_per_round": 1e3 * wall / max(out["rounds"], 1),
        "peak_gb": peak / 1e9, "J_mean": J.mean().item(), "conservation_rel": cons,
        "lane0_rel_vs_B1": rel0, "lane0_same_hosts": same_hosts, "launches": launches,
        "neumann_variants": variants, "argmin_variants": argmin_variants,
        "lane0_argmin_variants": lane0_argmin_variants, "split": split,
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
        "argmin_variants": counter.last_variants["minplus_argmin"],
    })


def connected_without(adj, dead) -> bool:
    """Whether the nodes of `adj` (numpy [V, V]) minus `dead` stay connected."""
    from repro_torch.core import _graphs

    alive = [u for u in range(adj.shape[0]) if u not in dead]
    g = {u: {} for u in alive}
    for u in alive:
        for v in alive:
            if u < v and adj[u, v] > 0:
                _graphs.add_edge(g, u, v)
    return _graphs.is_connected(g)


def record_kernel_calls(fn) -> dict:
    """Run `fn()` and return the inputs it handed to the kernel wrappers,
    by wrapper name: [(args, kwargs), ...]. The wrappers are replaced in
    their ops modules and in `kernels.minplus`, whose names the hop-bound
    closure imports."""
    from repro_torch.kernels import minplus as mp_pkg
    from repro_torch.kernels.minplus import ops as mp_ops
    from repro_torch.kernels.neumann import ops as nm_ops

    calls = {"neumann_propagate": [], "minplus_matmul": [], "minplus_matmul_argmin": []}
    places = [(nm_ops, "neumann_propagate"), (mp_ops, "minplus_matmul"), (mp_ops, "minplus_matmul_argmin"),
              (mp_pkg, "minplus_matmul"), (mp_pkg, "minplus_matmul_argmin")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in places]

    def recorder(name, wrapper):
        def record(*args, **kw):
            calls[name].append((args, kw))
            return wrapper(*args, **kw)
        return record

    for mod, name, wrapper in saved:
        setattr(mod, name, recorder(name, wrapper))
    try:
        fn()
    finally:
        for mod, name, wrapper in saved:
            setattr(mod, name, wrapper)
    return calls


def fleet_kernels_vs_plain(core, stacked, state) -> dict:
    """The solver kernels against their plain versions on the fleet's own
    padded inputs: every Neumann solve of one `round_eval` (traffic and
    cost-to-go, with the zero right-hand sides of phantom stages and pad
    apps) and every min-plus product of one `placement_update` (the APSP
    squarings, and the next-hop argmin with its all-BIG rows at pad nodes),
    recorded as the engine hands them to the wrappers, then replayed. Neumann
    at NEUMANN_RTOL, with an exactly zero solution for a zero right-hand
    side; min-plus and its argmin bitwise. Returns the max abs error by
    kernel and what the inputs held."""
    import torch
    from repro_torch.kernels.minplus import minplus_matmul_argmin_ref, minplus_matmul_ref
    from repro_torch.kernels.minplus import ops as mp_ops
    from repro_torch.kernels.neumann import neumann_propagate_ref
    from repro_torch.kernels.neumann import ops as nm_ops

    wrappers = {"neumann_propagate": nm_ops.neumann_propagate, "minplus_matmul": mp_ops.minplus_matmul,
                "minplus_matmul_argmin": mp_ops.minplus_matmul_argmin}

    def one_round():
        with torch.no_grad():
            _, aux = core.round_eval(stacked, state)
            core.placement_update(stacked, state, aux["ctg"])

    calls = record_kernel_calls(one_round)

    err = {"neumann_cols": 0.0, "neumann_rows": 0.0, "minplus": 0.0, "minplus_argmin": 0.0}
    rel = {"neumann_cols": 0.0, "neumann_rows": 0.0}  # max abs error over the largest |x|
    seen = {"solves": {"neumann_cols": 0, "neumann_rows": 0}, "zero_rhs_operators": 0,
            "minplus_products": 0, "argmin_products": 0, "all_big_argmin_rows": 0}
    for (w, b), kw in calls["neumann_propagate"]:
        name = "neumann_cols" if kw["transpose"] else "neumann_rows"
        got = wrappers["neumann_propagate"](w, b, **kw)
        want = neumann_propagate_ref(w, b, kw["hops"], kw["tol"], kw["transpose"])
        e, scale = (got - want).abs().max().item(), want.abs().max().item()
        if not e <= NEUMANN_RTOL * scale:
            raise AssertionError(f"phase 7: {name} {tuple(w.shape)}: max err {e} > {NEUMANN_RTOL} * {scale}")
        zero = (b == 0).all(dim=-1)
        if bool((got[zero] != 0).any()):
            raise AssertionError(f"phase 7: {name}: a zero right-hand side gave a nonzero solution")
        err[name] = max(err[name], e)
        rel[name] = max(rel[name], e / scale if scale > 0 else 0.0)
        seen["solves"][name] += 1
        seen["zero_rhs_operators"] += int(zero.sum())
    for (a_, b_), _ in calls["minplus_matmul"]:
        got, want = wrappers["minplus_matmul"](a_, b_), minplus_matmul_ref(a_, b_)
        if not torch.equal(got, want):
            raise AssertionError(f"phase 7: minplus {tuple(a_.shape)} not bitwise equal to the plain version")
        seen["minplus_products"] += 1
    for (a_, b_), _ in calls["minplus_matmul_argmin"]:
        got, want = wrappers["minplus_matmul_argmin"](a_, b_), minplus_matmul_argmin_ref(a_, b_)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"phase 7: minplus_argmin {tuple(a_.shape)} not bitwise equal to the plain version")
        seen["argmin_products"] += 1
        seen["all_big_argmin_rows"] += int((a_ >= core.BIG).all(dim=-1).sum())
    del calls
    if not (min(seen["solves"].values()) > 0 and seen["zero_rhs_operators"] > 0 and seen["minplus_products"] > 0
            and seen["argmin_products"] > 0 and seen["all_big_argmin_rows"] > 0):
        raise AssertionError(f"phase 7: the recorded round lacks a padded case: {seen}")
    return {"max_abs_err": err, "neumann_err_over_scale": rel, **seen}


def phase7(core, counter, problems):
    """The fleet path: sample_fleet -> pad -> engine (placement sweep, trace) ->
    FleetResult, with the seven checks of the fleet workload, and each
    solver kernel against its plain version on one padded round."""
    import numpy as np
    import torch
    from repro_torch import fleet
    from repro_torch.core import placement
    from repro_torch.obs import trace as obs_trace

    kw = dict(method="ALT", m_max=4, t_phi=5, round_to=8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = counter.run(lambda: fleet.solve_fleet(problems, trace=True, keep_state=True, **kw))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches, variants = counter.last, counter.last_variants
    stacked, info = fleet.stack_problems(problems, round_to=8)
    b, v, a, k = stacked.net.adj.shape[0], stacked.net.n_nodes, stacked.apps.n_apps, stacked.apps.L.shape[-1]

    # 1. J finite, the best of its history, traffic conserved on real apps.
    J, hist = res.J, res.history
    if J.shape != (FLEET_B,) or not np.isfinite(J).all():
        raise AssertionError("phase 7: J not finite or wrong shape")
    if not (np.array_equal(np.nanmin(hist, axis=1), J) and (J <= hist[:, 0]).all()):
        raise AssertionError("phase 7: returned J is not the best of the history")
    absorbed = core.total_absorbed(stacked, res.state)
    lam = stacked.apps.lam
    real = lam > 0
    cons = ((absorbed - lam).abs()[real] / lam[real]).max().item()
    if not cons <= 1e-3:
        raise AssertionError(f"phase 7: conservation violated by {cons}")
    # 7. The path went through every solver kernel (nonzero: counts follow the data).
    for name in ("neumann_cols", "neumann_rows", "minplus", "minplus_argmin"):
        if launches[name] <= 0:
            raise AssertionError(f"phase 7: {name} never launched")
    vs_plain = fleet_kernels_vs_plain(core, stacked, res.state)

    # 2. The trace changes no solved bit.
    untraced = counter.run(lambda: fleet.solve_fleet(problems, trace=False, **kw))
    if not np.array_equal(untraced.J, res.J) or untraced.trace is not None:
        raise AssertionError("phase 7: trace=False changed J")

    def near(got_J, same_hosts, what):
        """rtol 1e-5 per lane, except on at most NEAR_TIE_LANES lanes whose
        hosts differ (a placement near-tie of marginals that differ by an
        ulp, ROADMAP section 3), which hold J to NEAR_TIE_RTOL."""
        rel = np.abs(np.asarray(got_J) / J[:len(got_J)] - 1.0)
        ties = []
        for lane in np.flatnonzero(rel > 1e-5):
            if same_hosts[lane] or not rel[lane] <= NEAR_TIE_RTOL:
                raise AssertionError(f"phase 7: {what} lane {lane}: J {got_J[lane]} vs {J[lane]} "
                                     f"(hosts {'same' if same_hosts[lane] else 'differ'})")
            ties.append(int(lane))
        if len(ties) > NEAR_TIE_LANES:
            raise AssertionError(f"phase 7: {what}: {len(ties)} lanes off by more than 1e-5: {ties}")
        return {"max_rel": float(rel.max()), "near_tie_lanes": ties}

    # 3. Two chunks of half the fleet against the single batch.
    chunked = counter.run(lambda: fleet.solve_fleet(problems, chunk_size=FLEET_B // 2, **kw))
    chunk_vs = near(chunked.J, [np.array_equal(chunked.hosts[i], res.hosts[i]) for i in range(FLEET_B)],
                    "chunk_size=B/2")
    # 4. Lanes 0-3 (one of each family), unpadded at B = 1.
    seq = counter.run(lambda: fleet.solve_sequential(problems[:4], m_max=4, t_phi=5))
    seq_same = []
    for i, r in enumerate(seq):
        h = r.state.hosts().cpu().numpy()
        seq_same.append(np.array_equal(h, res.hosts[i, :h.shape[0], :h.shape[1]]))
    seq_vs = near([r.J for r in seq], seq_same, "solve_sequential")
    # 5. The four methods on lanes 0-7: finite J, hosts only on real nodes.
    methods = {}
    for m in fleet.METHODS:
        r = counter.run(lambda m=m: fleet.solve_fleet(problems[:8], **{**kw, "method": m}))
        rows = r.per_instance()
        if not np.isfinite(r.J).all() or any("padded_host_leaks" in row for row in rows):
            raise AssertionError(f"phase 7: {m} J not finite or a host on a pad node")
        methods[m] = {"J_mean": float(r.J.mean()), "rounds": r.rounds}

    # 6. repair_placement: two non-endpoint nodes whose loss keeps the graph
    # connected die, at least one of them hosting a partition. Lane 0 when
    # it has such a host (a depth-1 lane may host every partition at an
    # app endpoint), else the first lane that does.
    for lane in range(FLEET_B):
        prob = problems[lane]
        adj_l = prob.net.adj.cpu().numpy()
        live_apps = res.app_mask[lane] > 0
        parts_l = res.parts[lane]
        busy = {int(h) for row, pa in zip(res.hosts[lane][live_apps], parts_l[live_apps]) for h in row[:pa]}
        ends = set(prob.apps.src.tolist()) | set(prob.apps.dst.tolist())
        dead = []
        for node in sorted(busy - ends) + sorted(set(range(prob.net.n_nodes)) - busy - ends):
            if connected_without(adj_l, dead + [node]):
                dead.append(node)
            if len(dead) == 2:
                break
        if dead and dead[0] in busy:
            break
    else:
        raise AssertionError("phase 7: no lane hosts a partition on a removable non-endpoint node")
    lane0, info0 = fleet.stack_problems([prob], envelope=(v, a), n_parts=k - 1, hop_bound=stacked.hop_bound)
    state0 = core.State(x=res.state.x[lane:lane + 1], phi=res.state.phi[lane:lane + 1])
    same = counter.run(lambda: placement.repair_placement(lane0, state0, info0.node_mask))
    if not (torch.equal(same.x, state0.x) and torch.equal(same.phi, state0.phi)):
        raise AssertionError("phase 7: repair_placement with every node live changed the state")
    adj, mu, nu = lane0.net.adj.clone(), lane0.net.mu.clone(), lane0.net.nu.clone()
    mask = info0.node_mask.clone()
    for d in dead:
        adj[:, d, :] = 0.0
        adj[:, :, d] = 0.0
        mu[:, d, :] = core.BIG
        mu[:, :, d] = core.BIG
        nu[:, d] = fleet.NU_PAD
        mask[:, d] = 0.0
    broken = dataclasses.replace(lane0, net=core.Network(adj=adj, mu=mu, nu=nu))
    repaired = counter.run(lambda: placement.repair_placement(broken, state0, mask))
    h_rep = repaired.hosts()[0].cpu().numpy()
    real_parts = [(int(i), p) for i in np.flatnonzero(live_apps) for p in range(parts_l[i])]
    on_dead = [(i, p) for i, p in real_parts if h_rep[i, p] in dead]
    if on_dead:
        raise AssertionError(f"phase 7: repair left partitions {on_dead} on dead nodes {dead}")
    moved = sum(int(h_rep[i, p] != res.hosts[lane][i, p]) for i, p in real_parts)
    if moved == 0 or any(h_rep[i, p] != res.hosts[lane][i, p] for i, p in real_parts
                         if res.hosts[lane][i, p] not in dead):
        raise AssertionError(f"phase 7: repair moved {moved} partitions, or moved one off a live node")

    # One more round, each step timed with CUDA events (as phase 3), and the
    # placement sweep twice more on the same inputs.
    state = res.state
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    with torch.no_grad():
        torch.cuda.synchronize()
        ev[0].record()
        core.structured_init(stacked)
        ev[1].record()
        _, aux = core.round_eval(stacked, state)
        ev[2].record()
        nxt = core.placement_update(stacked, state, aux["ctg"])
        ev[3].record()
        core.forwarding_update(stacked, nxt, t_phi=kw["t_phi"], alpha=0.5)
        ev[4].record()
        torch.cuda.synchronize()
        split = {
            "init_ms": ev[0].elapsed_time(ev[1]), "round_eval_ms": ev[1].elapsed_time(ev[2]),
            "placement_ms": ev[2].elapsed_time(ev[3]), "forwarding_ms": ev[3].elapsed_time(ev[4]),
        }
        sweep_ms = [cuda_ms(lambda: core.placement_update(stacked, state, aux["ctg"]), 1, 0)
                    for _ in range(2)]
        # Device operations (kernels, copies, fills) one sweep issues, and
        # their device time.
        pr = profile(lambda: core.placement_update(stacked, state, aux["ctg"]), {})
        sweep_ops = {"device_ops": pr.get("device_ops", "not measured"),
                     "device_busy_ms": pr.get("device_busy_ms", "not measured")}
        del nxt, aux

    def one_round():
        with torch.no_grad():
            _, aux = core.round_eval(stacked, state)
            nxt = core.placement_update(stacked, state, aux["ctg"])
            core.forwarding_update(stacked, nxt, t_phi=kw["t_phi"], alpha=0.5)

    prof = profile(
        one_round, {"neumann_rows": ("neumann_rows_kernel",), "neumann_cols": ("neumann_cols_kernel",),
                    "minplus": ("minplus_tile_kernel",), "minplus_argmin": ("minplus_argmin",)},
        split["round_eval_ms"] + split["placement_ms"] + split["forwarding_ms"],
    )
    # The round phases from the engine's own spans, over one traced solve
    # of the same fleet (host clocks; the execute span ends after the
    # device while tracing is on).
    obs_trace.configure(enabled=True)
    obs_trace.reset()
    try:
        traced = counter.run(lambda: fleet.solve_fleet(problems, **kw))
        spans = obs_trace.TRACER.events()
    finally:
        obs_trace.configure(enabled=False)
        obs_trace.reset()
    if not (np.array_equal(traced.J, res.J) and np.array_equal(traced.hosts, res.hosts)):
        raise AssertionError("phase 7: tracing changed the solve")
    phases = round_phases(spans, traced.rounds)
    inner = phases["placement_ms"] + phases["forwarding_ms"] + phases["eval_ms"]
    if not (all(math.isfinite(x) and x > 0 for x in phases.values()) and inner <= phases["round_ms"]
            and phases["round_spans"] == traced.rounds):
        raise AssertionError(f"phase 7: round phases from the spans {phases}")
    emit({
        "phase": 7, "name": "fleet", "B": b, "V": v, "A": a, "K": k, **kw,
        "families": {f: sum(1 for i in range(FLEET_B) if i % 4 == j) for j, f in enumerate(fleet.FAMILIES)},
        "rounds": res.rounds, "wall_s": wall, "ms_per_round": 1e3 * wall / max(res.rounds, 1),
        "peak_gb": peak / 1e9, "phi_gb": b * a * k * v * v * 4 / 1e9,
        "real_nodes": int(res.node_mask.sum()), "padded_nodes": b * v,
        "real_apps": int(res.app_mask.sum()), "padded_apps": b * a,
        "J_mean": float(J.mean()), "conservation_rel": cons, "mean_churn": res.trace.mean_churn(),
        "iters": np.bincount(res.iters, minlength=5).tolist(), "launches": launches,
        "variants": {n: variants[n] for n in ("neumann_cols", "neumann_rows", "minplus_argmin")},
        "split": split, "profile": prof, "round_phases": phases, "placement_ms_block_apps_1": sweep_ms,
        "placement_ops_block_apps_1": sweep_ops,
        "kernels_vs_plain": vs_plain,
        "chunk_half_vs_single": chunk_vs, "sequential_lanes_0_3_vs_fleet": seq_vs, "methods_lanes_0_7": methods,
        "repair": {"lane": lane, "dead": dead, "hosts_moved": moved, "identity_all_live": True},
    })
    del res, untraced, chunked, traced, stacked, state
    torch.cuda.empty_cache()
    return vs_plain["max_abs_err"], J


def round_phases(spans, rounds: int) -> dict:
    """Milliseconds a round of the engine's spans in one traced solve (the
    round, each phase, the host's waits on the device inside the round,
    execute over the rounds) and the host syncs a round and a call."""
    by_id = {e.id: e for e in spans}

    def per_round(name):
        return 1e3 * sum(e.dur for e in spans if e.name == name) / rounds

    def in_round(e):
        while e is not None and e.name != "solve_fleet.round":
            e = by_id.get(e.parent)
        return e is not None

    round_spans = [e for e in spans if e.name == "solve_fleet.round"]
    return {
        "round_spans": len(round_spans), "round_ms": per_round("solve_fleet.round"),
        "execute_ms": per_round("solve_fleet.execute"),
        **{f"{p}_ms": per_round(f"solve_fleet.round.{p}") for p in ("placement", "forwarding", "eval")},
        "host_wait_ms": 1e3 * sum(e.dur for e in spans if e.name == "device.sync" and in_round(e)) / rounds,
        "host_syncs_per_round": sum(e.attrs["host_syncs"] for e in round_spans) / rounds,
        "host_syncs_per_call": sum(e.attrs["host_syncs"] for e in spans if e.name == "solve_fleet.call"),
    }


# Phase 8: run_control's CLI defaults over phase 7's fleet, with both
# exactness gates and the cold comparison on.
CONTROL_EPOCHS, CONTROL_TRACE_SEED = 50, 11
CONTROL_KW = dict(m_max=8, t_phi=5, round_to=8)
CONTROL_SPANS = ("control.chaos", "control.hop_bound", "control.repair", "control.solve", "control.compare_cold")


def span_window_idle(fn, span_name: str, index: int) -> dict:
    """Device busy time and idle share inside the `index`-th `span_name`
    span of `fn()`, from one torch.profiler capture: obs spans are profiler
    ranges while tracing is on, and every device operation that starts in
    the span's host interval counts (one stream: they do not overlap). The
    span must end in a device sync for the share to cover its work. "not
    measured" if the capture has no such span or no device operation."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    windows = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.name == span_name and e.device_type == cpu)
    if len(windows) <= index:
        return {"idle_share": "not measured"}
    t0, t1 = windows[index]
    ops = [e.time_range.end - e.time_range.start for e in events
           if e.device_type == cuda and t0 <= e.time_range.start < t1
           and not e.name.startswith(("control.", "solve_fleet.", "launch.", "pareto."))]
    if not ops:
        return {"idle_share": "not measured"}
    busy = sum(ops)
    return {"window_ms": (t1 - t0) / 1e3, "device_busy_ms": busy / 1e3, "device_ops": len(ops),
            "idle_share": max(0.0, 1.0 - busy / (t1 - t0))}


def churn_epoch_vs_plain(core, chaos, fleet, problems, trace) -> dict:
    """One node-churn epoch's kernel inputs, recorded and replayed: the warm
    hop-bound closure of each instance a node event touched (its masked
    product, then the squarings) and `refresh_apsp0` over the epoch's fleet
    (the APSP squarings and the next-hop argmin at B = 64), through each
    kernel and its plain version, bitwise."""
    import torch
    from repro_torch.kernels.minplus import minplus_matmul_argmin_ref, minplus_matmul_ref
    from repro_torch.kernels.minplus import ops as mp_ops

    timeline = list(trace.timeline())
    epoch = next(e for e, fired, _ in timeline if e > 0 and any(
        ev.kind in (chaos.NODE_DOWN, chaos.NODE_UP) for ev in fired))
    before, (_, fired, after) = timeline[epoch - 1][2], timeline[epoch]
    insts = sorted({ev.instance for ev in fired if ev.kind in (chaos.NODE_DOWN, chaos.NODE_UP)})
    probs = [chaos.apply_health(p, h)[0] for p, h in zip(problems, after)]
    caches = {i: core.hop_bound_cache(chaos.apply_health(problems[i], before[i])[0].net) for i in insts}
    env = dict(round_to=CONTROL_KW["round_to"], envelope=fleet.fleet_envelope(problems, round_to=CONTROL_KW["round_to"]),
               n_parts=fleet.fleet_part_envelope(problems), hop_bound=fleet.unify_hop_bound(problems))
    warm, sweeps = [], []
    for i in insts:
        calls = record_kernel_calls(lambda i=i: sweeps.append(core.hop_bound_cache(probs[i].net, caches[i]).sweeps))
        warm += calls["minplus_matmul"]
    apsp0 = record_kernel_calls(lambda: chaos.refresh_apsp0(probs, None, **env))
    seen = {"epoch": epoch, "instances": insts, "warm_sweeps": sweeps, "warm_products": len(warm),
            "apsp0_products": len(apsp0["minplus_matmul"]), "apsp0_argmin_products": len(apsp0["minplus_matmul_argmin"])}
    if not (min(sweeps) >= 1 and seen["apsp0_products"] and seen["apsp0_argmin_products"]):
        raise AssertionError(f"phase 8: the recorded churn epoch lacks a warm sweep or an APSP: {seen}")
    for (a_, b_), _ in warm + apsp0["minplus_matmul"]:
        if not torch.equal(mp_ops.minplus_matmul(a_, b_), minplus_matmul_ref(a_, b_)):
            raise AssertionError(f"phase 8: minplus {tuple(a_.shape)} not bitwise equal to the plain version")
    for (a_, b_), _ in apsp0["minplus_matmul_argmin"]:
        got, want = mp_ops.minplus_matmul_argmin(a_, b_), minplus_matmul_argmin_ref(a_, b_)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"phase 8: minplus_argmin {tuple(a_.shape)} not bitwise equal to the plain version")
    a_, _ = warm[0][0]
    seen["masked_product_touched_nodes"] = int((a_ < 1e18).any(dim=0).sum())
    seen["masked_product_big_share"] = float((a_ >= 1e18).float().mean())
    return seen


def no_fallback(res, what: str) -> None:
    """Every epoch of a control run accepted its first rung: the ladder
    catches a solve that raises or returns non-finite J, so an epoch that
    only a retry, CoLocated or the carried placement served is a fault."""
    fell = [(r.epoch, r.outcome, r.attempts) for r in res.reports if r.outcome != "ok" or r.attempts != 1]
    if fell or res.summary()["fallback_epochs"]:
        raise AssertionError(f"phase 8: {what} fell back on (epoch, outcome, attempts) {fell}")


def same_epochs(ref, got, what: str) -> list:
    """Two control runs of one trace agree epoch for epoch: mode, outcome,
    rounds and perturbed count equal, J_median at rtol 1e-5. Returns the
    relative J_median differences."""
    same = ("mode", "outcome", "rounds", "perturbed")
    rel = []
    for g, c in zip(got.reports, ref.reports, strict=True):
        if any(getattr(g, k) != getattr(c, k) for k in same):
            raise AssertionError(f"phase 8: {what}: epoch {g.epoch} {[getattr(g, k) for k in same]} vs "
                                 f"{[getattr(c, k) for k in same]}")
        rel.append(abs(g.J_median / c.J_median - 1.0))
    if not max(rel) <= 1e-5:
        raise AssertionError(f"phase 8: {what}: J_median rel {max(rel)}")
    return rel


def span_means(spans: dict) -> dict:
    return {k: 1e3 * sum(spans.get(k, [0.0])) / max(1, len(spans.get(k, []))) for k in CONTROL_SPANS}


def phase8(core, counter, problems):
    """The control plane: `run_control` over phase 7's fleet and a 50-epoch
    fault trace, with both exactness gates (the warm hop-bound closure and
    the cached zero-load APSP held bitwise to from-scratch solves on every
    epoch) and the cold comparison; a replay of one node-churn epoch's
    min-plus inputs; the same trace again with the gates and the comparison
    off (the warm path's own recovery latency); one event epoch's device
    idle share; and the small control loop on the card against the CPU.
    Every run must serve every epoch from its first rung."""
    import numpy as np
    import torch
    from repro_torch import chaos, fleet
    from repro_torch.launch import control
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace

    trace = chaos.generate_trace(problems, CONTROL_EPOCHS, seed=CONTROL_TRACE_SEED)
    obs_metrics.registry.reset()
    obs_trace.configure(enabled=True)
    obs_trace.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ctl = counter.run(lambda: control.run_control(
        problems, trace=trace, verify_hop_bound=True, verify_apsp0=True, compare_cold=True, **CONTROL_KW))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches, argmin_variants = counter.last, counter.last_variants["minplus_argmin"]
    spans = {}
    for e in obs_trace.TRACER.events():
        spans.setdefault(e.name, []).append(e.dur)
    obs_trace.configure(enabled=False)
    snap = obs_metrics.registry.snapshot()
    summ = ctl.summary()

    bad = [r.epoch for r in ctl.reports if not (r.finite and r.feasible and np.isfinite(r.J_median))]
    if bad or summ["infeasible_epochs"] or summ["nonfinite_epochs"]:
        raise AssertionError(f"phase 8: epochs {bad} not finite and feasible: {summ}")
    no_fallback(ctl, "the gated run")
    if not snap.get("control.apsp0.hits", 0) > 0:
        raise AssertionError("phase 8: the zero-load APSP cache never hit")
    if not snap.get("control.hop_bound.warm_sweeps", 0) > 0:
        raise AssertionError("phase 8: the warm hop-bound closure took no sweep on a node-churn epoch")
    if not summ["warm_rounds_executed"] <= summ.get("cold_rounds_executed", -1):
        raise AssertionError(f"phase 8: warm rounds {summ['warm_rounds_executed']} above cold "
                             f"{summ.get('cold_rounds_executed')} on event epochs")
    for name in ("neumann_cols", "neumann_rows", "minplus", "minplus_argmin"):
        if launches[name] <= 0:
            raise AssertionError(f"phase 8: {name} never launched")
    replay = churn_epoch_vs_plain(core, chaos, fleet, problems, trace)

    # The warm path alone: the same trace with both gates and the cold
    # comparison off, the recovery latency an operator sees. Its epochs are
    # the gated run's (the gates and the comparison change no state).
    obs_trace.configure(enabled=True)
    obs_trace.reset()
    t0 = time.perf_counter()
    bare = counter.run(lambda: control.run_control(problems, trace=trace, **CONTROL_KW))
    bare_wall = time.perf_counter() - t0
    bare_spans = {}
    for e in obs_trace.TRACER.events():
        bare_spans.setdefault(e.name, []).append(e.dur)
    obs_trace.configure(enabled=False)
    no_fallback(bare, "the warm-path run")
    same_epochs(ctl, bare, "gated vs warm-path run")
    bare_summ = bare.summary()

    # One event epoch's device idle share: epoch 1 of a two-epoch trace that
    # kills the trace's first killed node (the solve's gather of J syncs).
    first = next(ev for ev in trace.events if ev.kind == chaos.NODE_DOWN)
    two = chaos.FaultTrace((dataclasses.replace(first, epoch=1),), 2, len(problems))
    obs_trace.configure(enabled=True)
    idle = span_window_idle(lambda: control.run_control(problems, trace=two, **CONTROL_KW), "control.epoch", 1)
    obs_trace.configure(enabled=False)
    obs_trace.reset()

    # The small control loop (four iot_hierarchy instances, 12 epochs) on the
    # card and on the CPU: the same epochs, J_median at rtol 1e-5, the final
    # hosts equal but on at most NEAR_TIE_LANES lanes.
    def small(device):
        base = fleet.sample_fleet(4, families=["iot_hierarchy"], seed=2030, device=device)
        tr = chaos.generate_trace(base, 12, seed=2031, node_failures=3, link_degradations=2, flash_crowds=1)
        return control.run_control(base, trace=tr, m_max=20, t_phi=5, round_to=8, device=device)

    gpu, cpu = counter.run(lambda: small("cuda")), small("cpu")
    no_fallback(gpu, "the small loop on the card")
    no_fallback(cpu, "the small loop on the CPU")
    rel = same_epochs(cpu, gpu, "card vs CPU")
    g_hosts, c_hosts = gpu.state.hosts().cpu(), cpu.state.hosts()
    differ = [i for i in range(g_hosts.shape[0]) if not torch.equal(g_hosts[i], c_hosts[i])]
    if len(differ) > NEAR_TIE_LANES:
        raise AssertionError(f"phase 8: card vs CPU final hosts differ on lanes {differ}")

    emit({
        "phase": 8, "name": "control", "instances": len(problems), "epochs": CONTROL_EPOCHS,
        "trace_seed": CONTROL_TRACE_SEED, **CONTROL_KW, "events": summ["events"],
        "gates_and_cold_comparison": {
            "wall_s": wall, "epochs_per_s": summ["epochs_per_s"], "p50_recovery_latency_s": summ["p50_recovery_latency_s"],
            "p95_recovery_latency_s": summ["p95_recovery_latency_s"],
            "recovery_latency_s": snap.get("control.recovery_latency_s"),
            "span_mean_ms": span_means(spans), "span_count": {k: len(spans.get(k, [])) for k in CONTROL_SPANS}},
        "warm_path": {
            "wall_s": bare_wall, "epochs_per_s": bare_summ["epochs_per_s"],
            "p50_recovery_latency_s": bare_summ["p50_recovery_latency_s"],
            "p95_recovery_latency_s": bare_summ["p95_recovery_latency_s"],
            "recovery_s": [r.recovery_s for r in bare.reports if r.recovery_s is not None],
            "span_mean_ms": span_means(bare_spans)},
        "warm_rounds_executed": summ["warm_rounds_executed"], "cold_rounds_executed": summ.get("cold_rounds_executed"),
        "fallback_epochs": summ["fallback_epochs"], "warm_epochs": summ["warm_epochs"],
        "hop_bound": {"max": snap.get("control.hop_bound.max"), **{k.rsplit(".", 1)[-1]: snap.get(k, 0) for k in (
            "control.hop_bound.warm_sweeps", "control.hop_bound.unchanged", "control.hop_bound.exceeds_pinned")}},
        "apsp0": {"hits": snap.get("control.apsp0.hits", 0), "misses": snap.get("control.apsp0.misses", 0)},
        "peak_gb": peak / 1e9, "launches": launches, "argmin_variants": argmin_variants,
        "event_epoch_device": idle, "churn_epoch_vs_plain": replay,
        "card_vs_cpu": {"epochs": len(rel), "max_J_median_rel": max(rel), "host_lanes_differ": differ},
    })
    del ctl, bare, gpu, cpu
    torch.cuda.empty_cache()


# Phase 9: the Pareto CLI's defaults, every candidate of the zoo.
PARETO_SUB = dict(archs=("qwen1.5-0.5b", "mamba2-370m"), topologies=("iot",))
PARETO_OBJECTIVES = ("J", "latency", "compute", "egress")


def phase9(counter):
    """The split-point Pareto sweep: `sweep_zoo()` at the CLI's defaults
    (12 archs, iot and mesh, parts 1-4, 16 cut sets a depth, one batched
    solve in chunks under the 2 GB envelope cap), its fronts checked, and
    a sub-sweep on the card against the CPU."""
    import numpy as np
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.partition import pareto

    obs_metrics.registry.reset()
    t0 = time.perf_counter()
    rep = counter.run(pareto.sweep_zoo)
    wall = time.perf_counter() - t0
    launches, argmin_variants = counter.last, counter.last_variants["minplus_argmin"]
    snap = obs_metrics.registry.snapshot()
    pareto.check_fronts(rep)
    if not all(np.isfinite(p["J"]) for c in rep["cells"] for p in c["points"]):
        raise AssertionError("phase 9: a candidate's J is not finite")
    n_cells = len(rep["archs"]) * len(rep["topologies"]) * len(rep["loads"])
    if rep["archs"] != list(pareto.ZOO) or len(rep["cells"]) != n_cells or not all(c["front"] for c in rep["cells"]):
        raise AssertionError(f"phase 9: {len(rep['cells'])} cells of {rep['archs']}, or an empty front")
    for name in ("neumann_cols", "neumann_rows", "minplus", "minplus_argmin"):
        if launches[name] <= 0:
            raise AssertionError(f"phase 9: {name} never launched")

    gpu = counter.run(lambda: pareto.sweep_zoo(**PARETO_SUB))
    cpu = pareto.sweep_zoo(**PARETO_SUB, device="cpu")
    # Every point's J, latency, compute and egress at rtol 1e-5. Egress is a
    # function of the hosts alone, so a point whose egress differs at all
    # was placed on other hosts by the card than by the CPU.
    rel, swapped, hosts_differ = dict.fromkeys(PARETO_OBJECTIVES, 0.0), {}, {}
    for g, c in zip(gpu["cells"], cpu["cells"], strict=True):
        for i, (pg, pc) in enumerate(zip(g["points"], c["points"], strict=True)):
            for k in PARETO_OBJECTIVES:
                rel[k] = max(rel[k], abs(pg[k] - pc[k]) / abs(pc[k]) if pc[k] else abs(pg[k]))
            if pg["egress"] != pc["egress"]:
                hosts_differ.setdefault(g["arch"], []).append(i)
        swapped[g["arch"]] = pareto.fronts_agree(c, g, 1e-5)
    if not max(rel.values()) <= 1e-5:
        raise AssertionError(f"phase 9: card vs CPU objectives rel {rel}, points on other hosts {hosts_differ}")
    emit({
        "phase": 9, "name": "pareto", "archs": len(rep["archs"]), "topologies": rep["topologies"],
        "instances": rep["n_instances"], "chunks": snap.get("fleet.chunks_executed"), "rounds": rep["rounds"],
        "pad_overhead_fraction": rep["pad_overhead_fraction"], "cut_sets_possible": rep["cut_sets_possible"],
        "cut_sets_dropped": rep["cut_sets_dropped"], "wall_s": wall, "candidates_per_s": rep["n_instances"] / wall,
        "front_sizes": {f"{c['arch']}/{c['topology']}": c["front_size"] for c in rep["cells"]},
        "launches": launches, "argmin_variants": argmin_variants,
        "card_vs_cpu": {"cells": len(gpu["cells"]), "max_rel": rel, "points_on_other_hosts": hosts_differ,
                        "near_tie_front_swaps": swapped},
    })


# Names of the obs spans (torch.profiler ranges while tracing is on).
SPAN_PREFIXES = ("serve.", "moe.", "ssm.", "round.", "control.", "flash.")


def profile(fn, families, wall_ms=None, regions=()) -> dict:
    """Device time of `fn()` under torch.profiler by kernel family
    (`families`: name -> substrings of kernel names; the rest is "other"),
    the ten largest kernels, the count of device operations (kernels,
    copies, fills), and, given `wall_ms` (the same work timed
    without the profiler), the device's idle share. Only device-side kernel
    events are summed: CPU operator ranges also carry their children's
    device time, and the device-side ranges of `obs` spans cover idle
    gaps. `regions`: obs span names whose ranges' device time (every
    kernel launched inside them, so overlapping the families) is reported
    apart; the spans record only while tracing is on. "not measured" if
    the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fam = {k: 0.0 for k in families} | {"other": 0.0}
    region_ms = {k: 0.0 for k in regions}
    top = []
    for e in prof.key_averages():
        if e.key in region_ms and e.device_type == torch.autograd.DeviceType.CPU:
            region_ms[e.key] += getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0)) / 1e3
        if e.device_type != torch.autograd.DeviceType.CUDA or e.key.startswith(SPAN_PREFIXES):
            continue
        dev_ms = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        if dev_ms <= 0:
            continue
        key = next((f for f, subs in families.items() if any(x in e.key for x in subs)), "other")
        fam[key] += dev_ms
        top.append((dev_ms, e.key[:90], e.count))
    busy = sum(fam.values())
    ops = sum(c for _, _, c in top)
    if busy <= 0:
        return {"device_ms": "not measured", "wall_ms": wall_ms}
    top.sort(reverse=True)
    out = {
        "device_busy_ms": busy, "device_ops": ops, "device_ms_by_family": fam,
        "top_kernels": [{"ms": t, "name": n, "calls": c} for t, n, c in top[:10]],
    }
    if regions:
        out["regions_device_ms"] = region_ms
    if wall_ms is not None:
        out.update(wall_ms=wall_ms, idle_share=max(0.0, 1.0 - busy / wall_ms))
    return out


# cuBLAS's kernels on this toolkit are named nvjet_* (GEMM) and gemv*.
SERVE_FAMILIES = {"flash": ("flash_kernel", "flash_wgmma_kernel"),
                  "matmul": ("nvjet", "gemm", "gemv", "xmma", "cutlass")}


def phase5(counter):
    """The serve loop on qwen1.5-0.5b at full width and depth."""
    import copy

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import serve_config
    from repro_torch.models import decode_step, init_params, logits_fn, prefill
    from repro_torch.models.model import ParamTree
    from repro_torch.obs import MetricsRegistry
    from repro_torch.obs import trace as obs_trace

    cfg = serve_config(get_config("qwen1.5-0.5b"))
    params = init_params(cfg, 0, device="cuda")
    n_params = sum(p.numel() for p in params.parameters())
    requests, slots, prompt_len, max_new, max_seq = 16, 8, 1024, 64, 2048
    prompts = np.random.RandomState(0).randint(0, cfg.vocab, (requests, prompt_len)).astype(np.int32)
    kw = dict(batch_slots=slots, max_new=max_new, max_seq=max_seq)

    def run(n_req, new):
        return serve(cfg, params, prompts[:n_req], **{**kw, "max_new": new}, registry=MetricsRegistry())

    run(slots, 2)  # warm-up: cuBLAS handles and first launches
    obs_trace.configure(enabled=True)
    obs_trace.reset()
    torch.cuda.reset_peak_memory_stats()
    tokens, summary = counter.run(lambda: run(requests, max_new))
    peak = torch.cuda.max_memory_allocated()
    launches = counter.last
    n_prefills = sum(1 for e in obs_trace.TRACER.events() if e.name == "serve.prefill")
    if (summary["requests"], summary["generated_tokens"], summary["decode_steps"]) != (16, 1024, 128):
        raise AssertionError(f"phase 5: summary {summary}")
    if launches["flash_attention"] != cfg.n_layers * n_prefills or n_prefills != 2:
        raise AssertionError(f"phase 5: {launches['flash_attention']} flash launches, {n_prefills} prefills")
    flash_variants = counter.last_variants["flash_attention"]
    if flash_variants != {"wgmma": launches["flash_attention"]}:  # every prefill on the tensor cores
        raise AssertionError(f"phase 5: flash variants {flash_variants}")
    if not all(len(t) == max_new and all(0 <= x < cfg.vocab for x in t) for t in tokens):
        raise AssertionError("phase 5: malformed generated tokens")

    # Prefill and one decode step at the serve shapes, by CUDA events.
    batch = {"tokens": torch.from_numpy(prompts[:slots]).cuda()}
    with torch.inference_mode():
        caches, _ = prefill(cfg, params, batch, max_seq)
        step_tok = torch.zeros(slots, 1, dtype=torch.int32, device="cuda")
        prefill_ms = cuda_ms(lambda: prefill(cfg, params, batch, max_seq), 3, 1)
        decode_ms = cuda_ms(lambda: decode_step(cfg, params, caches, step_tok, prompt_len), 20, 2)
        prof_prefill = profile(lambda: prefill(cfg, params, batch, max_seq), SERVE_FAMILIES)
        prof_decode = profile(
            lambda: [decode_step(cfg, params, caches, step_tok, prompt_len) for _ in range(4)],
            SERVE_FAMILIES, 4 * decode_ms)
        del caches
    # One wave (8 requests, 16 new tokens) untimed, timed, then profiled.
    t0 = time.perf_counter()
    run(slots, 16)
    torch.cuda.synchronize()
    wave_ms = 1e3 * (time.perf_counter() - t0)
    prof_wave = profile(lambda: run(slots, 16), SERVE_FAMILIES, wave_ms)
    obs_trace.configure(enabled=False)

    # Prefill-then-decode against the full forward at full width and depth:
    # the prefill goes through the kernel, the decode steps through plain
    # attention. In fp32 compute (on the bf16 weights) they agree within
    # test_models.py's rtol 2e-3, atol 1e-2. In the serve config's bf16
    # compute, GEMMs of other row counts round differently and 24 layers
    # carry those roundings to the logits: held to 4 bf16 ulps of the
    # largest logit (0.035 measured at logits up to 3.0, 2.25 such ulps).
    toks = torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab, (2, 72)).astype(np.int32)).cuda()
    consistency = {}
    for compute in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, compute_dtype=compute)
        with torch.inference_mode():
            full = logits_fn(c, params, {"tokens": toks}).float()
            caches, last = prefill(c, params, {"tokens": toks[:, :64]}, 128)
            pairs = [(last[:, 0].float(), full[:, 63])]
            for pos in range(64, 71):
                lg, caches = decode_step(c, params, caches, toks[:, pos:pos + 1], pos)
                pairs.append((lg[:, 0].float(), full[:, pos]))
        top = full.abs().max().item()
        tol = dict(rtol=2e-3, atol=1e-2) if compute == "float32" else dict(
            rtol=0.0, atol=4 * 2.0 ** (math.floor(math.log2(top)) - 7))
        consistency[compute] = {
            "max_abs": max((a - b).abs().max().item() for a, b in pairs), "max_logit": top, **tol}
        for a, b in pairs:
            torch.testing.assert_close(a, b, **tol)
        del full, caches

    # The card against the CPU on the same weights: full width, the first
    # 4 layers, B=1, S=256, fp32 compute.
    cfg4 = dataclasses.replace(cfg, n_layers=4, compute_dtype="float32")
    p4 = ParamTree({"embed": params.embed, "final_norm": params.final_norm, "blocks": list(params.blocks)[:4]})
    p4_cpu = copy.deepcopy(p4).to("cpu")
    toks = torch.from_numpy(np.random.RandomState(2).randint(0, cfg.vocab, (1, 256)).astype(np.int32))
    with torch.inference_mode():
        gpu = logits_fn(cfg4, p4, {"tokens": toks.cuda()}).cpu()
        cpu = logits_fn(cfg4, p4_cpu, {"tokens": toks})
    gpu_vs_cpu = ((gpu - cpu).abs() / cpu.abs().clamp(min=1e-3)).max().item()
    torch.testing.assert_close(gpu, cpu, rtol=1e-3, atol=1e-4)
    del p4_cpu, gpu, cpu

    emit({
        "phase": 5, "arch": cfg.name, "params": n_params, "requests": requests, "slots": slots,
        "prompt_len": prompt_len, "max_new": max_new, "max_seq": max_seq, "serve": {
            k: v for k, v in summary.items() if k != "metrics"},
        "prefills": n_prefills, "launches": launches, "flash_variants": flash_variants, "peak_gb": peak / 1e9,
        "prefill_ms": prefill_ms, "decode_step_ms": decode_ms,
        "profile_prefill": prof_prefill, "profile_4_decode_steps": prof_decode, "wave_8x16": prof_wave,
        "prefill_decode_vs_forward": consistency, "gpu_vs_cpu_max_rel": gpu_vs_cpu,
    })
    return cfg, params


def phase6(counter, cfg, params):
    """The data plane: partition 1 -> stage-1 activation -> partition 2."""
    import numpy as np
    import torch
    from repro_torch.models import logits_fn
    from repro_torch.partition import run_partition, split_params

    k = 12
    toks = torch.from_numpy(np.random.RandomState(3).randint(0, cfg.vocab, (1, 1024)).astype(np.int32)).cuda()

    def split_run():
        with torch.inference_mode():
            p1, p2 = split_params(cfg, params, k)
            act = run_partition(cfg, p1, {"tokens": toks}, part=1)
            return act, run_partition(cfg, p2, act, part=2)

    t0 = time.perf_counter()
    act, logits = counter.run(split_run)
    wall = time.perf_counter() - t0
    with torch.inference_mode():
        mono = logits_fn(cfg, params, {"tokens": toks})
    torch.testing.assert_close(logits.float(), mono.float(), rtol=2e-3, atol=2e-3)
    if act.shape != (1, 1024, cfg.d_model) or not bool(torch.isfinite(act).all()):
        raise AssertionError(f"phase 6: activation {tuple(act.shape)} not finite")
    emit({
        "phase": 6, "arch": cfg.name, "split_layer": k, "seq_len": 1024,
        "activation_bytes": act.numel() * act.element_size(), "activation_dtype": str(act.dtype),
        "bitwise_equal_monolithic": bool(torch.equal(logits, mono)),
        "max_abs_vs_monolithic": (logits.float() - mono.float()).abs().max().item(),
        "wall_s": wall, "launches": counter.last,
    })


# ---------------------------------------------------------------------------
# Phase 10: every model family the port serves, at full width, bf16
# parameters, random weights from seed 0.
# ---------------------------------------------------------------------------
FAMILY_KERNELS = {**SERVE_FAMILIES, "elementwise": ("elementwise_kernel",)}
FAMILY_REGIONS = ("moe.dispatch", "moe.experts", "moe.combine", "ssm.ssd")
SERVED = ("mamba2-370m", "hymba-1.5b", "qwen2-moe-a2.7b")  # phase 5's traffic through serve()
CHECK_LAYERS, CHECK_SEQ = 2, 128  # card vs CPU: first layers at full width, fp32 compute


def bf16_ulps(top: float, n: int = 4) -> float:
    """n bf16 ulps at magnitude `top` (8 significant bits)."""
    return n * 2.0 ** (math.floor(math.log2(top)) - 7)


def by_position(calls: list, n_layers: int, positions: list) -> dict:
    """{(layer, sequence, position): (experts, near-tie)} from one run's
    `record_routes()`; `positions[i]` lists the positions of the i-th run
    of the n_layers dispatches (a forward or prefill, then one decode step
    each). Empty where the model has no MoE layer."""
    out = {}
    for i, pos in enumerate(positions if calls else ()):
        for layer in range(n_layers):
            r = calls[i * n_layers + layer]
            experts = r.experts.view(-1, len(pos), r.experts.shape[-1])
            tie = r.near_tie().view(-1, len(pos))
            for b in range(experts.shape[0]):
                for j, p in enumerate(pos):
                    out[(layer, b, p)] = (tuple(experts[b, j].tolist()), bool(tie[b, j]))
    return out


def route_flips(a: dict, b: dict, n_layers: int, exact: bool, what: str):
    """The (layer, sequence, position) of every token the two runs sent to
    other experts, and a predicate for the (sequence, position) such a
    flip reaches: the token itself at the last layer, it and every later
    position of its sequence at an earlier one. Raises on a flip the
    rounding cannot explain: any flip where `exact` (float32 compute), else
    one that is a near-tie in neither run (`Route.near_tie`) and that no
    explained flip at an earlier layer, an earlier or the same position of
    its sequence, reaches."""
    flips = sorted(k for k in a.keys() & b.keys() if a[k][0] != b[k][0])  # by layer first
    for i, (layer, s, p) in enumerate(flips):
        carried = any(l0 < layer and s0 == s and p0 <= p for l0, s0, p0 in flips[:i])
        if exact or not (a[(layer, s, p)][1] or b[(layer, s, p)][1] or carried):
            raise AssertionError(f"phase 10 {what}: layer {layer}, sequence {s}, position {p} routed to "
                                 f"{a[(layer, s, p)]} and {b[(layer, s, p)]}, not a near-tie ({flips})")

    def reached(seq, pos):
        return any(s == seq and (p == pos or (layer < n_layers - 1 and p <= pos)) for layer, s, p in flips)

    return flips, reached


def tree_to(module, device) -> dict:
    """A ParamTree's tensors copied to `device`, as the nested dict
    ParamTree takes."""
    from torch import nn

    out = {n: p.detach().to(device) for n, p in module.named_parameters(recurse=False)}
    for n, m in module.named_children():
        out[n] = [tree_to(x, device) for x in m] if isinstance(m, nn.ModuleList) else tree_to(m, device)
    return out


def family_batch(cfg, rng, b: int, s: int, enc_len: int, device="cuda") -> dict:
    """Random inputs in the model's batch format: token ids, patch
    features a position, or frames plus decoder tokens."""
    import torch

    toks = torch.from_numpy(rng.randint(0, cfg.vocab, (b, s)).astype("int32")).to(device)
    if cfg.family == "encdec":
        feats = torch.from_numpy(rng.randn(b, enc_len, cfg.frontend_dim).astype("float32")).to(device)
        return {"feats": feats, "dec_tokens": toks}
    if cfg.frontend != "none":
        return {"feats": torch.from_numpy(rng.randn(b, s, cfg.frontend_dim).astype("float32")).to(device)}
    return {"tokens": toks}


def prefix(batch: dict, n: int) -> dict:
    if "dec_tokens" in batch:
        return {**batch, "dec_tokens": batch["dec_tokens"][:, :n]}
    return {k: v[:, :n] for k, v in batch.items()}


# decode_vs_forward's bf16 limit, in bf16 ulps of the largest logit: phase
# 5's 4, but more for the two deepest SSM stacks, whose JAX reference itself
# reads more than 4 on the same check at full width and depth
# (REFERENCE_BF16_ULPS, scripts/reference_bf16_noise.py on the CPU; 2.5
# for qwen1.5-0.5b). Each limit lies above every reading of the reference
# and of the port (mamba2 4.0, hymba 4.98, bitwise repeatable on the H100)
# and, for mamba2, below the 6.875 that scripts/bf16_gate_control.py reads
# with the SSM state cached in bf16 (hymba's control reads inside its
# noise: PERF.md section 6).
BF16_ULPS = {"mamba2-370m": 6.5, "hymba-1.5b": 6.0}
REFERENCE_BF16_ULPS = {"mamba2-370m": 6.25, "hymba-1.5b": 4.453125}


def _prefill_decode_gap(cfg, params, batch) -> dict:
    """Prefill of 64 tokens then 7 decode steps against the full forward of
    72 (B=2, as scripts/reference_bf16_noise.py reads the reference): the
    largest difference over the positions no router flip reaches, the flips
    (layer, sequence, position) and the (sequence, position) pairs they
    reach, left out. Flips are held to `route_flips` (none in float32
    compute), and at least half of the positions both runs route (0-70)
    must be reached by none, as the CPU tests require of a forward.
    `_logits` keeps every logit computed, for the repeat check."""
    import torch
    from repro_torch.models import decode_step, logits_fn, prefill
    from repro_torch.models.routes import record_routes

    toks = batch["dec_tokens"] if cfg.family == "encdec" else batch["tokens"]
    n = cfg.n_dec_layers if cfg.family == "encdec" else cfg.n_layers
    with torch.inference_mode(), record_routes() as fwd:
        full = logits_fn(cfg, params, batch).float()
    with torch.inference_mode(), record_routes() as inc:
        caches, last = prefill(cfg, params, prefix(batch, 64), 128)
        pairs = [(63, last[:, 0].float())]
        for pos in range(64, 71):
            lg, caches = decode_step(cfg, params, caches, toks[:, pos:pos + 1], pos)
            pairs.append((pos, lg[:, 0].float()))
    flips, reached = route_flips(by_position(fwd, n, [range(72)]),
                                 by_position(inc, n, [range(64)] + [[p] for p in range(64, 71)]), n,
                                 exact=cfg.compute_dtype == "float32", what=f"{cfg.name} prefill-then-decode")
    compared, left_out = [], []
    for pos, lg in pairs:
        for b in range(2):
            (left_out if reached(b, pos) else compared).append((b, pos, lg[b], full[b, pos]))
    unreached = sum(not reached(b, p) for b in range(2) for p in range(71)) / (2 * 71)
    if not compared or unreached < 0.5:
        raise AssertionError(f"phase 10 {cfg.name}: router near-ties reach {1 - unreached:.0%} of the "
                             f"positions, {len(left_out)} of {len(pairs) * 2} logits: {flips}")
    top = full.abs().max().item()
    err = max((x - y).abs().max().item() for _, _, x, y in compared)
    return {"layers": n, "max_abs": err, "max_logit": top, "ulps": err / bf16_ulps(top, 1),
            "route_flips": flips, "left_out": [(b, p) for b, p, _, _ in left_out],
            "compared": len(compared), "positions_unreached": unreached, "_compared": compared,
            "_logits": [full] + [lg for _, lg in pairs]}


def decode_vs_forward(cfg, params) -> dict:
    """Prefill-then-decode against the full forward, as phase 5: in fp32
    compute (on the bf16 weights) within test_models.py's rtol 2e-3, atol
    1e-2; in the config's bf16 compute within 4 bf16 ulps of the largest
    logit (BF16_ULPS for the deep SSM stacks). The bf16 run is made twice
    and must repeat bitwise. MoE at JAX's no-drop capacity (prefill and
    forward would drop other tokens); a token whose experts differ between
    the forward and prefill/decode (a bf16 router near-tie), and what it
    reaches, is reported and left out."""
    import numpy as np
    import torch

    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts) / cfg.top_k + 1.0)
    batch = family_batch(cfg, np.random.RandomState(1), 2, 72, 256)
    out = {}
    for compute in ("float32", "bfloat16"):
        res = _prefill_decode_gap(dataclasses.replace(cfg, compute_dtype=compute), params, batch)
        limit = BF16_ULPS.get(cfg.name, 4.0)
        tol = dict(rtol=2e-3, atol=1e-2) if compute == "float32" else dict(
            rtol=0.0, atol=bf16_ulps(res["max_logit"], limit))
        for _, _, x, y in res.pop("_compared"):
            torch.testing.assert_close(x, y, **tol)
        logits = res.pop("_logits")
        out[compute] = {**res, **tol}
        if compute == "bfloat16":
            again = _prefill_decode_gap(dataclasses.replace(cfg, compute_dtype=compute), params, batch)
            if not all(torch.equal(x, y) for x, y in zip(logits, again["_logits"], strict=True)):
                raise AssertionError(f"phase 10 {cfg.name}: the bf16 prefill-then-decode run does not repeat "
                                     f"bitwise ({res['ulps']} then {again['ulps']} ulps)")
            out[compute].update(limit_ulps=limit, repeat_bitwise=True)
            if cfg.name in REFERENCE_BF16_ULPS:
                out[compute]["reference_ulps"] = REFERENCE_BF16_ULPS[cfg.name]
    return out


def card_vs_cpu(cfg, params) -> dict:
    """The card against the CPU on the same weights: the first CHECK_LAYERS
    layers (of the encoder and the decoder) at full width, B=1, S=CHECK_SEQ,
    fp32 compute, rtol 1e-3 / atol 1e-4 as phase 5, at every position: an
    MoE token the two devices send to other experts fails it."""
    import numpy as np
    import torch
    from repro_torch.models import logits_fn
    from repro_torch.models.model import ParamTree
    from repro_torch.models.routes import record_routes

    c = dataclasses.replace(cfg, n_layers=min(CHECK_LAYERS, cfg.n_layers),
                            n_dec_layers=min(CHECK_LAYERS, cfg.n_dec_layers), compute_dtype="float32")
    tree = {k: getattr(params, k) for k in ("embed", "final_norm", "enc_final_norm") if hasattr(params, k)}
    tree["blocks"] = list(params.blocks)[:c.n_layers]
    if c.family == "encdec":
        tree["dec_blocks"] = list(params.dec_blocks)[:c.n_dec_layers]
    gpu_p = ParamTree(tree)
    cpu_p = ParamTree(tree_to(gpu_p, "cpu"))
    batch = family_batch(c, np.random.RandomState(2), 1, CHECK_SEQ, CHECK_SEQ, device="cpu")
    with torch.inference_mode():
        with record_routes() as on_gpu:
            gpu = logits_fn(c, gpu_p, {k: v.cuda() for k, v in batch.items()}).cpu()
        with record_routes() as on_cpu:
            cpu = logits_fn(c, cpu_p, batch)
    n = c.n_dec_layers if c.family == "encdec" else c.n_layers
    route_flips(by_position(on_gpu, n, [range(CHECK_SEQ)]), by_position(on_cpu, n, [range(CHECK_SEQ)]), n,
                exact=True, what=f"{cfg.name} card vs CPU")
    torch.testing.assert_close(gpu, cpu, rtol=1e-3, atol=1e-4)
    rel = ((gpu - cpu).abs() / cpu.abs().clamp(min=1e-3)).max().item()
    del cpu_p
    return {"layers": n, "seq": CHECK_SEQ, "max_rel": rel, "moe_dispatches_same_experts": len(on_gpu)}


def timed_profiles(cfg, params, batch, max_seq: int, pos: int, step_tok) -> dict:
    """Prefill and one decode step by CUDA events, then each under
    torch.profiler: device time by kernel family and by model region, and
    the idle share."""
    import torch
    from repro_torch.models import decode_step, prefill
    from repro_torch.obs import trace as obs_trace

    with torch.inference_mode():
        caches, _ = prefill(cfg, params, batch, max_seq)
        prefill_ms = cuda_ms(lambda: prefill(cfg, params, batch, max_seq), 3, 1)
        decode_ms = cuda_ms(lambda: decode_step(cfg, params, caches, step_tok, pos), 10, 2)
        obs_trace.configure(enabled=True)
        try:
            prof_prefill = profile(lambda: prefill(cfg, params, batch, max_seq), FAMILY_KERNELS, prefill_ms,
                                   FAMILY_REGIONS)
            prof_decode = profile(lambda: decode_step(cfg, params, caches, step_tok, pos), FAMILY_KERNELS,
                                  decode_ms, FAMILY_REGIONS)
        finally:
            obs_trace.configure(enabled=False)
            obs_trace.reset()
        del caches
    return {"prefill_ms": prefill_ms, "decode_step_ms": decode_ms, "profile_prefill": prof_prefill,
            "profile_decode_step": prof_decode}


def cache_tensors(caches) -> list:
    """Every tensor of a list of per-layer cache dicts, in a fixed order."""
    if isinstance(caches, dict):
        return [t for k in sorted(caches) for t in cache_tensors(caches[k])]
    if isinstance(caches, list):
        return [t for c in caches for t in cache_tensors(c)]
    return [caches]


def bitwise_prefill_repeat(cfg, params, batch, max_seq) -> bool:
    """The same prefill twice: logits and every cache tensor bitwise equal
    (the MoE combine has no atomics, and no kernel of any family does)."""
    import torch
    from repro_torch.models import prefill

    with torch.inference_mode():
        c1, l1 = prefill(cfg, params, batch, max_seq)
        c2, l2 = prefill(cfg, params, batch, max_seq)
    same = torch.equal(l1, l2) and all(
        torch.equal(a, b) for a, b in zip(cache_tensors(c1), cache_tensors(c2), strict=True))
    if not same:
        raise AssertionError(f"phase 10 {cfg.name}: a repeated prefill is not bitwise equal")
    return same


def wgmma_only(counter, cfg, what: str) -> dict:
    """Every bf16 flash launch of the last counted run on the tensor cores."""
    by = counter.last_variants["flash_attention"]
    if set(by) - {"wgmma"}:
        raise AssertionError(f"phase 10 {cfg.name}: {what} flash variants {by}")
    return by


def free_device() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase10_served(counter, arch: str) -> None:
    """mamba2-370m, hymba-1.5b, qwen2-moe-a2.7b at full depth: serve() at
    phase 5's traffic, the timings and profiles, and the checks."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.launch.steps import serve_config
    from repro_torch.models import init_params
    from repro_torch.obs import MetricsRegistry
    from repro_torch.obs import trace as obs_trace

    cfg = serve_config(get_config(arch))
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, 0, device="cuda")
    n_params = sum(p.numel() for p in params.parameters())
    requests, slots, prompt_len, max_new, max_seq = 16, 8, 1024, 64, 2048
    prompts = np.random.RandomState(0).randint(0, cfg.vocab, (requests, prompt_len)).astype(np.int32)

    def run(n_req, new):
        return serve(cfg, params, prompts[:n_req], batch_slots=slots, max_new=new, max_seq=max_seq,
                     registry=MetricsRegistry())

    run(slots, 2)  # warm-up
    obs_trace.configure(enabled=True)
    obs_trace.reset()
    t0 = time.perf_counter()
    tokens, summary = counter.run(lambda: run(requests, max_new))
    wall = time.perf_counter() - t0
    n_prefills = sum(1 for e in obs_trace.TRACER.events() if e.name == "serve.prefill")
    obs_trace.configure(enabled=False)
    obs_trace.reset()
    peak = torch.cuda.max_memory_allocated()
    launches = counter.last["flash_attention"]
    if (summary["requests"], summary["generated_tokens"], summary["decode_steps"]) != (16, 1024, 128):
        raise AssertionError(f"phase 10 {arch}: summary {summary}")
    want_flash = cfg.n_layers * n_prefills if cfg.attends else 0
    if launches != want_flash or n_prefills != 2:
        raise AssertionError(f"phase 10 {arch}: {launches} flash launches, {n_prefills} prefills")
    variants = wgmma_only(counter, cfg, "serve")
    if not all(len(t) == max_new and all(0 <= x < cfg.vocab for x in t) for t in tokens):
        raise AssertionError(f"phase 10 {arch}: malformed generated tokens")

    batch = {"tokens": torch.from_numpy(prompts[:slots]).cuda()}
    step_tok = torch.zeros(slots, 1, dtype=torch.int32, device="cuda")
    line = {
        "phase": 10, "arch": arch, "family": cfg.family, "params": n_params, "layers": cfg.n_layers,
        "reduced": [], "requests": requests, "slots": slots, "prompt_len": prompt_len, "max_new": max_new,
        "max_seq": max_seq, "serve": {k: v for k, v in summary.items() if k != "metrics"}, "serve_wall_s": wall,
        "prefills": n_prefills, "flash_launches": launches, "flash_variants": variants, "peak_gb": peak / 1e9,
        **timed_profiles(cfg, params, batch, max_seq, prompt_len, step_tok),
    }
    line["prefill_repeat_bitwise"] = bitwise_prefill_repeat(cfg, params, batch, max_seq)
    line["prefill_decode_vs_forward"] = decode_vs_forward(cfg, params)
    line["gpu_vs_cpu"] = card_vs_cpu(cfg, params)
    emit(line)
    del params
    free_device()


def phase10_mixtral(counter) -> None:
    """mixtral-8x22b, 4 of its 56 layers at full width: a prefill of
    8 x 1024 tokens and 8 decode steps."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import serve_config
    from repro_torch.models import decode_step, init_params, prefill

    full = get_config("mixtral-8x22b")
    cfg = dataclasses.replace(serve_config(full), n_layers=4)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, 0, device="cuda")
    n_params = sum(p.numel() for p in params.parameters())
    batch = family_batch(cfg, np.random.RandomState(0), 8, 1024, 0)
    with torch.inference_mode():
        caches, logits = counter.run(lambda: prefill(cfg, params, batch, 2048))
        variants = wgmma_only(counter, cfg, "prefill")
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        for pos in range(1024, 1032):
            logits, caches = decode_step(cfg, params, caches, tok, pos)
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("phase 10 mixtral: decode logits not finite")
        del caches
    step_tok = torch.zeros(8, 1, dtype=torch.int32, device="cuda")
    line = {
        "phase": 10, "arch": full.name, "family": cfg.family, "params": n_params, "layers": cfg.n_layers,
        "reduced": [f"4 of {full.n_layers} layers at full width (the whole model is "
                    f"{full.n_params() * 2 / 1e9:.0f} GB in bf16); output-projection init scales use 4 layers"],
        "batch": 8, "prompt_len": 1024, "decode_steps": 8, "flash_variants": variants,
        **timed_profiles(cfg, params, batch, 2048, 1024, step_tok),
        "prefill_repeat_bitwise": bitwise_prefill_repeat(cfg, params, batch, 2048),
        "prefill_decode_vs_forward": decode_vs_forward(cfg, params),
        "gpu_vs_cpu": card_vs_cpu(cfg, params),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit(line)
    del params
    free_device()


def phase10_seamless(counter) -> None:
    """seamless-m4t-medium at full depth: 8 utterances of 1024 random
    80-dim frames, a 16-token decoder prefix, 64 greedy decode steps; and
    the executor's encoder / decoder split against the monolithic logits."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import serve_config
    from repro_torch.models import decode_step, init_params, logits_fn, prefill
    from repro_torch.partition import run_partition, split_params

    cfg = serve_config(get_config("seamless-m4t-medium"))
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, 0, device="cuda")
    n_params = sum(p.numel() for p in params.parameters())
    batch = family_batch(cfg, np.random.RandomState(0), 8, 16, 1024)
    max_seq, steps = 128, 64

    def utterances():
        caches, logits = prefill(cfg, params, batch, max_seq)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        out = []
        for pos in range(16, 16 + steps):
            logits, caches = decode_step(cfg, params, caches, tok, pos)
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            out.append(tok)
        return torch.cat(out, 1)

    with torch.inference_mode():
        utterances()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generated = counter.run(utterances)
        wall = time.perf_counter() - t0
        n_flash = counter.last["flash_attention"]
        variants = wgmma_only(counter, cfg, "prefill and decode")
        # encoder self attention, decoder self and cross attention in the
        # prefill, then cross attention in every decode step.
        if n_flash != cfg.n_layers + 2 * cfg.n_dec_layers + steps * cfg.n_dec_layers:
            raise AssertionError(f"phase 10 seamless: {n_flash} flash launches")
        if generated.shape != (8, steps) or not bool(((generated >= 0) & (generated < cfg.vocab)).all()):
            raise AssertionError("phase 10 seamless: malformed generated tokens")

        def split_run():
            p1, p2 = split_params(cfg, params, 0)
            memory = run_partition(cfg, p1, {"feats": batch["feats"]}, part=1)
            return memory, run_partition(cfg, p2, {"memory": memory, "dec_tokens": batch["dec_tokens"]}, part=2)

        memory, split_logits = counter.run(split_run)
        mono = logits_fn(cfg, params, batch)
        if not torch.equal(split_logits, mono):
            raise AssertionError("phase 10 seamless: the encoder / decoder split is not bitwise the model")
    step_tok = torch.zeros(8, 1, dtype=torch.int32, device="cuda")
    emit({
        "phase": 10, "arch": cfg.name, "family": cfg.family, "params": n_params,
        "layers": [cfg.n_layers, cfg.n_dec_layers], "reduced": [], "utterances": 8, "frames": 1024,
        "decoder_prefix": 16, "decode_steps": steps, "wall_s": wall, "tokens_per_s": 8 * steps / wall,
        "flash_launches": n_flash, "flash_variants": variants,
        **timed_profiles(cfg, params, batch, max_seq, 16, step_tok),
        "split": {"memory_bytes": memory.numel() * memory.element_size(), "bitwise_equal_monolithic": True},
        "prefill_decode_vs_forward": decode_vs_forward(cfg, params),
        "gpu_vs_cpu": card_vs_cpu(cfg, params),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
    })
    del params, memory
    free_device()


def phase10_internvl(counter) -> None:
    """internvl2-76b, 4 of its 80 layers at full width: logits_fn on 1024
    random 3200-dim patch features."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import serve_config
    from repro_torch.models import init_params, logits_fn

    full = get_config("internvl2-76b")
    cfg = dataclasses.replace(serve_config(full), n_layers=4)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, 0, device="cuda")
    n_params = sum(p.numel() for p in params.parameters())
    batch = family_batch(cfg, np.random.RandomState(0), 1, 1024, 0)
    with torch.inference_mode():
        logits = counter.run(lambda: logits_fn(cfg, params, batch))
        variants = wgmma_only(counter, cfg, "forward")
        if logits.shape != (1, 1024, cfg.vocab) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"phase 10 internvl: logits {tuple(logits.shape)} not finite")
        fwd_ms = cuda_ms(lambda: logits_fn(cfg, params, batch), 3, 1)
        prof = profile(lambda: logits_fn(cfg, params, batch), FAMILY_KERNELS, fwd_ms)
        del logits
    emit({
        "phase": 10, "arch": full.name, "family": cfg.family, "frontend": cfg.frontend, "params": n_params,
        "layers": cfg.n_layers, "reduced": [f"4 of {full.n_layers} layers at full width; output-projection "
                                             "init scales use 4 layers"],
        "patches": 1024, "frontend_dim": cfg.frontend_dim, "flash_variants": variants, "forward_ms": fwd_ms,
        "profile_forward": prof, "gpu_vs_cpu": card_vs_cpu(cfg, params),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
    })
    del params
    free_device()


def phase10_int8(counter) -> None:
    """command-r-plus-104b, 4 of its 64 layers at full width: quantize_params
    (int8), then a prefill of 8 x 1024 tokens and 8 decode steps against the
    same model with its weights dequantized to bf16: equal within one bf16
    ulp of the largest logit (the same values reach the same kernels)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import serve_config
    from repro_torch.models import decode_step, dequantize_params, init_params, prefill, quantize_params

    full = get_config("command-r-plus-104b")
    cfg = dataclasses.replace(serve_config(full), n_layers=4)
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, 0, device="cuda")
    bf16_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    t0 = time.perf_counter()
    qparams = quantize_params(params)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    del params
    free_device()
    int8_bytes = sum(p.numel() * p.element_size() for p in qparams.parameters())
    deq = dequantize_params(qparams, torch.bfloat16)
    batch = family_batch(cfg, np.random.RandomState(0), 8, 1024, 0)
    logits = {}
    with torch.inference_mode():
        for name, p in (("int8", qparams), ("dequantized", deq)):
            caches, lg = counter.run(lambda p=p: prefill(cfg, p, batch, 2048))
            wgmma_only(counter, cfg, "prefill")
            steps = [lg[:, -1].float()]
            tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
            for pos in range(1024, 1032):
                lg, caches = decode_step(cfg, p, caches, tok, pos)
                steps.append(lg[:, -1].float())
                tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
            logits[name] = torch.stack(steps)
            del caches
        step_tok = torch.zeros(8, 1, dtype=torch.int32, device="cuda")
        times = {name: timed_profiles(cfg, p, batch, 2048, 1024, step_tok)
                 for name, p in (("int8", qparams), ("dequantized", deq))}
    top = logits["dequantized"].abs().max().item()
    err = (logits["int8"] - logits["dequantized"]).abs().max().item()
    if not err <= bf16_ulps(top, 1):
        raise AssertionError(f"phase 10 int8: logits {err} off the dequantized model's (top {top})")
    emit({
        "phase": 10, "arch": full.name, "family": cfg.family, "int8": True, "layers": cfg.n_layers,
        "reduced": [f"4 of {full.n_layers} layers at full width; output-projection init scales use 4 layers"],
        "bf16_bytes": bf16_bytes, "int8_bytes": int8_bytes, "quantize_s": quant_s,
        "quantized_leaves": sum(1 for n, _ in qparams.named_parameters() if n.endswith("__q")),
        "batch": 8, "prompt_len": 1024, "decode_steps": 8, "max_abs_vs_dequantized": err, "max_logit": top,
        "timings": {k: {kk: v[kk] for kk in ("prefill_ms", "decode_step_ms")} for k, v in times.items()},
        "profile_int8": {k: times["int8"][k] for k in ("profile_prefill", "profile_decode_step")},
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
    })
    del qparams, deq
    free_device()


def phase10(counter) -> None:
    """Every model family the port serves, at full width (module doc)."""
    t0 = time.perf_counter()
    for arch in SERVED:
        phase10_served(counter, arch)
    phase10_mixtral(counter)
    phase10_seamless(counter)
    phase10_internvl(counter)
    phase10_int8(counter)
    emit({"phase": 10, "name": "families", "wall_s": time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# Phase 11: training on the card.
# ---------------------------------------------------------------------------
# The full run: qwen1.5-0.5b at full depth and width, fp32 params, bf16
# compute, remat, SyntheticLM batches of 8 x 1024 tokens.
TRAIN_ARCH, TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR, TRAIN_CKPT_EVERY, TRAIN_RESUME_AT = (
    "qwen1.5-0.5b", 8, 1024, 30, 3e-4, 10, 20)
# Card against CPU, fp32 compute: one reduced config a family, and
# qwen1.5-0.5b at full width cut to 2 layers.
TRAIN_CHECK_ARCHS = ("qwen1.5-0.5b", "qwen2-moe-a2.7b", "mamba2-370m", "hymba-1.5b", "internvl2-76b",
                     "seamless-m4t-medium")
CHECK_LR = 1e-3
# Flash gradients against autograd through the plain version: bf16
# gradients are rounded once from fp32 on both sides (one bf16 ulp is 2^-8
# of the value), fp32 gradients differ in summation order only.
FLASH_GRAD_TOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}  # max abs error / max |gradient|
# SDPA's backward (the yardstick) rounds P and dS to bf16 on the way: held
# to the plain version at phase 1's bf16 bound, relative to the largest
# gradient (read 8.4e-3 at the training shape).
SDPA_GRAD_TOL = FLASH_BF16_TOL
TRAIN_FAMILY_KERNELS = {**FAMILY_KERNELS, "reduce": ("reduce_kernel", "softmax")}
# (tag, B, H, Kv, S, D, causal, window, q_offset, dtype): the training
# step's shape, hymba's window with GQA 25:5, and an fp32 (CUDA-core) case
# whose first 64 rows see no key.
FLASH_GRAD_CASES = (
    ("train step", 8, 16, 16, 1024, 64, True, None, 0, "bfloat16"),
    ("hymba window 1024", 8, 25, 5, 2048, 64, True, 1024, 0, "bfloat16"),
    ("fp32 GQA 4:1 window 128, q_offset -64", 2, 8, 2, 512, 64, True, 128, -64, "float32"),
)


def rel_max(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30)).item()


def phase11_flash_grad() -> list:
    """The flash kernel's autograd route at the training shapes: the
    forward bitwise the kernel call, dq / dk / dv against autograd through
    the plain version (`attention_chunked`) on the card, and the times of
    the kernel forward, the plain backward and SDPA's backward (held to
    the plain version too, where one SDPA call computes the function)."""
    import torch
    from repro_torch.kernels.flash_attention import attention_chunked, flash_attention
    from repro_torch.kernels.flash_attention import ops as fa_ops

    gen = torch.Generator(device="cuda").manual_seed(11)
    bf16 = torch.bfloat16
    rows = []
    for tag, b, h, kv, s, d, causal, window, q_offset, dtype_name in FLASH_GRAD_CASES:
        dt, tol = getattr(torch, dtype_name), FLASH_GRAD_TOL[dtype_name]

        def make(heads):  # the model's transposed [B, S, H, D] view
            return torch.randn(b, s, heads, d, generator=gen, device="cuda").to(dt).transpose(1, 2)

        q, k, v, do = make(h), make(kv), make(kv), make(h)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        direct = fa_ops._launch(q, k, v, causal, window, q_offset)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention(*leaves, **kw)
        forward_bitwise = torch.equal(out, direct)
        grads = torch.autograd.grad(out, leaves, do)
        plain_leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(attention_chunked(*plain_leaves, **kw), plain_leaves, do)
        torch.cuda.synchronize()
        errs = {n: rel_max(g, w) for n, g, w in zip(("dq", "dk", "dv"), grads, want)}
        dead = max(0, min(s, -q_offset))
        dead_zero = bool((grads[0][:, :, :dead] == 0).all()) if dead else None
        del out, grads, leaves, plain_leaves
        live = int(flash_live_mask(s, s, causal, window, q_offset).sum()) * b * h
        esize = q.element_size()
        bytes_bwd = (2 * (q.numel() + k.numel() + v.numel()) + do.numel()) * esize  # read q, k, v, dO; write dq, dk, dv
        ops_bwd = 10 * d * live  # S = QK^T again, dP = dO V^T, dV, dQ, dK: 2d each a live score
        t_b, t_o = bytes_bwd / HBM_BYTES_PER_S, ops_bwd / (BF16_OPS_PER_S if dt == bf16 else FP32_OPS_PER_S)
        lib_in = [t.detach().requires_grad_() for t in (q, k, v)]
        library = sdpa_call(*lib_in, causal, window, q_offset)
        sdpa_bwd_ms = lib_err = None
        if library is not None:
            lib_out = library()
            lib_grads = torch.autograd.grad(lib_out, lib_in, do, retain_graph=True)
            lib_err = max(rel_max(g, w) for g, w in zip(lib_grads, want))
            if not lib_err <= SDPA_GRAD_TOL:
                raise AssertionError(f"phase 11 flash {tag}: SDPA's gradient computes another function ({lib_err})")
            sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, lib_in, do, retain_graph=True), 5, 1)
            del lib_out, lib_grads
        del lib_in, library
        row = {
            "shape": f"{tag}: B={b} H={h} Kv={kv} S={s} D={d} {dtype_name}", "variant": fa_ops._variant(dt, d),
            "sdpa_grad_err_rel_max": lib_err,
            "forward_bitwise_kernel": forward_bitwise, "grad_err_rel_max": errs, "dead_rows": dead,
            "dead_row_dq_zero": dead_zero,
            "forward_ms": cuda_ms(lambda: flash_attention(q, k, v, **kw), 10),
            "plain_backward_ms": cuda_ms(lambda: fa_ops.flash_attention_backward(q, k, v, do, **kw), 3, 1),
            "sdpa_backward_ms": sdpa_bwd_ms,
            "backward_bound_ms": 1e3 * max(t_b, t_o), "backward_bound_by": "bytes" if t_b >= t_o else "operations",
        }
        rows.append(row)
        del q, k, v, do, direct, want
        free_device()
        bad = [n for n, e in errs.items() if not e <= tol]
        if not forward_bitwise or bad or dead_zero is False:
            raise AssertionError(f"phase 11 flash {tag}: {row}")
    emit({"phase": 11, "name": "flash_grad", "rows": rows})
    return rows


def train_batch(cfg, rng, b: int, s: int, device) -> dict:
    """`family_batch` plus the labels a frontend arch's loss reads."""
    import torch

    out = family_batch(cfg, rng, b, s, enc_len=s, device=device)
    if cfg.frontend != "none" and cfg.family != "encdec":
        out["labels"] = torch.from_numpy(rng.randint(0, cfg.vocab, (b, s)).astype("int32")).to(device)
    return out


def phase11_card_vs_cpu() -> dict:
    """Loss, every gradient leaf and 3 AdamW steps of one model a family on
    the card against the CPU, the same weights, fp32 compute; and
    `compress_int8` of the largest gradient on the card against the CPU
    on the same tensor, bitwise."""
    import copy

    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init, compress_int8

    out, failures = {}, []
    cases = [(a, dataclasses.replace(reduced_config(a), compute_dtype="float32"), 2, 64) for a in TRAIN_CHECK_ARCHS]
    cases.append((f"{TRAIN_ARCH} full width, 2 layers",
                  dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2, compute_dtype="float32"), 1, 128))
    for name, cfg, b, s in cases:
        rng = np.random.RandomState(3)
        p_cpu = init_params(cfg, 0, device="cpu")
        p_gpu = copy.deepcopy(p_cpu).to("cuda")
        batches = [train_batch(cfg, rng, b, s, "cpu") for _ in range(3)]
        on_gpu = [{k: t.cuda() for k, t in x.items()} for x in batches]
        l_cpu, g_cpu = value_and_grad(cfg, p_cpu, batches[0])
        l_gpu, g_gpu = value_and_grad(cfg, p_gpu, on_gpu[0])
        loss_rel = abs(l_gpu.item() - l_cpu.item()) / abs(l_cpu.item())
        leaf_rel = max(
            (torch.linalg.vector_norm(g_gpu[n].cpu() - g) / torch.linalg.vector_norm(g).clamp_min(1e-30)).item()
            for n, g in g_cpu.items())
        big = max(g_gpu, key=lambda n: g_gpu[n].numel())
        cq = compress_int8(g_gpu[big])
        hq = compress_int8(g_gpu[big].cpu())
        compress_bitwise = all(torch.equal(x.cpu(), y) for x, y in zip(cq, hq))
        step = make_train_step(cfg, lr=CHECK_LR)
        o_cpu, o_gpu = adamw_init(p_cpu), adamw_init(p_gpu)
        for x_cpu, x_gpu in zip(batches, on_gpu):
            p_cpu, o_cpu, _ = step(p_cpu, o_cpu, x_cpu)
            p_gpu, o_gpu, _ = step(p_gpu, o_gpu, x_gpu)
        # AdamW's step divides by sqrt(vhat) + eps: an element whose
        # gradient lies within summation-order noise of zero takes a step of
        # up to lr either way, so params are held at rtol 1e-3 plus one
        # step, lr (read 0.77 lr at full width); how many elements go past
        # rtol 1e-3 + 0.01 lr is reported.
        excess, beyond, n_el = {}, 0, 0
        for (n, a), (_, c) in zip(p_gpu.named_parameters(), p_cpu.named_parameters()):
            e = (a.detach().cpu() - c.detach()).abs() - 1e-3 * c.detach().abs()
            excess[n] = e.max().item() / CHECK_LR
            beyond += int((e > 0.01 * CHECK_LR).sum())
            n_el += e.numel()
        worst = max(excess, key=excess.get)
        p_err_lr = excess[worst]
        mom_rel = max(rel_max(o_gpu[m][n].cpu(), o_cpu[m][n]) for m in ("mu", "nu") for n in o_cpu[m])
        out[name] = {"loss_rel": loss_rel, "grad_leaf_rel_l2_max": leaf_rel, "compress_int8_bitwise": compress_bitwise,
                     "compressed_leaf": big, "params_excess_over_rtol_in_lr": p_err_lr, "params_worst_leaf": worst,
                     "params_beyond_0.01_lr": beyond, "params": n_el, "moments_rel_max": mom_rel}
        if not (loss_rel <= 1e-4 and leaf_rel <= 1e-3 and compress_bitwise and p_err_lr <= 1.0 and mom_rel <= 1e-3):
            failures.append(name)
        del p_cpu, p_gpu, o_cpu, o_gpu, g_cpu, g_gpu
        free_device()
    emit({"phase": 11, "name": "card_vs_cpu", "cases": out})
    if failures:
        raise AssertionError(f"phase 11: card vs CPU failed for {failures}: {out}")
    return out


def phase11_train(counter) -> dict:
    """The full run (module doc): 30 steps with a checkpoint every 10, the
    microbatch check, one step's profile, a resume from step 20 and the
    card-to-CPU-and-back restore."""
    import copy
    import os
    import shutil

    import numpy as np
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params, trainable
    from repro_torch.obs import trace as obs_trace
    from repro_torch.optim import adamw_init

    cfg = get_config(TRAIN_ARCH)
    if not (cfg.param_dtype == "float32" and cfg.compute_dtype == "bfloat16" and cfg.remat):
        raise AssertionError(f"phase 11: {TRAIN_ARCH} is not fp32 params, bf16 compute, remat")
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S, global_batch=TRAIN_B, seed=1234)
    stream = make_pipeline(data_cfg)
    batches = [torch.from_numpy(stream.next_batch()) for _ in range(TRAIN_STEPS + 1)]
    ckpt_dir = ROOT / "build" / "phase11_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt = CheckpointManager(ckpt_dir, keep=2)
    step_fn = make_train_step(cfg, lr=TRAIN_LR, grad_clip=1.0)
    try:
        params = init_params(cfg, 0, device="cuda")
        n_params = sum(p.numel() for p in params.parameters())
        opt = adamw_init(trainable(params))

        # microbatches=2 against 1 on step 0, from copies of the same state.
        p2, o2 = copy.deepcopy(params), copy.deepcopy(opt)
        _, _, m2 = make_train_step(cfg, lr=TRAIN_LR, microbatches=2)(p2, o2, {"tokens": batches[0].cuda()})
        loss_mb2 = m2["loss"].item()
        del p2, o2, m2
        free_device()

        losses, norms, step_ms, save_s = [], [], [], []

        def run():
            nonlocal params, opt
            for i in range(TRAIN_STEPS):
                t0 = time.perf_counter()
                params, opt, m = step_fn(params, opt, {"tokens": batches[i].cuda()})
                losses.append(m["loss"].item())
                norms.append(m["grad_norm"].item())
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t0))
                if (i + 1) % TRAIN_CKPT_EVERY == 0:
                    t0 = time.perf_counter()
                    ckpt.save(i + 1, {"params": params, "opt": opt}, extra={"data": {"seed": 1234, "step": i + 1}})
                    save_s.append(time.perf_counter() - t0)

        torch.cuda.reset_peak_memory_stats()
        t_run = time.perf_counter()
        counter.run(run)
        run_s = time.perf_counter() - t_run
        peak = torch.cuda.max_memory_allocated()
        flash_launches = counter.last["flash_attention"]
        steady = sorted(step_ms[1:])
        p50, p95 = steady[len(steady) // 2], steady[min(len(steady) - 1, int(0.95 * len(steady)))]

        # One more step under the profiler, the plain backward as its span.
        obs_trace.configure(enabled=True)
        obs_trace.reset()
        prof = profile(lambda: step_fn(params, opt, {"tokens": batches[TRAIN_STEPS].cuda()}),
                       TRAIN_FAMILY_KERNELS, wall_ms=p50, regions=("flash.backward",))
        obs_trace.configure(enabled=False)
        del params, opt
        free_device()

        # Resume: a fresh model and optimizer restored from step 20 run
        # steps 20-29; the stream restored from the checkpoint's extra.
        fresh = init_params(cfg, 1, device="cuda")
        t0 = time.perf_counter()
        tree, extra, at = ckpt.restore(TRAIN_RESUME_AT, {"params": fresh, "opt": adamw_init(trainable(fresh))})
        fresh.load_state_dict(tree["params"])
        r_opt = tree["opt"]
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        r_stream = make_pipeline(data_cfg, extra["data"])
        r_losses = []
        for i in range(at, TRAIN_STEPS):
            toks = torch.from_numpy(r_stream.next_batch())
            if not torch.equal(toks, batches[i]):
                raise AssertionError(f"phase 11: the restored stream's batch {i} differs")
            fresh, r_opt, m = step_fn(fresh, r_opt, {"tokens": toks.cuda()})
            r_losses.append(m["loss"].item())
        resume_bitwise = r_losses == losses[at:]
        resume_rel = max(abs(a - b) / abs(b) for a, b in zip(r_losses, losses[at:]))
        del fresh, r_opt
        # The checkpoint the card wrote, restored on the CPU: bitwise the
        # card's restore (`tree`, which the resumed steps did not touch).
        like = {"params": init_params(cfg, 1, device="cpu")}
        like["opt"] = adamw_init(like["params"])
        host, _, _ = ckpt.restore(TRAIN_RESUME_AT, like, device="cpu")
        elastic = all(torch.equal(host["params"][n], tree["params"][n].cpu()) for n in host["params"]) and all(
            torch.equal(host["opt"][m][n], tree["opt"][m][n].cpu()) for m in ("mu", "nu") for n in host["opt"][m])
        del like, host, tree
        free_device()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    # The CLI's entry point on the card at the reduced config, in one
    # subprocess (a process takes seconds to reach the card): 8 steps, then
    # --resume to 12.
    cli_dir = ROOT / "build" / "phase11_cli"
    shutil.rmtree(cli_dir, ignore_errors=True)
    base = ["--arch", TRAIN_ARCH, "--reduced", "--global-batch", "4", "--seq-len", "64", "--ckpt-every", "4",
            "--ckpt-dir", str(cli_dir), "--device", "cuda"]
    code = ("from repro_torch.launch import train\n"
            f"assert train.main({base!r} + ['--steps', '8']) == 0\n"
            f"assert train.main({base!r} + ['--steps', '12', '--resume']) == 0\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    try:
        t0 = time.perf_counter()
        cli = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=ROOT,
                             timeout=300)
        cli_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(cli_dir, ignore_errors=True)
    cli_ok = cli.returncode == 0 and "resumed from step 8" in cli.stdout and "done: first-5-avg=" in cli.stdout

    tokens = TRAIN_B * TRAIN_S
    result = {
        "phase": 11, "name": "train", "arch": cfg.name, "params": n_params, "layers": cfg.n_layers,
        "batch": [TRAIN_B, TRAIN_S], "steps": TRAIN_STEPS, "lr": TRAIN_LR, "remat": cfg.remat,
        "first_step_ms": step_ms[0], "step_ms_p50": p50, "step_ms_p95": p95, "tokens_per_s": tokens / (p50 / 1e3),
        "run_s": run_s, "peak_gb": peak / 1e9, "losses": losses, "grad_norms": norms,
        "first5_mean": float(np.mean(losses[:5])), "last5_mean": float(np.mean(losses[-5:])),
        "loss_microbatches_2": loss_mb2, "loss_microbatches_1": losses[0],
        "checkpoint_save_s": save_s, "restore_s": restore_s, "resume_losses_bitwise": resume_bitwise,
        "resume_loss_rel_max": resume_rel, "restore_card_cpu_card_bitwise": elastic,
        "flash_launches": flash_launches, "flash_launches_per_step": flash_launches / TRAIN_STEPS,
        "flash_forward_ms_in_step": (prof.get("device_ms_by_family") or {}).get("flash", "not measured"),
        "flash_plain_backward_ms_in_step": (prof.get("regions_device_ms") or {}).get("flash.backward", "not measured"),
        "profile_one_step": prof, "cli_resume_ok": cli_ok, "cli_s": cli_s,
    }
    emit(result)
    checks = {
        "finite": all(math.isfinite(x) for x in losses + norms),
        "loss falls": result["last5_mean"] < result["first5_mean"],
        "microbatches": abs(loss_mb2 - losses[0]) <= 1e-4 * abs(losses[0]),
        "resume": resume_bitwise, "elastic restore": elastic,
        "flash launched twice a layer a step (forward, remat)": flash_launches == 2 * cfg.n_layers * TRAIN_STEPS,
        "cli": cli_ok,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        tail = "" if cli_ok else cli.stdout[-1500:] + cli.stderr[-1500:]
        raise AssertionError(f"phase 11: {failed} {tail}")
    return result


def phase11(counter) -> dict:
    """Training on the card (module doc)."""
    t = [time.perf_counter()]
    grad_rows = phase11_flash_grad()
    t.append(time.perf_counter())
    phase11_card_vs_cpu()
    t.append(time.perf_counter())
    result = phase11_train(counter)
    t.append(time.perf_counter())
    emit({"phase": 11, "name": "training", "wall_s": t[-1] - t[0], "flash_grad_s": t[1] - t[0],
          "card_vs_cpu_s": t[2] - t[1], "train_s": t[3] - t[2]})
    return {"flash_grad_rows": grad_rows, "train": result}


# Phase 12: the dry run. Its whole matrix runs on the host in the
# background from the start (it never touches the card), over this many
# processes, one (arch, mesh) unit at a time, the slowest first.
DRYRUN_DIR = ROOT / "build" / "phase12_dryrun"
DRYRUN_WORKERS = 4
DRYRUN_SLOW_FIRST = ("mixtral-8x22b", "mamba2-370m", "qwen2-moe-a2.7b", "internvl2-76b", "hymba-1.5b",
                     "command-r-plus-104b")
DRYRUN_ARCH = "qwen1.5-0.5b"
PEAK_RTOL = 0.15  # the dry run's peak against max_memory_allocated over the same step
# (kind, sequence length, batch) of the steps held against the card: phase
# 11's train shape, and a prefill and a decode at 32k that one card holds.
DRYRUN_STEPS = (("train", 1024, 8), ("prefill", 32_768, 2), ("decode", 32_768, 8))


class DryrunMatrix:
    """`python -m repro_torch.launch.dryrun --arch A [--multi-pod]` for every
    arch and both production meshes, in `DRYRUN_WORKERS` processes at low
    priority, records into `DRYRUN_DIR`. `stop` kills what still runs."""

    def __init__(self, archs):
        import os
        import shutil
        import threading

        shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
        DRYRUN_DIR.mkdir(parents=True)
        slow = [a for a in DRYRUN_SLOW_FIRST if a in archs]
        self.units = [(a, mp) for a in slow + [a for a in archs if a not in slow] for mp in (True, False)]
        self.procs, self.rcs = [], {}
        self.env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
        self._lock = threading.Lock()
        self._stopped = False
        self.t0 = time.perf_counter()
        self.wall_s = None
        self.error = None
        self._thread = threading.Thread(target=self._schedule, daemon=True)
        self._thread.start()

    def _run(self, arch, multi_pod):
        import os

        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--out-dir", str(DRYRUN_DIR)]
        log = DRYRUN_DIR / f"{arch}{'-multipod' if multi_pod else ''}.log"
        with self._lock:
            if self._stopped:
                return
            with open(log, "w") as f:
                proc = subprocess.Popen(cmd + (["--multi-pod"] if multi_pod else []), stdout=f,
                                        stderr=subprocess.STDOUT, env=self.env, cwd=ROOT)
            self.procs.append(proc)
        os.setpriority(os.PRIO_PROCESS, proc.pid, 10)  # below the phases that drive the card
        self.rcs[(arch, multi_pod)] = proc.wait()

    def _schedule(self):
        from concurrent.futures import ThreadPoolExecutor

        try:
            with ThreadPoolExecutor(DRYRUN_WORKERS) as pool:
                list(pool.map(lambda u: self._run(*u), self.units))
        except Exception as e:  # read by `join`, in the main thread
            self.error = e
        self.wall_s = time.perf_counter() - self.t0

    def join(self) -> float:
        self._thread.join()
        if self.error is not None:
            raise RuntimeError("phase 12: the dry-run matrix could not run") from self.error
        return self.wall_s

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


def phase12_matrix(matrix) -> float:
    """Every cell of the dry run's matrix ok where `shape_applicable` says
    and skipped elsewhere. Every ok cell, the MoE archs' included, ran its
    DTensor trace: no mesh error, and per-device FLOPs, temporaries and
    nonzero collectives, none of them null. Every unit exits 0. Returns the
    matrix's wall s."""
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.models.config import SHAPES, shape_applicable

    wall_s = matrix.join()
    recs = {(r["arch"], r["shape"], r["mesh"]): r
            for r in (json.loads(f.read_text()) for f in DRYRUN_DIR.glob("*.json"))}
    cells, flops, coll, wrong = {}, {}, {}, []
    n_applicable = 0
    for arch in ARCHS:
        for shape in SHAPES:
            applicable = shape_applicable(get_config(arch), SHAPES[shape])[0]
            for mesh in ("16x16", "2x16x16"):
                n_applicable += applicable
                r = recs.get((arch, shape, mesh), {"status": "missing"})
                key = f"{arch}/{shape}/{mesh}"
                if r["status"] != ("ok" if applicable else "skipped"):
                    wrong.append((arch, shape, mesh, r["status"], r.get("error", "")[:200]))
                if r["status"] != "ok":
                    continue
                cells[key] = [r["flops_per_device"], r["per_device_argument_gib"]]
                flops[key] = r["flops"]
                coll[key] = r["collective_bytes"]
                if "mesh_error" in r:
                    wrong.append((arch, shape, mesh, "mesh error", r["mesh_error"][:200]))
                elif not (r["flops_per_device"] is not None and r["flops_per_device"] > 0
                          and r["memory"]["temp_bytes"] is not None and r["collective_bytes"] is not None
                          and sum(r["collective_bytes"].values()) > 0):
                    wrong.append((arch, shape, mesh, "a null per-device number or zero collectives"))
    counts = {k: sum(r["status"] == k for r in recs.values()) for k in ("ok", "skipped", "error")}
    n_mesh_errors = sum("mesh_error" in r for r in recs.values())
    bad_rc = {f"{a}{' --multi-pod' if mp else ''}": rc for (a, mp), rc in matrix.rcs.items() if rc != 0}
    emit({"phase": 12, "name": "dryrun_matrix", "wall_s": wall_s, "processes": DRYRUN_WORKERS, **counts,
          "mesh_errors": n_mesh_errors,
          "trace_s_total": sum(r.get("trace_s", 0.0) + r.get("mesh_trace_s", 0.0) for r in recs.values()),
          "cells_flops_gib_per_device": cells, "cells_flops_global": flops, "cells_collective_bytes": coll})
    if bad_rc or wrong or n_mesh_errors or counts != {
            "ok": n_applicable, "skipped": 2 * len(ARCHS) * len(SHAPES) - n_applicable, "error": 0}:
        raise AssertionError(f"phase 12: dry-run matrix {counts}, {n_mesh_errors} mesh errors, "
                             f"exit codes {bad_rc}, cells {wrong[:5]}")
    return wall_s


def phase12_step(counter, shape) -> None:
    """One step of the dry run on the one-device mesh against the same step
    run on the card: FLOPs equal (FlopCounterMode with the flash op's
    formula on the card), the predicted peak within PEAK_RTOL of
    max_memory_allocated, every flash launch counted, wgmma in bf16."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as St
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import init_caches, init_params
    from repro_torch.optim import adamw_init

    mesh = make_debug_mesh(n_devices=1, model=1)
    t0 = time.perf_counter()
    rec = dryrun.run_cell(DRYRUN_ARCH, shape, mesh=mesh, save=False)
    dry_s = time.perf_counter() - t0
    if rec["status"] != "ok":
        raise AssertionError(f"phase 12: dry run of {shape.name}: {rec.get('error')}")
    step, _, _ = dryrun.build_cell(DRYRUN_ARCH, shape, mesh, ShardingRules())
    cfg = get_config(DRYRUN_ARCH)
    cfg = cfg if shape.kind == "train" else St.serve_config(cfg)
    free_device()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda").manual_seed(12)
    tokens = torch.randint(0, cfg.vocab, (shape.global_batch, 1 if shape.kind == "decode" else shape.seq_len),
                           dtype=torch.int32, device="cuda", generator=gen)
    params = init_params(cfg, 12, device="cuda")
    if shape.kind == "train":
        args = (params, adamw_init(params), {"tokens": tokens})
    elif shape.kind == "prefill":
        args = (params, {"tokens": tokens})
    else:
        args = (params, init_caches(cfg, shape.global_batch, shape.seq_len, device="cuda"), tokens,
                torch.zeros((), dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def run():
        with FlopCounterMode(display=False) as fc:
            out = step(*args)
        return fc.get_total_flops(), out

    t0 = time.perf_counter()
    flops, out = counter.run(run)
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    finite = all(bool(torch.isfinite(t.float()).all()) for t in (
        [out[2]["loss"]] if shape.kind == "train" else [out[1] if shape.kind == "prefill" else out[0]]))
    launches, variants = counter.last["flash_attention"], counter.last_variants["flash_attention"]
    want_launches = {"train": 2 * cfg.n_layers, "prefill": cfg.n_layers, "decode": 0}[shape.kind]
    del args, out, params
    free_device()
    row = {"phase": 12, "step": shape.kind, "shape": f"B={shape.global_batch} S={shape.seq_len}",
           "dryrun_flops": rec["flops"], "card_flops": flops, "dryrun_peak_bytes": rec["peak_bytes"],
           "card_peak_bytes": peak, "peak_ratio": rec["peak_bytes"] / peak,
           "argument_bytes": rec["memory"]["argument_bytes"], "temp_bytes": rec["memory"]["temp_bytes"],
           "flash_launches": launches, "flash_variants": variants, "dryrun_s": dry_s, "card_step_s": step_s,
           "finite": finite}
    emit(row)
    checks = {
        "flops equal": flops == rec["flops"],
        "peak within 15%": abs(rec["peak_bytes"] - peak) <= PEAK_RTOL * peak,
        "flash launches": launches == want_launches and set(variants) <= {"wgmma"},
        "finite": finite,
    }
    if not all(checks.values()):
        raise AssertionError(f"phase 12 {shape.kind}: {[k for k, v in checks.items() if not v]} {row}")


def phase12(counter, matrix) -> None:
    """The dry run (module doc): its matrix on the host, then one train,
    prefill and decode step of qwen1.5-0.5b against the card."""
    from repro_torch.models.config import ShapeConfig

    t0 = time.perf_counter()
    matrix_s = phase12_matrix(matrix)
    t1 = time.perf_counter()
    for kind, seq, batch in DRYRUN_STEPS:
        phase12_step(counter, ShapeConfig(f"{kind}_{batch}x{seq}", kind, seq, batch))
    emit({"phase": 12, "name": "dryrun", "wall_s": time.perf_counter() - t0, "matrix_wall_s": matrix_s,
          "matrix_wait_s": t1 - t0, "matrix_hidden_s": matrix_s - (t1 - t0), "steps_s": time.perf_counter() - t1})


# Phase 13: the examples on the card against the CPU, the fleet and the
# GPipe schedule over a one-rank NCCL group, and the 4-rank gloo runs of the
# CPU tests on this host.
PIPE_M, PIPE_B, PIPE_S = 4, 2, 1024  # microbatches of PIPE_B x PIPE_S tokens
EXAMPLE_RTOL = 1e-5


def quiet(fn):
    """`fn()` with its standard output kept out of the log."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return fn()


def rel_err(got, want) -> float:
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def phase13_examples(counter) -> dict:
    """(a) Both examples on the card against the same functions on the CPU."""
    from repro_torch.examples import edge_serving, quickstart

    out = {}
    launches = {}
    for name, mod in (("quickstart", quickstart), ("edge_serving", edge_serving)):
        t0 = time.perf_counter()
        card = counter.run(lambda mod=mod: quiet(lambda: mod.main("cuda")))
        t1 = time.perf_counter()
        cpu = quiet(lambda mod=mod: mod.main("cpu"))
        launches[name] = dict(counter.last)
        out[name] = {"card_s": t1 - t0, "cpu_s": time.perf_counter() - t1, "launches": counter.last,
                     "flash_variants": counter.last_variants["flash_attention"]}
        if name == "quickstart":
            errs = {m: rel_err(card["J"][m], cpu["J"][m]) for m in card["J"]}
            errs["wire"] = rel_err(card["wire"], cpu["wire"])
            out[name]["hosts_equal"] = bool((card["hosts"] == cpu["hosts"]).all())
        else:
            errs = {k: rel_err(card[k], cpu[k]) for k in ("J", "J2", "stale_J")}
            out[name]["data_plane_err"] = card["data_plane"]["err"]
            out[name]["split_layer"] = card["data_plane"]["k"]
            out[name]["hosts_equal"] = bool((card["hosts"] == cpu["hosts"]).all()
                                            and (card["hosts2"] == cpu["hosts2"]).all())
            # Both sides of the example's own check run the same kernel, so
            # the card's logits are also held to the CPU's on the card's
            # weights and tokens (the plain attention there).
            out[name]["logits_vs_cpu"] = data_plane_vs_cpu(edge_serving, card)
            if not (card["data_plane"]["err"] < 1e-2 and card["J2"] < card["stale_J"]):
                raise AssertionError(f"phase 13: edge_serving on the card: {out[name]}")
        out[name]["rel_err_vs_cpu"] = errs
        if not max(errs.values()) <= EXAMPLE_RTOL:
            raise AssertionError(f"phase 13: {name} card vs CPU: {errs}")
    for kernel in ("neumann_cols", "neumann_rows", "minplus", "minplus_argmin", "flash_attention"):
        if sum(by[kernel] for by in launches.values()) <= 0:
            raise AssertionError(f"phase 13: the examples never launched {kernel}: {launches}")
    return out


def data_plane_vs_cpu(edge_serving, card) -> dict:
    """The card's data-plane logits against `data_plane` on the CPU with a
    copy of the card's weights and tokens, at FLASH_BF16_TOL (max abs; the
    logits are below 1, bf16 compute against fp32 compute reads 0.011 on
    the CPU)."""
    import copy

    import torch
    from repro_torch.configs import reduced_config

    cfg = reduced_config(edge_serving.ARCHS[0])
    with torch.no_grad():
        cpu = edge_serving.data_plane(cfg, copy.deepcopy(card["params"]).to("cpu"), card["tokens"].cpu(),
                                      device="cpu")
    got, want = card["data_plane"]["logits"].float().cpu(), cpu["logits"].float()
    err = (got - want).abs().max().item()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()) or not err <= FLASH_BF16_TOL:
        raise AssertionError(f"phase 13: edge_serving logits card vs CPU: max abs {err} > {FLASH_BF16_TOL}")
    return {"max_abs": err, "max_logit": want.abs().max().item(), "tol": FLASH_BF16_TOL,
            "shape": list(got.shape), "dtype": str(card["data_plane"]["logits"].dtype)}


def phase13_fleet(counter, problems, phase7_J) -> dict:
    """(b) Phase 7's fleet through solve_fleet(shard=True) over the one-rank
    NCCL group: the single-device plan, J bitwise phase 7's; a mesh of two
    ranks refused; the cost of the round loop's exit flag."""
    import numpy as np
    import torch
    from repro_torch import fleet
    from repro_torch.core.engine import _any_active
    from repro_torch.launch.mesh import make_fleet_mesh

    kw = dict(method="ALT", m_max=4, t_phi=5, round_to=8)
    t0 = time.perf_counter()
    res = counter.run(lambda: fleet.solve_fleet(problems, shard=True, trace=True, keep_state=True,
                                                device="cuda", **kw))
    wall = time.perf_counter() - t0
    if res.shard.reason != "single-device" or res.shard.n_devices != 1:
        raise AssertionError(f"phase 13: one-rank plan {res.shard}")
    if not np.array_equal(res.J, phase7_J):
        raise AssertionError("phase 13: the one-rank sharded fleet J is not bitwise phase 7's")
    try:
        make_fleet_mesh(2, device="cuda")
        raise AssertionError("phase 13: make_fleet_mesh(2) on one GPU did not raise")
    except ValueError as e:
        refused = str(e)
    mesh = make_fleet_mesh(device="cuda")
    active = torch.ones(FLEET_B, dtype=torch.bool, device=problems[0].device)

    def per_call_us(fn, reps=500):
        for _ in range(20):
            fn()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e6 * (time.perf_counter() - t) / reps

    return {"reason": res.shard.reason, "J_bitwise_phase7": True, "rounds": res.rounds, "wall_s": wall,
            "ms_per_round": 1e3 * wall / max(res.rounds, 1), "two_rank_mesh_refused": refused,
            "mesh": str(mesh), "launches": counter.last,
            "flag_allreduce_us_nccl_1rank": per_call_us(lambda: _any_active(active, mesh.get_group("fleet"))),
            "flag_local_us": per_call_us(lambda: _any_active(active, None))}


def phase13_pipeline(counter) -> dict:
    """(c) One full-width qwen1.5-0.5b decoder layer (bf16) as the stage of
    pipeline_apply over the one-rank NCCL group: bitwise the layer applied
    to each microbatch directly, every flash launch wgmma."""
    import dataclasses as dc

    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import get_config
    from repro_torch.distributed import pipeline_apply
    from repro_torch.distributed.sharding import _map_tensors
    from repro_torch.launch.steps import serve_config
    from repro_torch.models import init_params
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.model import ParamTree, _block_full

    cfg = dc.replace(serve_config(get_config("qwen1.5-0.5b")), n_layers=1)
    layer = init_params(cfg, 0, device="cuda").blocks[0]

    def stacked(m) -> dict:
        out = {n: p.detach()[None] for n, p in m.named_parameters(recurse=False)}
        out.update({n: stacked(c) for n, c in m.named_children()})
        return out

    def stage_fn(p, x):
        return _block_full(ParamTree(p), x, cfg, "dense")[0]

    gen = torch.Generator(device="cuda").manual_seed(13)
    xs = torch.randn(PIPE_M, PIPE_B, PIPE_S, cfg.d_model, generator=gen, device="cuda",
                     dtype=dtype_of(cfg.compute_dtype))
    mesh = DeviceMesh("cuda", [0], mesh_dim_names=("pod",))
    params = stacked(layer)
    with torch.no_grad():
        got = counter.run(lambda: pipeline_apply(stage_fn, params, xs, mesh=mesh, axis="pod", device="cuda"))
        variants = dict(counter.last_variants["flash_attention"])
        want = torch.stack([_block_full(layer, xs[i], cfg, "dense")[0] for i in range(PIPE_M)])
        if not torch.equal(got, want):
            raise AssertionError(f"phase 13: pipeline_apply is not bitwise the layer: max err "
                                 f"{(got.float() - want.float()).abs().max().item()}")
        if set(variants) != {"wgmma"} or variants["wgmma"] <= 0:
            raise AssertionError(f"phase 13: pipeline flash launches {variants}")
        # Where a one-stage pipeline's time over the direct layer goes:
        # `wrapped` is stage_fn on this rank's stage params without the
        # schedule (the ParamTree wrap a call), `schedule` the schedule with
        # an identity stage (the output buffer and its copies). Each timed in
        # turns, twice, by CUDA events; `host_ms` is the wall time of one
        # call to its last synchronize.
        p0 = _map_tensors(params, lambda a: a[0])
        runs = {
            "direct": lambda: [_block_full(layer, xs[i], cfg, "dense")[0] for i in range(PIPE_M)],
            "wrapped": lambda: [stage_fn(p0, xs[i]) for i in range(PIPE_M)],
            "pipeline": lambda: pipeline_apply(stage_fn, params, xs, mesh=mesh, axis="pod", device="cuda"),
            "schedule": lambda: pipeline_apply(lambda p, x: x, params, xs, mesh=mesh, axis="pod",
                                               device="cuda"),
        }
        ms = {k: [] for k in runs}
        host = {}
        for _ in range(2):
            for k, fn in runs.items():
                ms[k].append(cuda_ms(fn, 5))
        for k, fn in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host[k] = 1e3 * (time.perf_counter() - t0)
    return {"shape": [PIPE_M, PIPE_B, PIPE_S, cfg.d_model], "dtype": str(xs.dtype), "bitwise": True,
            "flash_variants": variants, "pipeline_ms": min(ms["pipeline"]), "direct_ms": min(ms["direct"]),
            "overhead": {"ms": ms, "host_ms": host}}


def phase13_ranks_start(out_dir):
    """(d) Start the CPU tests' 4-rank gloo runs on this host (fleet and
    pipeline, one torch thread a rank); `phase13_ranks_finish` holds them."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("_torch_ranks", ROOT / "tests" / "_torch_ranks.py")
    ranks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ranks)
    out_dir.mkdir(parents=True, exist_ok=True)
    return ranks, time.perf_counter(), {w: ranks.launch(w, out_dir) for w in ("fleet", "pipeline")}


def phase13_ranks_finish(started, out_dir) -> dict:
    ranks, t0, procs = started
    runs = {w: ranks.finish(p, out_dir, w) for w, p in procs.items()}
    out = {"device": "cpu", "ranks": ranks.N_RANKS, "backend": "gloo", "torch": str(runs["fleet"]["torch"]),
           "wall_s": time.perf_counter() - t0}
    for w, r in runs.items():
        failed = ranks.failed_checks(r)
        err = ranks.against_reference(w, r)
        if failed or not all(e <= ranks.RTOL for e in err.values()):
            raise AssertionError(f"phase 13: {w} ranks: failed checks {failed}, against the reference {err}")
        out[w] = {"checks": sum(1 for k in r if k.startswith("check.")), "ranks_wall_s": float(r["wall_s"]),
                  "max_rel_err_vs_reference": max(err.values())}
    out["fleet"]["flag_allreduce_us"] = float(runs["fleet"]["flag_allreduce_us"])
    out["pipeline"]["hop_us"] = float(runs["pipeline"]["hop_us"])
    return out


def phase13(counter, problems, phase7_J) -> None:
    import torch
    import torch.distributed as dist

    t = [time.perf_counter()]
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        examples = phase13_examples(counter)
        t.append(time.perf_counter())
        emit({"phase": 13, "part": "a", "name": "examples", "wall_s": t[1] - t[0], **examples})
        fleet_run = phase13_fleet(counter, problems, phase7_J)
        t.append(time.perf_counter())
        emit({"phase": 13, "part": "b", "name": "fleet_one_rank_nccl", "wall_s": t[2] - t[1], **fleet_run})
        pipe = phase13_pipeline(counter)
        t.append(time.perf_counter())
        emit({"phase": 13, "part": "c", "name": "pipeline_one_rank_nccl", "wall_s": t[3] - t[2], **pipe})
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    # After the card's parts, so that the ranks have the host to themselves.
    rank_dir = ROOT / "build" / "phase13_ranks"
    started = phase13_ranks_start(rank_dir)
    try:
        host = phase13_ranks_finish(started, rank_dir)
    finally:
        for proc in started[2].values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    emit({"phase": 13, "part": "d", "name": "gloo_ranks_on_host", **host})
    emit({"phase": 13, "name": "mesh_pipeline_examples", "wall_s": time.perf_counter() - t[0]})


# Phase 14: model parallelism. (a) phase 11's model and batches through the
# model-parallel step on a (data=1, model=1) mesh over a one-rank NCCL group,
# then an MoE model the same way, with a prefill and decode steps; (b) the dry
# run's per-device records of qwen1.5-0.5b and of the MoE archs on both
# production meshes, from phase 12's matrix; (c) the CPU tests' gloo ranks.
MP_STEPS = 3
MP_CELLS = ("train_4k", "prefill_32k", "decode_32k")
# The MoE model of (a): its published widths, cut to this many layers.
MP_MOE_ARCH, MP_MOE_LAYERS = "qwen2-moe-a2.7b", 2
# The MoE cells of (b), beside DRYRUN_ARCH's.
MP_MOE_CELLS = (("qwen2-moe-a2.7b", ("train_4k", "prefill_32k", "decode_32k")),
                ("mixtral-8x22b", ("train_4k", "prefill_32k", "decode_32k", "long_500k")))


def mp_train_pair(counter, cfg, batches, mesh, rules) -> dict:
    """MP_STEPS train steps of `cfg` on `batches` from init_params(cfg, 0),
    plain, then over the one-rank `mesh` as DTensors under
    activation_sharding, each run's state freed before the next: losses,
    grad norms and step ms of each, whether the final parameters are
    bitwise equal, and the flash launches of each run."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.sharding import distribute_batch, distribute_params, param_pspecs
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params, trainable
    from repro_torch.optim import adamw_init

    def train(on_mesh: bool):
        params = init_params(cfg, 0, device="cuda")
        if on_mesh:
            distribute_params(params, mesh, param_pspecs(cfg, params, MeshShape.of(mesh), rules))
        opt = adamw_init(trainable(params))
        step = make_train_step(cfg, lr=TRAIN_LR, **({"mesh": mesh, "rules": rules} if on_mesh else {}))
        losses, norms, ms = [], [], []

        def run():
            nonlocal params, opt
            for b in batches:
                t0 = time.perf_counter()
                batch = distribute_batch({"tokens": b}, mesh, rules) if on_mesh else {"tokens": b}
                params, opt, m = step(params, opt, batch)
                losses.append(m["loss"].item())
                norms.append(m["grad_norm"].item())
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))

        counter.run(run)
        final = {n: (p.to_local() if isinstance(p, DTensor) else p).detach().clone()
                 for n, p in params.named_parameters()}
        dtensors = all(isinstance(p, DTensor) for p in params.parameters()) and all(
            isinstance(t, DTensor) for t in opt["mu"].values())
        del params, opt
        free_device()
        return losses, norms, ms, final, dtensors

    plain = train(False)
    plain_launches = counter.last["flash_attention"]
    mp = train(True)
    out = {"plain": plain[:3], "mesh": mp[:3], "dtensors": mp[4], "flash_launches_plain": plain_launches,
           "flash_launches": counter.last["flash_attention"],
           "flash_variants": counter.last_variants["flash_attention"],
           "params_bitwise": all(torch.equal(mp[3][n], w) for n, w in plain[3].items()),
           "params_differ": [n for n, w in plain[3].items() if not torch.equal(mp[3][n], w)][:5]}
    del plain, mp
    free_device()
    return out


def p50(ms: list) -> float:
    """The median of the steps after the first."""
    return sorted(ms[1:])[len(ms[1:]) // 2]


def phase14_train(counter, plain_p50_ms: float) -> dict:
    """(a) MP_STEPS train steps of phase 11's config and batches, plain and
    over the one-rank mesh as DTensors under activation_sharding, from the
    same weights: losses, grad norms and parameters bitwise; the flash op
    launched through its sharding rule twice a layer a step (remat), all
    wgmma; then the wrapper on CUDA DTensors, which launches or raises."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.mesh import build_mesh

    cfg = get_config(TRAIN_ARCH)
    stream = make_pipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S, global_batch=TRAIN_B, seed=1234))
    batches = [torch.from_numpy(stream.next_batch()).cuda() for _ in range(MP_STEPS)]
    mesh, rules = build_mesh(1, "cuda"), ShardingRules()
    pair = mp_train_pair(counter, cfg, batches, mesh, rules)
    plain, mp = pair["plain"], pair["mesh"]
    launches, variants = pair["flash_launches"], pair["flash_variants"]
    params_bitwise = pair["params_bitwise"]

    # The wrapper on CUDA DTensors at the serve prefill's shape: the kernel's
    # output bitwise, one launch; a dtype the kernels refuse raises.
    g = torch.Generator(device="cuda").manual_seed(14)
    q, k, v = (torch.randn(8, 16, 1024, 64, generator=g, device="cuda", dtype=torch.bfloat16) for _ in range(3))
    rep = [Replicate()] * 2
    qd, kd, vd = (distribute_tensor(t, mesh, rep, src_data_rank=None) for t in (q, k, v))
    out_d = counter.run(lambda: flash_attention(qd, kd, vd))
    wrapper_launches = dict(counter.last_variants["flash_attention"])
    out = flash_attention(q, k, v)
    wrapper_bitwise = isinstance(out_d, DTensor) and torch.equal(out_d.to_local(), out)
    try:
        flash_attention(*(t.to(torch.float16) for t in (qd, kd, vd)))
        refused = None
    except (TypeError, ValueError, RuntimeError) as e:  # DTensor wraps the op's own error
        refused = f"{type(e).__name__}: {e}"[:200]
    del q, k, v, qd, kd, vd, out, out_d
    free_device()

    p50_mesh, p50_plain = p50(mp[2]), p50(plain[2])
    result = {
        "mesh": str(mesh), "steps": MP_STEPS, "losses": mp[0], "grad_norms": mp[1],
        "losses_plain": plain[0], "grad_norms_plain": plain[1],
        "losses_bitwise": mp[0] == plain[0], "grad_norms_bitwise": mp[1] == plain[1],
        "params_bitwise": params_bitwise, "params_differ": pair["params_differ"], "dtensors": pair["dtensors"],
        "flash_launches": launches, "flash_variants": variants, "flash_launches_plain": pair["flash_launches_plain"],
        "step_ms": mp[2], "step_ms_plain": plain[2], "step_ms_p50": p50_mesh, "step_ms_p50_plain": p50_plain,
        "step_ms_p50_phase11": plain_p50_ms, "dtensor_host_overhead_ms": p50_mesh - p50_plain,
        "wrapper_dtensor_launches": wrapper_launches, "wrapper_dtensor_bitwise": wrapper_bitwise,
        "wrapper_dtensor_float16_refused": refused,
    }
    emit({"phase": 14, "part": "a", "name": "model_parallel_train_one_rank_nccl", **result})
    checks = {
        "losses bitwise": result["losses_bitwise"], "grad norms bitwise": result["grad_norms_bitwise"],
        "params bitwise": params_bitwise, "params and moments are DTensors": pair["dtensors"],
        "flash through its rule, twice a layer a step": launches == 2 * cfg.n_layers * MP_STEPS
        and set(variants) == {"wgmma"},
        "wrapper on DTensors launches the kernel": wrapper_launches == {"wgmma": 1} and wrapper_bitwise,
        "wrapper refuses float16": refused is not None,
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 14a: {failed} {result}")
    return result


def mp_serve_pair(counter, cfg, tokens, mesh, rules) -> dict:
    """A prefill of `tokens` and MP_STEPS greedy decode steps of the serving
    config of `cfg` from init_params(., 0), plain, then over the one-rank
    `mesh` (the prefill's caches laid out by `cache_pspecs`): each run's
    last-position logits and tokens, and the flash launches of each."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.sharding import (distribute_batch, distribute_caches, distribute_params,
                                                  param_pspecs)
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.steps import make_prefill_step, make_serve_step, serve_config
    from repro_torch.models import init_params

    scfg = serve_config(cfg)
    total = tokens.shape[1] + MP_STEPS

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def serve(on_mesh: bool):
        kw = {"mesh": mesh, "rules": rules} if on_mesh else {}
        params = init_params(scfg, 0, device="cuda")
        if on_mesh:
            distribute_params(params, mesh, param_pspecs(scfg, params, MeshShape.of(mesh), rules))

        def batch(t):
            return distribute_batch({"tokens": t}, mesh, rules) if on_mesh else {"tokens": t}

        def run():
            caches, logits = make_prefill_step(scfg, total, **kw)(params, batch(tokens))
            if on_mesh:
                plain = [{k: ({kk: full(vv) for kk, vv in v.items()} if isinstance(v, dict) else full(v))
                          for k, v in layer.items()} for layer in caches]
                caches = distribute_caches(scfg, plain, mesh, rules)
            out, toks = [full(logits)[:, -1].clone()], []
            step = make_serve_step(scfg, **kw)
            for i in range(MP_STEPS):
                toks.append(out[-1].argmax(-1).to(torch.int32)[:, None])
                logits, caches = step(params, caches, batch(toks[-1])["tokens"], tokens.shape[1] + i)
                out.append(full(logits)[:, -1].clone())
            return torch.stack(out), torch.cat(toks, dim=1)

        logits, toks = counter.run(run)
        del params
        free_device()
        return logits, toks

    plain = serve(False)
    plain_launches = counter.last["flash_attention"]
    mp = serve(True)
    out = {"logits_bitwise": torch.equal(plain[0], mp[0]), "tokens_equal": torch.equal(plain[1], mp[1]),
           "max_abs_diff": [float((a.float() - b.float()).abs().max()) for a, b in zip(plain[0], mp[0])],
           "flash_launches_plain": plain_launches, "flash_launches": counter.last["flash_attention"],
           "flash_variants": counter.last_variants["flash_attention"]}
    del plain, mp
    free_device()
    return out


def phase14_moe(counter, card: str) -> dict:
    """(a, MoE) MP_MOE_ARCH at its published widths cut to MP_MOE_LAYERS
    layers (fp32 params, bf16 compute, remat), phase 11's batches: MP_STEPS
    train steps plain and over the one-rank mesh, where each rank
    dispatches its own token groups on local tensors and the expert
    products run in the parameter rules' layouts (`layers._moe_on_mesh`):
    losses, grad norms and all parameters bitwise; then a prefill of the
    first batch and MP_STEPS decode steps, plain and over the mesh,
    bitwise. Every flash launch through its sharding rule, wgmma (D=128).
    The steps' p50 plain and over the mesh, beside the card's name and
    power limit."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_pipeline
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch.mesh import build_mesh

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(MP_MOE_ARCH), n_layers=MP_MOE_LAYERS)
    stream = make_pipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S, global_batch=TRAIN_B, seed=1234))
    batches = [torch.from_numpy(stream.next_batch()).cuda() for _ in range(MP_STEPS)]
    mesh, rules = build_mesh(1, "cuda"), ShardingRules()
    pair = mp_train_pair(counter, cfg, batches, mesh, rules)
    t1 = time.perf_counter()
    served = mp_serve_pair(counter, cfg, batches[0], mesh, rules)
    plain, mp = pair["plain"], pair["mesh"]
    per_step = (2 if cfg.remat else 1) * cfg.n_layers
    result = {
        "arch": cfg.name, "layers": cfg.n_layers, "params": cfg.n_params(),
        "experts": cfg.n_experts, "top_k": cfg.top_k, "moe_groups": cfg.moe_groups, "batch": [TRAIN_B, TRAIN_S],
        "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype, "remat": cfg.remat,
        "losses": mp[0], "losses_plain": plain[0], "grad_norms": mp[1], "grad_norms_plain": plain[1],
        "losses_bitwise": mp[0] == plain[0], "grad_norms_bitwise": mp[1] == plain[1],
        "params_bitwise": pair["params_bitwise"], "params_differ": pair["params_differ"],
        "dtensors": pair["dtensors"], "flash_launches": pair["flash_launches"],
        "flash_variants": pair["flash_variants"], "flash_launches_plain": pair["flash_launches_plain"],
        "step_ms": mp[2], "step_ms_plain": plain[2], "step_ms_p50": p50(mp[2]), "step_ms_p50_plain": p50(plain[2]),
        "serve": served, "card": card, "train_s": t1 - t0, "serve_s": time.perf_counter() - t1,
        "wall_s": time.perf_counter() - t0,
    }
    emit({"phase": 14, "part": "a", "name": "model_parallel_moe_one_rank_nccl", **result})
    checks = {
        "losses bitwise": result["losses_bitwise"], "grad norms bitwise": result["grad_norms_bitwise"],
        "params bitwise": pair["params_bitwise"], "params and moments are DTensors": pair["dtensors"],
        "flash through its rule, all wgmma": pair["flash_launches"] == per_step * MP_STEPS
        and set(pair["flash_variants"]) == {"wgmma"},
        "prefill and decode bitwise": served["logits_bitwise"] and served["tokens_equal"],
        "prefill flash through its rule, all wgmma": served["flash_launches"] == cfg.n_layers
        and set(served["flash_variants"]) == {"wgmma"},
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 14a MoE: {failed} {result}")
    return result


def phase14_dryrun() -> dict:
    """(b) The matrix's qwen1.5-0.5b records and the MoE archs' records
    (`MP_MOE_CELLS`) on both production meshes: collectives by kind,
    per-device temporaries, FLOPs and arguments; none null, no mesh error,
    nonzero collectives, none an error."""
    rows, bad = {}, []
    for arch, shapes in ((DRYRUN_ARCH, MP_CELLS), *MP_MOE_CELLS):
        for shape in shapes:
            for mesh in ("16x16", "2x16x16"):
                f = DRYRUN_DIR / f"{arch}__{shape}__{mesh}.json"
                r = json.loads(f.read_text()) if f.exists() else {"status": "missing"}
                if r["status"] != "ok":
                    bad.append((arch, shape, mesh, r["status"], r.get("error", "")[:200]))
                    continue
                row = {"collective_bytes": r["collective_bytes"], "temp_bytes": r["memory"]["temp_bytes"],
                       "flops_per_device": r["flops_per_device"], "flops": r["flops"],
                       "per_device_argument_gib": r["per_device_argument_gib"], "mesh_trace_s": r["mesh_trace_s"]}
                if ("mesh_error" in r or any(v is None for v in row.values())
                        or not sum(row["collective_bytes"].values())):
                    bad.append((arch, shape, mesh, "null", r.get("mesh_error"), row))
                rows[f"{arch}/{shape}/{mesh}"] = row
    emit({"phase": 14, "part": "b", "name": "dryrun_mesh_records", "cells": rows})
    if bad:
        raise AssertionError(f"phase 14b: {bad}")
    return rows


def phase14_ranks() -> dict:
    """(c) The CPU tests' model-parallel run on this host's torch: 4 gloo
    ranks, a (data=2, model=2) mesh (`tests/_torch_ranks.py
    model_parallel`: the dense model and the two MoE configs, the train
    CLI on both), every check held."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("_torch_ranks", ROOT / "tests" / "_torch_ranks.py")
    ranks = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ranks)
    out_dir = ROOT / "build" / "phase14_ranks"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        r = ranks.finish(ranks.launch("model_parallel", out_dir), out_dir, "model_parallel")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    failed = ranks.failed_checks(r)
    row = {"device": "cpu", "ranks": ranks.N_RANKS, "backend": "gloo", "torch": str(r["torch"]),
           "wall_s": time.perf_counter() - t0, "ranks_wall_s": float(r["wall_s"]),
           "checks": sum(1 for k in r if k.startswith("check.")), "step_s": float(r["mp_step_s"]),
           "losses": r["mp.losses"].tolist(), "losses_one_process": r["one.losses"].tolist(),
           "moe": {arch: {"losses": r[f"{arch}.losses"].tolist(),
                          "losses_one_process": r[f"{arch}.one.losses"].tolist(),
                          "dropped_entries": int(r[f"{arch}.dropped_entries"])} for arch in ranks.MOE_CONFIGS},
           "moe_cli_losses": r["moe_cli.losses"].tolist(),
           "moe_cli_losses_one_process": r["moe_cli.one.losses"].tolist()}
    emit({"phase": 14, "part": "c", "name": "model_parallel_gloo_ranks_on_host", **row})
    if failed:
        raise AssertionError(f"phase 14c: failed checks {failed}")
    return row


def phase14(counter, plain_p50_ms: float, card: str) -> None:
    import torch.distributed as dist

    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        phase14_train(counter, plain_p50_ms)
        t_moe = time.perf_counter()
        phase14_moe(counter, card)
    finally:
        dist.destroy_process_group()
    t1 = time.perf_counter()
    phase14_dryrun()
    t2 = time.perf_counter()
    phase14_ranks()
    emit({"phase": 14, "name": "model_parallelism", "wall_s": time.perf_counter() - t0, "train_s": t1 - t0,
          "moe_s": t1 - t_moe, "ranks_s": time.perf_counter() - t2})


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
    from repro_torch.configs import ARCHS

    matrix = DryrunMatrix(ARCHS)
    try:
        return run_phases(torch, matrix)
    finally:
        matrix.stop()


def run_phases(torch, matrix) -> int:
    from repro_torch import core
    from repro_torch.core import alt, scenarios as scen
    from repro_torch import fleet
    from repro_torch.fleet import pad
    from repro_torch.kernels import _build

    card = gpu_line()
    t0 = time.perf_counter()
    libs = _build.build_all()
    flash_ops, minplus_ops = sass_opcodes(libs["flash_attention"]), sass_opcodes(libs["minplus"])
    hgmma = None if flash_ops is None else sum(
        n for fn in flash_ops.values() for op, n in fn.items() if op.startswith("HGMMA"))
    if hgmma == 0:
        raise AssertionError("the flash library holds no HGMMA (wgmma) instruction")
    ptxas = {n: ptxas_summary(_build.build_log(n)) for n in _build.SOURCES}
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    emit({"phase": 0, "name": "build", "build_s": time.perf_counter() - t0,
          "torch": torch.__version__, "cuda": torch.version.cuda, "nvcc": nvcc,
          "flash_hgmma_instructions": "not measured (no cuobjdump)" if hgmma is None else hgmma,
          "minplus_sass": "not measured (no cuobjdump)" if minplus_ops is None else minplus_sass(minplus_ops),
          "ptxas": ptxas})
    # neumann_cols rests on its operands staying in registers between hops,
    # the argmin on its minima and chunk ids staying there over the k loop.
    spills = [ln for ln in ptxas["neumann"] + ptxas["minplus"]
              if ln.startswith(("neumann_cols_kernel", "minplus_argmin")) and "spill" in ln]
    if spills:
        raise AssertionError(f"kernels that spill: {spills}")

    problems = [scen.random_connected(256, 32, seed=s) for s in range(64)]
    stacked, _ = pad.stack_problems(problems)
    fleet_problems = fleet.sample_fleet(FLEET_B, seed=0, n_range=FLEET_N_RANGE, apps_range=FLEET_APPS_RANGE,
                                        partitions=(1, 2, 3))
    pareto_chunk = pareto_first_chunk(fleet)
    warm_mm = warm_closure_operands(core, problems[0])

    summary = phase1(scen, _build, stacked, fleet_problems, pareto_chunk, warm_mm)
    del pareto_chunk, warm_mm
    summary.update(phase1_flash())
    _build.reset_launches()
    counter = Counter(_build)
    phase2(scen, alt, counter)
    phase3(core, pad, counter, stacked, problems[0])
    phase4(scen, alt, core, counter)
    del stacked, problems
    torch.cuda.empty_cache()
    cfg, params = phase5(counter)
    phase6(counter, cfg, params)
    del params
    torch.cuda.empty_cache()
    fleet_err, phase7_J = phase7(core, counter, fleet_problems)
    for name, e in fleet_err.items():
        summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"], e)
    phase8(core, counter, fleet_problems)
    phase9(counter)
    phase10(counter)
    trained = phase11(counter)
    phase12(counter, matrix)
    phase13(counter, fleet_problems, phase7_J)
    phase14(counter, trained["train"]["step_ms_p50"], card)
    summary["flash_attention"]["backward"] = {
        "route": "plain (recompute under autograd, kernels/flash_attention/ops.py::flash_attention_backward)",
        "rows": trained["flash_grad_rows"],
        "launches_per_train_step": trained["train"]["flash_launches_per_step"],
    }

    sources = {
        "neumann": "src/repro_torch/csrc/neumann.cu", "minplus": "src/repro_torch/csrc/minplus.cu",
        "flash": "src/repro_torch/csrc/flash_attention.cu",
        "placement": "src/repro_torch/csrc/placement.cu",
        "forwarding": "src/repro_torch/csrc/forwarding.cu",
    }
    replaces = {
        "neumann_cols": "src/repro/kernels/neumann/kernel.py:52",
        "neumann_rows": "src/repro/kernels/neumann/kernel.py:52",
        "minplus": "src/repro/kernels/minplus/kernel.py:36",
        "minplus_argmin": "src/repro/kernels/minplus/kernel.py:61",
        "flash_attention": "src/repro/kernels/flash_attention/kernel.py:39",
        "placement_sweep": "no Pallas kernel: src/repro/core/placement.py:103, a lax.scan over apps",
        "forwarding_sweep": "no Pallas kernel: src/repro/core/forwarding.py, jnp over [B, A, K, V, V]",
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
            **({"shapes": s["shapes"]} if "shapes" in s else {}),
            **({"backward": s["backward"]} if "backward" in s else {}),
            **({"variants": counter.total_variants[name]} if name in counter.total_variants else {}),
        })
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
