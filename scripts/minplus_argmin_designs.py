#!/usr/bin/env python3
"""Designs of the fused min-plus argmin on one GPU, on the same inputs.

    python3 scripts/minplus_argmin_designs.py

The shipped kernel (`csrc/minplus.cu` `minplus_argmin_kernel`: 4-deep
chunk minima, then one deferred search for the first minimising k) against
the same source built with 8- and 16-deep chunks (`KC` substituted: a
cheaper loop, a longer search), and against the design it was chosen
over, kept here and built only by this script: a
128 x 128 tile of 512 threads, an 8 x 4 micro-tile a thread (columns
tx + 32c, so stores run along a row), the int32 index kept per candidate
(FADD, compare, value select, index select: four instructions a
candidate), on the same cp.async ring. Both are held
bitwise, value and index, to the plain version, then timed by CUDA events
in turns (alternative, shipped, KC = 8, KC = 16, then the reverse) at the
main path's
argmin shapes: the next-hop product of phase 3 (64 stacked
random_connected(256, 32)) and phase 4 (random_connected(1024, 4)), and
integer ties at the phase-3 shape. Prints one JSON line per shape, and the
card's name and power limit.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

ALT_SOURCE = r"""
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
namespace {
constexpr int T = 128, KT = 16, PAD = 4;
struct Stage { float a[KT][T + PAD]; float b[KT][T]; };
__device__ __forceinline__ void cp4(float* d, const float* s) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"((uint32_t)__cvta_generic_to_shared(d)), "l"(s) : "memory");
}
__device__ __forceinline__ void load(Stage& s, const float* A, const float* B, int M, int K, int N, int i0, int j0,
                                     int k0, int tid) {
#pragma unroll
  for (int u = 0; u < T * KT / 512; ++u) {
    const int e = tid + 512 * u, row = e / KT, kk = e % KT, gi = i0 + row, gk = k0 + kk;
    if (gi < M && gk < K) cp4(&s.a[kk][row], A + (long long)gi * K + gk); else s.a[kk][row] = INFINITY;
  }
  const int kk = tid / (T / 4), col = 4 * (tid % (T / 4)), gk = k0 + kk;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int gj = j0 + col + c;
    if (gk < K && gj < N) cp4(&s.b[kk][col + c], B + (long long)gk * N + gj); else s.b[kk][col + c] = INFINITY;
  }
}
__global__ void __launch_bounds__(512, 1)
    argmin_per_candidate_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
                                long long* __restrict__ I, int M, int K, int N) {
  __shared__ __align__(16) Stage st[2];
  const long long z = blockIdx.z;
  A += z * M * K; B += z * K * N; C += z * M * N; I += z * M * N;
  const int i0 = blockIdx.y * T, j0 = blockIdx.x * T, tid = threadIdx.x, tx = tid % 32, ty = tid / 32;
  float acc[8][4];
  int idx[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = INFINITY, idx[r][c] = 0;
  const int nk = (K + KT - 1) / KT;
  load(st[0], A, B, M, K, N, i0, j0, 0, tid);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (kt + 1 < nk) load(st[(kt + 1) % 2], A, B, M, K, N, i0, j0, (kt + 1) * KT, tid);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const Stage& s = st[kt % 2];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s.a[kk][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&s.a[kk][64 + 4 * ty]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[4] = {s.b[kk][tx], s.b[kk][tx + 32], s.b[kk][tx + 64], s.b[kk][tx + 96]};
      const int k = kt * KT + kk;
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float v = a[r] + b[c];
          if (v < acc[r][c]) acc[r][c] = v, idx[r][c] = k;
        }
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + (r < 4 ? 4 * ty + r : 64 + 4 * ty + r - 4);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 32 * c;
      if (i < M && j < N) C[(long long)i * N + j] = acc[r][c], I[(long long)i * N + j] = idx[r][c];
    }
  }
}
}  // namespace
extern "C" int argmin_per_candidate(const float* a, const float* b, float* c, long long* idx, int batch, int m,
                                    int k, int n, void* stream) {
  const dim3 grid((n + T - 1) / T, (m + T - 1) / T, batch);
  argmin_per_candidate_kernel<<<grid, 512, 0, static_cast<cudaStream_t>(stream)>>>(a, b, c, idx, m, k, n);
  return (int)cudaGetLastError();
}
"""


def build_alternative(build):
    """Compile ALT_SOURCE beside the port's libraries; (library, ptxas lines)."""
    key = hashlib.sha256(ALT_SOURCE.encode() + " ".join(build.NVCC_FLAGS).encode()).hexdigest()[:16]
    src = build.BUILD_DIR / f"argmin_per_candidate-{key}.cu"
    lib = src.with_suffix(".so")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(ALT_SOURCE)
    out = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                         capture_output=True, text=True, check=True)
    ptxas = [ln.strip() for ln in (out.stdout + out.stderr).splitlines() if "registers" in ln or "spill" in ln]
    fn = ctypes.CDLL(str(lib)).argmin_per_candidate
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, ptxas


def build_chunk_depth(build, kc):
    """The shipped minplus.cu with KC-deep chunks, built beside the port's
    libraries; its C function minplus_matmul_argmin."""
    text = (build.CSRC / "minplus.cu").read_text()
    assert "constexpr int KC = 4;" in text
    text = text.replace("constexpr int KC = 4;", f"constexpr int KC = {kc};")
    key = hashlib.sha256(text.encode() + " ".join(build.NVCC_FLAGS).encode()).hexdigest()[:16]
    src = build.BUILD_DIR / f"minplus_kc{kc}-{key}.cu"
    lib = src.with_suffix(".so")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(text)
    out = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                         capture_output=True, text=True, check=True)
    ptxas = [ln.strip() for ln in (out.stdout + out.stderr).splitlines() if "registers" in ln or "spill" in ln]
    fn = ctypes.CDLL(str(lib)).minplus_matmul_argmin
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, ptxas


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("minplus_argmin_designs: this script needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import FP32_ISSUE_PER_S, argmin_variant, cuda_ms, gpu_line
    from repro_torch.core import scenarios as scen
    from repro_torch.core import stack_single
    from repro_torch.core.placement import zero_load_dp
    from repro_torch.fleet import pad
    from repro_torch.kernels import _build
    from repro_torch.kernels.minplus import apsp, minplus_matmul_argmin, minplus_matmul_argmin_ref

    _build.build_all(("minplus",))
    alt_fn, alt_ptxas = build_alternative(_build)
    depth = {kc: build_chunk_depth(_build, kc) for kc in (8, 16)}
    print(json.dumps({"alternative_ptxas": alt_ptxas, **{f"kc{kc}_ptxas": p for kc, (_, p) in depth.items()}}),
          flush=True)

    def chunk_depth(kc, a, b):  # one range of K, as the chooser gives at B=64, V=256
        nb, m, k = a.shape
        n = b.shape[-1]
        out = torch.empty(nb, m, n, device="cuda")
        idx = torch.empty(nb, m, n, dtype=torch.int64, device="cuda")
        ksplit = -(-k // 16) * 16
        _build.check(depth[kc][0](a.data_ptr(), b.data_ptr(), out.data_ptr(), idx.data_ptr(), None, None, nb, m, k,
                                  n, 1, ksplit, int(ksplit // kc > 256), _build.stream_of(a)), f"argmin kc={kc}")
        return out, idx

    def alternative(a, b):
        nb, m, k = a.shape
        n = b.shape[-1]
        out = torch.empty(nb, m, n, device="cuda")
        idx = torch.empty(nb, m, n, dtype=torch.int64, device="cuda")
        _build.check(alt_fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), idx.data_ptr(), nb, m, k, n,
                            _build.stream_of(a)), "argmin_per_candidate")
        return out, idx

    gen = torch.Generator(device="cuda").manual_seed(0)
    ints = torch.randint(1, 5, (2, 64, 256, 256), generator=gen, device="cuda").float()
    ints = torch.where(torch.rand(ints.shape, generator=gen, device="cuda") < 0.5, ints, 1e18)
    w256 = zero_load_dp(pad.stack_problems([scen.random_connected(256, 32, seed=s) for s in range(64)])[0])
    w1024 = zero_load_dp(stack_single(scen.random_connected(1024, 4, seed=1)))
    cases = [("B=64 V=256 nexthop", w256, apsp(w256)), ("B=64 V=256 integer ties", ints[0], ints[1]),
             ("B=1 V=1024 nexthop", w1024, apsp(w1024))]
    for tag, a, b in cases:
        want = minplus_matmul_argmin_ref(a, b)
        row = {"shape": tag, "variant": argmin_variant(*a.shape, b.shape[-1]),
               "bound_ms": 1e3 * 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[-1] / FP32_ISSUE_PER_S}
        designs = {
            "per_candidate_ms": lambda: alternative(a, b), "shipped_ms": lambda: minplus_matmul_argmin(a, b),
            "kc8_ms": lambda: chunk_depth(8, a, b), "kc16_ms": lambda: chunk_depth(16, a, b),
        }
        for name, fn in designs.items():
            got = fn()
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"{name} {tag}: not bitwise equal to the plain version")
        reps = 10 if a.shape[0] > 1 else 5
        order = list(designs) + list(designs)[::-1]
        for name in order:
            row.setdefault(name, []).append(cuda_ms(designs[name], reps))
        print(json.dumps(row), flush=True)
        del want
    print(gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
