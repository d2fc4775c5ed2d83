// cost_to_go's two contractions of phi for Hopper (sm_90a), one launch each
// a call, every stage in it.
//
// No Pallas kernel corresponds to either: the JAX package writes both in
// jnp (src/repro/core/flow.py `loads`, src/repro/core/marginals.py
// `cost_to_go`). Their plain PyTorch versions (kernels/phi_contract/ref.py)
// write a product of phi's size [B, A, V, V] a stage and read it back to
// reduce it: three passes over phi for one read's worth of work.
//
//   phi_loads:     F[b, i, j] = sum_k sum_a L[b, a, k] t[b, a, k, i] phi[b, a, k, i, j]
//   phi_link_term: out[b, a, k, i] = L[b, a, k] sum_j phi[b, a, k, i, j] dp[b, i, j]
//
// The two are each other's adjoints (the backward of one is the other),
// so they share an operand layout: phi [B, A, K, V, V], the [B, A, K, V]
// vector (t or out), the [B, V, V] matrix (F or dp) and L [B, A, K], all
// float32 and contiguous.
//
// What bounds both: bytes, phi read once (16-byte evict-first loads); every
// other operand is at most 1/V of phi's size.
//
// phi_loads: a thread owns VEC columns of one row i of one network b and
// walks (k, a) in index order, stages outer and apps inner, with kBatch
// apps' loads in flight before their multiply-adds. Stage k's sum is a
// chain over the apps in order, added to F in stage order, as `loads`
// does: apps padded on at the end and phantom stages are exact-zero
// addends at the tail of a chain, so padding stays bitwise inert.
//
// phi_link_term: the forwarding kernel's layout (csrc/forwarding.cu): a
// row lies on a segment of SEG lanes, NPL values a lane in vectors of VEC
// columns; a CTA owns a block of rows i of one network b over a run of
// kSlabs (a, k) slabs, so its rows of dp are read once a run and kept in
// registers. Each row's sum is kChains chains a lane, then shuffles within
// the segment. Past V = 1024 the streamed kernel walks a row on a warp,
// dp read through L1 on every slab.

#include <cuda_runtime.h>

namespace {

constexpr int kBatch = 8;   // apps whose phi loads phi_loads keeps in flight
constexpr int kSlabs = 16;  // (a, k) slabs a phi_link_term CTA walks
constexpr int kChains = 4;  // independent sum chains of a phi_link_term lane

// VEC contiguous floats: `ldg` by the read-only path, `stream_get`
// evict-first (phi is read once), `put` a plain store.
template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  static __device__ __forceinline__ void ldg(const float* p, float* v) { v[0] = __ldg(p); }
  static __device__ __forceinline__ void stream_get(const float* p, float* v) { v[0] = __ldcs(p); }
  static __device__ __forceinline__ void put(float* p, const float* v) { p[0] = v[0]; }
};
template <>
struct Vec<4> {
  static __device__ __forceinline__ void ldg(const float* p, float* v) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  }
  static __device__ __forceinline__ void stream_get(const float* p, float* v) {
    const float4 x = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  }
  static __device__ __forceinline__ void put(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// One thread a vector of VEC columns of a row (b, i): threads in column
// order, then rows, so a warp reads whole rows of a slab.
template <int VEC>
__global__ void __launch_bounds__(256) phi_loads_kernel(
    const float* __restrict__ phi, const float* __restrict__ t, const float* __restrict__ L,
    float* __restrict__ F, int B, int A, int K, int V) {
  const int nvec = V / VEC;
  const size_t gid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (size_t)B * V * nvec) return;
  const int c = (int)(gid % nvec);
  const size_t row = gid / nvec;  // b * V + i
  const int i = (int)(row % V);
  const size_t b = row / V;
  const size_t vv = (size_t)V * V;
  const size_t slabs = (size_t)A * K;
  const float* x0 = phi + b * slabs * vv + (size_t)i * V + (size_t)c * VEC;
  const float* t0 = t + b * slabs * V + i;
  const float* L0 = L + b * slabs;

  float f[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) f[e] = 0.f;
  for (int k = 0; k < K; ++k) {
    float s[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) s[e] = 0.f;
    int a = 0;
    for (; a + kBatch <= A; a += kBatch) {
      float x[kBatch][VEC], w[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const size_t slab = (size_t)(a + u) * K + k;
        Vec<VEC>::stream_get(x0 + slab * vv, x[u]);
        w[u] = __fmul_rn(__ldg(L0 + slab), __ldg(t0 + slab * V));
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
#pragma unroll
        for (int e = 0; e < VEC; ++e) s[e] = __fmaf_rn(w[u], x[u][e], s[e]);
    }
    for (; a < A; ++a) {
      const size_t slab = (size_t)a * K + k;
      float x[VEC];
      Vec<VEC>::stream_get(x0 + slab * vv, x);
      const float w = __fmul_rn(__ldg(L0 + slab), __ldg(t0 + slab * V));
#pragma unroll
      for (int e = 0; e < VEC; ++e) s[e] = __fmaf_rn(w, x[e], s[e]);
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) f[e] = __fadd_rn(f[e], s[e]);
  }
  Vec<VEC>::put(F + row * V + (size_t)c * VEC, f);
}

// Rows held in registers, as forwarding_sweep_kernel lays them: vector c
// of lane sl at columns (c * SEG + sl) * VEC + e, 32 / SEG rows a warp.
// Grid (B * row blocks, slab runs). Rows past V are worked on row V - 1
// and not stored.
template <int NPL, int VEC, int SEG>
__global__ void __launch_bounds__(256) phi_link_term_kernel(
    const float* __restrict__ phi, const float* __restrict__ dp, const float* __restrict__ L,
    float* __restrict__ out, int S, int V) {
  constexpr int NV = NPL / VEC;
  const int lane = threadIdx.x & 31, sl = lane % SEG;
  const int rows_cta = blockDim.x / SEG;
  const int blocks = (V + rows_cta - 1) / rows_cta;
  const int b = blockIdx.x / blocks;
  const int row = (blockIdx.x % blocks) * rows_cta + threadIdx.x / SEG;
  const int i = min(row, V - 1);
  const int s0 = blockIdx.y * kSlabs;
  const int s1 = min(S, s0 + kSlabs);

  float w[NPL];  // the row of dp, for the whole run
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const int j0 = (c * SEG + sl) * VEC;
    if (j0 < V) {
      Vec<VEC>::ldg(dp + ((size_t)b * V + i) * V + j0, &w[c * VEC]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) w[c * VEC + e] = 0.f;
    }
  }

  for (int s = s0; s < s1; ++s) {
    const size_t slab = (size_t)b * S + s;
    const float* xrow = phi + (slab * V + i) * V;
    float x[NPL];
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int j0 = (c * SEG + sl) * VEC;
      if (j0 < V) Vec<VEC>::stream_get(xrow + j0, &x[c * VEC]);
    }
    const float Lk = __ldg(L + slab);
    float sums[kChains] = {};
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int j0 = (c * SEG + sl) * VEC;
      if (j0 >= V) continue;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int n = c * VEC + e;
        sums[n % kChains] = __fmaf_rn(x[n], w[n], sums[n % kChains]);
      }
    }
    float sum = __fadd_rn(__fadd_rn(sums[0], sums[1]), __fadd_rn(sums[2], sums[3]));
#pragma unroll
    for (int off = SEG / 2; off > 0; off >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
    if (sl == 0 && row < V) out[slab * V + i] = __fmul_rn(Lk, sum);
  }
}

// Rows past the register-resident range: one row a warp, dp read through
// L1 on every slab.
__global__ void __launch_bounds__(256) phi_link_term_streamed_kernel(
    const float* __restrict__ phi, const float* __restrict__ dp, const float* __restrict__ L,
    float* __restrict__ out, int S, int V) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rows_cta = blockDim.x >> 5;
  const int blocks = (V + rows_cta - 1) / rows_cta;
  const int b = blockIdx.x / blocks;
  const int i = (blockIdx.x % blocks) * rows_cta + warp;
  if (i >= V) return;  // warp-uniform; no barrier follows
  const int s0 = blockIdx.y * kSlabs;
  const int s1 = min(S, s0 + kSlabs);
  const float* w = dp + ((size_t)b * V + i) * V;

  for (int s = s0; s < s1; ++s) {
    const size_t slab = (size_t)b * S + s;
    const float* x = phi + (slab * V + i) * V;
    float sum = 0.f;
    for (int j = lane; j < V; j += 32) sum = __fmaf_rn(__ldcs(x + j), __ldg(w + j), sum);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
    if (lane == 0) out[slab * V + i] = __fmul_rn(__ldg(L + slab), sum);
  }
}

template <int NPL, int VEC, int SEG>
int launch_link(dim3 grid, int threads, cudaStream_t st, const float* phi, const float* dp, const float* L,
                float* out, int S, int V) {
  phi_link_term_kernel<NPL, VEC, SEG><<<grid, threads, 0, st>>>(phi, dp, L, out, S, V);
  return (int)cudaGetLastError();
}

}  // namespace

// F [batch, V, V] from phi [batch, A, K, V, V], t [batch, A, K, V] and
// L [batch, A, K]; float32, contiguous, phi and F from 16-byte boundaries
// when vec is 4. `vec` in {1, 4} dividing V. Returns the launch's CUDA
// error code, or -1 for a vec without an instance.
extern "C" int phi_loads(const float* phi, const float* t, const float* L, float* F, int batch, int A, int K,
                         int V, int vec, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int threads = 256;
  const size_t n = (size_t)batch * V * (V / vec);
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  if (vec == 4) {
    phi_loads_kernel<4><<<blocks, threads, 0, st>>>(phi, t, L, F, batch, A, K, V);
  } else if (vec == 1) {
    phi_loads_kernel<1><<<blocks, threads, 0, st>>>(phi, t, L, F, batch, A, K, V);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}

// out [batch, S, V] from phi [batch, S, V, V] (S = A * K slabs), dp
// [batch, V, V] and L [batch, S]; float32, contiguous. `seg`, `npl`,
// `vec` and `warps` as forwarding_sweep takes them (kernels/forwarding/
// ops.py `_geometry`); npl = 0 takes the streamed kernel with `warps`
// warps of one row each. Returns the launch's CUDA error code, or -1 for
// a geometry without an instance.
extern "C" int phi_link_term(const float* phi, const float* dp, const float* L, float* out, int batch, int S,
                             int V, int npl, int vec, int seg, int warps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows_cta = npl == 0 ? warps : warps * (32 / seg);
  const dim3 grid(batch * ((V + rows_cta - 1) / rows_cta), (S + kSlabs - 1) / kSlabs);
  const int threads = 32 * warps;
  if (npl == 0) {
    phi_link_term_streamed_kernel<<<grid, threads, 0, st>>>(phi, dp, L, out, S, V);
    return (int)cudaGetLastError();
  }
#define LINK_CASE(N, E, G) \
  if (npl == N && vec == E && seg == G) return launch_link<N, E, G>(grid, threads, st, phi, dp, L, out, S, V);
  LINK_CASE(8, 1, 4)
  LINK_CASE(8, 4, 4)
  LINK_CASE(8, 1, 8)
  LINK_CASE(8, 4, 8)
  LINK_CASE(8, 1, 16)
  LINK_CASE(8, 4, 16)
  LINK_CASE(8, 1, 32)
  LINK_CASE(8, 4, 32)
  LINK_CASE(16, 1, 32)
  LINK_CASE(16, 4, 32)
  LINK_CASE(32, 1, 32)
  LINK_CASE(32, 4, 32)
#undef LINK_CASE
  return -1;
}
