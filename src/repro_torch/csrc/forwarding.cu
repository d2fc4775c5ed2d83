// One congestion-aware forwarding sweep's update of phi (paper Eq. 11) for
// Hopper (sm_90a): one launch a sweep.
//
// No Pallas kernel corresponds to it: the JAX package writes the sweep in
// jnp (src/repro/core/forwarding.py). Its plain PyTorch version
// (kernels/forwarding/ref.py) builds the link marginals delta and then the
// gap, the rate, the blocking mask, the decay, the prune and the one-hot
// reassignment as whole tensors of phi's size [B, A, K, V, V]: about 45
// passes over phi a sweep. Here every row (b, a, k, i) is done in
// registers, and phi is read once and written once:
//   1. delta_ij = adj_ij > 0 ? L_ak * dp_ij + q_j : BIG;
//   2. its minimum and first argmin j* (torch.argmin's order: NaN first,
//      then the smaller value, ties to the smaller index; a row with no
//      live out-edge is all BIG and takes j* = 0);
//   3. gap = delta < 1e17 ? delta - min : 0,
//      rate = alpha * (gap / (|min| + gap + 1e-12)), alpha where q_j >= q_i
//      (the blocking rule), phi * (1 - rate), pruned to 0 below 1e-9;
//   4. phi at j* zeroed, the others summed, and max(mass_i - others, 0)
//      added at j*.
//
// Exactness: every entry but the j* column is bitwise the plain path's on
// the same tensors. Every operation there rounds once in fp32, so every
// operation here is a round-to-nearest intrinsic (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn) that nvcc never contracts into an FMA, in the
// plain path's order, with its constants as the fp32 values PyTorch takes
// for them. Only the row sum `others` is taken in another order.
//
// What bounds it: bytes, phi read and written once, and the instruction rate
// close behind (25-40 instructions a value, an IEEE division on each
// edge). A CTA owns a block of rows i of one lane b and walks a run of
// kSlabs (a, k) slabs, so the adjacency of its rows is read once a run and
// kept as bits in registers, and their dp rows and each slab's q row come
// through L1 (the read-only path) for the run's other slabs and the CTA's
// other rows: neither is a second phi's worth of traffic. A row lies on a
// segment of 4 to 32 lanes, 8 to 32 values a lane in 16-byte vectors;
// minimum, argmin and sum by shuffles within the segment. Each warp walks
// its rows without barriers. Off the edges (most of a row) delta is BIG
// and the rate the row's one flat value, so the division runs on the
// edges alone. Past V = 1024 the streamed kernel walks each row twice
// instead: delta on the fly for the minimum, then phi once, with dp and
// the adjacency read from L2 on both walks.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kSlabs = 16;  // (a, k) slabs a CTA walks
constexpr int kChains = 4;  // independent minimum and sum chains of a lane
constexpr float kBig = 1e18f;
constexpr float kBigThreshold = 1e17f;
constexpr float kPrune = 1e-9f;
constexpr float kEps = 1e-12f;

// torch.argmin's order on (value, index), as csrc/placement.cu.
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  if (isnan(a)) return !isnan(b) || ia < ib;
  if (isnan(b)) return false;
  return a < b || (a == b && ia < ib);
}

__device__ __forceinline__ void warp_argmin(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (before(ov, oi, v, i)) v = ov, i = oi;
  }
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  return s;
}

__device__ __forceinline__ float delta_of(bool edge, float Lk, float dp, float qj) {
  return edge ? __fadd_rn(__fmul_rn(Lk, dp), qj) : kBig;
}

// Step 3's decay and prune of one entry; `improper`: !(q_j < q_i).
__device__ __forceinline__ float decayed(float phi, float d, float dmin, bool improper, float alpha) {
  const float gap = d < kBigThreshold ? __fsub_rn(d, dmin) : 0.f;
  float rate = __fmul_rn(alpha, __fdiv_rn(gap, __fadd_rn(__fadd_rn(fabsf(dmin), gap), kEps)));
  if (improper) rate = alpha;
  const float p = __fmul_rn(phi, __fsub_rn(1.f, rate));
  return p < kPrune ? 0.f : p;
}

// max(mass - others, 0) as torch.clamp_min (NaN stays NaN).
__device__ __forceinline__ float freed(float mass, float others) {
  const float c = __fsub_rn(mass, others);
  return c < 0.f ? 0.f : c;
}

// One slab's q row into shared memory, by all threads of the CTA.
__device__ __forceinline__ void stage_q(float* qs, const float* q_row, int V) {
  for (int j = threadIdx.x; j < V; j += blockDim.x) qs[j] = q_row[j];
}

// VEC contiguous floats: `ldg` by the read-only path (cached in L1),
// `stream_get` / `stream_put` evict-first (phi is touched once).
template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  static __device__ __forceinline__ void ldg(const float* p, float* v) { v[0] = __ldg(p); }
  static __device__ __forceinline__ void stream_get(const float* p, float* v) { v[0] = __ldcs(p); }
  static __device__ __forceinline__ void stream_put(float* p, const float* v) { __stcs(p, v[0]); }
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
  static __device__ __forceinline__ void stream_put(float* p, const float* v) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

// Rows held in registers. A row lies on a segment of SEG lanes, NPL values
// a lane (V <= SEG * NPL) as NPL / VEC vectors, vector c of lane sl at
// columns (c * SEG + sl) * VEC + e; a warp holds 32 / SEG rows. Grid
// (B * row blocks, slab runs). Each warp walks its rows through the run on
// its own, without barriers: a slab's phi rows are loaded first and arrive
// while the first walk forms delta (dp and q by the read-only path, which
// keeps them in L1 for the run's other slabs and the CTA's other rows) and
// the blocking bits; the second walk decays phi. Rows past V are worked on
// row V - 1 and not stored.
template <int NPL, int VEC, int SEG>
__global__ void __launch_bounds__(256) forwarding_sweep_kernel(
    const float* __restrict__ phi, const float* __restrict__ q, const float* __restrict__ dp,
    const float* __restrict__ L, const float* __restrict__ adj, const float* __restrict__ mass,
    float* __restrict__ out, int S, int V, float alpha) {
  constexpr int NV = NPL / VEC;
  const int lane = threadIdx.x & 31, sl = lane % SEG;
  const int rows_cta = blockDim.x / SEG;
  const int blocks = (V + rows_cta - 1) / rows_cta;
  const int b = blockIdx.x / blocks;
  const int row = (blockIdx.x % blocks) * rows_cta + threadIdx.x / SEG;
  const int i = min(row, V - 1);
  const int s0 = blockIdx.y * kSlabs;
  const int s1 = min(S, s0 + kSlabs);
  const float* wrow = dp + ((size_t)b * V + i) * V;

  unsigned edges = 0u;  // the adjacency of the lane's columns, for the whole run
#pragma unroll
  for (int c = 0; c < NV; ++c)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int j = (c * SEG + sl) * VEC + e;
      if (j < V && adj[((size_t)b * V + i) * V + j] > 0.f) edges |= 1u << (c * VEC + e);
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
    const float* qrow = q + slab * V;
    const float Lk = __ldg(L + slab), qi = __ldg(qrow + i), mi = __ldg(mass + slab * V + i);

    // delta and the blocking bits; the first minimum of kChains chains of
    // rising columns (a chain's first column is valid if any is), then the
    // lane's, then the segment's.
    float d[NPL], dm[kChains];
    int jm[kChains];
    unsigned improper = 0u;
#pragma unroll
    for (int k = 0; k < kChains; ++k) dm[k] = INFINITY, jm[k] = INT_MAX;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int j0 = (c * SEG + sl) * VEC;
      if (j0 >= V) continue;
      float wv[VEC], qv[VEC];
      Vec<VEC>::ldg(wrow + j0, wv);
      Vec<VEC>::ldg(qrow + j0, qv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int n = c * VEC + e, k = n % kChains;
        d[n] = delta_of(edges >> n & 1u, Lk, wv[e], qv[e]);
        if (!(qv[e] < qi)) improper |= 1u << n;
        // Smaller, or the first NaN after numbers.
        if (n < kChains || (!isnan(dm[k]) && !(d[n] >= dm[k]))) dm[k] = d[n], jm[k] = j0 + e;
      }
    }
    float dmin = dm[0];
    int jstar = jm[0];
#pragma unroll
    for (int k = 1; k < kChains; ++k)
      if (before(dm[k], jm[k], dmin, jstar)) dmin = dm[k], jstar = jm[k];
#pragma unroll
    for (int off = SEG / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, dmin, off);
      const int oi = __shfl_xor_sync(0xffffffffu, jstar, off);
      if (before(ov, oi, dmin, jstar)) dmin = ov, jstar = oi;
    }

    // Off the edges delta is BIG and the gap 0: the rate there is alpha *
    // (0 / (|min| + 0 + 1e-12)), the same for the whole row.
    const float keep_flat = __fsub_rn(1.f, __fmul_rn(alpha, __fdiv_rn(0.f, __fadd_rn(__fadd_rn(fabsf(dmin), 0.f), kEps))));
    const float keep_blocked = __fsub_rn(1.f, alpha);
    float sums[kChains] = {}, ystar = 0.f;  // the sums off j*; the j* entry before its reassignment
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int j0 = (c * SEG + sl) * VEC;
      if (j0 >= V) continue;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int n = c * VEC + e;
        const bool blocked = improper >> n & 1u;
        float y;
        if (edges >> n & 1u) {
          y = decayed(x[n], d[n], dmin, blocked, alpha);
        } else {
          y = __fmul_rn(x[n], blocked ? keep_blocked : keep_flat);
          y = y < kPrune ? 0.f : y;
        }
        x[n] = y;
        const bool at = j0 + e == jstar;
        ystar = at ? y : ystar;
        sums[n % kChains] = __fadd_rn(sums[n % kChains], at ? __fmul_rn(y, 0.f) : y);
      }
    }
    float others = __fadd_rn(__fadd_rn(sums[0], sums[1]), __fadd_rn(sums[2], sums[3]));
#pragma unroll
    for (int off = SEG / 2; off > 0; off >>= 1) others = __fadd_rn(others, __shfl_xor_sync(0xffffffffu, others, off));
    const float c_ = freed(mi, others);
    const float zc = __fmul_rn(0.f, c_);  // the one-hot's 0 * c off j*: +0 unless c is not finite
    if (row >= V) continue;
    float* orow = out + (slab * V + i) * V;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int j0 = (c * SEG + sl) * VEC;
      if (j0 >= V) continue;
      if (isnan(zc))
#pragma unroll
        for (int e = 0; e < VEC; ++e) x[c * VEC + e] = __fadd_rn(x[c * VEC + e], zc);
      Vec<VEC>::stream_put(orow + j0, &x[c * VEC]);
    }
    // j* takes its zeroed entry plus the freed mass, from the lane that
    // holds it.
    if (sl == jstar / VEC % SEG) __stcs(orow + jstar, __fadd_rn(__fmul_rn(ystar, 0.f), c_));
  }
}

// Rows past the register-resident range: one row a warp, walked twice
// (delta for the minimum; then phi once), q staged in dynamic shared
// memory (2 * V floats, double-buffered, one barrier a slab).
__global__ void __launch_bounds__(256) forwarding_sweep_streamed_kernel(
    const float* __restrict__ phi, const float* __restrict__ q, const float* __restrict__ dp,
    const float* __restrict__ L, const float* __restrict__ adj, const float* __restrict__ mass,
    float* __restrict__ out, int S, int V, float alpha) {
  extern __shared__ __align__(16) float qsd[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rows_cta = blockDim.x >> 5;
  const int blocks = (V + rows_cta - 1) / rows_cta;
  const int b = blockIdx.x / blocks;
  const int i = (blockIdx.x % blocks) * rows_cta + warp;
  const int s0 = blockIdx.y * kSlabs;
  const int s1 = min(S, s0 + kSlabs);
  const float* w = dp + ((size_t)b * V + (i < V ? i : 0)) * V;
  const float* a = adj + ((size_t)b * V + (i < V ? i : 0)) * V;

  for (int s = s0, t = 0; s < s1; ++s, ++t) {
    const size_t slab = (size_t)b * S + s;
    float* qb = qsd + (t & 1) * V;
    stage_q(qb, q + slab * V, V);
    __syncthreads();
    if (i >= V) continue;  // warp-uniform, after the barrier
    const float Lk = L[slab];
    float dmin = INFINITY;
    int jstar = INT_MAX;
    for (int j = lane; j < V; j += 32) {
      const float d = delta_of(a[j] > 0.f, Lk, w[j], qb[j]);
      if (before(d, j, dmin, jstar)) dmin = d, jstar = j;
    }
    warp_argmin(dmin, jstar);

    const float qi = qb[i];
    const float* x = phi + (slab * V + i) * V;
    float* y = out + (slab * V + i) * V;
    float others = 0.f;
    for (int j = lane; j < V; j += 32) {
      const float qj = qb[j];
      float p = decayed(x[j], delta_of(a[j] > 0.f, Lk, w[j], qj), dmin, !(qj < qi), alpha);
      if (j == jstar) p = __fmul_rn(p, 0.f);
      y[j] = p;
      others = __fadd_rn(others, p);
    }
    others = warp_sum(others);
    const float c_ = freed(mass[slab * V + i], others);
    const float zc = __fmul_rn(0.f, c_);
    if (isnan(zc)) {  // c not finite: the one-hot's 0 * c makes every entry NaN, as in the plain path
      for (int j = lane; j < V; j += 32)
        if (j != jstar) y[j] = __fadd_rn(y[j], zc);
    }
    if (lane == (jstar & 31)) y[jstar] = __fadd_rn(y[jstar], c_);
  }
}

template <int NPL, int VEC, int SEG>
int launch(dim3 grid, int threads, cudaStream_t st, const float* phi, const float* q, const float* dp, const float* L,
           const float* adj, const float* mass, float* out, int S, int V, float alpha) {
  forwarding_sweep_kernel<NPL, VEC, SEG><<<grid, threads, 0, st>>>(phi, q, dp, L, adj, mass, out, S, V, alpha);
  return (int)cudaGetLastError();
}

}  // namespace

// One sweep's phi update over `batch` lanes of S = A * K slabs of V x V.
// float32, contiguous: phi and out [batch, S, V, V]; q and mass
// [batch, S, V]; dp and adj [batch, V, V]; L [batch, S]. `seg` in
// {4, 8, 16, 32} lanes a row, `npl` in {8, 16, 32} values of a row a lane
// (8 below 32 lanes, seg * npl >= V), `vec` in {1, 4} dividing V, `warps`
// a CTA, each holding 32 / seg rows; npl = 0 takes the streamed kernel
// with `warps` warps of one row each (2 * V * 4 bytes of shared memory). Returns
// the launch's CUDA error code, or -1 for a geometry without an instance.
extern "C" int forwarding_sweep(const float* phi, const float* q, const float* dp, const float* L, const float* adj,
                                const float* mass, float* out, int batch, int S, int V, int npl, int vec, int seg,
                                int warps, float alpha, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows_cta = npl == 0 ? warps : warps * (32 / seg);
  const dim3 grid(batch * ((V + rows_cta - 1) / rows_cta), (S + kSlabs - 1) / kSlabs);
  const int threads = 32 * warps;
  if (npl == 0) {
    const size_t smem = 2 * (size_t)V * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(forwarding_sweep_streamed_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    forwarding_sweep_streamed_kernel<<<grid, threads, smem, st>>>(phi, q, dp, L, adj, mass, out, S, V, alpha);
    return (int)cudaGetLastError();
  }
#define FWD_CASE(N, E, G) \
  if (npl == N && vec == E && seg == G) return launch<N, E, G>(grid, threads, st, phi, q, dp, L, adj, mass, out, S, V, alpha);
  FWD_CASE(8, 1, 4)
  FWD_CASE(8, 4, 4)
  FWD_CASE(8, 1, 8)
  FWD_CASE(8, 4, 8)
  FWD_CASE(8, 1, 16)
  FWD_CASE(8, 4, 16)
  FWD_CASE(8, 1, 32)
  FWD_CASE(8, 4, 32)
  FWD_CASE(16, 1, 32)
  FWD_CASE(16, 4, 32)
  FWD_CASE(32, 1, 32)
  FWD_CASE(32, 4, 32)
#undef FWD_CASE
  return -1;
}
