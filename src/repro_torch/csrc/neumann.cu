// Fused batched Neumann propagation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/neumann/kernel.py
// `_neumann_kernel` (:52, W resident in VMEM for V <= 1024) and
// `_neumann_tiled_kernel` (:69, W streamed in row tiles past V = 1024, opt-in
// bf16 operands). The TPU needed two kernels because VMEM holds W whole only
// up to V = 1024; no Hopper block holds a 4 MiB operator in shared memory
// anyway, so one kernel per operator layout serves every V.
//
// Contract (identical to the Pallas kernels and to neumann_propagate_ref):
// for each batch element n, x <- b + M x, x_0 = b, for at most `hops` hops.
// The first hop with max|x_new - x| <= tol * (max|x_new| + 1e-30) is applied
// and then the iterate is frozen -- here the block simply leaves the loop,
// which gives the same result as the TPU's frozen fori_loop carry.
//
// Operator layout: the caller hands phi and a flag instead of materialising
// the swapaxes copy the TPU wrapper made for every solve.
//   neumann_cols (M = W^T, the traffic solve (I - Phi^T) t = b):
//       x_new[i] = b[i] + sum_j W[j, i] x[j]; one thread per column i, so a
//       warp reads 32 consecutive floats of row j per step (coalesced).
//   neumann_rows (M = W, the cost-to-go solve (I - Phi) q = c):
//       x_new[i] = b[i] + sum_j W[i, j] x[j]; one warp per row i, lanes over
//       j (coalesced), then a shuffle sum.
//
// What bounds it on the H100: bytes. Every hop reads the whole V x V
// operator once (2 flops per 4-byte element), far below the ~20 flop/byte
// ridge of fp32 CUDA cores. The design keeps the iterate in shared memory
// (2V floats), reads W once per hop from L2/HBM, and when V^2 fits in 48 KB
// (the paper's V <= 64 topologies) stages W into shared memory once so the
// later hops read no device memory at all. One block per operator: the
// batched main path (B*A operators per stage) fills the card; a single
// large operator (B*A = 4 at V = 1024) does not -- a known slow case.
// bf16 operands (the old tiled kernel's mode) are read as __nv_bfloat16 and
// multiplied and accumulated in fp32, with the residual test in fp32; a bf16
// zero converts to an exact fp32 zero. nvcc contracts a*b+c into FMA, so
// sums round differently from the plain version (within the 1e-5 contract).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSmemW = 48 * 1024;  // W staged in shared memory up to this size

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// max that propagates NaN like jnp.max (fmaxf would drop it).
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || b != b) ? NAN : fmaxf(a, b);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide max of two values; every thread gets both results.
// red: 2 * 32 + 2 floats of shared memory. blockDim.x is a multiple of 32.
__device__ __forceinline__ void block_max2(float& r, float& s, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    r = nanmax(r, __shfl_xor_sync(0xffffffffu, r, o));
    s = nanmax(s, __shfl_xor_sync(0xffffffffu, s, o));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  if (lane == 0) {
    red[warp] = r;
    red[32 + warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    r = lane < nw ? red[lane] : 0.f;  // |.| >= 0, so 0 is the identity
    s = lane < nw ? red[32 + lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) {
      r = nanmax(r, __shfl_xor_sync(0xffffffffu, r, o));
      s = nanmax(s, __shfl_xor_sync(0xffffffffu, s, o));
    }
    if (lane == 0) {
      red[64] = r;
      red[65] = s;
    }
  }
  __syncthreads();
  r = red[64];
  s = red[65];
}

template <typename T, bool COLS>
__global__ void neumann_kernel(const T* __restrict__ W, long long w_bstride,
                               const float* __restrict__ B, float* __restrict__ X,
                               int V, int hops, float tol, int stage_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* x = reinterpret_cast<float*>(smem);
  float* xn = x + V;
  float* red = xn + V;                                   // 66 floats
  T* ws = reinterpret_cast<T*>(red + 68);                // V*V operands if staged

  const int n = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const T* wg = W + (long long)n * w_bstride;
  const float* b = B + (long long)n * V;

  for (int i = tid; i < V; i += nt) x[i] = b[i];
  const T* w = wg;
  if (stage_w) {
    for (int e = tid; e < V * V; e += nt) ws[e] = wg[e];
    w = ws;
  }
  __syncthreads();

  for (int h = 0; h < hops; ++h) {
    if (COLS) {
      for (int i = tid; i < V; i += nt) {
        float acc = 0.f;
        for (int j = 0; j < V; ++j) acc += to_f32(w[(long long)j * V + i]) * x[j];
        xn[i] = b[i] + acc;
      }
    } else {
      const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
      for (int i = warp; i < V; i += nw) {
        const T* row = w + (long long)i * V;
        float acc = 0.f;
        for (int j = lane; j < V; j += 32) acc += to_f32(row[j]) * x[j];
        acc = warp_sum(acc);
        if (lane == 0) xn[i] = b[i] + acc;
      }
    }
    __syncthreads();
    float r = 0.f, s = 0.f;
    for (int i = tid; i < V; i += nt) {
      r = nanmax(r, fabsf(xn[i] - x[i]));
      s = nanmax(s, fabsf(xn[i]));
    }
    block_max2(r, s, red);  // ends with a barrier: every xn[i] is final
    for (int i = tid; i < V; i += nt) x[i] = xn[i];
    __syncthreads();
    if (r <= tol * (s + 1e-30f)) break;  // uniform: r, s are block-wide
  }
  for (int i = tid; i < V; i += nt) X[(long long)n * V + i] = x[i];
}

template <typename T>
cudaError_t launch(const void* w, long long w_bstride, const float* b, float* x,
                   int n, int v, int hops, float tol, int cols, cudaStream_t stream) {
  const int threads = min(1024, max(32, ((v + 31) / 32) * 32));
  const size_t w_bytes = (size_t)v * v * sizeof(T);
  const int stage_w = w_bytes <= (size_t)kSmemW;
  const size_t smem = (2 * (size_t)v + 68) * sizeof(float) + (stage_w ? w_bytes : 0);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  const T* wt = static_cast<const T*>(w);
  if (cols) {
    auto k = neumann_kernel<T, true>;
    if (smem > 48 * 1024) cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    k<<<n, threads, smem, stream>>>(wt, w_bstride, b, x, v, hops, tol, stage_w);
  } else {
    auto k = neumann_kernel<T, false>;
    if (smem > 48 * 1024) cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    k<<<n, threads, smem, stream>>>(wt, w_bstride, b, x, v, hops, tol, stage_w);
  }
  return cudaGetLastError();
}

}  // namespace

// w: n operators of v x v (row-major, batch stride w_bstride elements),
// float32 (bf16 == 0) or bfloat16 (bf16 == 1); b, x: [n, v] float32.
// cols != 0 applies M = W^T, else M = W. Returns the launch's CUDA error.
extern "C" int neumann_propagate(const void* w, long long w_bstride, const float* b,
                                 float* x, int n, int v, int hops, float tol, int cols,
                                 int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = bf16
      ? launch<__nv_bfloat16>(w, w_bstride, b, x, n, v, hops, tol, cols, s)
      : launch<float>(w, w_bstride, b, x, n, v, hops, tol, cols, s);
  return (int)err;
}
