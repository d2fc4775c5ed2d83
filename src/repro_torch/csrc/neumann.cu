// Fused batched Neumann propagation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/neumann/kernel.py
// `_neumann_kernel` (:52, W resident in VMEM for V <= 1024) and
// `_neumann_tiled_kernel` (:69, W streamed in row tiles past V = 1024, opt-in
// bf16 operands). bf16 operands are read as __nv_bfloat16 and multiplied and
// accumulated in fp32, with the residual test in fp32; a bf16 zero converts
// to an exact fp32 zero. nvcc contracts a*b+c into FMA, so sums round
// differently from the plain version (within the 1e-5 contract).
//
// Contract (identical to the Pallas kernels and to neumann_propagate_ref):
// for each batch element n, x <- b + M x, x_0 = b, for at most `hops` hops.
// The first hop with max|x_new - x| <= tol * (max|x_new| + 1e-30) is applied
// and then the iterate is frozen -- here the blocks simply leave the loop,
// which gives the same result as the TPU's frozen fori_loop carry. The max
// propagates NaN like jnp.max, so a NaN iterate never counts as converged.
//
// Both kernels are bound by bytes: every hop is 2 flops per operand element,
// far below the ~20 flop/byte ridge of fp32 CUDA cores. The bound counts one
// read of each operator; what matters is how often a kernel goes back to
// L2/HBM for it.
//
// neumann_cols (M = W^T, the traffic solve (I - Phi^T) t = b):
//   x_new[i] = b[i] + sum_j W[j, i] x[j]; one block per operator, one thread
//   per column i, so a warp reads 32 consecutive floats of row j per step
//   (coalesced). W is staged in shared memory when V^2 fits in 48 KB (the
//   paper's V <= 64 topologies); otherwise every hop reads it from L2/HBM.
//
// neumann_rows (M = W, the cost-to-go solve (I - Phi) q = c):
//   x_new[i] = b[i] + sum_j W[i, j] x[j]. The TPU kept W in VMEM for the
//   whole solve; one Hopper block's 227 KB cannot hold a 256 KB operator, but
//   a thread-block cluster can. Each operator's rows are split over a
//   cluster of C CTAs (C in {1, 2, 4, 8}, chosen by the caller from V and the
//   operand size: kernels/neumann/ops.py `_rows_cluster`), grid = N * C. A
//   CTA loads its ceil(V / C) rows of W into shared memory once, with bulk
//   async copies (`cp.async.bulk` on an mbarrier), and keeps them for the
//   whole solve: at V = 256 fp32, C = 4 that is 64 KB a CTA, so three CTAs
//   share an SM and one CTA's load overlaps another's hops. Each hop a warp
//   takes 8 of the CTA's rows against the CTA's full copy of x (each x[j]
//   read from shared memory serves 8 products, 4 columns a lane a load where
//   V % 4 == 0), reduces the 8 dot products across the warp in 9 shuffles,
//   and its lanes write the 8 values into every CTA's next x buffer through
//   distributed shared memory. Each warp also hands its part of the
//   residual pair (r, s) to every CTA, and the CTAs meet at `cluster.sync()`,
//   the hop's only barrier. Every warp then reduces the same C x 8 pairs and
//   takes the same break decision. x and the pairs are double-buffered by
//   hop parity, so one cluster barrier a hop orders all reads and writes.
//   Where even C = 8 cannot hold the rows (V > 664 in fp32), the same split
//   streams each CTA's row block from L2 on every hop instead
//   (`resident` = 0): the phase-4 operators (4 x 4 MB at V = 1024) fit in
//   the 50 MB L2 and run on 4 * 8 SMs instead of 4.
//   What holds it back (N = 2048, V = 256: 0.67 ms on an H100, 4.1x the
//   bound; chip_smoke.py phase 1): each hop re-reads the CTA's 64 KB of W
//   from shared memory, and with three CTAs an SM the hops are
//   latency-bound (a warp's pass, the shuffles, the cluster barrier), while
//   the one HBM read of W is bursty. Fewer, larger clusters (C = 2), more,
//   smaller ones (C = 8) and point-to-point mbarrier signalling in place of
//   the cluster barrier were all slower when tried.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSmemW = 48 * 1024;  // neumann_cols stages W in shared memory up to this size
constexpr int kMaxCluster = 8;

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

// ---------------------------------------------------------------------------
// neumann_cols: one block per operator.
template <typename T>
__global__ void neumann_cols_kernel(const T* __restrict__ W, long long w_bstride,
                                    const float* __restrict__ B, float* __restrict__ X, int V,
                                    int hops, float tol, int stage_w) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* x = reinterpret_cast<float*>(smem);
  float* xn = x + V;
  float* red = xn + V;                     // 66 floats
  T* ws = reinterpret_cast<T*>(red + 68);  // V*V operands if staged

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
    for (int i = tid; i < V; i += nt) {
      float acc = 0.f;
      for (int j = 0; j < V; ++j) acc += to_f32(w[(long long)j * V + i]) * x[j];
      xn[i] = b[i] + acc;
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
cudaError_t launch_cols(const T* w, long long w_bstride, const float* b, float* x, int n, int v,
                        int hops, float tol, cudaStream_t stream) {
  const int threads = min(1024, max(32, ((v + 31) / 32) * 32));
  const size_t w_bytes = (size_t)v * v * sizeof(T);
  const int stage_w = w_bytes <= (size_t)kSmemW;
  const size_t smem = (2 * (size_t)v + 68) * sizeof(float) + (stage_w ? w_bytes : 0);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(neumann_cols_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  neumann_cols_kernel<T><<<n, threads, smem, stream>>>(w, w_bstride, b, x, v, hops, tol, stage_w);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// neumann_rows: one cluster of C CTAs per operator, each CTA R = ceil(V / C) rows.

constexpr int kRowWarps = 8;  // warps of a neumann_rows CTA: 8 rows each per pass

// Shared memory of one CTA, in bytes: the residual pairs
// [2][kMaxCluster * kRowWarps][2] floats at 0, an 8-byte mbarrier at
// kRowsBar, x[2][V] and b[V] floats from kRowsX (16-byte aligned, so x takes
// 16-byte loads when V % 4 == 0), then (resident) the CTA's R x V rows of W,
// 16-byte aligned.
constexpr int kRowsBar = 4 * kMaxCluster * kRowWarps * sizeof(float);
constexpr int kRowsX = kRowsBar + 16;
__host__ __device__ constexpr size_t rows_w_offset(int v) {
  return (kRowsX + 3 * (size_t)v * sizeof(float) + 15) / 16 * 16;
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// The sums of acc[0..7] over the warp in 9 shuffles instead of 8 x 5: each
// step hands half of the values still held to the partner lane. Every lane
// of the 4-lane group g = lane >> 2 ends with the sum for row g.
__device__ __forceinline__ float warp_sum8(const float (&acc)[8], int lane) {
  float v[4];
  const bool h16 = lane & 16;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    v[k] = (h16 ? acc[4 + k] : acc[k]) + __shfl_xor_sync(0xffffffffu, h16 ? acc[k] : acc[4 + k], 16);
  const bool h8 = lane & 8;
  float u[2];
#pragma unroll
  for (int k = 0; k < 2; ++k)
    u[k] = (h8 ? v[2 + k] : v[k]) + __shfl_xor_sync(0xffffffffu, h8 ? v[k] : v[2 + k], 8);
  const bool h4 = lane & 4;
  float w = (h4 ? u[1] : u[0]) + __shfl_xor_sync(0xffffffffu, h4 ? u[0] : u[1], 4);
  w += __shfl_xor_sync(0xffffffffu, w, 2);
  w += __shfl_xor_sync(0xffffffffu, w, 1);
  return w;
}

template <typename T>
__global__ void __launch_bounds__(kRowWarps * 32)
    neumann_rows_kernel(const T* __restrict__ W, long long w_bstride, const float* __restrict__ B,
                        float* __restrict__ X, int V, int R, int hops, float tol, int resident) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* pairs = reinterpret_cast<float*>(smem);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + kRowsBar);
  float* xb = reinterpret_cast<float*>(smem + kRowsX);  // x[2][V]
  float* bs = xb + 2 * V;                               // b[V]
  T* ws = reinterpret_cast<T*>(smem + rows_w_offset(V));

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int n = blockIdx.x / C;
  const int r0 = rank * R, nr = max(0, min(V, r0 + R) - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* wg = W + (long long)n * w_bstride + (long long)r0 * V;  // this CTA's rows
  const float* bg = B + (long long)n * V;

  const uint32_t bar_s = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
  const size_t w_bytes = (size_t)nr * V * sizeof(T);
  const bool bulk = resident && nr > 0 && ((uintptr_t)wg % 16 == 0) && (w_bytes % 16 == 0);
  if (bulk && tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar_s),
                 "r"((uint32_t)w_bytes)
                 : "memory");
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(ws));
    for (size_t off = 0; off < w_bytes; off += 16384)
      bulk_load(dst + (uint32_t)off, reinterpret_cast<const unsigned char*>(wg) + off,
                (uint32_t)min((size_t)16384, w_bytes - off), bar_s);
  } else if (resident) {
    for (long long e = tid; e < (long long)nr * V; e += blockDim.x) ws[e] = wg[e];
  }
  for (int i = tid; i < V; i += blockDim.x) xb[i] = bs[i] = bg[i];
  cluster.sync();  // every CTA of the cluster runs (DSMEM is safe) and x_0 is in place
  if (bulk) {
    uint32_t done;
    do {
      asm volatile(
          "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar_s)
          : "memory");
    } while (!done);
  }
  const T* w = resident ? ws : wg;
  // Vector loads need every row (and both x buffers) 4-element aligned.
  const bool vec = V % 4 == 0 && (uintptr_t)w % (4 * sizeof(T)) == 0;

  // A warp takes 8 rows a pass (each x[j] read serves 8 products); lane l
  // ends with row q = l >> 2 of the 8 and hands it to CTAs l & 3, (l & 3) + 4.
  const int q = lane >> 2, dst0 = lane & 3;
  int cur = 0;
  for (int h = 0; h < hops; ++h) {
    const float* x = xb + cur * V;
    float* nxt0 = cluster.map_shared_rank(xb + (cur ^ 1) * V, dst0 < C ? dst0 : 0);
    float* nxt1 = cluster.map_shared_rank(xb + (cur ^ 1) * V, dst0 + 4 < C ? dst0 + 4 : 0);
    float r = 0.f, s = 0.f;
    for (int i0 = 8 * warp; i0 < nr; i0 += 8 * kRowWarps) {
      const T* row[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) row[k] = w + (long long)min(i0 + k, nr - 1) * V;
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (vec) {  // 4 consecutive columns a lane: one 16-byte (fp32) or 8-byte (bf16) load a row
        for (int j = 4 * lane; j < V; j += 128) {
          const float4 xj = *reinterpret_cast<const float4*>(x + j);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float4 wk = load4(row[k] + j);
            acc[k] += wk.x * xj.x + wk.y * xj.y + wk.z * xj.z + wk.w * xj.w;
          }
        }
      } else {
#pragma unroll 2
        for (int j = lane; j < V; j += 32) {
          const float xj = x[j];
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[k] += to_f32(row[k][j]) * xj;
        }
      }
      const float sum = warp_sum8(acc, lane);
      const int i = i0 + q;
      if (i < nr) {
        const float v = bs[r0 + i] + sum;
        if (dst0 < C) nxt0[r0 + i] = v;
        if (dst0 + 4 < C) nxt1[r0 + i] = v;
        if (dst0 == 0) {
          r = nanmax(r, fabsf(v - x[r0 + i]));
          s = nanmax(s, fabsf(v));
        }
      }
    }
    // The warp's residual pair goes to every CTA; the cluster barrier is the
    // hop's only barrier.
    for (int o = 4; o < 32; o <<= 1) {  // lanes 0, 4, ..., 28 hold the rows' parts
      r = nanmax(r, __shfl_xor_sync(0xffffffffu, r, o));
      s = nanmax(s, __shfl_xor_sync(0xffffffffu, s, o));
    }
    r = __shfl_sync(0xffffffffu, r, 0);
    s = __shfl_sync(0xffffffffu, s, 0);
    float* slot = pairs + 2 * kMaxCluster * kRowWarps * (h & 1);
    if (lane < C) {
      float* dst = cluster.map_shared_rank(slot, lane) + 2 * (rank * kRowWarps + warp);
      dst[0] = r;
      dst[1] = s;
    }
    cluster.sync();  // x_new and every pair are in every CTA
    r = 0.f;
    s = 0.f;
    for (int k = lane; k < C * kRowWarps; k += 32) {
      r = nanmax(r, slot[2 * k]);
      s = nanmax(s, slot[2 * k + 1]);
    }
    for (int o = 16; o > 0; o >>= 1) {
      r = nanmax(r, __shfl_xor_sync(0xffffffffu, r, o));
      s = nanmax(s, __shfl_xor_sync(0xffffffffu, s, o));
    }
    cur ^= 1;
    if (r <= tol * (s + 1e-30f)) break;  // uniform over the cluster
  }
  for (int i = tid; i < nr; i += blockDim.x) X[(long long)n * V + r0 + i] = xb[cur * V + r0 + i];
}

template <typename T>
cudaError_t launch_rows(const T* w, long long w_bstride, const float* b, float* x, int n, int v,
                        int hops, float tol, int cluster, int resident, cudaStream_t stream) {
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) return cudaErrorInvalidValue;
  if ((long long)n * cluster > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int rows = (v + cluster - 1) / cluster;
  const size_t smem = rows_w_offset(v) + (resident ? (size_t)rows * v * sizeof(T) : 0);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(neumann_rows_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n * cluster);
  cfg.blockDim = dim3(kRowWarps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, neumann_rows_kernel<T>, w, w_bstride, b, x, v,
                                           rows, hops, tol, resident);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* w, long long w_bstride, const float* b, float* x, int n, int v,
                   int hops, float tol, int cols, int cluster, int resident, cudaStream_t stream) {
  const T* wt = static_cast<const T*>(w);
  return cols ? launch_cols<T>(wt, w_bstride, b, x, n, v, hops, tol, stream)
              : launch_rows<T>(wt, w_bstride, b, x, n, v, hops, tol, cluster, resident, stream);
}

}  // namespace

// w: n operators of v x v (row-major, batch stride w_bstride elements),
// float32 (bf16 == 0) or bfloat16 (bf16 == 1); b, x: [n, v] float32.
// cols != 0 applies M = W^T (neumann_cols), else M = W (neumann_rows, on
// clusters of `cluster` CTAs in {1, 2, 4, 8}, holding W in shared memory
// when `resident` != 0). Returns the launch's CUDA error.
extern "C" int neumann_propagate(const void* w, long long w_bstride, const float* b, float* x,
                                 int n, int v, int hops, float tol, int cols, int bf16, int cluster,
                                 int resident, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(w, w_bstride, b, x, n, v, hops, tol, cols, cluster, resident, s)
           : launch<float>(w, w_bstride, b, x, n, v, hops, tol, cols, cluster, resident, s);
  return (int)err;
}
