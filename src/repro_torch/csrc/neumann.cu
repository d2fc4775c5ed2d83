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
// L2/HBM for it. Both split each operator over a thread-block cluster of C
// CTAs (C in {1, 2, 4, 8}, chosen by the caller from V alone:
// kernels/neumann/ops.py `_rows_cluster`, `_cols_cluster`), grid = N * C,
// keep the operator on chip for the whole solve where the cluster can hold
// it, and exchange x_new through distributed shared memory (DSMEM) with one
// cluster barrier a hop. x and the residual pairs are double-buffered by hop
// parity, so that barrier orders every read and write; every warp reduces the
// same pairs in the same order, so the break is uniform over the cluster.
//
// neumann_cols (M = W^T, the traffic solve (I - Phi^T) t = b):
//   x_new[i] = b[i] + sum_j W[j, i] x[j]. What bounds it on the main path is
//   the one stream of W from HBM: the traffic scan's solves stop after 1-6
//   hops (1.2 on average at stage 1), so hop 1 is most of the work. CTA c
//   owns columns [c R, (c + 1) R) of W; its thread (g, q) owns rows
//   [g P, (g + 1) P) of column quad q and loads the first 16 of them
//   straight into registers as 16-byte (fp32) or 8-byte (bf16) vectors, all
//   in flight at once: at V = 256, C = 4 that is 16 rows x 4 columns a
//   thread, 64 KB a CTA, two CTAs and 128 KB in flight an SM, so the load IS
//   hop 1 (no staging through shared memory, no barrier before the first
//   product). Where the layout is resident, the operands stay in registers
//   for every later hop: 64 FMAs a thread against the group's 16 x[j], read
//   from shared memory as four 16-byte broadcasts. The row groups' partial
//   sums meet in shared memory, and group 0's thread of each quad adds them
//   and writes the quad's x_new to every CTA.
//   Where a row group has more than 16 rows (V > 128 on one CTA, V > 256 on
//   8), the layout is streamed (`resident` = 0): a thread keeps no rows and
//   reads all of them from L2 on every hop, 8 loads in flight, so the
//   phase-4 operators (4 x 4 MB at V = 1024) stay in the 50 MB L2 and run
//   on 32 SMs instead of 4. Past 256 quads a CTA (V > 8192) a thread also
//   sums quads q + 256, ... from L2; the two iterates in shared memory then
//   bound V at 28928. Where V % 4 != 0 (the paper's topologies, one CTA)
//   operands are read one by one. Registers: the resident instances use
//   the 128 that two CTAs an SM allow (64 of them operands) and spill
//   nothing, which phase 0 of chip_smoke.py checks; the group-sum loop is
//   unrolled by two only, as four more in flight spilled.
//   What holds it back (N = 2048, V = 256, chip_smoke.py phase 1, PERF.md):
//   at one hop it streams W at about 83% of the HBM rate, because a CTA's
//   memory traffic stops while it reduces and crosses the cluster barrier;
//   each later hop is latency-bound the same way (about 0.065 ms a hop over
//   the 2048 operators, stage 2 against stage 1). Persistent
//   clusters that prefetched the next operator by cp.async during the
//   current solve streamed slightly faster at one hop but lost more to load
//   imbalance where hop counts vary, and 128-thread CTAs on clusters of 8
//   were slower.
//
// neumann_rows (M = W, the cost-to-go solve (I - Phi) q = c):
//   x_new[i] = b[i] + sum_j W[i, j] x[j]. The TPU kept W in VMEM for the
//   whole solve; one Hopper block's 227 KB cannot hold a 256 KB operator, but
//   a cluster can. A CTA loads its ceil(V / C) rows of W into shared memory
//   once, with bulk async copies (`cp.async.bulk` on an mbarrier), and keeps
//   them for the whole solve: at V = 256 fp32, C = 4 that is 64 KB a CTA, so
//   three CTAs share an SM and one CTA's load overlaps another's hops. Each
//   hop a warp takes 8 of the CTA's rows against the CTA's full copy of x
//   (each x[j] read from shared memory serves 8 products, 4 columns a lane a
//   load where V % 4 == 0), reduces the 8 dot products across the warp in 9
//   shuffles, and its lanes write the 8 values into every CTA's next x buffer.
//   Where even C = 8 cannot hold the rows (V > 664 in fp32), the same split
//   streams each CTA's row block from L2 on every hop instead
//   (`resident` = 0).
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

constexpr int kMaxCluster = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// max that propagates NaN like jnp.max (fmaxf would drop it).
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || b != b) ? NAN : fmaxf(a, b);
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

// ---------------------------------------------------------------------------
// neumann_cols: one cluster of C CTAs per operator, each CTA R columns.

constexpr int kColThreads = 256;  // threads of a neumann_cols CTA
constexpr int kColWarps = kColThreads / 32;
constexpr int kColRegRows = 16;  // rows of its column quad that a thread keeps in registers
constexpr int kStreamUnroll = 8;  // L2 loads in flight a thread where the layout is streamed

// Shared memory of one CTA, in bytes: the residual pairs
// [2][kMaxCluster * kColWarps][2] floats at 0, x[2][V] floats from kColsX,
// then the partial sums of row groups 1..G-1, red[G - 1][min(Q, kColThreads)]
// float4s, 16-byte aligned. b stays in global memory, so that the iterates
// alone bound V, as they did for the one-block kernel this replaced.
constexpr int kColsX = 4 * kMaxCluster * kColWarps * sizeof(float);
__host__ __device__ constexpr size_t cols_red_offset(int v) {
  return (kColsX + 2 * (size_t)v * sizeof(float) + 15) / 16 * 16;
}
__host__ __device__ constexpr size_t cols_smem(int v, int groups, int quad_slots) {
  return cols_red_offset(v) + (size_t)(groups - 1) * quad_slots * sizeof(float4);
}

// Four consecutive operands of one row as they are loaded: 16 bytes of fp32
// or 8 of bf16, converted to fp32 where they are used.
template <typename T>
struct Quad;
template <>
struct Quad<float> {
  using type = float4;
};
template <>
struct Quad<__nv_bfloat16> {
  using type = uint2;
};

__device__ __forceinline__ float4 quad_f32(float4 v) { return v; }
__device__ __forceinline__ float4 quad_f32(uint2 u) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// The first `n` (1..4) operands at p one by one, zeros after them.
__device__ __forceinline__ float4 load_quad_scalar(const float* p, int n) {
  return make_float4(p[0], n > 1 ? p[1] : 0.f, n > 2 ? p[2] : 0.f, n > 3 ? p[3] : 0.f);
}
__device__ __forceinline__ uint2 load_quad_scalar(const __nv_bfloat16* p, int n) {
  const __nv_bfloat16 z = __ushort_as_bfloat16(0);
  __nv_bfloat162 lo = __halves2bfloat162(p[0], n > 1 ? p[1] : z);
  __nv_bfloat162 hi = __halves2bfloat162(n > 2 ? p[2] : z, n > 3 ? p[3] : z);
  return make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
}

// VEC: one aligned 16-byte (fp32) or 8-byte (bf16) load of the whole quad.
template <typename T, bool VEC>
__device__ __forceinline__ typename Quad<T>::type load_quad(const T* p, int n) {
  if (VEC) return *reinterpret_cast<const typename Quad<T>::type*>(p);
  return load_quad_scalar(p, n);
}

__device__ __forceinline__ void fma4(float4& acc, const float4 w, float x) {
  acc.x += w.x * x;
  acc.y += w.y * x;
  acc.z += w.z * x;
  acc.w += w.w * x;
}

// Split cluster barrier: `relaxed` orders no memory, it only says that this
// CTA runs (so its shared memory may be written through DSMEM).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// VEC: V % 4 == 0 and W aligned, so quads and x take vector loads.
// RESIDENT: every row group's rows fit the registers, so there is no L2 path.
template <typename T, bool VEC, bool RESIDENT>
__global__ void __launch_bounds__(kColThreads, 2)
    neumann_cols_kernel(const T* __restrict__ W, long long w_bstride, const float* __restrict__ B,
                        float* __restrict__ X, int V, int R, int P, int hops, float tol) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* pairs = reinterpret_cast<float*>(smem);
  float* xb = reinterpret_cast<float*>(smem + kColsX);  // x[2][V]
  float4* red = reinterpret_cast<float4*>(smem + cols_red_offset(V));

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int n = blockIdx.x / C;
  const int c0 = rank * R, nc = max(0, min(V, c0 + R) - c0);
  // Thread (g, q) owns column quad q (columns c0 + 4q .. + 3) in row group g
  // (rows g P .. g P + P - 1): a warp's lanes read consecutive quads of a
  // row, so each load instruction reads whole rows of the column block, and
  // the group's x[j] sit side by side. Past kColThreads quads (G = 1) thread
  // q also takes quads q + QT, q + 2 QT, ..., from L2 when it sums them.
  const int Q = (R + 3) / 4, QT = min(Q, kColThreads), G = kColThreads / QT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = tid % QT, g = tid / QT;
  const int GU = min(G, (V + P - 1) / P);  // the groups that hold rows
  const bool active = g < GU && 4 * q < nc;
  const int ncols = min(4, nc - 4 * q);
  const int nrows = active && hops > 0 ? min(P, V - g * P) : 0;
  const T* wblk = W + (long long)n * w_bstride + c0;  // this CTA's column block
  const T* wq = wblk + (long long)g * P * V + 4 * q;
  const float* bg = B + (long long)n * V;

  // Resident, the block's one read from HBM: every load of a thread's rows
  // is in flight before the first is used, and the operands stay in
  // registers for every hop. Streamed, no rows are kept: the registers go
  // to L2 loads in flight instead.
  constexpr int kRegs = RESIDENT ? kColRegRows : 0;
  typename Quad<T>::type w[RESIDENT ? kColRegRows : 1];
#pragma unroll
  for (int r = 0; r < kRegs; ++r)
    if (r < nrows) w[r] = load_quad<T, VEC>(wq + (long long)r * V, ncols);
  for (int i = tid; i < V; i += kColThreads) xb[i] = bg[i];
  cluster_arrive_relaxed();  // waited for just before the first DSMEM write
  __syncthreads();           // x_0 = b is in place

  int cur = 0;
  for (int h = 0; h < hops; ++h) {
    const float* x = xb + cur * V;
    const float* xg = x + g * P;  // this group's rows of x
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (active) {  // hop 1 consumes the operands as they land
      if (VEC) {   // P and the group's rows come in whole quads: x by 16-byte loads
#pragma unroll
        for (int r = 0; r < kRegs; r += 4)
          if (r < nrows) {
            const float4 xr = *reinterpret_cast<const float4*>(xg + r);
            fma4(acc, quad_f32(w[r]), xr.x);
            fma4(acc, quad_f32(w[r + 1]), xr.y);
            fma4(acc, quad_f32(w[r + 2]), xr.z);
            fma4(acc, quad_f32(w[r + 3]), xr.w);
          }
      } else {
#pragma unroll
        for (int r = 0; r < kRegs; ++r)
          if (r < nrows) fma4(acc, quad_f32(w[r]), xg[r]);
      }
      if (!RESIDENT)
#pragma unroll kStreamUnroll
        for (int r = 0; r < nrows; ++r)  // from L2 on every hop
          fma4(acc, quad_f32(load_quad<T, VEC>(wq + (long long)r * V, ncols)), xg[r]);
      if (g > 0) red[(g - 1) * QT + q] = acc;
    }
    if (GU > 1) __syncthreads();
    if (h == 0) cluster_wait();  // every CTA of the cluster runs
    // Group 0's thread of each quad adds the other groups' partial sums and
    // b, writes the quad's x_new to every CTA and takes it into its part of
    // the residual pair.
    float* nxt = xb + (cur ^ 1) * V;
    float r = 0.f, s = 0.f;
    for (int qq = q; g == 0 && 4 * qq < nc; qq += QT) {
      const int col = 4 * qq, nq = min(4, nc - col);
      float4 sum = acc;
      if (RESIDENT || qq == q) {
#pragma unroll 2
        for (int k = 0; k < GU - 1; ++k) {
          const float4 p = red[k * QT + q];
          sum.x += p.x;
          sum.y += p.y;
          sum.z += p.z;
          sum.w += p.w;
        }
      } else {
        sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll kStreamUnroll
        for (int j = 0; j < V; ++j) fma4(sum, quad_f32(load_quad<T, VEC>(wblk + (long long)j * V + col, nq)), x[j]);
      }
      const float part[4] = {sum.x, sum.y, sum.z, sum.w};
      float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k < nq) {
          v[k] = bg[c0 + col + k] + part[k];
          r = nanmax(r, fabsf(v[k] - x[c0 + col + k]));
          s = nanmax(s, fabsf(v[k]));
        }
      for (int d = 0; d < C; ++d) {
        float* dst = cluster.map_shared_rank(nxt, d) + c0 + col;
        if (VEC) {
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (k < nq) dst[k] = v[k];
        }
      }
      if (RESIDENT) break;  // at most 256 quads: one a thread
    }
    for (int o = 16; o > 0; o >>= 1) {
      r = nanmax(r, __shfl_xor_sync(0xffffffffu, r, o));
      s = nanmax(s, __shfl_xor_sync(0xffffffffu, s, o));
    }
    float* slot = pairs + 2 * kMaxCluster * kColWarps * (h & 1);
    if (lane < C) {
      float* dst = cluster.map_shared_rank(slot, lane) + 2 * (rank * kColWarps + warp);
      dst[0] = r;
      dst[1] = s;
    }
    cluster.sync();  // x_new and every pair are in every CTA
    r = 0.f;
    s = 0.f;
    for (int k = lane; k < C * kColWarps; k += 32) {
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
  if (hops <= 0) cluster_wait();  // every arrive has its wait
  for (int i = tid; i < nc; i += kColThreads) X[(long long)n * V + c0 + i] = xb[cur * V + c0 + i];
}

// ---------------------------------------------------------------------------
// Launches on clusters of `cluster` CTAs in {1, 2, 4, 8}, n clusters.

template <typename... Params, typename... Args>
cudaError_t launch_on_clusters(void (*kernel)(Params...), int n, int cluster, int threads, size_t smem,
                               cudaStream_t stream, Args... args) {
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) return cudaErrorInvalidValue;
  if ((long long)n * cluster > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows(const T* w, long long w_bstride, const float* b, float* x, int n, int v,
                        int hops, float tol, int cluster, int resident, cudaStream_t stream) {
  if (cluster < 1) return cudaErrorInvalidValue;
  const int rows = (v + cluster - 1) / cluster;
  const size_t smem = rows_w_offset(v) + (resident ? (size_t)rows * v * sizeof(T) : 0);
  return launch_on_clusters(neumann_rows_kernel<T>, n, cluster, kRowWarps * 32, smem, stream, w, w_bstride, b,
                            x, v, rows, hops, tol, resident);
}

// The column split of kernels/neumann/ops.py `_cols_layout`: R = ceil(V / C)
// columns a CTA (rounded up to whole quads where V % 4 == 0), Q = ceil(R / 4)
// quads, G = kColThreads / min(Q, kColThreads) row groups of P = ceil(V / G)
// rows (whole quads where V % 4 == 0). `resident` must say what the layout
// gives: every row group's rows fit its registers.
template <typename T>
cudaError_t launch_cols(const T* w, long long w_bstride, const float* b, float* x, int n, int v,
                        int hops, float tol, int cluster, int resident, cudaStream_t stream) {
  if (cluster < 1 || v < 1) return cudaErrorInvalidValue;
  int cols = (v + cluster - 1) / cluster;
  if (v % 4 == 0) cols = (cols + 3) / 4 * 4;
  const int quads = (cols + 3) / 4, slots = min(quads, kColThreads), groups = kColThreads / slots;
  int rows = (v + groups - 1) / groups;
  if (v % 4 == 0) rows = (rows + 3) / 4 * 4;
  if ((rows <= kColRegRows) != (resident != 0)) return cudaErrorInvalidValue;
  const size_t smem = cols_smem(v, groups, slots);
  const bool vec = v % 4 == 0 && w_bstride % 4 == 0 && (uintptr_t)w % (4 * sizeof(T)) == 0;
  auto* kernel = vec ? (resident ? neumann_cols_kernel<T, true, true> : neumann_cols_kernel<T, true, false>)
                     : (resident ? neumann_cols_kernel<T, false, true> : neumann_cols_kernel<T, false, false>);
  return launch_on_clusters(kernel, n, cluster, kColThreads, smem, stream, w, w_bstride, b, x, v, cols, rows, hops,
                            tol);
}

template <typename T>
cudaError_t launch(const void* w, long long w_bstride, const float* b, float* x, int n, int v,
                   int hops, float tol, int cols, int cluster, int resident, cudaStream_t stream) {
  const T* wt = static_cast<const T*>(w);
  return cols ? launch_cols<T>(wt, w_bstride, b, x, n, v, hops, tol, cluster, resident, stream)
              : launch_rows<T>(wt, w_bstride, b, x, n, v, hops, tol, cluster, resident, stream);
}

}  // namespace

// w: n operators of v x v (row-major, batch stride w_bstride elements),
// float32 (bf16 == 0) or bfloat16 (bf16 == 1); b, x: [n, v] float32.
// cols != 0 applies M = W^T (neumann_cols), else M = W (neumann_rows); both
// run on clusters of `cluster` CTAs in {1, 2, 4, 8}. `resident` != 0: rows
// holds its row blocks in shared memory; cols' layout keeps every operand in
// registers (the launch refuses a flag its layout does not give). Returns the
// launch's CUDA error.
extern "C" int neumann_propagate(const void* w, long long w_bstride, const float* b, float* x,
                                 int n, int v, int hops, float tol, int cols, int bf16, int cluster,
                                 int resident, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(w, w_bstride, b, x, n, v, hops, tol, cols, cluster, resident, s)
           : launch<float>(w, w_bstride, b, x, n, v, hops, tol, cols, cluster, resident, s);
  return (int)err;
}
