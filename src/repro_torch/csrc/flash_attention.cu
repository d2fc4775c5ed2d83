// Flash attention forward (streaming softmax) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// `_flash_kernel` (:39; wrapper `flash_attention_pallas` :120). It computes
// the same function: q [B, H, Sq, D] against k/v [B, Kv, Sk, D], kv head
// h / (H / Kv) (GQA by index arithmetic, no K/V replication), causal and
// sliding-window masks at absolute query positions q_offset + i,
// scale = 1/sqrt(D) applied after the q.k product, masked scores NEG = -1e30
// (not -inf), running max started at M_INIT = -1e29 and the output
// acc / max(l, 1e-30). A row that sees no key, whether its every tile is
// skipped or its every key is masked inside a live tile, therefore stays
// exactly 0: exp(NEG - M_INIT) underflows to 0 and never produces a NaN.
// Softmax state and accumulators are fp32; the output is in the input type.
// Only KV tiles that some row of the block can see are visited
// (kernel.py:70-78): the causal upper triangle, keys left of the window and
// KV padding are skipped, and each element is masked exactly. Query blocks
// are issued heaviest (latest causal rows) first. Every tensor comes with its
// batch, head and sequence strides (the last dim contiguous), so the model
// hands over the transposed [B, S, H, D] -> [B, H, S, D] views of its
// projections with no copy, and the output is written in the query's layout.
//
// Two kernels, chosen by the caller from the dtype and D alone
// (kernels/flash_attention/ops.py `_variant`):
//
// * `flash_wgmma_kernel`, bf16 with D % 16 == 0 and D <= 256: the tensor
//   cores. At the serve prefill shape (B=8, H=16, S=1024, D=64, causal) the
//   call moves 67 MB (20 us at 3.35 TB/s) and does 17 GFLOP of live scores
//   (17 us at 989 TFLOP/s bf16), so it is bound by bytes and operations about
//   equally. Design:
//   - A CTA takes one (b, h) and 128 query rows as two consumer warpgroups
//     of 64 rows (D <= 128), or 64 rows as one warpgroup (D = 192, 256: the
//     64 x 256 fp32 output accumulator is 128 registers a thread, and one
//     warpgroup plus the producer warp leaves 255 registers a thread, so no
//     `setmaxnreg` is needed). At D <= 64 two CTAs share an SM (64-key
//     tiles keep a thread at 96 registers), so one CTA's softmax overlaps
//     the other's wgmma and loads. Head dims are padded to 64-column slabs
//     in shared memory; TMA zero-fills the columns past D.
//   - One producer warp issues every load with TMA (`cp.async.bulk.tensor`,
//     4-d tensor maps built on the host from q/k/v's own strides, passed as
//     __grid_constant__ parameters): Q once, then K and V tiles of BK keys
//     (128 at D = 128, else 64) into a 2-stage ring, each stage with a
//     "full" mbarrier (TMA bytes) and an "empty" one (consumer arrivals).
//     TMA's 128-byte swizzle is the layout wgmma reads without bank
//     conflicts; keys past Sk arrive as zeros and are masked.
//   - S = Q K^T is `wgmma.mma_async.m64nBKk16.f32.bf16.bf16` with Q and K
//     K-major in shared memory. The online softmax runs on the fp32
//     accumulator fragments: each thread holds two rows, a row's max and sum
//     take two shuffles; masks are applied per element from each fragment's
//     (row, col), and only on tiles that cross a mask edge.
//   - O += P V is a second wgmma with A = P rounded to bf16 in registers
//     (the accumulator layout of S is the A-fragment layout of P) and B = the
//     V tile read MN-major through the transposed-operand descriptor, so V is
//     never transposed. P in bf16 is the one rounding point the plain
//     version does not have: <= 2^-9 relative per weight, inside the bf16
//     output's own rounding (chip_smoke.py phases 1 and 5 hold it).
//   - exp(x) is taken as exp2(x * log2(e)): one MUFU instruction.
//   What still holds it back (0.094 ms at the serve shape on an H100, 1.5x
//   PyTorch's SDPA and 4.7x the bound; chip_smoke.py phase 1): inside a
//   warpgroup one tile's softmax does not overlap the next tile's wgmma (no
//   intra-warpgroup pipelining or ping-pong schedule), the producer waits for
//   both consumers before it refills a stage, and the output is stored from
//   registers rather than by TMA.
//
// * `flash_kernel`, fp32 (tensor cores would mean TF32 and break the 1e-4
//   fp32 contract) and bf16 with D % 16 != 0: CUDA cores. It is bound by its
//   own shared-memory traffic and the fp32 FMA rate (67 TFLOP/s at best): one
//   block of 8 warps takes 32 query rows of one (b, h); each warp owns 4
//   rows; a block stages 32-key K and V tiles in shared memory as fp32 (rows
//   padded to a pitch of 4 (mod 32) floats so the per-lane float4 reads of K
//   are conflict-free); a lane scores one key against the warp's 4 rows, warp
//   shuffles give each row's max and sum, and for p.V the lanes split the D
//   output columns and read the 4 rows' probabilities as broadcast float4s
//   from shared memory. D <= 256; above 48 KB of shared memory (D > 64) the
//   kernel opts in to more dynamic shared memory.
#include <cuda.h>  // CUtensorMap and its enums only: the driver entry point is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// CUDA-core kernel (fp32, and bf16 with D % 16 != 0).

constexpr int WARPS = 8;
constexpr int ROWS = 4;           // query rows per warp
constexpr int BQ = WARPS * ROWS;  // query rows per block
constexpr int BK = 32;            // keys per tile: one per lane
constexpr float NEG = -1e30f;
constexpr float M_INIT = -1e29f;

struct Strides {
  long long b, h, s;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides sq, sk, sv, so;
  int B, H, KV, Sq, Sk, D;
  int causal, has_window, window, q_offset;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared memory: qs [BQ][DP], ks [BK][DP], vs [BK][DP] (fp32, zero beyond D
// and beyond the sequence), ps [WARPS][ROWS][BK] (each warp's probabilities).
template <int NC>
__host__ __device__ constexpr int pitch() { return 32 * NC + 4; }
template <int NC>
constexpr size_t smem_bytes() {
  return ((size_t)(BQ + 2 * BK) * pitch<NC>() + WARPS * ROWS * BK) * sizeof(float);
}

// NC = output columns per lane: D <= 32 * NC.
template <typename T, int NC>
__global__ void __launch_bounds__(WARPS * 32) flash_kernel(Params p) {
  constexpr int DP = pitch<NC>();
  constexpr int DW = 32 * NC;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + BQ * DP;
  float* vs = ks + BK * DP;
  float* ps = vs + BK * DP;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KV);
  const int row0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest causal blocks first
  const int nrows = min(BQ, p.Sq - row0);
  const int D = p.D;
  const T* Q = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* K = static_cast<const T*>(p.k) + b * p.sk.b + kvh * p.sk.h;
  const T* V = static_cast<const T*>(p.v) + b * p.sv.b + kvh * p.sv.h;
  T* O = static_cast<T*>(p.o) + b * p.so.b + h * p.so.h;

  for (int e = tid; e < BQ * DW; e += WARPS * 32) {
    const int r = e / DW, d = e % DW;
    qs[r * DP + d] = (r < nrows && d < D) ? to_f(Q[(long long)(row0 + r) * p.sq.s + d]) : 0.f;
  }

  // KV tiles some row of the block can see (kernel.py:70-78).
  const int q_lo = p.q_offset + row0, q_hi = q_lo + nrows - 1;
  int k_begin = 0, k_end = p.Sk;
  if (p.causal) k_end = min(k_end, q_hi + 1);
  if (p.has_window) k_begin = max(k_begin, q_lo - p.window + 1);
  const int t_begin = k_begin / BK;
  const int t_end = k_end > k_begin ? (k_end + BK - 1) / BK : t_begin;

  const int wrow = warp * ROWS;       // the warp's first row in the block
  const int wq_lo = q_lo + wrow;      // its absolute query position
  const int wq_hi = wq_lo + ROWS - 1;
  float m[ROWS], l[ROWS], acc[ROWS][NC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = M_INIT;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }
  float* pw = ps + warp * ROWS * BK;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile is consumed (and qs is staged)
    for (int e = tid; e < BK * DW; e += WARPS * 32) {
      const int r = e / DW, d = e % DW;
      const int key = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (key < p.Sk && d < D) {
        kx = to_f(K[(long long)key * p.sk.s + d]);
        vx = to_f(V[(long long)key * p.sv.s + d]);
      }
      ks[r * DP + d] = kx;
      vs[r * DP + d] = vx;
    }
    __syncthreads();
    // Warps whose rows all lie past Sq, or see none of this tile, sit out.
    bool live = wrow < nrows;
    if (p.causal) live = live && k0 <= wq_hi;
    if (p.has_window) live = live && k0 + BK - 1 > wq_lo - p.window;
    if (!live) continue;

    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(ks + lane * DP);
#pragma unroll 4
    for (int d4 = 0; d4 < DW / 4; ++d4) {
      const float4 kv = krow[d4];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qv = reinterpret_cast<const float4*>(qs + (wrow + r) * DP)[d4];
        s[r] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
      }
    }

    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qpos = wq_lo + r;
      bool ok = key < p.Sk;
      if (p.causal) ok = ok && key <= qpos;
      if (p.has_window) ok = ok && key > qpos - p.window;
      const float sc = ok ? s[r] * p.scale : NEG;
      float mt = sc;
#pragma unroll
      for (int off = 16; off; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[r], mt);
      const float corr = expf(m[r] - m_new);
      const float pr = expf(sc - m_new);
      float ls = pr;
#pragma unroll
      for (int off = 16; off; off >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, off);
      l[r] = l[r] * corr + ls;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
      pw[r * BK + lane] = pr;
    }
    __syncwarp();
#pragma unroll 2
    for (int j4 = 0; j4 < BK / 4; ++j4) {
      float4 p4[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) p4[r] = reinterpret_cast<const float4*>(pw + r * BK)[j4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = vs + (j4 * 4 + jj) * DP + lane;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float vv = vrow[32 * c];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const float pj = jj == 0 ? p4[r].x : jj == 1 ? p4[r].y : jj == 2 ? p4[r].z : p4[r].w;
            acc[r][c] += pj * vv;
          }
        }
      }
    }
    __syncwarp();  // pw is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = wrow + r;
    if (row >= nrows) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = O + (long long)(row0 + row) * p.so.s;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) orow[d] = from_f<T>(acc[r][c] / denom);
    }
  }
}

template <typename T, int NC>
int launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<NC>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(p.B * p.H, (p.Sq + BQ - 1) / BQ);
  flash_kernel<T, NC><<<grid, WARPS * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, cudaStream_t stream) {
  if (p.D <= 32) return launch<T, 1>(p, stream);
  if (p.D <= 64) return launch<T, 2>(p, stream);
  if (p.D <= 128) return launch<T, 4>(p, stream);
  if (p.D <= 256) return launch<T, 8>(p, stream);
  return (int)cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16, D % 16 == 0, D <= 256).
namespace wg {

constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;  // exp(x) = exp2(x * log2(e)), one MUFU op

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits until the barrier's phase of the given parity has completed. A copy
// that never lands traps (a launch error) after ~2^30 polls instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1u << 30)) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor for the 128-byte swizzle (offsets in
// bytes; the tile base is 1024-byte aligned, so the base offset field is 0).
__device__ __forceinline__ uint64_t sdesc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// The compiler does not know that wgmma is asynchronous: these empty asm
// statements pin the accumulator and A-fragment registers until the wait.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int accumulate);
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db);

// S (+)= A B^T: A [64 x 16] and B [64 x 16], both K-major in shared memory.
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// S (+)= A B^T: A [64 x 16] and B [128 x 16], both K-major in shared memory.
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O += P V: P [64 x 16] bf16 in registers, V [16 x 64] MN-major in shared memory.
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// O += P V: P [64 x 16] bf16 in registers, V [16 x 128] MN-major in shared memory.
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// O += P V: P [64 x 16] bf16 in registers, V [16 x 192] MN-major in shared memory.
template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, "
      " %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// O += P V: P [64 x 16] bf16 in registers, V [16 x 256] MN-major in shared memory.
template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, "
      " %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103, "
      " %104, %105, %106, %107, %108, %109, %110, %111, "
      " %112, %113, %114, %115, %116, %117, %118, %119, "
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <int DP>  // head dim padded to a multiple of 64
struct Cfg {
  static constexpr int NWG = DP <= 128 ? 2 : 1;  // consumer warpgroups, 64 query rows each
  static constexpr int BQ = 64 * NWG;
  // Keys per K/V tile: 64 for D <= 64 (two CTAs then share an SM: 96
  // registers a thread), 128 up to D = 128, 64 above (register room).
  static constexpr int BK = DP == 128 ? 128 : 64;
  static constexpr int MIN_CTAS = DP <= 64 ? 2 : 1;  // CTAs an SM, for __launch_bounds__
  static constexpr int STAGES = 2;
  static constexpr int SLABS = DP / 64;  // 64-column (128-byte) slabs of the head dim
  static constexpr int Q_SLAB = 64 * 128;
  static constexpr int KV_SLAB = BK * 128;
  static constexpr int Q_BYTES = NWG * SLABS * Q_SLAB;
  static constexpr int KV_BYTES = SLABS * KV_SLAB;  // one K or one V tile
  static constexpr int BAR_OFF = Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (2 * STAGES + 1);  // + alignment slack
  static constexpr int THREADS = 128 * NWG + 32;                      // + the producer warp
};

// Where the sequence, head and batch coordinates sit (1..3) in a tensor map.
struct Order {
  int s, h, b;
};

struct Params {
  void* o;
  Strides so;
  int H, KV, Sq, Sk, D;
  int causal, has_window, window, q_offset;
  float scale;
  Order oq, ok, ov;
};

__device__ __forceinline__ void place(Order od, int s, int h, int b, int& c1, int& c2, int& c3) {
  c1 = od.s == 1 ? s : od.h == 1 ? h : b;
  c2 = od.s == 2 ? s : od.h == 2 ? h : b;
  c3 = od.s == 3 ? s : od.h == 3 ? h : b;
}

template <int DP>
__global__ void __launch_bounds__(Cfg<DP>::THREADS, Cfg<DP>::MIN_CTAS)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, const Params p) {
  using C = Cfg<DP>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, kv_s = base + C::Q_BYTES, bars = base + C::BAR_OFF;
  const uint32_t qbar = bars + 16 * C::STAGES;
  // bars: full[STAGES] (TMA bytes landed), empty[STAGES] (consumers done), qbar.

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KV);
  const int row0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;  // heaviest causal blocks first
  const int nrows = min(C::BQ, p.Sq - row0);

  // KV tiles some row of the block can see (kernel.py:70-78).
  const int q_lo = p.q_offset + row0, q_hi = q_lo + nrows - 1;
  int k_begin = 0, k_end = p.Sk;
  if (p.causal) k_end = min(k_end, q_hi + 1);
  if (p.has_window) k_begin = max(k_begin, q_lo - p.window + 1);
  const int t_begin = k_begin / C::BK;
  const int t_end = k_end > k_begin ? (k_end + C::BK - 1) / C::BK : t_begin;

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (C::STAGES + s), 128 * C::NWG);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * C::NWG) {  // the producer warp: one thread issues every load
    if (lane == 0) {
      int c1, c2, c3;
      mbar_expect_tx(qbar, C::Q_BYTES);
      for (int g = 0; g < C::NWG; ++g) {
        place(p.oq, row0 + 64 * g, h, b, c1, c2, c3);
        for (int s = 0; s < C::SLABS; ++s)
          tma_load_4d(q_s + (g * C::SLABS + s) * C::Q_SLAB, &qmap, qbar, 64 * s, c1, c2, c3);
      }
      for (int t = t_begin, it = 0; t < t_end; ++t, ++it) {
        const int st = it % C::STAGES;
        const uint32_t ph = (it / C::STAGES) & 1;
        const uint32_t full = bars + 8 * st;
        mbar_wait(bars + 8 * (C::STAGES + st), ph ^ 1);  // the first round passes at once
        mbar_expect_tx(full, 2 * C::KV_BYTES);
        const uint32_t kt = kv_s + 2 * st * C::KV_BYTES, vt = kt + C::KV_BYTES;
        for (int s = 0; s < C::SLABS; ++s) {
          place(p.ok, t * C::BK, kvh, b, c1, c2, c3);
          tma_load_4d(kt + s * C::KV_SLAB, &kmap, full, 64 * s, c1, c2, c3);
          place(p.ov, t * C::BK, kvh, b, c1, c2, c3);
          tma_load_4d(vt + s * C::KV_SLAB, &vmap, full, 64 * s, c1, c2, c3);
        }
      }
    }
    return;
  }

  // Consumer warpgroup g. Accumulator fragment i of a thread sits at row
  // r0 + 8 * ((i >> 1) & 1) and column 8 * (i >> 2) + cq + (i & 1).
  const int g = warp >> 2;
  const int r0 = 16 * (warp & 3) + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const int g_row0 = row0 + 64 * g;
  const int g_rows = min(64, p.Sq - g_row0);  // may be <= 0: the warpgroup only keeps pace
  const int gq_lo = p.q_offset + g_row0, gq_hi = gq_lo + 63;
  const int qp0 = gq_lo + r0, qp1 = qp0 + 8;
  const uint32_t q_g = q_s + g * C::SLABS * C::Q_SLAB;

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m0 = M_INIT, m1 = M_INIT, l0 = 0.f, l1 = 0.f;  // l: this thread's part of the row sum
  mbar_wait(qbar, 0);

  for (int t = t_begin, it = 0; t < t_end; ++t, ++it) {
    const int st = it % C::STAGES;
    mbar_wait(bars + 8 * st, (it / C::STAGES) & 1);
    const int k0 = t * C::BK;
    bool live = g_rows > 0;
    if (p.causal) live = live && k0 <= gq_hi;
    if (p.has_window) live = live && k0 + C::BK - 1 > gq_lo - p.window;
    if (live) {
      const uint32_t kt = kv_s + 2 * st * C::KV_BYTES, vt = kt + C::KV_BYTES;
      float s[C::BK / 2];
#pragma unroll
      for (int i = 0; i < C::BK / 2; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {  // 16 head-dim columns a step, 4 steps a slab
        const uint32_t off = (kk & 3) * 32;  // a 32-byte step inside the swizzled row
        wgmma_ss<C::BK>(s, sdesc(q_g + (kk >> 2) * C::Q_SLAB + off, 16, 1024),
                        sdesc(kt + (kk >> 2) * C::KV_SLAB + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      keep(s);

      // Scale, then mask where the tile crosses a mask edge.
      const bool inside = k0 + C::BK <= p.Sk && (!p.causal || k0 + C::BK - 1 <= gq_lo) &&
                          (!p.has_window || k0 > gq_hi - p.window);
#pragma unroll
      for (int i = 0; i < C::BK / 2; ++i) {
        float x = s[i] * p.scale;
        if (!inside) {
          const int key = k0 + 8 * (i >> 2) + cq + (i & 1);
          const int qp = (i & 2) ? qp1 : qp0;
          bool ok = key < p.Sk;
          if (p.causal) ok = ok && key <= qp;
          if (p.has_window) ok = ok && key > qp - p.window;
          x = ok ? x : NEG;
        }
        s[i] = x;
      }
      float mx0 = NEG, mx1 = NEG;
#pragma unroll
      for (int i = 0; i < C::BK / 2; ++i) {
        if (i & 2) mx1 = fmaxf(mx1, s[i]);
        else mx0 = fmaxf(mx0, s[i]);
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {  // the 4 threads that share a row
        mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = exp2f((m0 - mn0) * LOG2E), c1 = exp2f((m1 - mn1) * LOG2E);
      m0 = mn0;
      m1 = mn1;
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int i = 0; i < C::BK / 2; ++i) {
        const float e = exp2f((s[i] - ((i & 2) ? mn1 : mn0)) * LOG2E);
        s[i] = e;
        if (i & 2) ls1 += e;
        else ls0 += e;
      }
      l0 = l0 * c0 + ls0;
      l1 = l1 * c1 + ls1;
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= (i & 2) ? c1 : c0;

      uint32_t pa[C::BK / 4];  // P in bf16: 4 A-fragment registers for each of BK / 16 steps
#pragma unroll
      for (int j = 0; j < C::BK / 4; ++j) pa[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::BK / 16; ++kk)  // 16 keys a step: two 8-key swizzle rows
        wgmma_rs<DP>(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                     sdesc(vt + kk * 2048, C::KV_SLAB, 1024));
      wgmma_commit();
      wgmma_wait0();
      keep(o);
      keep(pa);
    }
    mbar_arrive(bars + 8 * (C::STAGES + st));
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(FULL, l0, off);
    l1 += __shfl_xor_sync(FULL, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(p.o) + b * p.so.b + h * p.so.h;
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int r = (i & 2) ? r0 + 8 : r0;
    const int col = 8 * (i >> 2) + cq;
    if (r < g_rows && col < p.D) {
      const float d = (i & 2) ? d1 : d0;
      *reinterpret_cast<__nv_bfloat162*>(O + (long long)(g_row0 + r) * p.so.s + col) =
          __floats2bfloat162_rn(o[i] / d, o[i + 1] / d);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library needs no -lcuda.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-d bf16 tensor map {D, and the sequence, head and batch dims in
// increasing stride}, box {64 columns, `rows` of the sequence}. A dim of
// extent 1 only ever sees coordinate 0, so it takes a stride past the others.
int make_map(CUtensorMap* map, Order* od, const void* ptr, Strides st, int nb, int nh, int ns,
             int d, int rows) {
  const EncodeTiled enc = encode_fn();
  if (!enc) return (int)cudaErrorNotSupported;
  struct Dim {
    long long n, stride;
    int role;  // 0 sequence, 1 head, 2 batch
  } dims[3] = {{ns, st.s, 0}, {nh, st.h, 1}, {nb, st.b, 2}};
  long long span = 8;
  for (const Dim& x : dims)
    if (x.n > 1) span = span > x.n * x.stride ? span : x.n * x.stride;
  for (Dim& x : dims)
    if (x.n == 1) x.stride = (span + 7) / 8 * 8;
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && dims[j].stride < dims[j - 1].stride; --j) {
      const Dim tmp = dims[j];
      dims[j] = dims[j - 1];
      dims[j - 1] = tmp;
    }
  cuuint64_t gdim[4] = {(cuuint64_t)d, (cuuint64_t)dims[0].n, (cuuint64_t)dims[1].n,
                        (cuuint64_t)dims[2].n};
  cuuint64_t gstride[3];
  cuuint32_t box[4] = {64, 1, 1, 1}, estride[4] = {1, 1, 1, 1};
  int pos[3];
  for (int i = 0; i < 3; ++i) {
    gstride[i] = (cuuint64_t)dims[i].stride * 2;
    pos[dims[i].role] = i + 1;
    if (dims[i].role == 0) box[i + 1] = rows;
  }
  *od = Order{pos[0], pos[1], pos[2]};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), gdim,
                         gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int DP>
int launch(const ::Params& a, cudaStream_t stream) {
  using C = Cfg<DP>;
  CUtensorMap qm, km, vm;
  Params p;
  int e;
  if ((e = make_map(&qm, &p.oq, a.q, a.sq, a.B, a.H, a.Sq, a.D, 64))) return e;
  if ((e = make_map(&km, &p.ok, a.k, a.sk, a.B, a.KV, a.Sk, a.D, C::BK))) return e;
  if ((e = make_map(&vm, &p.ov, a.v, a.sv, a.B, a.KV, a.Sk, a.D, C::BK))) return e;
  p.o = a.o;
  p.so = a.so;
  p.H = a.H;
  p.KV = a.KV;
  p.Sq = a.Sq;
  p.Sk = a.Sk;
  p.D = a.D;
  p.causal = a.causal;
  p.has_window = a.has_window;
  p.window = a.window;
  p.q_offset = a.q_offset;
  p.scale = a.scale;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.B * a.H, (a.Sq + C::BQ - 1) / C::BQ);
  flash_wgmma_kernel<DP><<<grid, C::THREADS, C::SMEM, stream>>>(qm, km, vm, p);
  return (int)cudaGetLastError();
}

}  // namespace wg
}  // namespace

// q [B, H, Sq, D], k/v [B, KV, Sk, D], o [B, H, Sq, D], all of one type
// (bf16 when `bf16` is non-zero, else float32), each with the last dim
// contiguous; `strides` holds 12 element strides: (batch, head, sequence)
// of q, k, v and o in that order. `has_window` selects the sliding-window
// mask key > q - window. `wgmma` selects the tensor-core kernel, which takes
// bf16 with D % 16 == 0 only, 16-byte aligned pointers and strides that are
// multiples of 8 elements (the caller checks). The caller checks
// B * H < 2^31, Sq < 65535 * 32, H % KV == 0 and 1 <= D <= 256. Returns the
// launch's CUDA error.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   const long long* strides, int B, int H, int KV, int Sq,
                                   int Sk, int D, int causal, int has_window, int window,
                                   int q_offset, float scale, int bf16, int wgmma, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  Strides* st[4] = {&p.sq, &p.sk, &p.sv, &p.so};
  for (int i = 0; i < 4; ++i) *st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  p.B = B;
  p.H = H;
  p.KV = KV;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  p.causal = causal;
  p.has_window = has_window;
  p.window = window;
  p.q_offset = q_offset;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wgmma) {
    if (!bf16 || D % 16 != 0 || D > 256) return (int)cudaErrorInvalidValue;
    switch ((D + 63) / 64) {
      case 1: return wg::launch<64>(p, s);
      case 2: return wg::launch<128>(p, s);
      case 3: return wg::launch<192>(p, s);
      default: return wg::launch<256>(p, s);
    }
  }
  return bf16 ? dispatch<__nv_bfloat16>(p, s) : dispatch<float>(p, s);
}
