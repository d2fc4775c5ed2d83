// Batched tropical (min,+) matrix product for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/minplus/kernel.py
// `_minplus_kernel` (:36, C[i,j] = min_k A[i,k] + B[k,j]) and
// `_minplus_argmin_kernel` (:61, the fused first-minimum argmin over k that
// gives the next-hop table). Under vmap the Pallas call gained a leading
// batch axis; here gridDim.z is that batch.
//
// Exactness: one fp32 add per candidate and an exact min, so the result is
// bitwise equal to the plain version (minplus_matmul_ref) in any order of k.
// The argmin variant keeps (value, index) per output and updates with strict
// `<` while each thread walks k in ascending order, so the FIRST minimising
// k wins, as torch.argmin / jnp.argmin on the full candidate tensor. Ragged
// edges never reach a stored output: out-of-range rows and columns are never
// stored, and a k past K is either skipped (argmin) or padded with +INF in
// both operands, a candidate that cannot win.
//
// What bounds it on the H100: instruction issue. M*N*K candidates of one
// FADD and one FMNMX each on the fp32 CUDA cores (there are no tensor cores
// for (min,+), and no fused add-min for fp32), at 4 x 32 thread-instructions
// a clock an SM: 33.5 T candidates' instructions a second over 132 SMs at
// 1.98 GHz, so B = 64, V = 256 takes at least 0.064 ms (0.128 ms for the
// argmin's four instructions a candidate). Every other instruction in the
// inner loop -- the shared-memory loads of the operands, address arithmetic,
// barriers -- takes an issue slot from the arithmetic.
//
// minplus (minplus_tile_kernel): 128 x 128 output tile per block of 256
// threads, an 8 x 8 register micro-tile a thread (rows 4ty..4ty+3 and
// 64+4ty.., columns 4tx.. and 64+4tx..), so each k step reads its 8 + 8
// operands with four 16-byte shared loads (LDS.128) for 128 FADD/FMNMX. A is
// stored k-major (transposed by 4-byte cp.async as it lands, rows padded to
// 132 floats so the writes are at most 2-way bank-conflicted), B row-major
// by 16-byte cp.async. Two stages of 16-deep k chunks: the next chunk lands
// during this one's arithmetic, with one barrier a chunk. At B = 64,
// V = 256 the 128 x 128 tile gives 256 blocks; at two blocks an SM (128
// registers, 33 KB of shared memory each) they fill 132 SMs in one wave
// (97% of the slots), where 64 x 128 tiles would give the same fill with
// twice the operand loads per output. On the H100 (chip_smoke.py phase 1)
// it runs at about 63% of the issue bound: FMNMX shares its pipe with the
// loop's integer address arithmetic, and ptxas reloads some operands with
// scalar LDS to stay within 128 registers. 8-deep chunks in a 3-stage ring
// spilled and ran slower, and 176 registers at one block an SM gained
// nothing.
//
// minplus_argmin (minplus_argmin_kernel): the first port's design: a
// 64 x 64 tile, 16 x 16 threads with a 4 x 4 micro-tile, A and B staged
// through shared memory in 16-deep k chunks by scalar loads.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// minplus: 128 x 128 tiles, 8 x 8 a thread, two cp.async stages of 16-deep k chunks.

constexpr int MT = 128, NT = 128;  // output tile
constexpr int KT = 16;             // k chunk a stage
constexpr int STAGES = 2;
constexpr int APAD = 4;  // As row pad: conflict-free transposed writes, 16-byte aligned rows
constexpr int kTileBlocksPerSM = 2;

struct Stage {
  float a[KT][MT + APAD];  // a[k][i] = A[i0 + i, k0 + k]
  float b[KT][NT];         // b[k][j] = B[k0 + k, j0 + j]
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue the copies of k chunk [k0, k0 + KT) into stage s; +INF past M, K or N.
// VEC: N % 4 == 0 and B 16-byte aligned, so a quad of B is wholly in or out.
template <bool VEC>
__device__ __forceinline__ void load_stage(Stage& s, const float* A, const float* B, int M, int K, int N,
                                           int i0, int j0, int k0, int tid) {
#pragma unroll
  for (int u = 0; u < MT * KT / 256; ++u) {  // KT consecutive k of one row per KT threads
    const int e = tid + 256 * u, row = e / KT, kk = e % KT;
    const int gi = i0 + row, gk = k0 + kk;
    if (gi < M && gk < K)
      cp_async4(&s.a[kk][row], A + (long long)gi * K + gk);
    else
      s.a[kk][row] = INFINITY;
  }
#pragma unroll
  for (int u = 0; u < KT * NT / 4 / 256; ++u) {  // quads of B: a row of 32 per warp
    const int e = tid + 256 * u, kk = e / (NT / 4), col = 4 * (e % (NT / 4));
    const int gk = k0 + kk, gj = j0 + col;
    float* dst = &s.b[kk][col];
    if (VEC) {
      if (gk < K && gj < N)
        cp_async16(dst, B + (long long)gk * N + gj);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (gk < K && gj + c < N)
          cp_async4(dst + c, B + (long long)gk * N + gj + c);
        else
          dst[c] = INFINITY;
      }
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(256, kTileBlocksPerSM)
    minplus_tile_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
                        int M, int K, int N) {
  __shared__ __align__(16) Stage st[STAGES];
  const long long z = blockIdx.z;
  A += z * M * K;
  B += z * K * N;
  C += z * M * N;
  const int i0 = blockIdx.y * MT, j0 = blockIdx.x * NT;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = INFINITY;

  const int nk = (K + KT - 1) / KT;
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < nk) load_stage<VEC>(st[p], A, B, M, K, N, i0, j0, p * KT, tid);
    cp_async_commit();  // possibly empty: keeps one group per chunk
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk kt have landed
    __syncthreads();              // everyone's have, and chunk kt - 1's stage is free
    const int next = kt + STAGES - 1;
    if (next < nk) load_stage<VEC>(st[next % STAGES], A, B, M, K, N, i0, j0, next * KT, tid);
    cp_async_commit();
    const Stage& s = st[kt % STAGES];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s.a[kk][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&s.a[kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&s.b[kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&s.b[kk][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fminf(acc[r][c], a[r] + b[c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + (r < 4 ? 4 * ty + r : 64 + 4 * ty + r - 4);
    if (i >= M) continue;
    float* row = C + (long long)i * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + 64 * h + 4 * tx;
      if (VEC) {
        if (j < N)
          *reinterpret_cast<float4*>(row + j) =
              make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2], acc[r][4 * h + 3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (j + c < N) row[j + c] = acc[r][4 * h + c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// minplus_argmin: 64 x 64 tiles, 4 x 4 a thread.

constexpr int TILE = 64;
constexpr int BK = 16;
constexpr int TM = 4, TN = 4;  // outputs per thread: rows ty + 16 r, cols tx + 16 c

__global__ void minplus_argmin_kernel(const float* __restrict__ A, const float* __restrict__ B,
                                      float* __restrict__ C, long long* __restrict__ I,
                                      int M, int K, int N) {
  __shared__ float As[BK][TILE];  // As[k][i] = A[i0 + i, k0 + k]
  __shared__ float Bs[BK][TILE];  // Bs[k][j] = B[k0 + k, j0 + j]
  const long long z = blockIdx.z;
  A += z * M * K;
  B += z * K * N;
  C += z * M * N;
  I += z * M * N;
  const int i0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * 16 + tx;

  float acc[TM][TN];
  long long idx[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      acc[r][c] = INFINITY;
      idx[r][c] = 0;
    }

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < TILE * BK; e += 256) {
      const int r = e / BK, c = e % BK;
      const int gi = i0 + r, gk = k0 + c;
      As[c][r] = (gi < M && gk < K) ? A[(long long)gi * K + gk] : INFINITY;
    }
    for (int e = tid; e < BK * TILE; e += 256) {
      const int r = e / TILE, c = e % TILE;
      const int gk = k0 + r, gj = j0 + c;
      Bs[r][c] = (gk < K && gj < N) ? B[(long long)gk * N + gj] : INFINITY;
    }
    __syncthreads();
    const int kmax = min(BK, K - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int r = 0; r < TM; ++r) a[r] = As[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < TN; ++c) b[c] = Bs[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) {
          const float v = a[r] + b[c];
          if (v < acc[r][c]) {
            acc[r][c] = v;
            idx[r][c] = k0 + kk;
          }
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= M) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int j = j0 + tx + 16 * c;
      if (j >= N) continue;
      C[(long long)i * N + j] = acc[r][c];
      I[(long long)i * N + j] = idx[r][c];
    }
  }
}

}  // namespace

// a: [batch, m, k], b: [batch, k, n], c: [batch, m, n], all float32 and
// contiguous; idx (int64 [batch, m, n]) selects the fused argmin kernel when
// non-null. Returns the launch's CUDA error.
extern "C" int minplus_matmul(const float* a, const float* b, float* c, long long* idx,
                              int batch, int m, int k, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx) {
    const dim3 grid((n + TILE - 1) / TILE, (m + TILE - 1) / TILE, batch);
    minplus_argmin_kernel<<<grid, dim3(16, 16), 0, s>>>(a, b, c, idx, m, k, n);
  } else {
    const dim3 grid((n + NT - 1) / NT, (m + MT - 1) / MT, batch);
    const bool vec = n % 4 == 0 && (uintptr_t)b % 16 == 0 && (uintptr_t)c % 16 == 0;
    if (vec)
      minplus_tile_kernel<true><<<grid, 256, 0, s>>>(a, b, c, m, k, n);
    else
      minplus_tile_kernel<false><<<grid, 256, 0, s>>>(a, b, c, m, k, n);
  }
  return (int)cudaGetLastError();
}
