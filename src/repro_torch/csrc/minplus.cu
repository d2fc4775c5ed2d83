// Batched tropical (min,+) matrix product for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/minplus/kernel.py
// `_minplus_kernel` (:36, C[i,j] = min_k A[i,k] + B[k,j]) and
// `_minplus_argmin_kernel` (:61, the fused first-minimum argmin over k that
// gives the next-hop table). Under vmap the Pallas call gained a leading
// batch axis; here it is folded into gridDim.z.
//
// Exactness: one fp32 add per candidate and an exact min, so the value is
// bitwise equal to the plain version (minplus_matmul_ref) in any order of k.
// The argmin returns the FIRST minimising k, as torch.argmin / jnp.argmin on
// the full candidate tensor (see minplus_argmin below for how). Ragged edges
// never reach a stored output: out-of-range rows and columns are never
// stored, and a k past the end is padded with +INF in both operands, a
// candidate that cannot win a strict `<`.
//
// What bounds it on the H100: instruction issue. M*N*K candidates of one
// FADD and one FMNMX each on the fp32 CUDA cores (there are no tensor cores
// for (min,+), and no fused add-min for fp32), at 4 x 32 thread-instructions
// a clock an SM: 33.5 T candidates' instructions a second over 132 SMs at
// 1.98 GHz, so B = 64, V = 256 takes at least 0.064 ms, the argmin too: its
// index costs no instruction a candidate in the design below. Every other
// instruction in the inner loop -- the shared-memory loads of the operands,
// address arithmetic, barriers -- takes an issue slot from the arithmetic.
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
// minplus_argmin (minplus_argmin_kernel): chunk minima, then one deferred
// search. The same cp.async ring and k-major A as minplus, on a 128 x 64
// tile with an 8 x 4 micro-tile a thread (rows as minplus, columns tx + 16c,
// so a warp's stores and search loads run along a row), because each output
// carries three things: its running minimum, the minimum of the current
// 4-deep chunk, and the chunk that set the running minimum.
//   1. Within a chunk only the value is computed: FADD and FMNMX a
//      candidate.
//   2. At the chunk's end, one strict update an output: if the chunk's
//      minimum is below the running one, it replaces it and the chunk's
//      number is kept (a byte of a packed word; a whole word where a split
//      has more than 256 chunks). Chunks are walked in ascending order, so
//      the kept chunk is the first that holds the final minimum. That is 3
//      instructions (FSETP, FSEL, PRMT) an output a chunk.
//   3. After the k loop each output re-reads its kept chunk's 4 values of
//      A's row (a 16-byte load where K % 4 == 0) and B's column from L2
//      and recomputes the same fp32 sums; the first k whose sum equals the
//      minimum is the index. That is exact: each candidate is one IEEE add
//      computed the same way both times. An all-+INF output keeps chunk 0
//      and so gets the split's first k.
// The chunk depth trades the two: the search reads 4 * KC bytes of B an
// output from L2, while each chunk costs 3 ALU instructions an output; at
// B = 64, V = 256 8- and 16-deep chunks lose more in the search than they
// save in the loop (scripts/minplus_argmin_designs.py times them). B lands
// by 16-byte cp.async where N % 4 == 0 (VEC), by 4-byte copies elsewhere.
// At B = 64, V = 256 the tile gives 512 blocks, two waves at two blocks an
// SM (116 registers). Where the tiles cannot fill the card (B = 1,
// V = 1024: 128 blocks) the wrapper splits K into S ranges of whole 16-deep
// stages (gridDim.z = S * batch, chosen from the shape alone in ops.py
// `_argmin_split`); each block writes its range's (minimum, first argmin)
// and minplus_argmin_combine_kernel merges the S partials in ascending
// split order with strict `<`, so the first minimum still wins.
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

template <int TM_, int TN_>
struct Stage {
  float a[KT][TM_ + APAD];  // a[k][i] = A[i0 + i, k0 + k]
  float b[KT][TN_];         // b[k][j] = B[k0 + k, j0 + j]
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

// Issue the copies of k chunk [k0, k0 + KT) of a TM_ x TN_ tile into stage
// s; +INF past M, N or `kend` (K, or the end of a split's k range; A's rows
// are K long). VEC: N % 4 == 0 and B 16-byte aligned, so a quad of B is
// wholly in or out.
template <int TM_, int TN_, bool VEC>
__device__ __forceinline__ void load_stage(Stage<TM_, TN_>& s, const float* A, const float* B, int M, int K,
                                           int N, int i0, int j0, int k0, int kend, int tid) {
#pragma unroll
  for (int u = 0; u < TM_ * KT / 256; ++u) {  // KT consecutive k of one row per KT threads
    const int e = tid + 256 * u, row = e / KT, kk = e % KT;
    const int gi = i0 + row, gk = k0 + kk;
    if (gi < M && gk < kend)
      cp_async4(&s.a[kk][row], A + (long long)gi * K + gk);
    else
      s.a[kk][row] = INFINITY;
  }
#pragma unroll
  for (int u = 0; u < KT * TN_ / 4 / 256; ++u) {  // quads of B: a row of TN_ / 4 per warp
    const int e = tid + 256 * u, kk = e / (TN_ / 4), col = 4 * (e % (TN_ / 4));
    const int gk = k0 + kk, gj = j0 + col;
    float* dst = &s.b[kk][col];
    if (VEC) {
      if (gk < kend && gj < N)
        cp_async16(dst, B + (long long)gk * N + gj);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (gk < kend && gj + c < N)
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
  __shared__ __align__(16) Stage<MT, NT> st[STAGES];
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
    if (p < nk) load_stage<MT, NT, VEC>(st[p], A, B, M, K, N, i0, j0, p * KT, K, tid);
    cp_async_commit();  // possibly empty: keeps one group per chunk
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk kt have landed
    __syncthreads();              // everyone's have, and chunk kt - 1's stage is free
    const int next = kt + STAGES - 1;
    if (next < nk) load_stage<MT, NT, VEC>(st[next % STAGES], A, B, M, K, N, i0, j0, next * KT, K, tid);
    cp_async_commit();
    const Stage<MT, NT>& s = st[kt % STAGES];
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
// minplus_argmin: 128 x 64 tiles, 8 x 4 a thread, 4-deep chunk minima and a deferred search.

constexpr int AMT = 128, ANT = 64;  // output tile
constexpr int KC = 4;               // k chunk of the minima and the kept chunk numbers
constexpr int kArgBlocksPerSM = 2;

// The chunk (of the block's k range) that set each output's running minimum.
template <bool WIDE>
struct ChunkIds;
template <>
struct ChunkIds<false> {  // a byte an output, the 4 columns of micro-tile row r in w[r]: <= 256 chunks
  uint32_t w[8];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int r = 0; r < 8; ++r) w[r] = 0;
  }
  __device__ __forceinline__ void set(int r, int c, uint32_t chunk) {  // byte c of w[r] = byte 0 of chunk
    w[r] = __byte_perm(w[r], chunk, c == 0 ? 0x3214 : c == 1 ? 0x3240 : c == 2 ? 0x3410 : 0x4210);
  }
  __device__ __forceinline__ int get(int r, int c) const { return (w[r] >> (8 * c)) & 0xff; }
};
template <>
struct ChunkIds<true> {  // a word an output
  uint32_t w[8][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) w[r][c] = 0;
  }
  __device__ __forceinline__ void set(int r, int c, uint32_t chunk) { w[r][c] = chunk; }
  __device__ __forceinline__ int get(int r, int c) const { return (int)w[r][c]; }
};

// Block (x, y, s * batch + z) reduces k in [s * ksplit, min(K, (s + 1) * ksplit))
// of batch z's tile and writes (minimum, first argmin) at C, I + blockIdx.z * M * N:
// the final outputs when gridDim.z == batch, else split s's partials. Thread
// (tx, ty) owns rows 4ty..4ty+3 and 64+4ty.. and columns tx + 16c, c < 4, so
// a warp's stores and search loads run along a row. VEC as in load_stage.
template <bool VEC, bool WIDE, typename IdxT>
__global__ void __launch_bounds__(256, WIDE ? 1 : kArgBlocksPerSM)
    minplus_argmin_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
                          IdxT* __restrict__ I, int batch, int M, int K, int N, int ksplit) {
  __shared__ __align__(16) Stage<AMT, ANT> st[STAGES];
  const int z = blockIdx.z % batch, kb = (blockIdx.z / batch) * ksplit;
  const int ke = min(K, kb + ksplit), nk = (ke - kb + KT - 1) / KT;
  A += (long long)z * M * K;
  B += (long long)z * K * N;
  C += (long long)blockIdx.z * M * N;
  I += (long long)blockIdx.z * M * N;
  const int i0 = blockIdx.y * AMT, j0 = blockIdx.x * ANT;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[8][4];
  ChunkIds<WIDE> id;
  id.zero();
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = INFINITY;

  load_stage<AMT, ANT, VEC>(st[0], A, B, M, K, N, i0, j0, kb, ke, tid);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<0>();  // this thread's copies of stage kt have landed
    __syncthreads();     // everyone's have, and stage kt - 1's buffer is free
    if (kt + 1 < nk) load_stage<AMT, ANT, VEC>(st[(kt + 1) % STAGES], A, B, M, K, N, i0, j0, kb + (kt + 1) * KT, ke, tid);
    cp_async_commit();
    const Stage<AMT, ANT>& s = st[kt % STAGES];
#pragma unroll
    for (int q = 0; q < KT / KC; ++q) {
      float cmin[8][4];
#pragma unroll
      for (int u = 0; u < KC; ++u) {
        const int kk = KC * q + u;
        const float4 a0 = *reinterpret_cast<const float4*>(&s.a[kk][4 * ty]);
        const float4 a1 = *reinterpret_cast<const float4*>(&s.a[kk][64 + 4 * ty]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[4] = {s.b[kk][tx], s.b[kk][tx + 16], s.b[kk][tx + 32], s.b[kk][tx + 48]};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) cmin[r][c] = u ? fminf(cmin[r][c], a[r] + b[c]) : a[r] + b[c];
      }
      const uint32_t chunk = kt * (KT / KC) + q;
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (cmin[r][c] < acc[r][c]) {  // strict: an equal later chunk keeps the earlier one
            acc[r][c] = cmin[r][c];
            id.set(r, c, chunk);
          }
    }
  }

  // The deferred search: the first k of the kept chunk whose sum equals the minimum.
  const bool avec = K % 4 == 0 && (uintptr_t)A % 16 == 0;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = i0 + (r < 4 ? 4 * ty + r : 64 + 4 * ty + r - 4);
    if (i >= M) continue;
    const float* arow = A + (long long)i * K;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      if (j >= N) continue;
      const int k0 = kb + KC * id.get(r, c);
      const bool full = k0 + KC <= ke;
      float av[KC], bv[KC];
      if (avec && full) {
#pragma unroll
        for (int q = 0; q < KC / 4; ++q) {
          const float4 t = *reinterpret_cast<const float4*>(arow + k0 + 4 * q);
          av[4 * q] = t.x, av[4 * q + 1] = t.y, av[4 * q + 2] = t.z, av[4 * q + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int u = 0; u < KC; ++u) av[u] = full || k0 + u < ke ? arow[k0 + u] : INFINITY;
      }
#pragma unroll
      for (int u = 0; u < KC; ++u) bv[u] = full || k0 + u < ke ? B[(long long)(k0 + u) * N + j] : INFINITY;
      int best = k0;
#pragma unroll
      for (int u = KC - 1; u >= 0; --u)
        if (av[u] + bv[u] == acc[r][c]) best = k0 + u;
      C[(long long)i * N + j] = acc[r][c];
      I[(long long)i * N + j] = (IdxT)best;
    }
  }
}

// Merge S splits' partials [S, total] in ascending split order with strict
// `<`: the earliest split holding the minimum keeps its first argmin.
__global__ void minplus_argmin_combine_kernel(const float* __restrict__ Cs, const int* __restrict__ Is,
                                              float* __restrict__ C, long long* __restrict__ I, long long total,
                                              int splits) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float best = Cs[e];
  int arg = Is[e];
  for (int s = 1; s < splits; ++s) {
    const float v = Cs[s * total + e];
    if (v < best) {
      best = v;
      arg = Is[s * total + e];
    }
  }
  C[e] = best;
  I[e] = arg;
}

template <typename IdxT>
void launch_argmin(bool vec, bool wide, dim3 grid, cudaStream_t s, const float* a, const float* b, float* c,
                   IdxT* idx, int batch, int m, int k, int n, int ksplit) {
  if (vec && wide)
    minplus_argmin_kernel<true, true, IdxT><<<grid, 256, 0, s>>>(a, b, c, idx, batch, m, k, n, ksplit);
  else if (vec)
    minplus_argmin_kernel<true, false, IdxT><<<grid, 256, 0, s>>>(a, b, c, idx, batch, m, k, n, ksplit);
  else if (wide)
    minplus_argmin_kernel<false, true, IdxT><<<grid, 256, 0, s>>>(a, b, c, idx, batch, m, k, n, ksplit);
  else
    minplus_argmin_kernel<false, false, IdxT><<<grid, 256, 0, s>>>(a, b, c, idx, batch, m, k, n, ksplit);
}

}  // namespace

// a: [batch, m, k], b: [batch, k, n], c: [batch, m, n], all float32 and
// contiguous. Returns the launch's CUDA error.
extern "C" int minplus_matmul(const float* a, const float* b, float* c, int batch, int m, int k, int n,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + NT - 1) / NT, (m + MT - 1) / MT, batch);
  const bool vec = n % 4 == 0 && (uintptr_t)b % 16 == 0 && (uintptr_t)c % 16 == 0;
  if (vec)
    minplus_tile_kernel<true><<<grid, 256, 0, s>>>(a, b, c, m, k, n);
  else
    minplus_tile_kernel<false><<<grid, 256, 0, s>>>(a, b, c, m, k, n);
  return (int)cudaGetLastError();
}

// (min_k, first argmin_k) of a[z, i, k] + b[z, k, j] into c (float32) and
// idx (int64), each [batch, m, n]. k is split into `splits` ranges of
// `ksplit` (a multiple of 16; every range non-empty); with splits > 1,
// part_c (float32) and part_idx (int32), each [splits, batch, m, n], hold
// the ranges' partials before the combine. `wide`: a split has more than 256
// chunks of 4. Returns the first CUDA error of the launches.
extern "C" int minplus_matmul_argmin(const float* a, const float* b, float* c, long long* idx, float* part_c,
                                     int* part_idx, int batch, int m, int k, int n, int splits, int ksplit,
                                     int wide, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + ANT - 1) / ANT, (m + AMT - 1) / AMT, batch * splits);
  const bool vec = n % 4 == 0 && (uintptr_t)b % 16 == 0;
  if (splits == 1) {
    launch_argmin(vec, wide, grid, s, a, b, c, idx, batch, m, k, n, ksplit);
    return (int)cudaGetLastError();
  }
  launch_argmin(vec, wide, grid, s, a, b, part_c, part_idx, batch, m, k, n, ksplit);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const long long total = (long long)batch * m * n;
  minplus_argmin_combine_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(part_c, part_idx, c, idx, total,
                                                                                 splits);
  return (int)cudaGetLastError();
}
