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
// edges are masked: the k loop stops at K, out-of-range rows and columns are
// never stored (no padding value ever enters a candidate).
//
// What bounds it on the H100: operations. M*N*K candidates of one add and
// one min each on the fp32 CUDA cores (there are no tensor cores for
// (min,+)); the inputs are read from device memory once per 64-wide tile.
// Design: 64 x 64 output tile per block, 16 x 16 threads with a 4 x 4
// register micro-tile each, A and B staged through shared memory in 16-deep
// k chunks (A transposed so both reads are broadcast or conflict-free).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;
constexpr int BK = 16;
constexpr int TM = 4, TN = 4;  // outputs per thread: rows ty + 16 r, cols tx + 16 c

template <bool ARG>
__global__ void minplus_kernel(const float* __restrict__ A, const float* __restrict__ B,
                               float* __restrict__ C, long long* __restrict__ I,
                               int M, int K, int N) {
  __shared__ float As[BK][TILE];  // As[k][i] = A[i0 + i, k0 + k]
  __shared__ float Bs[BK][TILE];  // Bs[k][j] = B[k0 + k, j0 + j]
  const long long z = blockIdx.z;
  A += z * M * K;
  B += z * K * N;
  C += z * M * N;
  if (ARG) I += z * M * N;
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
          if (ARG) {
            if (v < acc[r][c]) {
              acc[r][c] = v;
              idx[r][c] = k0 + kk;
            }
          } else {
            acc[r][c] = fminf(acc[r][c], v);
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
      if (ARG) I[(long long)i * N + j] = idx[r][c];
    }
  }
}

}  // namespace

// a: [batch, m, k], b: [batch, k, n], c: [batch, m, n], all float32 and
// contiguous; idx (int64 [batch, m, n]) selects the fused argmin variant when
// non-null. Returns the launch's CUDA error.
extern "C" int minplus_matmul(const float* a, const float* b, float* c, long long* idx,
                              int batch, int m, int k, int n, void* stream) {
  const dim3 block(16, 16);
  const dim3 grid((n + TILE - 1) / TILE, (m + TILE - 1) / TILE, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx)
    minplus_kernel<true><<<grid, block, 0, s>>>(a, b, c, idx, m, k, n);
  else
    minplus_kernel<false><<<grid, block, 0, s>>>(a, b, c, nullptr, m, k, n);
  return (int)cudaGetLastError();
}
