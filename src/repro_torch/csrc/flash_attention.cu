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
// fp32 or bf16 inputs; softmax state and accumulators in fp32; the output
// in the input type. Only KV tiles that some row of the block can see are
// visited (kernel.py:70-78): the causal upper triangle, keys left of the
// window and KV padding are skipped, and each element is masked exactly.
//
// Layout: every tensor comes with its batch, head and sequence strides (the
// last dim must be contiguous), so the model hands over the transposed
// [B, S, H, D] -> [B, H, S, D] views of its projections with no copy, and
// the wrapper allocates the output in the query's layout.
//
// What bounds it on the H100: at the serve prefill shape (B=8, H=16,
// S=1024, D=64, bf16, causal) the call moves 67 MB (20 us at 3.35 TB/s)
// and does 17 GFLOP (17 us on the bf16 tensor cores), so a tensor-core
// kernel would be bound by bytes and operations about equally. This one is
// a simple CUDA-core design and is bound by its own shared-memory traffic
// and the fp32 FMA rate (67 TFLOP/s at best): one block of 8 warps takes 32
// query rows of one (b, h); each warp owns 4 rows; a block stages 32-key K
// and V tiles in shared memory as fp32 (rows padded to a pitch of
// 4 (mod 32) floats so the per-lane float4 reads of K are conflict-free);
// a lane scores one key against the warp's 4 rows, warp shuffles give each
// row's max and sum, and for p.V the lanes split the D output columns and
// read the 4 rows' probabilities as broadcast float4s from shared memory.
// Query blocks are issued heaviest (latest causal rows) first. wgmma/TMA
// are left for a later kernel. D <= 256; above 48 KB of shared memory
// (D > 64) the kernel opts in to more dynamic shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

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

}  // namespace

// q [B, H, Sq, D], k/v [B, KV, Sk, D], o [B, H, Sq, D], all of one type
// (bf16 when `bf16` is non-zero, else float32), each with the last dim
// contiguous; `strides` holds 12 element strides: (batch, head, sequence)
// of q, k, v and o in that order. `has_window` selects the sliding-window
// mask key > q - window. The caller checks B * H < 2^31, Sq < 65535 * 32,
// H % KV == 0 and 1 <= D <= 256. Returns the launch's CUDA error.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   const long long* strides, int B, int H, int KV, int Sq,
                                   int Sk, int D, int causal, int has_window, int window,
                                   int q_offset, float scale, int bf16, void* stream) {
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
  return bf16 ? dispatch<__nv_bfloat16>(p, s) : dispatch<float>(p, s);
}
