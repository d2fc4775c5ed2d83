// The paper's sequential placement sweep (Eqs. 12-16, footnote 5) for
// Hopper (sm_90a): one launch a sweep.
//
// No Pallas kernel corresponds to it: the JAX package runs the sweep as a
// lax.scan over apps. Its plain PyTorch version (kernels/placement/ref.py)
// is a Python loop over apps and partitions that issues about 30 small
// operations a step, 9,600 a sweep at A = 128, P = 2, each far cheaper on
// the card than on the host that issues it. Here one CTA owns one lane (one
// network b) and walks its apps and partitions in order; each thread owns
// the nodes tid, tid + blockDim.x, ... (NPT of them), and keeps their load
// G and the load-independent terms of the compute marginal in registers.
//
// A step (app a, partition p) of the chain walk:
//   1. once an app: its own loads come off G at its old hosts,
//      G = G - load * onehot(h_old[p]) for p in order, on every node;
//   2. S_i = (L_p * dist[up, i] + w_p * cprime(G_i)) + L_{p+1} * dist[i, down]
//      with dist[up, :] a row and dist[:, down] a row of the transposed
//      copy, both coalesced;
//   3. a block argmin with torch.argmin's order (NaN first, then the smaller
//      value, ties to the smaller index), one barrier a step;
//   4. hysteresis: the candidate only where S[cand] < margin * S[h_old[p]];
//   5. the commit, G = G + load * onehot(h), and up = h.
// Phantom partitions (p >= parts) keep their host, skip the argmin and
// still commit a zero load and move `up`, as the plain path does. With
// `colocate` an app takes one decision for all its live partitions, scored
// with its summed weight and load and its final stage's rate.
//
// Exactness: the hosts are bitwise those of the plain path on the same
// tensors. Every torch operation of that path rounds once, in fp32, so
// every operation here is an explicit round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn) that nvcc never contracts
// into an FMA, in the plain path's order; the one-hot updates are the
// dense multiply-and-add, not a scatter, so NaN, infinity and signed zeros
// propagate as they do there. The load-independent terms (the clamped rate,
// the knee, the tail's slope and curvature, the summed weights and loads)
// come in computed by the same torch operations the plain path runs.
//
// What bounds it: latency. A sweep is A * P dependent steps (the row read
// at `up` needs the previous decision), each a dependent L2 read, the
// marginal's division, a 5-level shuffle reduction and a barrier; bytes
// are 2 * V * 4 a step. Lanes run side by side, one CTA each.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kMaxWarps = 32;

// torch.argmin's order on (value, index): a NaN precedes every number and
// the first NaN wins; otherwise the smaller value, equal values (0 and -0
// included) to the smaller index.
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  if (isnan(a)) return !isnan(b) || ia < ib;
  if (isnan(b)) return false;
  return a < b || (a == b && ia < ib);
}

template <int NPT>
__global__ void __launch_bounds__(1024) placement_sweep_kernel(
    const float* __restrict__ dist, const float* __restrict__ dist_t, const float* __restrict__ g0,
    const float* __restrict__ t_cap, const float* __restrict__ t_knee, const float* __restrict__ t_s,
    const float* __restrict__ t_c, const float* __restrict__ w_comp, const long long* __restrict__ hosts,
    const long long* __restrict__ src, const long long* __restrict__ dst, const long long* __restrict__ parts,
    const float* __restrict__ L, const float* __restrict__ w, const float* __restrict__ loads,
    const float* __restrict__ w_tot, const float* __restrict__ load_tot, const float* __restrict__ L_fin,
    long long* __restrict__ out, int A, int P, int V, int colocate, int linear, float margin) {
  __shared__ float red_v[2][kMaxWarps];
  __shared__ int red_i[2][kMaxWarps];
  __shared__ float prev_v[2];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int K = P + 1;
  const size_t bv = (size_t)b * V;
  const float* rows = dist + bv * V;     // rows[u * V + i] = dist[b, u, i]
  const float* cols = dist_t + bv * V;   // cols[t * V + i] = dist[b, i, t]

  // G and the marginal's terms of this thread's nodes. Under `linear` the
  // marginal w_comp * cprime does not depend on G and comes in as t_cap.
  float g[NPT], cap[NPT], knee[NPT], s[NPT], c[NPT];
#pragma unroll
  for (int k = 0; k < NPT; ++k) {
    const int i = tid + k * nt;
    const bool in = i < V;
    g[k] = in ? g0[bv + i] : 0.f;
    cap[k] = in ? t_cap[bv + i] : 0.f;
    knee[k] = in && !linear ? t_knee[bv + i] : 0.f;
    s[k] = in && !linear ? t_s[bv + i] : 0.f;
    c[k] = in && !linear ? t_c[bv + i] : 0.f;
  }
  const float wc = linear ? 1.f : w_comp[b];
  int buf = 0;

  // One decision: the block argmin of S and the hysteresis test against
  // S[h_prev]. Every thread returns the same host.
  auto decide = [&](const float* up_row, const float* dn_row, float Lu, float wp, float Ld, int h_prev) {
    float best_v = INFINITY;
    int best_i = INT_MAX;
#pragma unroll
    for (int k = 0; k < NPT; ++k) {
      const int i = tid + k * nt;
      if (i < V) {
        float m;
        if (linear) {
          m = cap[k];
        } else {
          // _mm1_prime: cap / (cap - load)^2 up to the knee, the quadratic
          // tail's s + c (load - knee) past it; then times w_comp.
          float mm;
          if (g[k] <= knee[k]) {
            const float d = __fsub_rn(cap[k], g[k]);
            mm = __fdiv_rn(cap[k], __fmul_rn(d, d));
          } else {
            mm = __fadd_rn(s[k], __fmul_rn(c[k], __fsub_rn(g[k], knee[k])));
          }
          m = __fmul_rn(wc, mm);
        }
        const float S = __fadd_rn(__fadd_rn(__fmul_rn(Lu, up_row[i]), __fmul_rn(wp, m)), __fmul_rn(Ld, dn_row[i]));
        if (i == h_prev) prev_v[buf] = S;
        if (before(S, i, best_v, best_i)) {
          best_v = S;
          best_i = i;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best_v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
      if (before(ov, oi, best_v, best_i)) {
        best_v = ov;
        best_i = oi;
      }
    }
    if (lane == 0) {
      red_v[buf][warp] = best_v;
      red_i[buf][warp] = best_i;
    }
    // The only barrier of a step. Its buffers alternate, so a warp that
    // runs ahead into the next step writes the other half.
    __syncthreads();
    best_v = red_v[buf][0];
    best_i = red_i[buf][0];
    for (int w2 = 1; w2 < nwarps; ++w2) {
      const float ov = red_v[buf][w2];
      const int oi = red_i[buf][w2];
      if (before(ov, oi, best_v, best_i)) {
        best_v = ov;
        best_i = oi;
      }
    }
    const float sp = prev_v[buf];
    buf ^= 1;
    return best_v < __fmul_rn(margin, sp) ? best_i : h_prev;
  };

  for (int a = 0; a < A; ++a) {
    const size_t ba = (size_t)b * A + a;
    const long long* h_old = hosts + ba * P;
    const float* ld = loads + ba * P;
    const int n_live = (int)parts[ba];
    // 1. The app's own loads come off G, partition by partition.
    for (int p = 0; p < P; ++p) {
      const float l = ld[p];
      const long long h = h_old[p];
#pragma unroll
      for (int k = 0; k < NPT; ++k) g[k] = __fsub_rn(g[k], __fmul_rn(l, tid + k * nt == h ? 1.f : 0.f));
    }
    const float* La = L + ba * K;

    if (colocate) {
      const int h = decide(rows + (size_t)src[ba] * V, cols + (size_t)dst[ba] * V, La[0], w_tot[ba],
                           L_fin[ba], (int)h_old[0]);
      if (tid == 0)
        for (int p = 0; p < P; ++p) out[ba * P + p] = p < n_live ? h : h_old[p];
      const float l = load_tot[ba];
#pragma unroll
      for (int k = 0; k < NPT; ++k) g[k] = __fadd_rn(g[k], __fmul_rn(l, tid + k * nt == h ? 1.f : 0.f));
      continue;
    }

    const float* wa = w + ba * P;
    long long up = src[ba];
    for (int p = 0; p < P; ++p) {
      const bool live = p < n_live;
      // The old downstream anchor: partition p+1's current host, or the
      // destination for the last live partition and the phantoms.
      const long long down = p + 1 < n_live ? h_old[p + 1] : dst[ba];
      int h = (int)h_old[p];
      if (live) h = decide(rows + (size_t)up * V, cols + (size_t)down * V, La[p], wa[p], La[p + 1], h);
      if (tid == 0) out[ba * P + p] = h;
      const float l = live ? ld[p] : 0.f;
#pragma unroll
      for (int k = 0; k < NPT; ++k) g[k] = __fadd_rn(g[k], __fmul_rn(l, tid + k * nt == h ? 1.f : 0.f));
      up = h;
    }
  }
}

}  // namespace

// One sequential sweep over `batch` lanes of V nodes, A apps and P
// partitions (K = P + 1 stage rates in L). float32 inputs: dist and its
// transpose dist_t [batch, V, V]; the load g0 and the marginal's terms
// t_cap, t_knee, t_s, t_c [batch, V] (under `linear` t_cap alone, the
// marginal itself); w_comp [batch]; L [batch, A, K]; w and loads
// [batch, A, P]; under `colocate` w_tot, load_tot and L_fin [batch, A].
// int64: hosts and out [batch, A, P]; src, dst, parts [batch, A].
// `threads` is a multiple of 32 up to 1024 with npt * threads >= V, npt in
// {1, 2, 4, 8}. Returns the launch's CUDA error code, or -1 for an npt
// without an instance.
extern "C" int placement_sweep(const float* dist, const float* dist_t, const float* g0, const float* t_cap,
                               const float* t_knee, const float* t_s, const float* t_c, const float* w_comp,
                               const long long* hosts, const long long* src, const long long* dst,
                               const long long* parts, const float* L, const float* w, const float* loads,
                               const float* w_tot, const float* load_tot, const float* L_fin, long long* out,
                               int batch, int A, int P, int V, int threads, int npt, int colocate, int linear,
                               float margin, void* stream) {
  using Kernel = decltype(&placement_sweep_kernel<1>);
  const Kernel kernel = npt == 1   ? &placement_sweep_kernel<1>
                        : npt == 2 ? &placement_sweep_kernel<2>
                        : npt == 4 ? &placement_sweep_kernel<4>
                        : npt == 8 ? &placement_sweep_kernel<8>
                                   : nullptr;
  if (kernel == nullptr) return -1;
  kernel<<<batch, threads, 0, static_cast<cudaStream_t>(stream)>>>(dist, dist_t, g0, t_cap, t_knee, t_s, t_c, w_comp,
                                                                   hosts, src, dst, parts, L, w, loads, w_tot,
                                                                   load_tot, L_fin, out, A, P, V, colocate, linear,
                                                                   margin);
  return (int)cudaGetLastError();
}
