// The fp32 instances of the LN+MLP kernels: the forward (kernel 1,
// ln_mlp_fwd.cu) and the backward (kernel 2, ln_mlp_bwd.cu) on fp32 tokens,
// for fp32 models. The TPU kernels take an fp32 map as they take a bf16 one,
// with every cast to the operand type gone and fp32 products
// (ops/convnext_block.py:294-307, :372-453); so do these, with the stages of
// the bf16 pipelines:
//   forward:  (i) LN rows -> tok; (ii) pre1 = tok W1^T + b1 -> GELU -> hmid;
//             (iii) out = (hmid W2^T + b2) * gamma;
//   backward: (i) LN rows -> xhat, tok, dpre2 = g * gamma, 1/std;
//             (ii) pre1 and hmid again, g * (hmid W2^T + b2) for dgamma, and
//                  dpre1 = (dpre2 W2) * gelu'(pre1);
//             (iii) dln = dpre1 W1 and the LN backward rows -> dx;
//             (iv) dW1 = dpre1^T tok, dW2 = dpre2^T hmid, and the column sums
//                  db1, db2, dgamma, dln_s, dln_b.
// Every intermediate is an fp32 array in the caller's workspace.
//
// Design: a first version that is right, not fast. Each product is one
// generic tiled GEMM on the CUDA cores (fp32 FMA, as exact as the twin's fp32
// matmul with TF32 off): 64 x 64 output tiles, 16-deep k steps through shared
// memory, 4 x 4 outputs per thread, the epilogue a functor. The products
// whose reduction runs over the tokens (dW1, dW2) split it into a fixed number
// of token slices, and the slices' partials, like the column sums', are added
// in a fixed order: no atomics, the same bits on every run. Tensor cores (3xTF32
// or tf32 wgmma) are left for later work.
#pragma once

#include "ln_mlp_common.cuh"

namespace imt {
namespace f32 {

constexpr int kTile = 64;   // output tile edge
constexpr int kTk = 16;     // k step
constexpr int kGemmThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kRowThreads = 256;   // row kernels: one warp per token row
constexpr int kSliceTarget = 264;  // split-k: blocks per product, 2 per SM of 132

// A GEMM operand: A(m, k) = p[m * so + k * sk]; B(k, n) = p[n * so + k * sk]
// ("o" the output index, m or n).
struct Mat {
  const float* p;
  long long so, sk;
};

// One 64 x 16 tile of an operand into shared memory as T[k][o], o along the
// output index; rows o0.. past `rows` and k past ke are zero.
__device__ __forceinline__ void load_tile(const Mat& a, long long o0, long long rows, long long k0,
                                          long long ke, float (*T)[kTile + 4], int tid) {
  for (int e = tid; e < kTile * kTk; e += kGemmThreads) {
    // the loop's fast index runs along the operand's contiguous one
    const int o = a.so == 1 ? e % kTile : e / kTk;
    const int k = a.so == 1 ? e / kTile : e % kTk;
    const long long go = o0 + o, gk = k0 + k;
    T[k][o] = (go < rows && gk < ke) ? a.p[go * a.so + gk * a.sk] : 0.f;
  }
}

// C(m, n) = sum over k of A(m, k) B(k, n), handed to epi(m, n, value, slice)
// for the k range of slice blockIdx.z (kslice values each), in k order.
template <class Epi>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(Mat A, Mat B, long long M, int N, long long K, long long kslice, Epi epi) {
  __shared__ float As[kTk][kTile + 4];
  __shared__ float Bs[kTk][kTile + 4];
  const int tid = threadIdx.x;
  const int tm = tid / 16, tn = tid % 16;
  const long long m0 = static_cast<long long>(blockIdx.x) * kTile;
  const int n0 = blockIdx.y * kTile;
  const long long kb = static_cast<long long>(blockIdx.z) * kslice;
  const long long ke = kb + kslice < K ? kb + kslice : K;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (long long k0 = kb; k0 < ke; k0 += kTk) {
    load_tile(A, m0, M, k0, ke, As, tid);
    load_tile(B, n0, N, k0, ke, Bs, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTk; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][tm * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tn * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + tm * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn * 4 + j;
      if (n < N) epi(m, n, acc[i][j], blockIdx.z);
    }
  }
}

// Token slices of a product whose k runs over n tokens: enough blocks to
// fill the card, at least 256 tokens a slice. Depends on the shapes alone.
inline int k_slices(long long M, int N, long long K) {
  const long long tiles = ((M + kTile - 1) / kTile) * ((N + kTile - 1) / kTile);
  long long s = (kSliceTarget + tiles - 1) / tiles;
  const long long most = (K + 255) / 256;
  if (s > most) s = most;
  return static_cast<int>(s < 1 ? 1 : s);
}

inline long long slice_len(long long K, int slices) {
  const long long per = (K + slices - 1) / slices;
  return (per + kTk - 1) / kTk * kTk;
}

template <class Epi>
cudaError_t gemm(Mat A, Mat B, long long M, int N, long long K, int slices, Epi epi,
                 cudaStream_t st) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const long long mb = (M + kTile - 1) / kTile;
  if (mb > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(mb), (N + kTile - 1) / kTile, slices);
  gemm_kernel<Epi><<<grid, kGemmThreads, 0, st>>>(A, B, M, N, K, slice_len(K, slices), epi);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- epilogues

// out[slice][m][n] = v: the raw products, or a slice's partial of them
struct Store {
  float* out;
  long long ld, slice_stride;
  __device__ void operator()(long long m, int n, float v, int z) const {
    out[z * slice_stride + m * ld + n] = v;
  }
};

// hmid = GELU(v + b1); with `pre1` also keeps v + b1 (the backward's gelu')
template <bool FAST>
struct Hidden {
  const float* b1;
  float* hmid;
  float* pre1;
  int hidden;
  __device__ void operator()(long long m, int n, float v, int) const {
    const float p = v + b1[n];
    hmid[m * hidden + n] = gelu<FAST>(p);
    if (pre1) pre1[m * hidden + n] = p;
  }
};

// out = (v + b2) * gamma
struct Out {
  const float *b2, *gamma;
  float* out;
  int C;
  __device__ void operator()(long long m, int n, float v, int) const {
    out[m * C + n] = (v + b2[n]) * gamma[n];
  }
};

// g * pre2, pre2 = v + b2: the terms of dgamma
struct GammaTerms {
  const float *b2, *g;
  float* gp;
  int C;
  __device__ void operator()(long long m, int n, float v, int) const {
    gp[m * C + n] = g[m * C + n] * (v + b2[n]);
  }
};

// dpre1 = v * gelu'(pre1), v = (dpre2 W2)[m][n]
template <bool FAST>
struct Dpre1 {
  const float* pre1;
  float* dpre1;
  int hidden;
  __device__ void operator()(long long m, int n, float v, int) const {
    dpre1[m * hidden + n] = v * gelu_grad<FAST>(pre1[m * hidden + n]);
  }
};

// ---------------------------------------------------------------- row kernels

// fp32 LayerNorm statistics of a row, two-pass as the twin: (mean, 1/std).
__device__ __forceinline__ float2 row_stats(const float* __restrict__ h, int C, int lane,
                                            float eps) {
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += h[c];
  const float mu = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = h[c] - mu;
    v = fmaf(d, d, v);
  }
  return make_float2(mu, rsqrtf(warp_sum(v) / C + eps));
}

// forward (i): tok = LN(h) * ln_s + ln_b
__global__ void __launch_bounds__(kRowThreads)
ln_rows_kernel(const float* __restrict__ h, const float* __restrict__ ln_s,
               const float* __restrict__ ln_b, float* __restrict__ tok, long long n, int C,
               float eps) {
  const long long r = static_cast<long long>(blockIdx.x) * (kRowThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (r >= n) return;
  const float* x = h + r * C;
  const float2 st = row_stats(x, C, lane, eps);
  for (int c = lane; c < C; c += 32) tok[r * C + c] = (x[c] - st.x) * st.y * ln_s[c] + ln_b[c];
}

// backward (i): xhat, tok, dpre2 = g * gamma, and 1/std per row
__global__ void __launch_bounds__(kRowThreads)
bwd_rows_kernel(const float* __restrict__ h, const float* __restrict__ g,
                const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                const float* __restrict__ gamma, float* __restrict__ xhat,
                float* __restrict__ tok, float* __restrict__ dpre2, float* __restrict__ rstd,
                long long n, int C, float eps) {
  const long long r = static_cast<long long>(blockIdx.x) * (kRowThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (r >= n) return;
  const float* x = h + r * C;
  const float2 st = row_stats(x, C, lane, eps);
  for (int c = lane; c < C; c += 32) {
    const float xh = (x[c] - st.x) * st.y;
    xhat[r * C + c] = xh;
    tok[r * C + c] = xh * ln_s[c] + ln_b[c];
    dpre2[r * C + c] = g[r * C + c] * gamma[c];
  }
  if (lane == 0) rstd[r] = st.y;
}

// backward (iii): dx = rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)),
// dxhat = dln * ln_s
__global__ void __launch_bounds__(kRowThreads)
dx_rows_kernel(const float* __restrict__ dln, const float* __restrict__ xhat,
               const float* __restrict__ rstd, const float* __restrict__ ln_s,
               float* __restrict__ dx, long long n, int C) {
  const long long r = static_cast<long long>(blockIdx.x) * (kRowThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (r >= n) return;
  const float* d = dln + r * C;
  const float* xh = xhat + r * C;
  float m1 = 0.f, m2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float dh = d[c] * ln_s[c];
    m1 += dh;
    m2 = fmaf(dh, xh[c], m2);
  }
  m1 = warp_sum(m1) / C;
  m2 = warp_sum(m2) / C;
  const float rs = rstd[r];
  for (int c = lane; c < C; c += 32) dx[r * C + c] = rs * (d[c] * ln_s[c] - m1 - xh[c] * m2);
}

inline unsigned row_blocks(long long n) {
  return static_cast<unsigned>((n + kRowThreads / 32 - 1) / (kRowThreads / 32));
}

// ---------------------------------------------------------------- sums

constexpr int kSumSlices = 64;  // token slices of the column sums

// part[s][j] = sum over the rows of slice s, in order, of x[r][j] (* y[r][j])
__global__ void colsum_kernel(const float* __restrict__ x, const float* __restrict__ y,
                              long long n, int P, long long per, float* __restrict__ part) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= P) return;
  const long long r0 = blockIdx.y * per;
  const long long r1 = r0 + per < n ? r0 + per : n;
  float s = 0.f;
  for (long long r = r0; r < r1; ++r) s += y ? x[r * P + j] * y[r * P + j] : x[r * P + j];
  part[static_cast<long long>(blockIdx.y) * P + j] = s;
}

// out[e] = sum over s < slices, in order, of part[s][e]
__global__ void slices_sum_kernel(const float* __restrict__ part, long long size, int slices,
                                  float* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= size) return;
  float s = 0.f;
  for (int z = 0; z < slices; ++z) s += part[z * size + e];
  out[e] = s;
}

inline cudaError_t slices_sum(const float* part, long long size, int slices, float* out,
                              cudaStream_t st) {
  slices_sum_kernel<<<static_cast<unsigned>((size + 255) / 256), 256, 0, st>>>(part, size, slices,
                                                                              out);
  return cudaGetLastError();
}

// out[j] = sum over the n rows of x[r][j] (* y[r][j]), through `part`
// (kSumSlices * P floats)
inline cudaError_t colsum(const float* x, const float* y, long long n, int P, float* part,
                          float* out, cudaStream_t st) {
  const long long per = (n + kSumSlices - 1) / kSumSlices;
  colsum_kernel<<<dim3((P + 127) / 128, kSumSlices), 128, 0, st>>>(x, y, n, P, per, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return slices_sum(part, P, kSumSlices, out, st);
}

// ---------------------------------------------------------------- forward

// Workspace of the forward: tok (n, C) and hmid (n, hidden).
inline size_t fwd_workspace_bytes(long long n, int C, int hidden) {
  return align128(size_t(n) * C * 4) + align128(size_t(n) * hidden * 4);
}

// Stages [first, last) of the forward on fp32 h (n, C), w1 (hidden, C),
// w2 (C, hidden).
template <bool FAST>
cudaError_t forward(const float* h, const float* ln_s, const float* ln_b, const float* w1,
                    const float* b1, const float* w2, const float* b2, const float* gamma,
                    float* out, char* ws, long long n, int C, int hidden, float eps, int first,
                    int last, cudaStream_t st) {
  float* tok = reinterpret_cast<float*>(ws);
  float* hmid = reinterpret_cast<float*>(ws + align128(size_t(n) * C * 4));
  cudaError_t e = cudaSuccess;
  if (first <= 0 && last > 0) {
    ln_rows_kernel<<<row_blocks(n), kRowThreads, 0, st>>>(h, ln_s, ln_b, tok, n, C, eps);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (first <= 1 && last > 1) {
    e = gemm(Mat{tok, C, 1}, Mat{w1, C, 1}, n, hidden, C, 1,
             Hidden<FAST>{b1, hmid, nullptr, hidden}, st);
    if (e != cudaSuccess) return e;
  }
  if (first <= 2 && last > 2)
    e = gemm(Mat{hmid, hidden, 1}, Mat{w2, hidden, 1}, n, C, hidden, 1, Out{b2, gamma, out, C}, st);
  return e;
}

// ---------------------------------------------------------------- backward

// Workspace of the backward, part by part.
struct BwdPlan {
  int s1, s2;  // token slices of dW1 and dW2
  size_t xhat, tok, dpre2, gp, dln, rstd, pre1, hmid, dpre1, part, total;
};

inline BwdPlan bwd_plan(long long n, int C, int hidden) {
  BwdPlan p;
  p.s1 = k_slices(hidden, C, n);
  p.s2 = k_slices(C, hidden, n);
  const size_t nc = align128(size_t(n) * C * 4), nh = align128(size_t(n) * hidden * 4);
  size_t part = size_t(kSumSlices) * hidden * 4;
  const size_t wpart = size_t(p.s1 > p.s2 ? p.s1 : p.s2) * hidden * C * 4;
  if (wpart > part) part = wpart;
  p.xhat = 0;
  p.tok = p.xhat + nc;
  p.dpre2 = p.tok + nc;
  p.gp = p.dpre2 + nc;
  p.dln = p.gp + nc;
  p.rstd = p.dln + nc;
  p.pre1 = p.rstd + align128(size_t(n) * 4);
  p.hmid = p.pre1 + nh;
  p.dpre1 = p.hmid + nh;
  p.part = p.dpre1 + nh;
  p.total = p.part + align128(part);
  return p;
}

// Stages [first, last) of the backward on fp32 h and g (n, C): dx (n, C),
// dw1 (hidden, C), dw2 (C, hidden) and vecs = db1, db2, dgamma, dln_s, dln_b.
template <bool FAST>
cudaError_t backward(const float* h, const float* g, const float* ln_s, const float* ln_b,
                     const float* w1, const float* b1, const float* w2, const float* b2,
                     const float* gamma, float* dx, float* dw1, float* dw2, float* vecs, char* ws,
                     long long n, int C, int hidden, float eps, int first, int last,
                     cudaStream_t st) {
  const BwdPlan p = bwd_plan(n, C, hidden);
  float* xhat = reinterpret_cast<float*>(ws + p.xhat);
  float* tok = reinterpret_cast<float*>(ws + p.tok);
  float* dpre2 = reinterpret_cast<float*>(ws + p.dpre2);
  float* gp = reinterpret_cast<float*>(ws + p.gp);
  float* dln = reinterpret_cast<float*>(ws + p.dln);
  float* rstd = reinterpret_cast<float*>(ws + p.rstd);
  float* pre1 = reinterpret_cast<float*>(ws + p.pre1);
  float* hmid = reinterpret_cast<float*>(ws + p.hmid);
  float* dpre1 = reinterpret_cast<float*>(ws + p.dpre1);
  float* part = reinterpret_cast<float*>(ws + p.part);
  cudaError_t e = cudaSuccess;
  if (first <= 0 && last > 0) {
    bwd_rows_kernel<<<row_blocks(n), kRowThreads, 0, st>>>(h, g, ln_s, ln_b, gamma, xhat, tok,
                                                           dpre2, rstd, n, C, eps);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (first <= 1 && last > 1) {
    e = gemm(Mat{tok, C, 1}, Mat{w1, C, 1}, n, hidden, C, 1,
             Hidden<FAST>{b1, hmid, pre1, hidden}, st);
    if (e == cudaSuccess)
      e = gemm(Mat{hmid, hidden, 1}, Mat{w2, hidden, 1}, n, C, hidden, 1,
               GammaTerms{b2, g, gp, C}, st);
    // dhmid = dpre2 W2: B(k = c, n = j) = w2[c][j]
    if (e == cudaSuccess)
      e = gemm(Mat{dpre2, C, 1}, Mat{w2, 1, hidden}, n, hidden, C, 1,
               Dpre1<FAST>{pre1, dpre1, hidden}, st);
    if (e != cudaSuccess) return e;
  }
  if (first <= 2 && last > 2) {
    // dln = dpre1 W1: B(k = j, n = c) = w1[j][c]
    e = gemm(Mat{dpre1, hidden, 1}, Mat{w1, 1, C}, n, C, hidden, 1, Store{dln, C, 0}, st);
    if (e != cudaSuccess) return e;
    dx_rows_kernel<<<row_blocks(n), kRowThreads, 0, st>>>(dln, xhat, rstd, ln_s, dx, n, C);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (first <= 3 && last > 3) {
    const long long hc = static_cast<long long>(hidden) * C;
    // dW1 = dpre1^T tok: A(m = j, k = r) = dpre1[r][j], B(k = r, n = c) = tok[r][c]
    e = gemm(Mat{dpre1, 1, hidden}, Mat{tok, 1, C}, hidden, C, n, p.s1,
             Store{p.s1 > 1 ? part : dw1, C, hc}, st);
    if (e == cudaSuccess && p.s1 > 1) e = slices_sum(part, hc, p.s1, dw1, st);
    // dW2 = dpre2^T hmid: A(m = c, k = r) = dpre2[r][c], B(k = r, n = j) = hmid[r][j]
    if (e == cudaSuccess)
      e = gemm(Mat{dpre2, 1, C}, Mat{hmid, 1, hidden}, C, hidden, n, p.s2,
               Store{p.s2 > 1 ? part : dw2, hidden, hc}, st);
    if (e == cudaSuccess && p.s2 > 1) e = slices_sum(part, hc, p.s2, dw2, st);
    float* db1 = vecs;
    float* db2 = db1 + hidden;
    float* dgamma = db2 + C;
    float* dln_s = dgamma + C;
    float* dln_b = dln_s + C;
    if (e == cudaSuccess) e = colsum(dpre1, nullptr, n, hidden, part, db1, st);
    if (e == cudaSuccess) e = colsum(dpre2, nullptr, n, C, part, db2, st);
    if (e == cudaSuccess) e = colsum(gp, nullptr, n, C, part, dgamma, st);
    if (e == cudaSuccess) e = colsum(dln, xhat, n, C, part, dln_s, st);
    if (e == cudaSuccess) e = colsum(dln, nullptr, n, C, part, dln_b, st);
  }
  return e;
}

}  // namespace f32
}  // namespace imt
