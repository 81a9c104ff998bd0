// Device helpers shared by the partition-attention forward
// (partition_attn_fwd.cu) and backward (partition_attn_bwd.cu) kernels: the
// window geometry (which pixel holds token t of a window), the copy of one
// head's 32-wide slice of a window into shared memory, and bf16 access to it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace imt_pa {

typedef __nv_bfloat16 bf16;

constexpr int kD = 32;        // head width: one lane per channel
constexpr int kMaxT = 256;    // tokens per window: up to 8 key chunks of 32
constexpr int kLdw = 17;      // shared row stride in 32-bit words (34 bf16)
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;  // 227 KB per block on sm_90

// The map (B, H, W, *) cut into ph x pw windows; `grid` selects the dilated
// grid partition. Windows are numbered image by image, row-major over the
// wr x wc windows of an image.
struct Geometry {
  int H, W, C, nh, ph, pw, grid, wr, wc, T;
};

inline Geometry make_geometry(int H, int W, int C, int nh, int ph, int pw, int grid) {
  Geometry g;
  g.H = H; g.W = W; g.C = C; g.nh = nh; g.ph = ph; g.pw = pw; g.grid = grid;
  g.wr = H / ph; g.wc = W / pw; g.T = ph * pw;
  return g;
}

// Pixel index (b*H + row)*W + col of token t = a*pw + b of window `win`:
//   block: (i*ph + a, j*pw + b);
//   grid:  (a*(H/ph) + i, b*(W/pw) + j)  (grid_partition, window_attention.py:41-46).
__device__ __forceinline__ long long token_pixel(const Geometry& g, long long win, int t) {
  const int per_img = g.wr * g.wc;
  const long long n = win / per_img;
  const int r = static_cast<int>(win - n * per_img);
  const int i = r / g.wc, j = r - i * g.wc;
  const int a = t / g.pw, b = t - a * g.pw;
  const int row = g.grid ? a * g.wr + i : i * g.ph + a;
  const int col = g.grid ? b * g.wc + j : j * g.pw + b;
  return (n * g.H + row) * g.W + col;
}

// Copies the 32 channels at `coff` of every token of window `win` from
// `src` (`ld` bf16 per pixel) into `dst`: T rows of kLdw words, 16 bytes per
// step. The odd row stride puts both a row read by 32 lanes (lane = channel)
// and a column read by 32 lanes (lane = token) on distinct banks.
__device__ __forceinline__ void load_slice(const bf16* __restrict__ src, int ld, int coff,
                                           const Geometry& g, long long win, uint32_t* dst,
                                           int tid, int nthreads) {
  for (int e = tid; e < g.T * 4; e += nthreads) {
    const int t = e >> 2, s = e & 3;
    const uint4 u = *reinterpret_cast<const uint4*>(src + token_pixel(g, win, t) * ld + coff + s * 8);
    uint32_t* row = dst + t * kLdw + s * 4;
    row[0] = u.x;
    row[1] = u.y;
    row[2] = u.z;
    row[3] = u.w;
  }
}

// The two bf16 values of a shared word, as floats (exact).
__device__ __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Element c of row t of a shared slice.
__device__ __forceinline__ float elem(const uint32_t* m, int t, int c) {
  const uint32_t w = m[t * kLdw + (c >> 1)];
  return (c & 1) ? hi(w) : lo(w);
}

// A row of a shared slice into 32 registers (all lanes read the same words).
__device__ __forceinline__ void load_row(const uint32_t* m, int t, float* r) {
#pragma unroll
  for (int c2 = 0; c2 < kD / 2; ++c2) {
    const uint32_t w = m[t * kLdw + c2];
    r[2 * c2] = lo(w);
    r[2 * c2 + 1] = hi(w);
  }
}

// sum_c r[c] * row t of m[c]: one lane's dot product with its own token.
__device__ __forceinline__ float dot_row(const float* r, const uint32_t* m, int t) {
  float a = 0.f;
#pragma unroll
  for (int c2 = 0; c2 < kD / 2; ++c2) {
    const uint32_t w = m[t * kLdw + c2];
    a = fmaf(r[2 * c2], lo(w), a);
    a = fmaf(r[2 * c2 + 1], hi(w), a);
  }
  return a;
}

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16(x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Row i of softmax(q k^T + bias) for the warp: lane owns keys j = 32k + lane.
// r holds q_i; on return p[k] holds the probability rounded to bf16 (as a
// float), 0 past T. Scores and softmax in fp32 (_attend,
// partition_attention.py:107-115): exp(s - max) / sum.
template <int NJ>
__device__ __forceinline__ void softmax_row(const float* r, const uint32_t* Ks,
                                            const float* __restrict__ bias_row, int T, int lane,
                                            float* p) {
  float m = __int_as_float(0xff800000);  // -inf
#pragma unroll
  for (int k = 0; k < NJ; ++k) {
    const int j = k * 32 + lane;
    p[k] = m;
    if (j < T) {
      p[k] = dot_row(r, Ks, j) + bias_row[j];
      m = fmaxf(m, p[k]);
    }
  }
  m = warp_max(m);
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < NJ; ++k) {
    const int j = k * 32 + lane;
    p[k] = j < T ? expf(p[k] - m) : 0.f;
    sum += p[k];
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int k = 0; k < NJ; ++k) p[k] = round_bf16(p[k] / sum);
}

// sum_j x_j * m[j][lane] over the T keys, x_j held by lane j % 32 in x[j / 32].
template <int NJ>
__device__ __forceinline__ float mix_rows(const float* x, const uint32_t* m, int T, int lane) {
  float o = 0.f;
#pragma unroll
  for (int k = 0; k < NJ; ++k) {
    const int n = T - k * 32 < 32 ? T - k * 32 : 32;
    for (int src = 0; src < n; ++src) {
      const float xj = __shfl_sync(kFull, x[k], src);
      o = fmaf(xj, elem(m, k * 32 + src, lane), o);
    }
  }
  return o;
}

}  // namespace imt_pa
