// Device helpers shared by the partition-attention forward
// (partition_attn_fwd.cu) and backward (partition_attn_bwd.cu) kernels: the
// window geometry (which pixel holds token t of a window), the copy of one
// head's 32-wide slice of a window into shared memory, and access to it for
// both operand types: bf16 (the kernels' bf16 instances) and fp32 (their fp32
// instances, for fp32 models, with no rounding between the steps).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace imt_pa {

typedef __nv_bfloat16 bf16;

constexpr int kD = 32;        // head width: one lane per channel
constexpr int kMaxT = 256;    // tokens per window: up to 8 key chunks of 32
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

// The two bf16 values of a shared word, as floats (exact).
__device__ __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16(x)); }

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

// How a shared slice holds its rows of operand type E: bf16 two values to a
// 32-bit word, fp32 one. Both row strides (kLdw words) are odd, so a row read
// by 32 lanes (lane = channel) and a column read by 32 lanes (lane = token)
// each fall on distinct banks. `round` is the rounding to E of a value that
// the JAX kernel casts to the operand type (none in fp32), `cast` the store.
template <typename E>
struct Slot;

template <>
struct Slot<bf16> {
  static constexpr int kLdw = 17;    // 34 bf16 a row
  static constexpr int kPerVec = 8;  // values per 16-byte load
  // values 2 c2 and 2 c2 + 1 of a row
  static __device__ __forceinline__ void pair(const uint32_t* row, int c2, float& a, float& b) {
    const uint32_t w = row[c2];
    a = lo(w);
    b = hi(w);
  }
  static __device__ __forceinline__ float at(const uint32_t* row, int c) {
    const uint32_t w = row[c >> 1];
    return (c & 1) ? hi(w) : lo(w);
  }
  static __device__ __forceinline__ float round(float x) { return round_bf16(x); }
  static __device__ __forceinline__ bf16 cast(float x) { return __float2bfloat16(x); }
};

template <>
struct Slot<float> {
  static constexpr int kLdw = 33;
  static constexpr int kPerVec = 4;
  static __device__ __forceinline__ void pair(const uint32_t* row, int c2, float& a, float& b) {
    a = __uint_as_float(row[2 * c2]);
    b = __uint_as_float(row[2 * c2 + 1]);
  }
  static __device__ __forceinline__ float at(const uint32_t* row, int c) { return __uint_as_float(row[c]); }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float cast(float x) { return x; }
};

// Copies the 32 channels at `coff` of every token of window `win` from
// `src` (`ld` values per pixel) into `dst`: T rows of Slot<E>::kLdw words,
// 16 bytes per step.
template <typename E>
__device__ __forceinline__ void load_slice(const E* __restrict__ src, int ld, int coff,
                                           const Geometry& g, long long win, uint32_t* dst,
                                           int tid, int nthreads) {
  constexpr int kPer = Slot<E>::kPerVec, kVecs = kD / kPer;
  for (int e = tid; e < g.T * kVecs; e += nthreads) {
    const int t = e / kVecs, s = e - t * kVecs;
    const uint4 u =
        *reinterpret_cast<const uint4*>(src + token_pixel(g, win, t) * ld + coff + s * kPer);
    uint32_t* row = dst + t * Slot<E>::kLdw + s * 4;
    row[0] = u.x;
    row[1] = u.y;
    row[2] = u.z;
    row[3] = u.w;
  }
}

// Element c of row t of a shared slice.
template <typename E>
__device__ __forceinline__ float elem(const uint32_t* m, int t, int c) {
  return Slot<E>::at(m + t * Slot<E>::kLdw, c);
}

// A row of a shared slice into 32 registers (all lanes read the same words).
template <typename E>
__device__ __forceinline__ void load_row(const uint32_t* m, int t, float* r) {
#pragma unroll
  for (int c2 = 0; c2 < kD / 2; ++c2) Slot<E>::pair(m + t * Slot<E>::kLdw, c2, r[2 * c2], r[2 * c2 + 1]);
}

// sum_c r[c] * row t of m[c]: one lane's dot product with its own token.
template <typename E>
__device__ __forceinline__ float dot_row(const float* r, const uint32_t* m, int t) {
  float a = 0.f;
#pragma unroll
  for (int c2 = 0; c2 < kD / 2; ++c2) {
    float x0, x1;
    Slot<E>::pair(m + t * Slot<E>::kLdw, c2, x0, x1);
    a = fmaf(r[2 * c2], x0, a);
    a = fmaf(r[2 * c2 + 1], x1, a);
  }
  return a;
}

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
// r holds q_i; on return p[k] holds the probability rounded to E (as a
// float), 0 past T. Scores and softmax in fp32 (_attend,
// partition_attention.py:107-115): exp(s - max) / sum.
template <typename E, int NJ>
__device__ __forceinline__ void softmax_row(const float* r, const uint32_t* Ks,
                                            const float* __restrict__ bias_row, int T, int lane,
                                            float* p) {
  float m = __int_as_float(0xff800000);  // -inf
#pragma unroll
  for (int k = 0; k < NJ; ++k) {
    const int j = k * 32 + lane;
    p[k] = m;
    if (j < T) {
      p[k] = dot_row<E>(r, Ks, j) + bias_row[j];
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
  for (int k = 0; k < NJ; ++k) p[k] = Slot<E>::round(p[k] / sum);
}

// sum_j x_j * m[j][lane] over the T keys, x_j held by lane j % 32 in x[j / 32].
template <typename E, int NJ>
__device__ __forceinline__ float mix_rows(const float* x, const uint32_t* m, int T, int lane) {
  float o = 0.f;
#pragma unroll
  for (int k = 0; k < NJ; ++k) {
    const int n = T - k * 32 < 32 ? T - k * 32 : 32;
    for (int src = 0; src < n; ++src) {
      const float xj = __shfl_sync(kFull, x[k], src);
      o = fmaf(xj, elem<E>(m, k * 32 + src, lane), o);
    }
  }
  return o;
}

}  // namespace imt_pa
