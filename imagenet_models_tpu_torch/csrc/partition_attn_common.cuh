// Device helpers shared by the partition-attention forward
// (partition_attn_fwd.cu) and backward (partition_attn_bwd.cu) kernels: the
// window geometry (which pixel holds token t of a window); for the row
// kernels (CUDA cores: the forward in both dtypes and the fp32 backward) the
// copy of one head's 32-wide slice of a window into shared memory and access
// to it for both operand types (the generic pieces, also used by the stripe
// kernels' fp32 instances), a row's scores and softmax, and the mixing of
// rows; for the bf16 backward's tensor-core tiles (mma.sync) the window's
// first pixel and its tokens' offsets, the cp.async copy of a window's slice
// into padded rows, the products of a 16-row slice with a chunk of keys, the
// bias added to the score fragments, the softmax statistics, and the staged
// 16-byte stores of a slice's fragments.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mma_sync.cuh"

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


// ------------------------------------------------ bf16: windows in shared memory
//
// A window's head slice sits in shared memory as TP = 16 NKB rows (T padded
// to whole 16-row blocks: 49 -> 64, 144 and 256 as they are) of kDS bf16:
// the 32 channels plus 8, so that a row is 80 bytes, an odd number of
// 16-byte units, and the 8 rows of an ldmatrix fall on 8 distinct groups of
// four banks. Rows past T are zero, written once per block: the copies fill
// only rows < T. A warp owns a 16-row slice. On kernel 4's tensor-core
// tiles the keys come in chunks of kChunk blocks of 16 (128 keys: 16 score
// tiles of 8, 64 fp32 registers a thread), one chunk for T <= 128, and
// thread (g, t4) = (lane / 4, lane % 4) holds elements [g][2 t4 + 0, 1]
// (registers 0, 1) and [g + 8][2 t4 + 0, 1] (2, 3) of each 16 x 8 tile: the
// m16n8 accumulator layout of mma_sync.cuh, the same entries of its slice in
// every window.

constexpr int kDS = kD + 8;      // row stride of a staged slice, bf16
constexpr int kChunk = 8;        // key blocks of 16 per chunk of scores in registers
constexpr float kMask = -1e30f;  // JAX's mask of the padded keys

// warps of a block for nkb blocks of 16 tokens: one per 16-row slice, at most 8
__host__ __device__ constexpr int mma_warps(int nkb) { return nkb < 8 ? nkb : 8; }
__host__ __device__ constexpr int key_chunks(int nkb) { return (nkb + kChunk - 1) / kChunk; }

// token_pixel split in two, in 32-bit arithmetic but for the window's first
// pixel: window_base(win), computed once a window, plus token_offset(t),
// computed once a block into a table, which the copies and stores read.
//   block: (n*H + i*ph)*W + j*pw  plus  a*W + b;
//   grid:  (n*H + i)*W + j        plus  a*(H/ph)*W + b*(W/pw).
__device__ __forceinline__ long long window_base(const Geometry& g, int win) {
  const int per_img = g.wr * g.wc;
  const int n = win / per_img, r = win - n * per_img;
  const int i = r / g.wc, j = r - i * g.wc;
  const long long img = static_cast<long long>(n) * g.H;
  return g.grid ? (img + i) * g.W + j : (img + i * g.ph) * g.W + j * g.pw;
}

__device__ __forceinline__ int token_offset(const Geometry& g, int t) {
  const int a = t / g.pw, b = t - a * g.pw;
  return g.grid ? a * g.wr * g.W + b * g.wc : a * g.W + b;
}

// Issues the cp.async copies of the 32 channels at `coff` of the T tokens of
// the window whose first pixel is `base`, in a map of `ld` values a pixel,
// into rows of kDS bf16 at dst, 16 bytes each; tok holds the tokens' offsets.
__device__ __forceinline__ void copy_window(const bf16* __restrict__ src, int ld, int coff,
                                            long long base, const int* tok, int T, bf16* dst,
                                            int tid, int nthreads) {
  const bf16* from = src + base * ld + coff;
  for (int e = tid; e < 4 * T; e += nthreads) {
    const int t = e >> 2, c = e & 3;
    imt_mma::cp_async16(dst + t * kDS + 8 * c, from + static_cast<long long>(tok[t]) * ld + 8 * c);
  }
}

// The A fragments (two k16 steps) of rows m0..m0+15 of a staged slice.
__device__ __forceinline__ void load_rows(uint32_t (&a)[2][4], const bf16* M, int m0, int lane) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    imt_mma::ldsm_x4(a[kk], M + (m0 + (lane & 15)) * kDS + 16 * kk + 8 * (lane >> 4));
}

// The B fragments of rows r0..r0+15 of a staged slice taken as a (k = row,
// n = channel) matrix: b[t] for channel tile t, its k halves in b[t][0] and
// b[t][1] (ldmatrix.trans).
__device__ __forceinline__ void load_cols(uint32_t (&b)[4][2], const bf16* M, int r0, int lane) {
#pragma unroll
  for (int dt = 0; dt < 2; ++dt) {
    uint32_t r[4];
    imt_mma::ldsm_x4_trans(r, M + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * kDS + 16 * dt +
                                  8 * (lane >> 4));
    b[2 * dt][0] = r[0];
    b[2 * dt][1] = r[1];
    b[2 * dt + 1][0] = r[2];
    b[2 * dt + 1][1] = r[3];
  }
}

// The products of a 16-row slice (A fragments a) with the rows of M of key
// chunk kc: s[2 t2 + h] is the n8 tile of keys 16 (kChunk kc + t2) + 8 h ..,
// for the key blocks below NKB. Exact products of bf16 values, fp32 sums;
// the padded rows of M are zero, so their products are 0.
template <int NKB>
__device__ __forceinline__ void chunk_products(const bf16* M, const uint32_t (&a)[2][4], int kc,
                                               int lane, float (&s)[2 * kChunk][4]) {
#pragma unroll
  for (int t2 = 0; t2 < kChunk; ++t2) {
    if (kc * kChunk + t2 < NKB) {
      const int key0 = 16 * (kc * kChunk + t2);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[2 * t2][e] = s[2 * t2 + 1][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t kb[4];
        imt_mma::ldsm_x4(kb, M + (key0 + (lane & 7) + 8 * (lane >> 4)) * kDS + 16 * kk +
                                 8 * ((lane >> 3) & 1));
        imt_mma::mma_bf16(s[2 * t2], a[kk], kb[0], kb[1]);
        imt_mma::mma_bf16(s[2 * t2 + 1], a[kk], kb[2], kb[3]);
      }
    }
  }
}

// What the bias adds to element e of score tile t (key block t / 2) of the
// slice at m0: the head's bias bh[row][col] (fp32, T x T) at rows and keys
// below T; kMask at keys from T on (the padded keys' products are 0, so
// 0 + kMask is kMask: JAX's mask); 0 at the padded rows.
__device__ __forceinline__ float bias_term(const float* __restrict__ bh, int T, int m0, int t, int e,
                                           int lane) {
  const int row = m0 + (lane >> 2) + 8 * (e >> 1);
  const int col = 8 * t + 2 * (lane & 3) + (e & 1);
  return col >= T ? kMask : row < T ? __ldg(bh + row * T + col) : 0.f;
}

// s of key chunk kc plus its bias terms, read through L1/L2.
template <int NKB>
__device__ __forceinline__ void add_bias(float (&s)[2 * kChunk][4], int kc,
                                         const float* __restrict__ bh, int T, int m0, int lane) {
#pragma unroll
  for (int t = 0; t < 2 * kChunk; ++t)
    if (kc * kChunk + t / 2 < NKB) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] += bias_term(bh, T, m0, 2 * kChunk * kc + t, e, lane);
    }
}

// The bias terms of every key of the slice at m0 (NKB <= kChunk: one key
// chunk), for a warp that keeps them in registers across windows.
template <int NKB>
__device__ __forceinline__ void bias_frags(float (&b)[2 * kChunk][4], const float* __restrict__ bh,
                                           int T, int m0, int lane) {
  static_assert(NKB <= kChunk, "the bias terms of one key chunk");
#pragma unroll
  for (int t = 0; t < 2 * NKB; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) b[t][e] = bias_term(bh, T, m0, t, e, lane);
}

// The slice's score tiles of key chunk kc: q k^T (qa: q's fragments) plus
// the bias terms, from the registers `bfr` (kRegBias: `bias_frags`) or read
// through L1/L2.
template <int NKB, bool kRegBias>
__device__ __forceinline__ void slice_scores(const bf16* Ks, const uint32_t (&qa)[2][4], int kc,
                                             const float (&bfr)[2 * kChunk][4],
                                             const float* __restrict__ bh, int T, int m0,
                                             int lane, float (&s)[2 * kChunk][4]) {
  chunk_products<NKB>(Ks, qa, kc, lane, s);
  if constexpr (kRegBias) {
#pragma unroll
    for (int t = 0; t < 2 * NKB; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] += bfr[t][e];
  } else {
    add_bias<NKB>(s, kc, bh, T, m0, lane);
  }
}

// The softmax statistics of the slice's rows g and g + 8: the row max of the
// scores over every key, then the sum of exp(s - max), in fp32 (`_attend`,
// partition_attention.py:107-115); the quad of lanes sharing a row combines
// its parts by shuffles. `scores(kc, s)` leaves key chunk kc's scores in s.
// With one key chunk, s holds exp(s - max) on return; with two, each pass
// recomputes the chunk's scores.
template <int NKB, typename Scores>
__device__ __forceinline__ void softmax_stats(Scores scores, float (&s)[2 * kChunk][4],
                                              float (&mx)[2], float (&sum)[2]) {
  constexpr int NCH = key_chunks(NKB);
  mx[0] = mx[1] = __int_as_float(0xff800000);  // -inf
#pragma unroll
  for (int kc = 0; kc < NCH; ++kc) {
    scores(kc, s);
#pragma unroll
    for (int t = 0; t < 2 * kChunk; ++t)
      if (kc * kChunk + t / 2 < NKB) {
        mx[0] = fmaxf(mx[0], fmaxf(s[t][0], s[t][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[t][2], s[t][3]));
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
  }
  sum[0] = sum[1] = 0.f;
#pragma unroll
  for (int kc = 0; kc < NCH; ++kc) {
    if (NCH > 1) scores(kc, s);
#pragma unroll
    for (int t = 0; t < 2 * kChunk; ++t)
      if (kc * kChunk + t / 2 < NKB) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[t][e] = expf(s[t][e] - mx[e >> 1]);
          sum[e >> 1] += s[t][e];
        }
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(kFull, sum[i], 1);
    sum[i] += __shfl_xor_sync(kFull, sum[i], 2);
  }
}

// exp(s - max) of key chunk kc into s: already there with one chunk,
// recomputed with two.
template <int NKB, typename Scores>
__device__ __forceinline__ void chunk_exp(Scores scores, int kc, const float (&mx)[2],
                                          float (&s)[2 * kChunk][4]) {
  if (key_chunks(NKB) == 1) return;
  scores(kc, s);
#pragma unroll
  for (int t = 0; t < 2 * kChunk; ++t)
    if (kc * kChunk + t / 2 < NKB) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = expf(s[t][e] - mx[e >> 1]);
    }
}

// Stores the 16 bf16 rows of `stage` (kDS apart; the rows m0.. of a window)
// that lie below T as 16-byte stores of the 32 channels at `coff`, at their
// pixels base + tok[row] of a map of `ld` values a pixel: padded rows are
// never stored. The warp's lanes; `stage` is free again on return.
__device__ __forceinline__ void store_rows(bf16* stage, int m0, int T, long long base,
                                           const int* tok, bf16* __restrict__ out, int ld,
                                           int coff, int lane) {
  bf16* to = out + base * ld + coff;
  for (int e = lane; e < 64; e += 32) {
    const int r = e >> 2, c = e & 3;
    if (m0 + r < T)
      *reinterpret_cast<uint4*>(to + static_cast<long long>(tok[m0 + r]) * ld + 8 * c) =
          *reinterpret_cast<const uint4*>(stage + r * kDS + 8 * c);
  }
  __syncwarp();
}

// Stores a slice's accumulator fragments o rounded to bf16: through `stage`
// (16 rows of kDS bf16 that only this warp touches) to 16-byte stores of
// the 32 channels at `coff` of the slice's rows below T, at their pixels
// base + tok[row] of a map of `ld` values a pixel. Padded rows are never
// stored.
__device__ __forceinline__ void store_slice(bf16* stage, const float (&o)[4][4], int m0, int T,
                                            long long base, const int* tok,
                                            bf16* __restrict__ out, int ld, int coff, int lane) {
  const int gr = lane >> 2, t4 = lane & 3;
  __syncwarp();  // every lane is done reading what `stage` held
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int c = 8 * t + 2 * t4;
    *reinterpret_cast<uint32_t*>(stage + gr * kDS + c) = imt_mma::pack_bf16(o[t][0], o[t][1]);
    *reinterpret_cast<uint32_t*>(stage + (gr + 8) * kDS + c) = imt_mma::pack_bf16(o[t][2], o[t][3]);
  }
  __syncwarp();
  store_rows(stage, m0, T, base, tok, out, ld, coff, lane);
}

}  // namespace imt_pa
