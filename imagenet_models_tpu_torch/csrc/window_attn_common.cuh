// Device code shared by the fused window-attention kernels, per window (kernel
// 12, window_attn_fwd.cu) and per head with a shared bias (kernel 13,
// window_attn_heads_fwd.cu): the copy of a window's keys into shared memory,
// and one query row of softmax(q k^T [+ bias]) v for a warp.
//
// Numerics (`_attn_body`, imagenet_models_tpu/ops/flash_attention.py:37-52):
// scores q.k in fp32 (exact products of bf16 operands, fp32 sums), the bias
// added in fp32, softmax in fp32 as exp(s - max) / sum, p rounded to the input
// dtype, p.v summed in fp32, one cast at the output. Every sum runs in a fixed
// order, so two runs give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace imt_wa {

typedef __nv_bfloat16 bf16;

constexpr int kMaxN = 256;  // tokens per window
constexpr int kMaxNJ = 8;   // key chunks of 32: the lane's scores in registers
constexpr int kMaxD = 128;  // head width: up to 4 channel chunks of 32 per lane
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;  // 227 KB per block on sm_90
constexpr size_t kDefaultSmem = 48 * 1024;

inline __host__ __device__ int key_chunks(int n) { return (n + 31) / 32; }
inline __host__ __device__ int channel_chunks(int d) { return (d + 31) / 32; }

// Row stride of the keys in shared memory, in fp32 words: d + 4 keeps rows
// 16 bytes aligned, and since (d + 4) / 4 is odd for d % 8 == 0, the eight
// lanes of a quarter warp that read 16 bytes each of their own key row hit
// eight distinct groups of four banks.
inline __host__ __device__ int key_stride(int d) { return d + 4; }

// Shared memory of a block: two rows of probabilities per warp (whole chunks
// of 32, 16-byte aligned), the window's keys as fp32 rows, and, where they
// fit (`stages_qv`), its q and v rows as they are in device memory.
inline __host__ __device__ size_t key_floats(int n, int d) {
  return static_cast<size_t>(kWarps) * 2 * key_chunks(n) * 32 +
         static_cast<size_t>(n) * key_stride(d);
}

inline size_t smem_bytes(int n, int d, int elem_bytes, bool staged) {
  return key_floats(n, d) * sizeof(float) +
         (staged ? 2 * static_cast<size_t>(n) * d * elem_bytes : 0);
}

// Whether q and v are staged too: on every path shape (at n = 98, d = 32 in
// bf16 the block holds 31 KB), not at the largest windows (n = 256, d = 128:
// the keys and probabilities take 143 KB), which read them from device
// memory.
inline bool stages_qv(int n, int d, int elem_bytes) {
  return smem_bytes(n, d, elem_bytes, true) <= kMaxSmem;
}

// Windows the kernels take: 1 <= n <= 256 tokens, heads of d = 8..128
// channels in steps of 8 (16-byte rows in both dtypes).
inline bool supported(int n, int d) {
  return n >= 1 && n <= kMaxN && d >= 8 && d <= kMaxD && d % 8 == 0 &&
         smem_bytes(n, d, sizeof(float), false) <= kMaxSmem;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

// x rounded to T and back (exact for fp32).
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

// The elements of one 16-byte vector of T, as floats (exact).
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

template <>
struct Vec<bf16> {
  static constexpr int kN = 8;
  // element 2i sits in the low half of word i (little-endian)
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

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

// Copies a window into shared memory, 16 bytes per load, all threads of the
// block: the n x d keys at `k` into `Ks` as fp32 rows of key_stride(d) words,
// and where `Qs` is not null q and v as they are into `Qs` and `Vs`. All the
// loads are independent, so the window arrives in one round trip.
template <typename T>
__device__ __forceinline__ void load_window(const T* __restrict__ q, const T* __restrict__ k,
                                            const T* __restrict__ v, int n, int d, float* Ks,
                                            T* Qs, T* Vs, int tid) {
  constexpr int V = Vec<T>::kN;
  const int per_row = d / V, ld = key_stride(d);
  const uint4* src = reinterpret_cast<const uint4*>(k);
  for (int e = tid; e < n * per_row; e += kThreads) {
    const int t = e / per_row, c = (e - t * per_row) * V;
    float f[V];
    Vec<T>::unpack(__ldg(src + e), f);
    float4* row = reinterpret_cast<float4*>(Ks + t * ld + c);
#pragma unroll
    for (int u = 0; u < V / 4; ++u)
      row[u] = make_float4(f[4 * u], f[4 * u + 1], f[4 * u + 2], f[4 * u + 3]);
  }
  if (Qs != nullptr) {
    const uint4* qs = reinterpret_cast<const uint4*>(q);
    const uint4* vs = reinterpret_cast<const uint4*>(v);
    uint4* qd = reinterpret_cast<uint4*>(Qs);
    uint4* vd = reinterpret_cast<uint4*>(Vs);
    for (int e = tid; e < n * per_row; e += kThreads) {
      qd[e] = __ldg(qs + e);
      vd[e] = __ldg(vs + e);
    }
  }
}

// Adds the products of the W channels from c0 on to the scores of two query
// rows a and b: sa[kk] += qa[c] k_j[c] (and sb) for the lane's keys
// j = 32 kk + lane, in order of c. Each 16 bytes of a key read from shared
// memory serve both rows. Lanes past the last key read its row and are
// masked in the softmax, so the loop has no divergent branch. The rows'
// chunks are read by every lane (the same 16-byte vectors, a broadcast).
template <typename T, int W>
__device__ __forceinline__ void score_chunk(const T* qa, const T* qb, const float* Ks, int n,
                                            int ld, int c0, int lane, float* sa, float* sb) {
  constexpr int V = Vec<T>::kN;
  float ra[W], rb[W];
  const uint4* qva = reinterpret_cast<const uint4*>(qa + c0);
  const uint4* qvb = reinterpret_cast<const uint4*>(qb + c0);
#pragma unroll
  for (int u = 0; u < W / V; ++u) {
    Vec<T>::unpack(qva[u], ra + u * V);
    Vec<T>::unpack(qvb[u], rb + u * V);
  }
  const int nj = key_chunks(n);
#pragma unroll
  for (int kk = 0; kk < kMaxNJ; ++kk) {
    if (kk < nj) {  // the same for the whole warp
      const int j = min(kk * 32 + lane, n - 1);
      const float4* kr = reinterpret_cast<const float4*>(Ks + j * ld + c0);
#pragma unroll
      for (int u = 0; u < W / 4; ++u) {
        const float4 kv = kr[u];
        sa[kk] = fmaf(ra[4 * u], kv.x, sa[kk]);
        sb[kk] = fmaf(rb[4 * u], kv.x, sb[kk]);
        sa[kk] = fmaf(ra[4 * u + 1], kv.y, sa[kk]);
        sb[kk] = fmaf(rb[4 * u + 1], kv.y, sb[kk]);
        sa[kk] = fmaf(ra[4 * u + 2], kv.z, sa[kk]);
        sb[kk] = fmaf(rb[4 * u + 2], kv.z, sb[kk]);
        sa[kk] = fmaf(ra[4 * u + 3], kv.w, sa[kk]);
        sb[kk] = fmaf(rb[4 * u + 3], kv.w, sb[kk]);
      }
    }
  }
}

// One row's softmax over its scores s (+ bias_row, which may be null) into
// P: exp(s - max) / sum in fp32, rounded to T, for the lane's keys.
template <typename T>
__device__ __forceinline__ void softmax_row(float* s, const float* __restrict__ bias_row, int n,
                                            int lane, float* P) {
  const int nj = key_chunks(n);
  float mx = __int_as_float(0xff800000);  // -inf
#pragma unroll
  for (int kk = 0; kk < kMaxNJ; ++kk) {
    const int j = kk * 32 + lane;
    if (kk < nj && j < n) {
      if (bias_row != nullptr) s[kk] += __ldg(bias_row + j);
      mx = fmaxf(mx, s[kk]);
    }
  }
  mx = warp_max(mx);
  float sum = 0.f;
#pragma unroll
  for (int kk = 0; kk < kMaxNJ; ++kk) {
    const int j = kk * 32 + lane;
    s[kk] = kk < nj && j < n ? expf(s[kk] - mx) : 0.f;
    sum += s[kk];
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int kk = 0; kk < kMaxNJ; ++kk)
    if (kk < nj) P[kk * 32 + lane] = round_to<T>(s[kk] / sum);  // 0 past n
}

// oa[m] += pa v_j[32 m + lane] and ob[m] += pb v_j[32 m + lane] for the
// lane's channels: one read of v serves both rows.
template <typename T, int DC>
__device__ __forceinline__ void mix_row(float pa, float pb, const T* v_row, int d, int lane,
                                        float* oa, float* ob) {
#pragma unroll
  for (int m = 0; m < DC; ++m) {
    const int c = m * 32 + lane;
    if (c < d) {
      const float x = to_f(v_row[c]);
      oa[m] = fmaf(pa, x, oa[m]);
      ob[m] = fmaf(pb, x, ob[m]);
    }
  }
}

// Rows a and b of one window for the calling warp: out_r = softmax(q_r K^T +
// bias_r) V. The lane owns keys j = 32 kk + lane for the scores and the
// softmax, so a row's n scores stay in registers (8 a lane at n = 256); the
// rounded probabilities go to the warp's two rows P of shared memory, and
// the lanes then own channels c = 32 m + lane of p.v, reading p four at a
// time (a broadcast) and v's rows along the channels. Two rows at a time
// halve the shared-memory reads of the keys and of v per row. qa, qb and v
// point into shared memory where the window is staged, else into device
// memory (the window's rows are then shared by the block's warps through
// L1). The bias rows may be null; out_b is null where row b repeats row a
// (the last row of an odd window). DC = channel_chunks(d).
template <typename T, int DC>
__device__ __forceinline__ void attend_rows(const T* qa, const T* qb, const float* Ks, const T* v,
                                            const float* bias_a, const float* bias_b, float* P,
                                            T* __restrict__ out_a, T* __restrict__ out_b, int n,
                                            int d, int lane) {
  const int ld = key_stride(d);
  float sa[kMaxNJ], sb[kMaxNJ];
#pragma unroll
  for (int kk = 0; kk < kMaxNJ; ++kk) sa[kk] = sb[kk] = 0.f;
#pragma unroll
  for (int m = 0; m < DC; ++m) {
    const int c0 = m * 32;
    switch (d - c0) {  // d % 8 == 0
      case 24: score_chunk<T, 24>(qa, qb, Ks, n, ld, c0, lane, sa, sb); break;
      case 16: score_chunk<T, 16>(qa, qb, Ks, n, ld, c0, lane, sa, sb); break;
      case 8: score_chunk<T, 8>(qa, qb, Ks, n, ld, c0, lane, sa, sb); break;
      default: score_chunk<T, 32>(qa, qb, Ks, n, ld, c0, lane, sa, sb); break;
    }
  }
  float* Pa = P;
  float* Pb = P + key_chunks(n) * 32;
  softmax_row<T>(sa, bias_a, n, lane, Pa);
  softmax_row<T>(sb, bias_b, n, lane, Pb);
  __syncwarp();

  float oa[DC], ob[DC];
#pragma unroll
  for (int m = 0; m < DC; ++m) oa[m] = ob[m] = 0.f;
  int j0 = 0;
  for (; j0 + 4 <= n; j0 += 4) {
    const float4 pa = *reinterpret_cast<const float4*>(Pa + j0);
    const float4 pb = *reinterpret_cast<const float4*>(Pb + j0);
    const T* vr = v + j0 * d;
    mix_row<T, DC>(pa.x, pb.x, vr, d, lane, oa, ob);
    mix_row<T, DC>(pa.y, pb.y, vr + d, d, lane, oa, ob);
    mix_row<T, DC>(pa.z, pb.z, vr + 2 * d, d, lane, oa, ob);
    mix_row<T, DC>(pa.w, pb.w, vr + 3 * d, d, lane, oa, ob);
  }
  for (; j0 < n; ++j0) mix_row<T, DC>(Pa[j0], Pb[j0], v + j0 * d, d, lane, oa, ob);
#pragma unroll
  for (int m = 0; m < DC; ++m) {
    const int c = m * 32 + lane;
    if (c < d) {
      out_a[c] = from_f<T>(oa[m]);
      if (out_b != nullptr) out_b[c] = from_f<T>(ob[m]);
    }
  }
  __syncwarp();  // P is the warp's next rows'
}

}  // namespace imt_wa
