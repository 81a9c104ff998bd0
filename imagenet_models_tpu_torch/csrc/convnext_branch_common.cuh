// Device helpers of the fp32 instances of the fused ConvNeXt branch kernels
// (convnext_branch_fwd.cu, kernel 10; convnext_branch_bwd.cu, kernel 11),
// the first design's code: the per-token depthwise 7x7 conv, 4-channel loads and
// stores, and the wmma products of the LN+MLP stage (the A&S erf GELU is
// ln_mlp_common.cuh's `gelu_as`). Written for an operand type E, of which
// only fp32 is left: the bf16 instances run on convnext_branch_ring.cuh and
// kernels 1 and 2's GEMM stages.
//
// fp32 operands take the 16x16x8 tf32 wmma shape as three products
// (3xTF32): each value v is split into hi = tf32(v) and lo = tf32(v - hi),
// and a*b is summed as lo_a*hi_b + hi_a*lo_b + hi_a*hi_b, which keeps about
// 22 bits of each product (tf32 alone keeps 11) with fp32 sums.
#pragma once

#include <type_traits>

#include "ln_mlp_common.cuh"

namespace imt {
namespace branch {

// ---------------------------------------------------------------- loads, stores

__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

// plain (not read-only path) load: for scratch this kernel itself wrote
__device__ __forceinline__ void load4_rw(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

__device__ __forceinline__ void store4(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

__device__ __forceinline__ void zero4(float* p) {
  *reinterpret_cast<float4*>(p) = make_float4(0.f, 0.f, 0.f, 0.f);
}

template <typename E>
__device__ __forceinline__ E to_elem(float v);
template <>
__device__ __forceinline__ float to_elem<float>(float v) { return v; }

__device__ __forceinline__ float to_float(float v) { return v; }

// elements of a row pad: 16 bytes, so every row of a tile starts 16-byte aligned
template <typename E>
struct Pad {
  static constexpr int value = 16 / static_cast<int>(sizeof(E));
};

// ---------------------------------------------------------------- depthwise 7x7

// 4-channel units per lane of a warp's token row of width C (C = 96 takes 1,
// C = 1024 takes 8): a kernel instance's Q must be at least this.
__host__ __device__ constexpr int units_per_lane(int C) { return (C / 4 + 31) / 32; }

// The 49-tap depthwise conv of `src` (a (B, H, W, C) NHWC map) at token r =
// (b * H + y) * W + x, in fp32, for this lane's 4-channel units u = lane +
// 32 q (q < Q): out[q][e] = bias + sum over (ky, kx) in row-major order of
// src[b, y + d(ky), x + d(kx), 4u + e] * taps[ky * 7 + kx][4u + e], with
// d(k) = k - 3 (the forward conv) or 3 - k (FLIP: the correlation with the
// flipped taps, the conv's data gradient). Taps outside the map add nothing:
// the bounds checks stand in for the TPU kernel's zero-padded slab. taps is
// (49, C) fp32; bias (C) fp32 or null. The kx loop is unrolled so that the
// seven loads of a kernel row are in flight together.
template <int Q, bool FLIP, typename S>
__device__ __forceinline__ void dw_token(const S* __restrict__ src, const float* __restrict__ taps,
                                         const float* __restrict__ bias, long long r, int H, int W,
                                         int C, int lane, float (&out)[Q][4]) {
  const int U = C / 4;
  const long long hw = static_cast<long long>(H) * W;
  const long long b = r / hw;
  const int p = static_cast<int>(r - b * hw);
  const int y = p / W, x = p - (p / W) * W;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int u = lane + 32 * q;
#pragma unroll
    for (int e = 0; e < 4; ++e) out[q][e] = (bias != nullptr && u < U) ? __ldg(bias + 4 * u + e) : 0.f;
  }
  for (int ky = 0; ky < 7; ++ky) {
    const int yy = FLIP ? y + 3 - ky : y + ky - 3;
    if (yy < 0 || yy >= H) continue;
    const S* row = src + (b * H + yy) * W * C;
    const float* tap = taps + ky * 7 * C;
#pragma unroll
    for (int kx = 0; kx < 7; ++kx) {
      const int xx = FLIP ? x + 3 - kx : x + kx - 3;
      if (xx >= 0 && xx < W) {
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int u = lane + 32 * q;
          if (u < U) {
            float v[4];
            load4(row + static_cast<long long>(xx) * C + 4 * u, v);
            const float4 w = __ldg(reinterpret_cast<const float4*>(tap + kx * C + 4 * u));
            out[q][0] = fmaf(v[0], w.x, out[q][0]);
            out[q][1] = fmaf(v[1], w.y, out[q][1]);
            out[q][2] = fmaf(v[2], w.z, out[q][2]);
            out[q][3] = fmaf(v[3], w.w, out[q][3]);
          }
        }
      }
    }
  }
}

// LayerNorm statistics of a token row held by a warp (h[q][e] for units u =
// lane + 32 q < C/4): the mean, then the centred second moment from the same
// registers, as the TPU kernel's `_ln_fwd`. Returns (mu, rstd).
template <int Q>
__device__ __forceinline__ float2 ln_stats(const float (&h)[Q][4], int C, int lane, float eps) {
  const int U = C / 4;
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < Q; ++q)
    if (lane + 32 * q < U) s += (h[q][0] + h[q][1]) + (h[q][2] + h[q][3]);
  const float mu = warp_sum(s) / C;
  float v = 0.f;
#pragma unroll
  for (int q = 0; q < Q; ++q)
    if (lane + 32 * q < U) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v += (h[q][e] - mu) * (h[q][e] - mu);
    }
  return make_float2(mu, rsqrtf(warp_sum(v) / C + eps));
}

// A carveout hint for a kernel whose block takes `smem` bytes of shared
// memory and one block per SM: the rest of the SM's 256 KB stays L1, where
// the conv's windows of neighbouring tokens meet.
inline cudaError_t prefer_l1(const void* kern, size_t smem) {
  const size_t pct = (smem + 1024) * 100 / 233472 + 1;  // of the 228 KB the SM can give
  return cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                              static_cast<int>(pct < 100 ? pct : 100));
}

// ---------------------------------------------------------------- wmma by operand type

template <typename E>
struct Mma;

template <>
struct Mma<float> {
  static constexpr int K = 8;
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::row_major> A;
  typedef wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::col_major> ACol;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::col_major> BCol;
  typedef wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::row_major> BRow;
  typedef wmma::fragment<wmma::accumulator, 16, 16, 8, float> Acc;
  template <typename F>
  struct Op {
    F hi, lo;
  };
  template <typename F>
  static __device__ __forceinline__ void load(Op<F>& o, const float* p, int ld) {
    wmma::load_matrix_sync(o.hi, p, ld);
#pragma unroll
    for (int e = 0; e < o.hi.num_elements; ++e) {
      const float v = o.hi.x[e];
      const float h = wmma::__float_to_tf32(v);
      o.hi.x[e] = h;
      o.lo.x[e] = wmma::__float_to_tf32(v - h);
    }
  }
  template <typename FA, typename FB>
  static __device__ __forceinline__ void mma(Acc& c, const Op<FA>& a, const Op<FB>& b) {
    wmma::mma_sync(c, a.lo, b.hi, c);
    wmma::mma_sync(c, a.hi, b.lo, c);
    wmma::mma_sync(c, a.hi, b.hi, c);
  }
};

// The B fragment at k-step k and column block nb of a (K x N) operand held
// col-major (element (k, n) at n * ldb + k) or row-major (k * ldb + n).
template <typename E, bool BCOL>
__device__ __forceinline__ const E* bfrag(const E* B, int ldb, int k, int nb) {
  constexpr int KK = Mma<E>::K;
  return BCOL ? B + nb * 16 * ldb + k * KK : B + k * KK * ldb + nb * 16;
}

// Hp (fp32, ld ldh) = A[:, k-steps kb..ke) @ B for this warp's MT1 x NT1
// fragments at row block mb0 and column block nb0. A is a (T x K) tile
// row-major, B a (K x HC) operand, col-major (BCOL) or row-major. With fewer
// than four fragments, even and odd k-steps go to two accumulator sets.
template <typename E, int MT1, int NT1, bool BCOL>
__device__ __forceinline__ void hidden_product(const E* A, int lda, const E* B, int ldb, float* Hp,
                                               int ldh, int kb, int ke, int mb0, int nb0) {
  typedef Mma<E> M;
  typedef typename M::template Op<typename M::A> OA;
  typedef typename M::template Op<
      typename std::conditional<BCOL, typename M::BCol, typename M::BRow>::type> OB;
  constexpr int KK = M::K;
  constexpr int NACC = MT1 * NT1 >= 4 ? 1 : 2;
  typename M::Acc c1[NACC][MT1][NT1];
#pragma unroll
  for (int p = 0; p < NACC; ++p)
#pragma unroll
    for (int i = 0; i < MT1; ++i)
#pragma unroll
      for (int jj = 0; jj < NT1; ++jj) wmma::fill_fragment(c1[p][i][jj], 0.f);
  for (int k = kb; k < ke; k += NACC) {
#pragma unroll
    for (int p = 0; p < NACC; ++p) {
      if (k + p < ke) {
        OA a[MT1];
        OB b[NT1];
#pragma unroll
        for (int i = 0; i < MT1; ++i) M::load(a[i], A + (mb0 + i) * 16 * lda + (k + p) * KK, lda);
#pragma unroll
        for (int jj = 0; jj < NT1; ++jj) M::load(b[jj], bfrag<E, BCOL>(B, ldb, k + p, nb0 + jj), ldb);
#pragma unroll
        for (int i = 0; i < MT1; ++i)
#pragma unroll
          for (int jj = 0; jj < NT1; ++jj) M::mma(c1[p][i][jj], a[i], b[jj]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MT1; ++i)
#pragma unroll
    for (int jj = 0; jj < NT1; ++jj) {
#pragma unroll
      for (int p = 1; p < NACC; ++p)
#pragma unroll
        for (int e = 0; e < c1[0][i][jj].num_elements; ++e) c1[0][i][jj].x[e] += c1[p][i][jj].x[e];
      wmma::store_matrix_sync(Hp + (mb0 + i) * 16 * ldh + (nb0 + jj) * 16, c1[0][i][jj], ldh,
                              wmma::mem_row_major);
    }
}

// acc += A @ B over KB k-steps: A a (T x KB*K) tile row-major, B a (KB*K x C)
// operand, col-major (BCOL) or row-major; this warp's MT2 row blocks from mb0
// and nt2 column blocks from cb0.
template <typename E, int MT2, int NT2, int KB, bool BCOL>
__device__ __forceinline__ void out_product(typename Mma<E>::Acc (&acc)[MT2][NT2], const E* A, int lda,
                                            const E* B, int ldb, int mb0, int cb0, int nt2) {
  typedef Mma<E> M;
  typedef typename M::template Op<typename M::A> OA;
  typedef typename M::template Op<
      typename std::conditional<BCOL, typename M::BCol, typename M::BRow>::type> OB;
  constexpr int KK = M::K;
#pragma unroll
  for (int kk = 0; kk < KB; ++kk) {
    OA a[MT2];
#pragma unroll
    for (int i = 0; i < MT2; ++i) M::load(a[i], A + (mb0 + i) * 16 * lda + kk * KK, lda);
#pragma unroll
    for (int jj = 0; jj < NT2; ++jj) {
      if (jj < nt2) {
        OB b;
        M::load(b, bfrag<E, BCOL>(B, ldb, kk, cb0 + jj), ldb);
#pragma unroll
        for (int i = 0; i < MT2; ++i) M::mma(acc[i][jj], a[i], b);
      }
    }
  }
}

template <typename E, int MT2, int NT2>
__device__ __forceinline__ void zero_acc(typename Mma<E>::Acc (&acc)[MT2][NT2]) {
#pragma unroll
  for (int i = 0; i < MT2; ++i)
#pragma unroll
    for (int jj = 0; jj < NT2; ++jj) wmma::fill_fragment(acc[i][jj], 0.f);
}

template <typename E, int MT2, int NT2>
__device__ __forceinline__ void store_acc(typename Mma<E>::Acc (&acc)[MT2][NT2], float* Os, int ldo,
                                          int mb0, int cb0, int nt2) {
#pragma unroll
  for (int i = 0; i < MT2; ++i)
#pragma unroll
    for (int jj = 0; jj < NT2; ++jj)
      if (jj < nt2)
        wmma::store_matrix_sync(Os + (mb0 + i) * 16 * ldo + (cb0 + jj) * 16, acc[i][jj], ldo,
                                wmma::mem_row_major);
}

// Copy `rows` rows of `cols` elements (a multiple of 16 bytes) from global
// memory (row stride gld) into shared memory (row stride sld) with cp.async.
template <typename E>
__device__ __forceinline__ void copy_rows(E* dst, int sld, const E* src, long long gld, int rows,
                                          int cols, int tid) {
  constexpr int V = 16 / static_cast<int>(sizeof(E));
  const int segs = cols / V;
  for (int i = tid; i < rows * segs; i += kThreads) {
    const int r = i / segs, s = i - r * segs;
    cp_async16(dst + r * sld + s * V, src + static_cast<long long>(r) * gld + s * V);
  }
}

}  // namespace branch
}  // namespace imt
