// Fused ConvNeXt branch body, backward, for Hopper (sm_90a): kernel 2.
//
// Replaces the TPU kernel `_bwd_kernel` / `_fused_ln_mlp_bwd_pallas` in
// imagenet_models_tpu/ops/convnext_block.py (:372-453, :474-516). Per token it
// pulls the cotangent g of out = (GELU(LN(h) W1^T + b1) W2^T + b2) * gamma back
// to dx, and sums over all N tokens the weight gradients dW1 (hidden x C),
// dW2 (C x hidden) and the vector gradients db1, db2, dgamma, dln_s, dln_b.
//
// Numerics (the Pallas kernel's, and plain_ln_mlp_bwd's): the forward is
// recomputed from h with fp32 LN statistics; the LN'd tokens, the GELU output
// hmid, dpre2 = g*gamma and dpre1 = (dpre2 W2) * gelu'(pre1) are rounded to
// bf16 as products' operands; every product sums in fp32; gelu' is the fit's
// (erff-exact at eval, the minimax fit in training), not the derivative of
// the forward polynomial; the LN backward runs in fp32 and dx is cast to bf16.
// One difference: dW2 is gamma * (g^T hmid), scaled after the fp32 sum, where
// the twin sums bf16(g*gamma)^T hmid; the two differ by that one rounding.
// And dgamma = sum_t g * pre2 is taken from the same product, as
// sum_j W2[c][j] * (g^T hmid)[c][j] + b2[c] * sum_t g[t][c], so pre2 is never
// formed.
//
// Why it is not the TPU kernel. The TPU kernel adds every token tile's weight
// gradients into one output block, relying on grid steps that run in order.
// Hopper's blocks run in parallel in no order, and a block's 227 KB of shared
// memory holds neither W1 + W2 (4.7 MB in bf16 at C=768) nor an fp32 dW
// partial (9.4 MB). So the work is split in two halves, with no float atomics,
// and summed in a fixed order (the same result on every run):
//  (a) ln_mlp_bwd_dx_kernel, one block of 8 warps per tile of T tokens, laid
//      out as the forward kernel: the LN'd tile and the dpre2 tile stay in
//      shared memory; W1 and W2 chunks of HC hidden units stream through it
//      with cp.async. Loop 1 over the chunks recomputes pre1 and GELU, and
//      computes dhmid = dpre2 W2 and dpre1; it writes hmid and dpre1 in bf16
//      to HBM. Loop 2 reads its own dpre1 back and accumulates dln = dpre1 W1
//      in registers. Then the LN backward per token gives dx. Each block
//      writes one fp32 row of partial vector sums. The bf16 tok tile goes to
//      HBM too.
//  (b) wgrad_kernel, a hand-written tiled product out = A^T B over tokens:
//      each block owns a 128 x 128 tile of dW1 = dpre1^T tok or G = g^T hmid
//      and one slice of the N tokens (wmma, fp32 sums, a double-buffered
//      cp.async ring of 32-token stages). A second pass adds the slices'
//      partials, and the blocks' vector rows of (a), each column in a fixed
//      order; a last pass turns G into dW2 = gamma * G and adds
//      sum_j W2 * G to dgamma.
//
// What bounds it on the H100. The recomputed forward plus the backward are
// five products of N x hidden x C (8*N*C^2 flops each at hidden = 4C: pre1,
// dhmid and dln in (a), dW1 and G in (b)), far above the card's ~295
// flop/byte balance, so the fused TPU design is bound by the tensor cores.
// This version also writes and re-reads two (N, hidden) bf16 tensors, hmid
// and dpre1: at stage 0 of B=128 (N = 401408, hidden = 384) that is 2 x 308 MB
// written and read back, about 0.37 ms of HBM time, the traffic a later
// design removes by keeping the hidden on chip across both halves
// (weight-grad sums in a cluster's distributed shared memory, or wgmma with
// TMA). Loop 2 of (a) does not overlap its loads with its products.

#include <type_traits>

#include "ln_mlp_common.cuh"
#include "wgrad_common.cuh"

namespace {

using namespace imt;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragACol;

// ---------------------------------------------------------------- half (a)

// Shared-memory plan of (a), identical on host and device: the LN'd tile Xs
// and the dpre2 tile Ds; the weight chunks, whose region the fp32 (T, C) dln
// tile Os reuses after loop 2; KS fp32 partial sums of the (T, HC) pre1 (Hf)
// and dhmid (Df) chunks; the bf16 (T, HC) dpre1 chunk Gs of loop 2; per-token
// LN mean and 1/std.
struct BwdLayout {
  int ldx, ldw2, ldh, ldg, ldo;
  size_t xs, ds, w1s, w2s, os, hf, df, gs, st, total;
};

__host__ __device__ inline BwdLayout make_bwd_layout(int C, int T, int HC, int KS) {
  BwdLayout L;
  L.ldx = C + 8;
  L.ldw2 = HC + 8;
  L.ldh = HC + 4;
  L.ldg = HC + 8;
  L.ldo = C + 4;
  const size_t x_b = align128(size_t(T) * L.ldx * 2);
  const size_t w1_b = align128(size_t(HC) * L.ldx * 2);
  const size_t w2_b = align128(size_t(C) * L.ldw2 * 2);
  const size_t o_b = align128(size_t(T) * L.ldo * 4);
  const size_t h_b = align128(size_t(KS) * T * L.ldh * 4);
  L.xs = 0;
  L.ds = x_b;
  L.w1s = 2 * x_b;
  L.w2s = L.w1s + w1_b;
  L.os = L.w1s;
  L.hf = L.w1s + ((w1_b + w2_b) > o_b ? (w1_b + w2_b) : o_b);
  L.df = L.hf + h_b;
  L.gs = L.df + h_b;
  L.st = L.gs + align128(size_t(T) * L.ldg * 2);
  L.total = L.st + align128(size_t(2 * T) * 4);
  return L;
}

template <bool BCOL>
__device__ __forceinline__ const bf16* bfrag(const bf16* B, int ldb, int k, int nb) {
  return BCOL ? B + nb * 16 * ldb + k * 16 : B + k * 16 * ldb + nb * 16;
}

// Hp (fp32, ld ldh) = A[:, k-blocks kb..ke) @ B for this warp's MT1 x NT1
// fragments at row block mb0 and column block nb0. A is a (T x K) bf16 tile,
// B a (K x HC) operand in shared memory, col-major (BCOL) or row-major. With
// fewer than four fragments, even and odd k-steps go to two accumulator sets.
template <int MT1, int NT1, bool BCOL>
__device__ __forceinline__ void hidden_product(const bf16* A, int lda, const bf16* B, int ldb,
                                               float* Hp, int ldh, int kb, int ke, int mb0,
                                               int nb0) {
  using FB = typename std::conditional<BCOL, FragB, FragBRow>::type;
  constexpr int NACC = MT1 * NT1 >= 4 ? 1 : 2;
  FragC c1[NACC][MT1][NT1];
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
        FragA a[MT1];
        FB b[NT1];
#pragma unroll
        for (int i = 0; i < MT1; ++i)
          wmma::load_matrix_sync(a[i], A + (mb0 + i) * 16 * lda + (k + p) * 16, lda);
#pragma unroll
        for (int jj = 0; jj < NT1; ++jj)
          wmma::load_matrix_sync(b[jj], bfrag<BCOL>(B, ldb, k + p, nb0 + jj), ldb);
#pragma unroll
        for (int i = 0; i < MT1; ++i)
#pragma unroll
          for (int jj = 0; jj < NT1; ++jj) wmma::mma_sync(c1[p][i][jj], a[i], b[jj], c1[p][i][jj]);
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

// acc += A @ B: A a (T x 16*KB) bf16 tile, B a row-major (16*KB x C)
// operand; this warp's MT2 row blocks from mb0 and nt2 column blocks from cb0.
template <int MT2, int NT2, int KB>
__device__ __forceinline__ void out_product(FragC (&acc)[MT2][NT2], const bf16* A, int lda,
                                            const bf16* B, int ldb, int mb0, int cb0, int nt2) {
#pragma unroll
  for (int kk = 0; kk < KB; ++kk) {
    FragA a[MT2];
#pragma unroll
    for (int i = 0; i < MT2; ++i) wmma::load_matrix_sync(a[i], A + (mb0 + i) * 16 * lda + kk * 16, lda);
#pragma unroll
    for (int jj = 0; jj < NT2; ++jj) {
      if (jj < nt2) {
        FragBRow b;
        wmma::load_matrix_sync(b, bfrag<false>(B, ldb, kk, cb0 + jj), ldb);
#pragma unroll
        for (int i = 0; i < MT2; ++i) wmma::mma_sync(acc[i][jj], a[i], b, acc[i][jj]);
      }
    }
  }
}

// T tokens per block, HC hidden units per chunk; the (T x HC) products on a
// Grid1<T, HC, MT1, NT1> warp grid, the (T x C) accumulators on a WM2 x WN2
// grid with MT2 row blocks and up to NT2 column blocks per warp. `partial`
// gets one row of hidden + 4C fp32 sums per block: db1, db2, dgamma, dln_s,
// dln_b.
template <int T, int HC, int MT1, int NT1, int MT2, int NT2, bool FAST>
__global__ void __launch_bounds__(kThreads, 1)
ln_mlp_bwd_dx_kernel(const bf16* __restrict__ h, const bf16* __restrict__ g,
                     const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                     const bf16* __restrict__ w1, const float* __restrict__ b1,
                     const bf16* __restrict__ w2, const float* __restrict__ b2,
                     const float* __restrict__ gamma, bf16* __restrict__ dx,
                     bf16* __restrict__ tok, bf16* __restrict__ hmid, bf16* dpre1,
                     float* __restrict__ partial, long long n, int C, int hidden, float eps) {
  using G1 = Grid1<T, HC, MT1, NT1>;
  constexpr int WM1 = G1::WM1, WN1 = G1::WN1, KS = G1::KS;
  constexpr int WM2 = T / 16 / MT2;
  constexpr int WN2 = kWarps / WM2;
  static_assert(WM2 * MT2 == T / 16 && WM2 * WN2 == kWarps, "second-product warp grid");

  extern __shared__ __align__(128) unsigned char smem[];
  const BwdLayout L = make_bwd_layout(C, T, HC, KS);
  bf16* Xs = reinterpret_cast<bf16*>(smem + L.xs);
  bf16* Ds = reinterpret_cast<bf16*>(smem + L.ds);
  bf16* W1s = reinterpret_cast<bf16*>(smem + L.w1s);
  bf16* W2s = reinterpret_cast<bf16*>(smem + L.w2s);
  float* Os = reinterpret_cast<float*>(smem + L.os);
  float* Hf = reinterpret_cast<float*>(smem + L.hf);
  float* Df = reinterpret_cast<float*>(smem + L.df);
  bf16* Gs = reinterpret_cast<bf16*>(smem + L.gs);
  float* Mu = reinterpret_cast<float*>(smem + L.st);
  float* Rs = Mu + T;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long row0 = static_cast<long long>(blockIdx.x) * T;
  const int nchunks = hidden / HC;
  const int segs = C / 8;
  float* prt = partial + static_cast<size_t>(blockIdx.x) * (hidden + 4 * C);

  auto load_w1 = [&](int j) {  // rows [j*HC, j*HC+HC) of W1 (hidden, C)
    const bf16* src = w1 + static_cast<size_t>(j) * HC * C;
    for (int i = tid; i < HC * segs; i += kThreads) {
      const int r = i / segs, s = i - r * segs;
      cp_async16(W1s + r * L.ldx + s * 8, src + static_cast<size_t>(r) * C + s * 8);
    }
  };
  auto load_w2 = [&](int j) {  // columns [j*HC, j*HC+HC) of W2 (C, hidden)
    constexpr int hsegs = HC / 8;
    for (int i = tid; i < C * hsegs; i += kThreads) {
      const int r = i / hsegs, s = i - r * hsegs;
      cp_async16(W2s + r * L.ldw2 + s * 8,
                 w2 + static_cast<size_t>(r) * hidden + static_cast<size_t>(j) * HC + s * 8);
    }
  };
  auto load_dpre1 = [&](int j) {  // this tile's dpre1 columns [j*HC, j*HC+HC), zeros past n
    constexpr int hsegs = HC / 8;
    for (int i = tid; i < T * hsegs; i += kThreads) {
      const int t = i / hsegs, s = i - t * hsegs;
      bf16* dst = Gs + t * L.ldg + s * 8;
      if (row0 + t < n)
        cp_async16(dst, dpre1 + (row0 + t) * hidden + static_cast<size_t>(j) * HC + s * 8);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  };

  load_w1(0);
  cp_commit();

  // LayerNorm (one warp per row, as in the forward) into Xs and tok; the
  // cotangent times gamma, rounded to bf16, into Ds. Rows past n are zeros,
  // so they add nothing to any sum below.
  for (int t = warp; t < T; t += kWarps) {
    uint4* xs = reinterpret_cast<uint4*>(Xs + t * L.ldx);
    uint4* ds = reinterpret_cast<uint4*>(Ds + t * L.ldx);
    const long long r = row0 + t;
    if (r < n) {
      const uint4* src = reinterpret_cast<const uint4*>(h + r * C);
      uint4 raw[kMaxSegs];
      float f[8];
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxSegs; ++q) {
        const int sg = lane + 32 * q;
        if (sg < segs) {
          raw[q] = src[sg];
          unpack8(raw[q], f);
#pragma unroll
          for (int e = 0; e < 8; ++e) s += f[e];
        }
      }
      const float mu = warp_sum(s) / C;
      float var = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxSegs; ++q) {
        if (lane + 32 * q < segs) {
          unpack8(raw[q], f);
#pragma unroll
          for (int e = 0; e < 8; ++e) var += (f[e] - mu) * (f[e] - mu);
        }
      }
      const float rstd = rsqrtf(warp_sum(var) / C + eps);
      if (lane == 0) {
        Mu[t] = mu;
        Rs[t] = rstd;
      }
      uint4* trow = reinterpret_cast<uint4*>(tok + r * C);
      const uint4* grow = reinterpret_cast<const uint4*>(g + r * C);
#pragma unroll
      for (int q = 0; q < kMaxSegs; ++q) {
        const int sg = lane + 32 * q;
        if (sg < segs) {
          unpack8(raw[q], f);
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = (f[e] - mu) * rstd * ln_s[sg * 8 + e] + ln_b[sg * 8 + e];
          const uint4 u = pack8(f);
          xs[sg] = u;
          trow[sg] = u;
          unpack8(grow[sg], f);
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] *= gamma[sg * 8 + e];
          ds[sg] = pack8(f);
        }
      }
    } else {
      for (int sg = lane; sg < segs; sg += 32) {
        xs[sg] = make_uint4(0u, 0u, 0u, 0u);
        ds[sg] = make_uint4(0u, 0u, 0u, 0u);
      }
      if (lane == 0) {
        Mu[t] = 0.f;
        Rs[t] = 0.f;
      }
    }
  }
  cp_wait<0>();
  __syncthreads();

  // warp tiles of the (T x HC) products
  const int wm1 = warp % WM1, wn1 = (warp / WM1) % WN1;
  const int ks = warp / (WM1 * WN1);
  const int k16 = C / 16;
  const int kb = ks * k16 / KS, ke = (ks + 1) * k16 / KS;
  float* Hk = Hf + ks * T * L.ldh;
  float* Dk = Df + ks * T * L.ldh;
  // warp tiles of the (T x C) accumulators
  const int cblocks = C / 16;
  const int wm2 = warp % WM2, wn2 = warp / WM2;
  const int cb0 = wn2 * cblocks / WN2;
  const int nt2 = (wn2 + 1) * cblocks / WN2 - cb0;

  // loop 1: pre1, GELU, dhmid, dpre1
  for (int j = 0; j < nchunks; ++j) {
    load_w2(j);
    cp_commit();
    hidden_product<MT1, NT1, true>(Xs, L.ldx, W1s, L.ldx, Hk, L.ldh, kb, ke, wm1 * MT1, wn1 * NT1);
    __syncthreads();  // pre1 partials complete; W1s free

    if (j + 1 < nchunks) load_w1(j + 1);
    cp_commit();

    // pre1 + b1 -> hmid (bf16, to HBM) and gelu'(pre1) (fp32, in Hf)
    for (int i = tid; i < T * HC; i += kThreads) {
      const int t = i / HC, c = i - t * HC;
      float v = b1[j * HC + c];
#pragma unroll
      for (int s = 0; s < KS; ++s) v += Hf[s * T * L.ldh + t * L.ldh + c];
      Hf[t * L.ldh + c] = gelu_grad<FAST>(v);
      if (row0 + t < n) hmid[(row0 + t) * hidden + j * HC + c] = __float2bfloat16(gelu<FAST>(v));
    }
    cp_wait<1>();  // W2 chunk j has landed (W1 chunk j+1 may still be in flight)
    __syncthreads();

    hidden_product<MT1, NT1, false>(Ds, L.ldx, W2s, L.ldw2, Dk, L.ldh, kb, ke, wm1 * MT1, wn1 * NT1);
    __syncthreads();  // dhmid partials complete

    // dpre1 = dhmid * gelu'(pre1): fp32 in Df for db1, bf16 to HBM
    for (int i = tid; i < T * HC; i += kThreads) {
      const int t = i / HC, c = i - t * HC;
      float d = 0.f;
#pragma unroll
      for (int s = 0; s < KS; ++s) d += Df[s * T * L.ldh + t * L.ldh + c];
      d *= Hf[t * L.ldh + c];
      Df[t * L.ldh + c] = d;
      if (row0 + t < n) dpre1[(row0 + t) * hidden + j * HC + c] = __float2bfloat16(d);
    }
    __syncthreads();
    for (int c = tid; c < HC; c += kThreads) {
      float s = 0.f;
      for (int t = 0; t < T; ++t) s += Df[t * L.ldh + c];
      prt[j * HC + c] = s;
    }
    cp_wait<0>();
    __syncthreads();  // W1 chunk j+1 visible; this chunk's buffers free
  }

  // db2 = sum g * gamma, and dgamma's b2 * sum g (the rest of dgamma is
  // sum_j W2 * G, added by half (b))
  for (int c = tid; c < C; c += kThreads) {
    const float gm = gamma[c];
    float sdb2 = 0.f, sg = 0.f;
    for (int t = 0; t < T && row0 + t < n; ++t) {
      const float gv = __bfloat162float(g[(row0 + t) * C + c]);
      sdb2 += gv * gm;
      sg += gv;
    }
    prt[hidden + c] = sdb2;
    prt[hidden + C + c] = sg * b2[c];
  }

  // loop 2: dln = dpre1 @ W1, accumulated over the hidden chunks
  FragC acc[MT2][NT2];
#pragma unroll
  for (int i = 0; i < MT2; ++i)
#pragma unroll
    for (int jj = 0; jj < NT2; ++jj) wmma::fill_fragment(acc[i][jj], 0.f);
  for (int j = 0; j < nchunks; ++j) {
    load_w1(j);
    load_dpre1(j);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    out_product<MT2, NT2, HC / 16>(acc, Gs, L.ldg, W1s, L.ldx, wm2 * MT2, cb0, nt2);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < MT2; ++i)
#pragma unroll
    for (int jj = 0; jj < NT2; ++jj)
      if (jj < nt2)
        wmma::store_matrix_sync(Os + (wm2 * MT2 + i) * 16 * L.ldo + (cb0 + jj) * 16, acc[i][jj],
                                L.ldo, wmma::mem_row_major);
  __syncthreads();

  // dln_s = sum dln * xhat, dln_b = sum dln
  for (int c = tid; c < C; c += kThreads) {
    float ss = 0.f, sb = 0.f;
    for (int t = 0; t < T && row0 + t < n; ++t) {
      const float xh = (__bfloat162float(h[(row0 + t) * C + c]) - Mu[t]) * Rs[t];
      const float d = Os[t * L.ldo + c];
      ss += d * xh;
      sb += d;
    }
    prt[hidden + 2 * C + c] = ss;
    prt[hidden + 3 * C + c] = sb;
  }
  // LN backward per token: dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
  for (int t = warp; t < T; t += kWarps) {
    const long long r = row0 + t;
    if (r >= n) break;
    const uint4* src = reinterpret_cast<const uint4*>(h + r * C);
    const float mu = Mu[t], rs = Rs[t];
    float xh[kMaxSegs][8], dh[kMaxSegs][8];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxSegs; ++q) {
      const int sg = lane + 32 * q;
      if (sg < segs) {
        float f[8];
        unpack8(src[sg], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          xh[q][e] = (f[e] - mu) * rs;
          dh[q][e] = Os[t * L.ldo + sg * 8 + e] * ln_s[sg * 8 + e];
          s1 += dh[q][e];
          s2 += dh[q][e] * xh[q][e];
        }
      }
    }
    const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
    uint4* dst = reinterpret_cast<uint4*>(dx + r * C);
#pragma unroll
    for (int q = 0; q < kMaxSegs; ++q) {
      const int sg = lane + 32 * q;
      if (sg < segs) {
        float f[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = rs * (dh[q][e] - m1 - xh[q][e] * m2);
        dst[sg] = pack8(f);
      }
    }
  }
}

int dx_tile(int C) { return C <= 256 ? 64 : C <= 512 ? 32 : 16; }

template <int T, int HC, int MT1, int NT1, int MT2, int NT2, bool FAST>
cudaError_t launch_dx(const bf16* h, const bf16* g, const float* ln_s, const float* ln_b,
                      const bf16* w1, const float* b1, const bf16* w2, const float* b2,
                      const float* gamma, bf16* dx, bf16* tok, bf16* hmid, bf16* dpre1,
                      float* partial, long long n, int C, int hidden, float eps,
                      cudaStream_t stream) {
  constexpr int KS = Grid1<T, HC, MT1, NT1>::KS;
  constexpr int WN2 = kWarps / (T / 16 / MT2);
  if (T != dx_tile(C) || (C / 16 + WN2 - 1) / WN2 > NT2 || hidden % HC) return cudaErrorInvalidValue;
  const BwdLayout L = make_bwd_layout(C, T, HC, KS);
  if (L.total > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = ln_mlp_bwd_dx_kernel<T, HC, MT1, NT1, MT2, NT2, FAST>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L.total));
  if (e != cudaSuccess) return e;
  const long long blocks = (n + T - 1) / T;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(blocks), kThreads, L.total, stream>>>(
      h, g, ln_s, ln_b, w1, b1, w2, b2, gamma, dx, tok, hmid, dpre1, partial, n, C, hidden, eps);
  return cudaGetLastError();
}

template <bool FAST>
cudaError_t dispatch_dx(const bf16* h, const bf16* g, const float* ln_s, const float* ln_b,
                        const bf16* w1, const float* b1, const bf16* w2, const float* b2,
                        const float* gamma, bf16* dx, bf16* tok, bf16* hmid, bf16* dpre1,
                        float* partial, long long n, int C, int hidden, float eps,
                        cudaStream_t st) {
  // <T, HC, (T x HC) tile MT1 x NT1, (T x C) tile MT2 x NT2, GELU>; T = dx_tile(C)
  if (C <= 256)
    return launch_dx<64, 64, 1, 2, 1, 8, FAST>(h, g, ln_s, ln_b, w1, b1, w2, b2, gamma, dx, tok,
                                               hmid, dpre1, partial, n, C, hidden, eps, st);
  if (C <= 512)
    return launch_dx<32, 32, 1, 1, 1, 8, FAST>(h, g, ln_s, ln_b, w1, b1, w2, b2, gamma, dx, tok,
                                               hmid, dpre1, partial, n, C, hidden, eps, st);
  if (C <= 768)
    return launch_dx<16, 32, 1, 1, 1, 6, FAST>(h, g, ln_s, ln_b, w1, b1, w2, b2, gamma, dx, tok,
                                               hmid, dpre1, partial, n, C, hidden, eps, st);
  return launch_dx<16, 16, 1, 1, 1, 8, FAST>(h, g, ln_s, ln_b, w1, b1, w2, b2, gamma, dx, tok,
                                             hmid, dpre1, partial, n, C, hidden, eps, st);
}

// ---------------------------------------------------------------- half (b)

constexpr int kWK = 32;        // tokens per pipeline stage
constexpr int kWLd = kWB + 8;  // bf16 row stride of a staged tile

// out[m][p] = sum over tokens t of this block's slice of A[t][m] * B[t][p],
// A (n, M) and B (n, P) bf16 row-major, out (M, P) fp32 row-major at slice
// blockIdx.y. 8 warps on a 2 x 4 grid, each a 64 x 32 tile (4 x 2 fragments).
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, float* __restrict__ out,
             long long n, int M, int P, long long per_slice) {
  __shared__ __align__(128) bf16 As[2][kWK][kWLd];
  __shared__ __align__(128) bf16 Bs[2][kWK][kWLd];
  const int tiles_p = (P + kWB - 1) / kWB;
  const int m0 = (blockIdx.x / tiles_p) * kWB, p0 = (blockIdx.x % tiles_p) * kWB;
  const long long t0 = static_cast<long long>(blockIdx.y) * per_slice;
  const long long t1 = t0 + per_slice < n ? t0 + per_slice : n;
  float* dst = out + static_cast<size_t>(blockIdx.y) * M * P;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp % 2, wp = warp / 2;

  auto stage = [&](int buf, long long k0) {
    constexpr int segs = kWB / 8;
    for (int i = tid; i < kWK * segs; i += kThreads) {
      const int r = i / segs, s = i - r * segs;
      const long long t = k0 + r;
      bf16* da = &As[buf][r][s * 8];
      bf16* db = &Bs[buf][r][s * 8];
      if (t < t1 && m0 + s * 8 < M) cp_async16(da, A + t * M + m0 + s * 8);
      else *reinterpret_cast<uint4*>(da) = make_uint4(0u, 0u, 0u, 0u);
      if (t < t1 && p0 + s * 8 < P) cp_async16(db, B + t * P + p0 + s * 8);
      else *reinterpret_cast<uint4*>(db) = make_uint4(0u, 0u, 0u, 0u);
    }
  };

  FragC acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) wmma::fill_fragment(acc[i][jj], 0.f);

  if (t0 < t1) stage(0, t0);
  cp_commit();
  int buf = 0;
  for (long long k0 = t0; k0 < t1; k0 += kWK) {
    if (k0 + kWK < t1) stage(buf ^ 1, k0 + kWK);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWK / 16; ++kk) {
      FragACol a[4];
      FragBRow b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (m0 + wm * 64 + i * 16 < M)
          wmma::load_matrix_sync(a[i], &As[buf][kk * 16][wm * 64 + i * 16], kWLd);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        if (p0 + wp * 32 + jj * 16 < P)
          wmma::load_matrix_sync(b[jj], &Bs[buf][kk * 16][wp * 32 + jj * 16], kWLd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          if (m0 + wm * 64 + i * 16 < M && p0 + wp * 32 + jj * 16 < P)
            wmma::mma_sync(acc[i][jj], a[i], b[jj], acc[i][jj]);
    }
    __syncthreads();
    buf ^= 1;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int m = m0 + wm * 64 + i * 16, p = p0 + wp * 32 + jj * 16;
      if (m < M && p < P)
        wmma::store_matrix_sync(dst + static_cast<size_t>(m) * P + p, acc[i][jj], P,
                                wmma::mem_row_major);
    }
}

// Row c of G = g^T hmid (C, hidden): dgamma[c] += sum_j W2[c][j] * G[c][j],
// then G[c][j] *= gamma[c], which makes it dW2. One block per row; the row's
// sum meets in a fixed order (warp butterflies, then the warps in turn).
__global__ void __launch_bounds__(kThreads)
dw2_finish_kernel(const bf16* __restrict__ w2, const float* __restrict__ gamma,
                  float* __restrict__ dw2, float* __restrict__ dgamma, int hidden) {
  __shared__ float red[kWarps];
  const int c = blockIdx.x;
  const float gm = gamma[c];
  float* row = dw2 + static_cast<size_t>(c) * hidden;
  const bf16* wrow = w2 + static_cast<size_t>(c) * hidden;
  float s = 0.f;
  for (int j = threadIdx.x; j < hidden; j += kThreads) {
    const float gv = row[j];
    s += __bfloat162float(wrow[j]) * gv;
    row[j] = gm * gv;
  }
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += red[w];
    dgamma[c] += t;
  }
}

// The workspace: the blocks' vector rows of (a), their first column-sum pass,
// and the slice partials of dW1 and G (when a product has more than one slice).
struct Work {
  long long blocks, row;
  Slices s1, s2;
  size_t rows, scratch, part1, part2, total;
};

Work plan(long long n, int C, int hidden) {
  Work w;
  w.blocks = (n + dx_tile(C) - 1) / dx_tile(C);
  w.row = hidden + 4LL * C;
  w.s1 = plan_slices(n, hidden, C);
  w.s2 = plan_slices(n, C, hidden);
  const long long parts = w.blocks > kChunk ? (w.blocks + kChunk - 1) / kChunk : 0;
  w.rows = 0;
  w.scratch = w.rows + align256(static_cast<size_t>(w.blocks * w.row) * 4);
  w.part1 = w.scratch + align256(static_cast<size_t>(parts * w.row) * 4);
  const size_t wsize = static_cast<size_t>(hidden) * C * 4;
  w.part2 = w.part1 + (w.s1.count > 1 ? align256(w.s1.count * wsize) : 0);
  w.total = w.part2 + (w.s2.count > 1 ? align256(w.s2.count * wsize) : 0);
  return w;
}

// out (M, P) = A^T B over all n tokens: slices in parallel, then their sum.
cudaError_t wgrad(const bf16* A, const bf16* B, float* out, float* part, long long n, int M,
                  int P, Slices s, cudaStream_t st) {
  const int tiles = ((M + kWB - 1) / kWB) * ((P + kWB - 1) / kWB);
  float* dst = s.count > 1 ? part : out;
  wgrad_kernel<<<dim3(tiles, static_cast<unsigned>(s.count)), kThreads, 0, st>>>(A, B, dst, n, M,
                                                                                P, s.per);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || s.count == 1) return e;
  return colsum(part, s.count, static_cast<long long>(M) * P, out, nullptr, st);
}

}  // namespace

extern "C" {

// Widths the kernel takes, as the forward's: C a multiple of 16 up to 1024
// and hidden a multiple of 64. Returns 1 when (C, hidden) is supported.
int imt_ln_mlp_bwd_supported(int C, int hidden) {
  return C > 0 && C % 16 == 0 && C <= 1024 && hidden > 0 && hidden % 64 == 0;
}

// Bytes of device workspace the two halves need for n tokens.
long long imt_ln_mlp_bwd_workspace_bytes(long long n, int C, int hidden) {
  if (!imt_ln_mlp_bwd_supported(C, hidden) || n <= 0) return 0;
  return static_cast<long long>(plan(n, C, hidden).total);
}

// Half (a). h and g (n, C) bf16, w1 (hidden, C) and w2 (C, hidden) bf16,
// vectors fp32. Writes dx, tok (n, C) bf16 and hmid, dpre1 (n, hidden) bf16,
// and the blocks' vector rows into `workspace` (of
// imt_ln_mlp_bwd_workspace_bytes). All contiguous and 16-byte aligned.
// gelu_fast selects the training GELU. Launches on `stream`; returns the
// launch status (a cudaError_t; 0 is success).
int imt_ln_mlp_bwd_dx_bf16(const void* h, const void* g, const void* ln_s, const void* ln_b,
                           const void* w1, const void* b1, const void* w2, const void* b2,
                           const void* gamma, void* dx, void* tok, void* hmid, void* dpre1,
                           void* workspace, long long n, int C, int hidden, float eps,
                           int gelu_fast, void* stream) {
  if (!imt_ln_mlp_bwd_supported(C, hidden) || n <= 0) return cudaErrorInvalidValue;
  float* partial = reinterpret_cast<float*>(static_cast<char*>(workspace) + plan(n, C, hidden).rows);
  auto* f = gelu_fast ? &dispatch_dx<true> : &dispatch_dx<false>;
  return f(static_cast<const bf16*>(h), static_cast<const bf16*>(g),
           static_cast<const float*>(ln_s), static_cast<const float*>(ln_b),
           static_cast<const bf16*>(w1), static_cast<const float*>(b1),
           static_cast<const bf16*>(w2), static_cast<const float*>(b2),
           static_cast<const float*>(gamma), static_cast<bf16*>(dx), static_cast<bf16*>(tok),
           static_cast<bf16*>(hmid), static_cast<bf16*>(dpre1), partial, n, C, hidden, eps,
           static_cast<cudaStream_t>(stream));
}

// Half (b), after (a) on the same stream, with (a)'s tok, hmid and dpre1, its
// workspace, and the cotangent g, w2 and gamma that (a) was given: dw1
// (hidden, C) and dw2 (C, hidden) fp32, and `vecs` (hidden + 4C fp32) = db1,
// db2, dgamma, dln_s, dln_b summed over the blocks of (a).
int imt_ln_mlp_bwd_wgrad_bf16(const void* tok, const void* hmid, const void* dpre1,
                              const void* g, const void* w2, const void* gamma, void* workspace,
                              void* dw1, void* dw2, void* vecs, long long n, int C, int hidden,
                              void* stream) {
  if (!imt_ln_mlp_bwd_supported(C, hidden) || n <= 0) return cudaErrorInvalidValue;
  const Work w = plan(n, C, hidden);
  char* ws = static_cast<char*>(workspace);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e = wgrad(static_cast<const bf16*>(dpre1), static_cast<const bf16*>(tok),
                        static_cast<float*>(dw1), reinterpret_cast<float*>(ws + w.part1), n,
                        hidden, C, w.s1, st);
  if (e != cudaSuccess) return e;
  e = wgrad(static_cast<const bf16*>(g), static_cast<const bf16*>(hmid),
            static_cast<float*>(dw2), reinterpret_cast<float*>(ws + w.part2), n, C, hidden, w.s2,
            st);
  if (e != cudaSuccess) return e;
  e = colsum(reinterpret_cast<const float*>(ws + w.rows), w.blocks, w.row,
             static_cast<float*>(vecs), reinterpret_cast<float*>(ws + w.scratch), st);
  if (e != cudaSuccess) return e;
  dw2_finish_kernel<<<C, kThreads, 0, st>>>(static_cast<const bf16*>(w2),
                                            static_cast<const float*>(gamma),
                                            static_cast<float*>(dw2),
                                            static_cast<float*>(vecs) + hidden + C, hidden);
  return cudaGetLastError();
}

const char* imt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
