// The fused ConvNeXt branch, backward, for Hopper (sm_90a): kernel 11.
//
// From x (B, H, W, C), the cotangent g of out = (GELU(LN(dwconv7(x) + dw_b)
// W1^T + b1) W2^T + b2) * gamma, and the parameters: dx, the tap and bias
// gradients of the depthwise conv, dln_s, dln_b, dW1, db1, dW2, db2, dgamma.
//
// Replaces the TPU kernel `_bwd_kernel` / `_branch_bwd_pallas` in
// imagenet_models_tpu/ops/convnext_branch.py (:95-191, :242-287).
//
// Numerics (the TPU kernel's, and `plain_convnext_branch_bwd`'s): the forward
// is recomputed from x, nothing being saved between the passes (conv in fp32,
// LayerNorm statistics in fp32); the tokens, the GELU output hmid, dpre2 =
// g * gamma and dpre1 = (dpre2 W2) * gelu'(pre1) are rounded to x's type as
// the products' operands, where the TPU kernel casts them; every product sums
// in fp32 (bf16 on wgmma, or fp32 as 3xTF32); gelu' is the derivative of the
// exact GELU with the A&S erf; the LayerNorm backward gives dh in fp32; dx
// is the correlation of dh with the flipped taps, in fp32, cast once; the
// tap gradient is the fp32 sum of fp32 products x * dh, and the bias
// gradient the sum of dh.
//
// bf16: kernel 2's pipeline (csrc/ln_mlp_bwd.cu) with the conv in front and
// behind, over one workspace:
//  (i')  ring::conv_ln_kernel<true> (convnext_branch_ring.cuh): the conv
//        recomputed from a ring of x rows in shared memory, LayerNorm, and
//        tok, x-hat (fp32), rstd, dpre2 = bf16(g * gamma) and the blocks'
//        partial sums of db2 and of dgamma's b2 * sum g;
//  (ii)-(iv) kernel 2's GEMM stages (ln_mlp_bwd_stages.cuh, shared, not
//        copied) with the A&S GELU and its derivative: hmid and dpre1, dln
//        and the LayerNorm backward, which ends in dh in fp32 over x-hat
//        (the twin feeds the fp32 dh to the conv's backward), and dW1 and G
//        = g^T hmid, with dW2 = gamma * G and dgamma = sum_j W2 * G + b2 *
//        sum g: five products, pre2 is never formed. So dW2 differs from the
//        twin's dpre2_c^T hmid_c by the one rounding of g * gamma, as kernel
//        2's does;
//  (v)   ring::conv_bwd_kernel: x (bf16) and dh (fp32) read once through a
//        ring, dx = bf16(the correlation of dh with the flipped taps), and
//        the blocks' partials of the 49 tap sums and of ddw_b = sum dh,
//        added in a fixed order (conv_bwd_finish_kernel).
// dh in fp32 is N C 4 bytes, written once by (iii) and read once by (v).
// What remains over the bound is kernel 2's (hmid and dpre1 written once
// and read three times, the GELU epilogue), the conv's three sets of 49
// fp32 multiply-adds per element (recomputed h, dx, taps) on the CUDA
// cores, and x-hat and dh's fp32 traffic.
//
// fp32: the first design's kernels, below, bit for bit.
//
// Why the fp32 path is not the TPU kernel. The TPU kernel adds every grid step's
// gradients into output blocks that stay resident, relying on steps that run
// in order. Hopper's blocks run in parallel in no order, and a block's 227 KB
// of shared memory holds neither W1 + W2 nor an fp32 dW partial. So the work
// is split, with no atomics, every sum taken in a fixed order (the same bits
// on every run):
//  (a) branch_bwd_tile_kernel, one block of 8 warps per tile of T tokens, as
//      kernel 2's half (a) (csrc/ln_mlp_bwd.cu) with the conv in front:
//      stage 1 recomputes the conv and LayerNorm per token (one warp each)
//      into the tile of tokens, and writes the tokens, x-hat (into the dh
//      scratch) and dpre2; loop 1 over hidden chunks recomputes pre1, GELU
//      and pre2 and computes dhmid and dpre1, writing hmid and dpre1; loop 2
//      reads its dpre1 back and sums dln = dpre1 W1; then the LayerNorm
//      backward per token writes dh over x-hat. Each block writes one fp32
//      row of partial sums: db1, db2, dgamma, dln_s, dln_b, and the bias
//      gradient (the sum of dh).
//  (b) dW1 = dpre1^T tok and dW2 = dpre2^T hmid, a hand-written tiled A^T B
//      over token slices (wgrad_kernel, as kernel 2's), then the slices'
//      partials and (a)'s rows summed column by column in a fixed order.
//  (c) dx = the correlation of dh with the flipped taps, one warp per token
//      (branch_dx_kernel); the 49 tap sums of x * dh with kernel 9's design
//      (csrc/dw7_wgrad.cu): a ring of x rows in shared memory, per-block
//      partials, then a fixed-order sum; fp32 products, not kernel 9's
//      bf16-rounded ones.
//
// What bounds it on the H100. This version runs six products of N x 4C x C
// (pre1, pre2, dhmid, dln in (a); dW1, dW2 in (b)). The function needs five:
// with G = g^T hmid, dW2 = gamma * G and dgamma = sum_j W2 * G + b2 * sum g,
// as kernel 2 takes them, so pre2 is never formed. Five are 40 N C^2 flops,
// far above the ~295 flop/byte balance: the tensor cores bound it (0.16 ms
// per launch at B=128 in bf16 at every stage). This version also writes and
// reads back hmid and dpre1 ((N, 4C) each) and dh and x-hat ((N, C) fp32),
// and streams W1 and W2 through every tile's shared memory, the traffic a
// later design removes.

#include "convnext_branch_common.cuh"
#include "convnext_branch_ring.cuh"
#include "ln_mlp_bwd_stages.cuh"
#include "wgrad_common.cuh"

namespace {

using namespace imt;
using namespace imt::branch;

constexpr int kBF16 = 0, kF32 = 1;  // operand type codes of the C interface

// ---------------------------------------------------------------- half (a)

// Shared-memory plan of (a), identical on host and device: the tile of tokens
// Xs and the dpre2 tile Ds; the weight chunks, whose region the fp32 (T, C)
// tile Os (pre2, then dln, then dh) reuses between the loops; KS fp32 partial
// sums of the (T, HC) pre1 (Hf) and dhmid (Df) chunks; the (T, HC) chunk Gs
// (hmid in loop 1, dpre1 in loop 2); per-token 1/std.
struct BwdLayout {
  int ldx, ldw2, ldh, ldg, ldo;
  size_t xs, ds, w1s, w2s, os, hf, df, gs, st, total;
};

template <typename E>
__host__ __device__ inline BwdLayout make_bwd_layout(int C, int T, int HC, int KS) {
  constexpr int P = Pad<E>::value;
  constexpr size_t es = sizeof(E);
  BwdLayout L;
  L.ldx = C + P;
  L.ldw2 = HC + P;
  L.ldh = HC + 4;
  L.ldg = HC + P;
  L.ldo = C + 4;
  const size_t x_b = align128(size_t(T) * L.ldx * es);
  const size_t w1_b = align128(size_t(HC) * L.ldx * es);
  const size_t w2_b = align128(size_t(C) * L.ldw2 * es);
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
  L.st = L.gs + align128(size_t(T) * L.ldg * es);
  L.total = L.st + align128(size_t(T) * 4);
  return L;
}

// T tokens per block, HC hidden units per chunk; the (T x HC) products on a
// Grid1<T, HC, MT1, NT1> warp grid, the (T x C) accumulators on a WM2 x WN2
// grid with MT2 row blocks and up to NT2 column blocks per warp. `partial`
// gets one row of hidden + 5C fp32 sums per block: db1, db2, dgamma, dln_s,
// dln_b, ddw_b. Q 4-channel units of a token row per lane. dpre1 and dh are
// written and read back by the block, so they are not restrict.
template <typename E, int T, int HC, int MT1, int NT1, int MT2, int NT2, int Q>
__global__ void __launch_bounds__(kThreads, 1)
branch_bwd_tile_kernel(const E* __restrict__ x, const E* __restrict__ g,
                       const float* __restrict__ taps, const float* __restrict__ dwb,
                       const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                       const E* __restrict__ w1, const float* __restrict__ b1,
                       const E* __restrict__ w2, const float* __restrict__ b2,
                       const float* __restrict__ gamma, E* __restrict__ tok,
                       E* __restrict__ hmid, E* dpre1, E* __restrict__ dpre2, float* dh,
                       float* __restrict__ partial, int H, int W, long long n, int C, int hidden,
                       float eps) {
  typedef Mma<E> M;
  using G1 = Grid1<T, HC, MT1, NT1>;
  constexpr int WM1 = G1::WM1, WN1 = G1::WN1, KS = G1::KS;
  constexpr int WM2 = T / 16 / MT2;
  constexpr int WN2 = kWarps / WM2;
  constexpr int V = 16 / static_cast<int>(sizeof(E));
  static_assert(WM2 * MT2 == T / 16 && WM2 * WN2 == kWarps, "second-product warp grid");
  static_assert(HC % M::K == 0, "hidden chunk of whole k-steps");

  extern __shared__ __align__(128) unsigned char smem[];
  const BwdLayout L = make_bwd_layout<E>(C, T, HC, KS);
  E* Xs = reinterpret_cast<E*>(smem + L.xs);
  E* Ds = reinterpret_cast<E*>(smem + L.ds);
  E* W1s = reinterpret_cast<E*>(smem + L.w1s);
  E* W2s = reinterpret_cast<E*>(smem + L.w2s);
  float* Os = reinterpret_cast<float*>(smem + L.os);
  float* Hf = reinterpret_cast<float*>(smem + L.hf);
  float* Df = reinterpret_cast<float*>(smem + L.df);
  E* Gs = reinterpret_cast<E*>(smem + L.gs);
  float* Rs = reinterpret_cast<float*>(smem + L.st);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long row0 = static_cast<long long>(blockIdx.x) * T;
  const int nchunks = hidden / HC;
  const int U = C / 4;
  float* prt = partial + static_cast<size_t>(blockIdx.x) * (hidden + 5 * C);

  copy_rows(W1s, L.ldx, w1, C, HC, C, tid);  // W1 chunk 0
  cp_commit();

  // stage 1: conv and LayerNorm per token into Xs and tok, x-hat into the dh
  // scratch, dpre2 = g * gamma in x's type into Ds and dpre2. Rows past n
  // are zeros, so they add nothing to any product below.
  for (int t = warp; t < T; t += kWarps) {
    E* xs = Xs + t * L.ldx;
    E* ds = Ds + t * L.ldx;
    const long long r = row0 + t;
    if (r < n) {
      float h[Q][4];
      dw_token<Q, false>(x, taps, dwb, r, H, W, C, lane, h);
      const float2 st = ln_stats(h, C, lane, eps);
      if (lane == 0) Rs[t] = st.y;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int u = lane + 32 * q;
        if (u < U) {
          float xh[4], tk[4], gv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            xh[e] = (h[q][e] - st.x) * st.y;
            tk[e] = xh[e] * __ldg(ln_s + 4 * u + e) + __ldg(ln_b + 4 * u + e);
          }
          store4(xs + 4 * u, tk);
          store4(tok + r * C + 4 * u, tk);
          store4(dh + r * C + 4 * u, xh);
          load4(g + r * C + 4 * u, gv);
#pragma unroll
          for (int e = 0; e < 4; ++e) gv[e] *= __ldg(gamma + 4 * u + e);
          store4(ds + 4 * u, gv);
          store4(dpre2 + r * C + 4 * u, gv);
        }
      }
    } else {
      for (int u = lane; u < U; u += 32) {
        zero4(xs + 4 * u);
        zero4(ds + 4 * u);
      }
      if (lane == 0) Rs[t] = 0.f;
    }
  }
  cp_wait<0>();
  __syncthreads();

  // warp tiles of the (T x HC) products
  const int wm1 = warp % WM1, wn1 = (warp / WM1) % WN1;
  const int ks = warp / (WM1 * WN1);
  const int ksteps = C / M::K;
  const int kb = ks * ksteps / KS, ke = (ks + 1) * ksteps / KS;
  float* Hk = Hf + ks * T * L.ldh;
  float* Dk = Df + ks * T * L.ldh;
  // warp tiles of the (T x C) accumulators
  const int cblocks = C / 16;
  const int wm2 = warp % WM2, wn2 = warp / WM2;
  const int cb0 = wn2 * cblocks / WN2;
  const int nt2 = (wn2 + 1) * cblocks / WN2 - cb0;

  // loop 1: pre1, GELU, pre2, dhmid, dpre1
  typename M::Acc acc[MT2][NT2];
  zero_acc<E, MT2, NT2>(acc);
  for (int j = 0; j < nchunks; ++j) {
    copy_rows(W2s, L.ldw2, w2 + static_cast<size_t>(j) * HC, hidden, C, HC, tid);  // W2 chunk j
    cp_commit();
    hidden_product<E, MT1, NT1, true>(Xs, L.ldx, W1s, L.ldx, Hk, L.ldh, kb, ke, wm1 * MT1,
                                      wn1 * NT1);
    __syncthreads();  // pre1 partials complete; W1s free

    if (j + 1 < nchunks) copy_rows(W1s, L.ldx, w1 + static_cast<size_t>(j + 1) * HC * C, C, HC, C, tid);
    cp_commit();

    // pre1 + b1 -> hmid in x's type (Gs and HBM) and gelu'(pre1) in fp32 (Hf)
    for (int i = tid; i < T * HC; i += kThreads) {
      const int t = i / HC, c = i - t * HC;
      float v = __ldg(b1 + j * HC + c);
#pragma unroll
      for (int s = 0; s < KS; ++s) v += Hf[s * T * L.ldh + t * L.ldh + c];
      Hf[t * L.ldh + c] = gelu_grad_as(v);
      const E hm = to_elem<E>(gelu_as(v));
      Gs[t * L.ldg + c] = hm;
      if (row0 + t < n) hmid[(row0 + t) * hidden + j * HC + c] = hm;
    }
    cp_wait<1>();  // W2 chunk j has landed (W1 chunk j+1 may still be in flight)
    __syncthreads();

    hidden_product<E, MT1, NT1, false>(Ds, L.ldx, W2s, L.ldw2, Dk, L.ldh, kb, ke, wm1 * MT1,
                                       wn1 * NT1);                                 // dhmid
    out_product<E, MT2, NT2, HC / M::K, true>(acc, Gs, L.ldg, W2s, L.ldw2, wm2 * MT2, cb0, nt2);  // pre2
    __syncthreads();  // dhmid partials complete

    // dpre1 = dhmid * gelu'(pre1): fp32 in Df for db1, x's type to HBM
    for (int i = tid; i < T * HC; i += kThreads) {
      const int t = i / HC, c = i - t * HC;
      float d = 0.f;
#pragma unroll
      for (int s = 0; s < KS; ++s) d += Df[s * T * L.ldh + t * L.ldh + c];
      d *= Hf[t * L.ldh + c];
      Df[t * L.ldh + c] = d;
      if (row0 + t < n) dpre1[(row0 + t) * hidden + j * HC + c] = to_elem<E>(d);
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

  // db2 = sum g * gamma and dgamma = sum g * (pre2 + b2), pre2 through Os
  store_acc<E, MT2, NT2>(acc, Os, L.ldo, wm2 * MT2, cb0, nt2);
  __syncthreads();
  for (int c = tid; c < C; c += kThreads) {
    const float gm = __ldg(gamma + c), bb = __ldg(b2 + c);
    float sdb2 = 0.f, sdg = 0.f;
    for (int t = 0; t < T && row0 + t < n; ++t) {
      const float gv = to_float(g[(row0 + t) * C + c]);
      sdb2 += gv * gm;
      sdg += gv * (Os[t * L.ldo + c] + bb);
    }
    prt[hidden + c] = sdb2;
    prt[hidden + C + c] = sdg;
  }
  __syncthreads();  // Os read; loop 2 loads W1 over it

  // loop 2: dln = dpre1 @ W1, accumulated over the hidden chunks
  zero_acc<E, MT2, NT2>(acc);
  for (int j = 0; j < nchunks; ++j) {
    copy_rows(W1s, L.ldx, w1 + static_cast<size_t>(j) * HC * C, C, HC, C, tid);
    for (int i = tid; i < T * (HC / V); i += kThreads) {  // this tile's dpre1 chunk, zeros past n
      const int t = i / (HC / V), s = i - t * (HC / V);
      E* dst = Gs + t * L.ldg + s * V;
      if (row0 + t < n)
        cp_async16(dst, dpre1 + (row0 + t) * hidden + static_cast<size_t>(j) * HC + s * V);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    out_product<E, MT2, NT2, HC / M::K, false>(acc, Gs, L.ldg, W1s, L.ldx, wm2 * MT2, cb0, nt2);
    __syncthreads();
  }
  store_acc<E, MT2, NT2>(acc, Os, L.ldo, wm2 * MT2, cb0, nt2);
  __syncthreads();

  // dln_s = sum dln * x-hat, dln_b = sum dln (x-hat from the dh scratch)
  for (int c = tid; c < C; c += kThreads) {
    float ss = 0.f, sb = 0.f;
    for (int t = 0; t < T && row0 + t < n; ++t) {
      const float d = Os[t * L.ldo + c];
      ss += d * dh[(row0 + t) * C + c];
      sb += d;
    }
    prt[hidden + 2 * C + c] = ss;
    prt[hidden + 3 * C + c] = sb;
  }
  __syncthreads();  // x-hat read; the LN backward writes dh over it

  // LN backward per token: dh = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)),
  // dxhat = dln * ln_s; into the dh scratch and Os
  for (int t = warp; t < T; t += kWarps) {
    const long long r = row0 + t;
    if (r >= n) break;
    const float rs = Rs[t];
    float xh[Q][4], dxh[Q][4];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int u = lane + 32 * q;
      if (u < U) {
        load4_rw(dh + r * C + 4 * u, xh[q]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dxh[q][e] = Os[t * L.ldo + 4 * u + e] * __ldg(ln_s + 4 * u + e);
          s1 += dxh[q][e];
          s2 += dxh[q][e] * xh[q][e];
        }
      }
    }
    const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int u = lane + 32 * q;
      if (u < U) {
        float f[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          f[e] = rs * (dxh[q][e] - m1 - xh[q][e] * m2);
          Os[t * L.ldo + 4 * u + e] = f[e];
        }
        store4(dh + r * C + 4 * u, f);
      }
    }
  }
  __syncthreads();
  for (int c = tid; c < C; c += kThreads) {  // ddw_b = sum dh
    float s = 0.f;
    for (int t = 0; t < T && row0 + t < n; ++t) s += Os[t * L.ldo + c];
    prt[hidden + 4 * C + c] = s;
  }
}

// Tokens per tile of (a) (the launch checks its T).
constexpr int kTileTokens = 16;

struct TileArgs {
  const void *x, *g, *taps, *dwb, *ln_s, *ln_b, *w1, *b1, *w2, *b2, *gamma;
  void *tok, *hmid, *dpre1, *dpre2, *dh, *partial;
  int H, W;
  long long n;
  int C, hidden;
  float eps;
  cudaStream_t stream;
};

template <typename E, int T, int HC, int MT1, int NT1, int MT2, int NT2, int Q>
cudaError_t launch_tile(const TileArgs& a, bool check) {
  constexpr int KS = Grid1<T, HC, MT1, NT1>::KS;
  constexpr int WN2 = kWarps / (T / 16 / MT2);
  if (T != kTileTokens || (a.C / 16 + WN2 - 1) / WN2 > NT2 || a.hidden % HC ||
      units_per_lane(a.C) > Q)
    return cudaErrorInvalidValue;
  const BwdLayout L = make_bwd_layout<E>(a.C, T, HC, KS);
  if (L.total > kMaxSmem) return cudaErrorInvalidValue;
  if (check) return cudaSuccess;
  auto kern = branch_bwd_tile_kernel<E, T, HC, MT1, NT1, MT2, NT2, Q>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L.total));
  if (e == cudaSuccess) e = prefer_l1(reinterpret_cast<const void*>(kern), L.total);
  if (e != cudaSuccess) return e;
  const long long blocks = (a.n + T - 1) / T;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(blocks), kThreads, L.total, a.stream>>>(
      static_cast<const E*>(a.x), static_cast<const E*>(a.g), static_cast<const float*>(a.taps),
      static_cast<const float*>(a.dwb), static_cast<const float*>(a.ln_s),
      static_cast<const float*>(a.ln_b), static_cast<const E*>(a.w1),
      static_cast<const float*>(a.b1), static_cast<const E*>(a.w2),
      static_cast<const float*>(a.b2), static_cast<const float*>(a.gamma), static_cast<E*>(a.tok),
      static_cast<E*>(a.hmid), static_cast<E*>(a.dpre1), static_cast<E*>(a.dpre2),
      static_cast<float*>(a.dh), static_cast<float*>(a.partial), a.H, a.W, a.n, a.C, a.hidden,
      a.eps);
  return cudaGetLastError();
}

// <type, T, HC, (T x HC) tile MT1 x NT1, (T x C) tile MT2 x NT2, units per
// lane Q>: fp32 one small tile at every width. (bf16 runs run_bf16.)
cudaError_t dispatch_tile(const TileArgs& a, bool check) {
  return launch_tile<float, 16, 16, 1, 1, 1, 8, 8>(a, check);
}

// ---------------------------------------------------------------- half (b)

// out[m][p] = sum over tokens t of this block's slice of A[t][m] * B[t][p],
// A (n, M) and B (n, P) row-major, out (M, P) fp32 row-major at slice
// blockIdx.y. 8 warps on a 2 x 4 grid, each a 64 x 32 tile (4 x 2 fragments);
// a double-buffered cp.async ring of KW-token stages (64 bytes of a column).
template <typename E>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const E* __restrict__ A, const E* __restrict__ B, float* __restrict__ out,
             long long n, int M, int P, long long per_slice) {
  typedef Mma<E> MM;
  typedef typename MM::template Op<typename MM::ACol> OA;
  typedef typename MM::template Op<typename MM::BRow> OB;
  constexpr int KW = 64 / static_cast<int>(sizeof(E));
  constexpr int LD = kWB + Pad<E>::value;
  constexpr int V = 16 / static_cast<int>(sizeof(E));
  __shared__ __align__(128) E As[2][KW][LD];
  __shared__ __align__(128) E Bs[2][KW][LD];
  const int tiles_p = (P + kWB - 1) / kWB;
  const int m0 = (blockIdx.x / tiles_p) * kWB, p0 = (blockIdx.x % tiles_p) * kWB;
  const long long t0 = static_cast<long long>(blockIdx.y) * per_slice;
  const long long t1 = t0 + per_slice < n ? t0 + per_slice : n;
  float* dst = out + static_cast<size_t>(blockIdx.y) * M * P;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp % 2, wp = warp / 2;

  auto stage = [&](int buf, long long k0) {
    constexpr int segs = kWB / V;
    for (int i = tid; i < KW * segs; i += kThreads) {
      const int r = i / segs, s = i - r * segs;
      const long long t = k0 + r;
      E* da = &As[buf][r][s * V];
      E* db = &Bs[buf][r][s * V];
      if (t < t1 && m0 + s * V < M) cp_async16(da, A + t * M + m0 + s * V);
      else *reinterpret_cast<uint4*>(da) = make_uint4(0u, 0u, 0u, 0u);
      if (t < t1 && p0 + s * V < P) cp_async16(db, B + t * P + p0 + s * V);
      else *reinterpret_cast<uint4*>(db) = make_uint4(0u, 0u, 0u, 0u);
    }
  };

  typename MM::Acc acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) wmma::fill_fragment(acc[i][jj], 0.f);

  if (t0 < t1) stage(0, t0);
  cp_commit();
  int buf = 0;
  for (long long k0 = t0; k0 < t1; k0 += KW) {
    if (k0 + KW < t1) stage(buf ^ 1, k0 + KW);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KW / MM::K; ++kk) {
      OA a[4];
      OB b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (m0 + wm * 64 + i * 16 < M) MM::load(a[i], &As[buf][kk * MM::K][wm * 64 + i * 16], LD);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        if (p0 + wp * 32 + jj * 16 < P) MM::load(b[jj], &Bs[buf][kk * MM::K][wp * 32 + jj * 16], LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          if (m0 + wm * 64 + i * 16 < M && p0 + wp * 32 + jj * 16 < P) MM::mma(acc[i][jj], a[i], b[jj]);
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

// out (M, P) = A^T B over all n tokens: slices in parallel, then their sum.
template <typename E>
cudaError_t wgrad(const E* A, const E* B, float* out, float* part, long long n, int M, int P,
                  Slices s, cudaStream_t st) {
  const int tiles = ((M + kWB - 1) / kWB) * ((P + kWB - 1) / kWB);
  float* dst = s.count > 1 ? part : out;
  wgrad_kernel<E><<<dim3(tiles, static_cast<unsigned>(s.count)), kThreads, 0, st>>>(A, B, dst, n, M,
                                                                                   P, s.per);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || s.count == 1) return e;
  return colsum(part, s.count, static_cast<long long>(M) * P, out, nullptr, st);
}

// ---------------------------------------------------------------- half (c)

// dx = the correlation of dh with the flipped taps, one warp per token, fp32
// sums, one cast to x's type; Q 4-channel units per lane.
template <typename E, int Q>
__global__ void __launch_bounds__(kThreads)
branch_dx_kernel(const float* __restrict__ dh, const float* __restrict__ taps, E* __restrict__ dx,
                 int H, int W, long long n, int C) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (r >= n) return;
  float acc[Q][4];
  dw_token<Q, true>(dh, taps, static_cast<const float*>(nullptr), r, H, W, C, lane, acc);
  const int U = C / 4;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int u = lane + 32 * q;
    if (u < U) store4(dx + r * C + 4 * u, acc[q]);
  }
}

template <typename E, int Q>
cudaError_t launch_dx(const float* dh, const float* taps, E* dx, int H, int W, long long n, int C,
                      cudaStream_t st) {
  branch_dx_kernel<E, Q><<<static_cast<unsigned>((n + kWarps - 1) / kWarps), kThreads, 0, st>>>(
      dh, taps, dx, H, W, n, C);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch_dx(const float* dh, const float* taps, E* dx, int H, int W, long long n, int C,
                        cudaStream_t st) {
  switch (units_per_lane(C)) {
    case 1: return launch_dx<E, 1>(dh, taps, dx, H, W, n, C, st);
    case 2: return launch_dx<E, 2>(dh, taps, dx, H, W, n, C, st);
    case 3: return launch_dx<E, 3>(dh, taps, dx, H, W, n, C, st);
    case 4: return launch_dx<E, 4>(dh, taps, dx, H, W, n, C, st);
    case 5:
    case 6: return launch_dx<E, 6>(dh, taps, dx, H, W, n, C, st);
    default: return launch_dx<E, 8>(dh, taps, dx, H, W, n, C, st);
  }
}

// The tap gradient dw[c][ky][kx] = sum over (b, h, w) of x[b, h + ky - 3,
// w + kx - 3, c] * dh[b, h, w, c] (x zero outside the map), kernel 9's design
// (csrc/dw7_wgrad.cu) with x of the branch's type and dh fp32: a block takes
// 32 channels x 32 output columns and a slice of consecutive output rows, one
// warp per kernel row ky; lane l of a warp's half owns channel pair l, the
// halves take alternate columns, and each thread keeps the 7 tap sums (ky,
// 0..6) of its pair in fp32 registers. The 7 x rows an output row needs (with
// a 3-column border) sit in a ring in shared memory; moving down one row
// loads one new x row and the dh row beside them, issued before the current
// row's products. Products are fp32 (fmaf). The two column lanes meet in a
// shuffle; each block writes its 49 x 32 partial sums once, and a second pass
// adds the blocks' partials in a fixed order.
namespace tapgrad {

constexpr int K = 7, R = 3, TAPS = K * K;
constexpr int CT = 32;              // channels per block
constexpr int PAIRS = CT / 2;       // channel-pair lanes of a warp's half
constexpr int WL = 2;               // column lanes: the two halves of a warp
constexpr int THREADS = PAIRS * WL * K;  // one warp per kernel row ky
constexpr int TW = 32;              // output columns per block
constexpr int SW = TW + 2 * R;      // x columns of a ring row
constexpr int kBlocksTarget = 1056; // 8 blocks per SM of 132
constexpr int kMinRows = 4;         // output rows per slice, at the least
constexpr int kMaxSlices = 65535;   // gridDim.z

template <typename E>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};

__device__ __forceinline__ float2 widen(float2 p) { return p; }

struct Plan {
  int ctiles, wtiles, slices, rows_per_slice;
};

Plan make_plan(int B, int H, int W, int C) {
  Plan p;
  p.ctiles = (C + CT - 1) / CT;
  p.wtiles = (W + TW - 1) / TW;
  const long long rows = static_cast<long long>(B) * H;
  const long long per = static_cast<long long>(p.ctiles) * p.wtiles;
  long long s = (kBlocksTarget + per - 1) / per;
  const long long most = (rows + kMinRows - 1) / kMinRows;
  if (s > most) s = most;
  if (s > kMaxSlices) s = kMaxSlices;
  if (s < 1) s = 1;
  const long long rps = (rows + s - 1) / s;
  p.rows_per_slice = static_cast<int>(rps);
  p.slices = static_cast<int>((rows + rps - 1) / rps);
  return p;
}

// The i-th 16-byte vector of ring row hx of image b (x columns w0 - 3 ..
// w0 + TW + 2, channels c0 .. c0 + CT - 1), zeros outside the map.
template <typename E>
__device__ __forceinline__ uint4 x_vector(const E* __restrict__ x, int b, int hx, int H, int W,
                                          int C, int w0, int c0, int i) {
  constexpr int VEC = 16 / sizeof(E), VPC = CT / VEC;
  const int wx = w0 - R + i / VPC, cc = c0 + (i % VPC) * VEC;
  if (i < SW * VPC && hx >= 0 && hx < H && wx >= 0 && wx < W && cc < C)
    return __ldg(reinterpret_cast<const uint4*>(
        x + ((static_cast<long long>(b) * H + hx) * W + wx) * C + cc));
  return make_uint4(0u, 0u, 0u, 0u);
}

// The i-th 16-byte vector of dh row h of image b (columns w0 .. w0 + TW - 1,
// channels c0 .. c0 + CT - 1), zeros outside the map.
__device__ __forceinline__ uint4 dh_vector(const float* __restrict__ dh, int b, int h, int H, int W,
                                           int C, int w0, int c0, int i) {
  constexpr int VEC = 4, VPC = CT / VEC;
  const int w = w0 + i / VPC, cc = c0 + (i % VPC) * VEC;
  if (i < TW * VPC && w < W && cc < C)
    return __ldg(reinterpret_cast<const uint4*>(
        dh + ((static_cast<long long>(b) * H + h) * W + w) * C + cc));
  return make_uint4(0u, 0u, 0u, 0u);
}

// Pass 1: partials is (slices * wtiles, 49, C) fp32, one slab per block
// column (w tile) and row slice.
template <typename E>
__global__ void __launch_bounds__(THREADS)
partials_kernel(const E* __restrict__ x, const float* __restrict__ dh, int H, int W, int C,
                long long rows, int rows_per_slice, float* __restrict__ partials) {
  using P = typename Pair<E>::type;
  constexpr int XVEC = 16 / sizeof(E);                      // x elements per 16-byte load
  constexpr int XVPC = CT / XVEC;                           // 16-byte loads per x column
  constexpr int DVEC = 4, DVPC = CT / DVEC;                 // the same for dh
  constexpr int NV = (SW * XVPC + THREADS - 1) / THREADS;   // of an x row, per thread
  constexpr int ND = (TW * DVPC + THREADS - 1) / THREADS;   // of a dh row, per thread
  constexpr int NC = TW / WL;                               // columns per thread
  __shared__ __align__(16) E xs[K][SW][CT];
  __shared__ __align__(16) float dhs[TW][CT];

  const int c0 = blockIdx.x * CT;
  const int w0 = blockIdx.y * TW;
  const long long r0 = static_cast<long long>(blockIdx.z) * rows_per_slice;
  const long long r1 = r0 + rows_per_slice < rows ? r0 + rows_per_slice : rows;
  const int tid = threadIdx.x;
  const int pair = tid % PAIRS;
  const int lane_w = (tid / PAIRS) % WL;
  const int ky = tid / (PAIRS * WL);
  const int c = c0 + 2 * pair;  // C % 16 == 0: c < C implies c + 1 < C
  const int wn = W - w0;        // the block's columns inside the map

  auto store_x = [&](int hx, const uint4* v) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = tid + k * THREADS;
      if (i < SW * XVPC)
        *reinterpret_cast<uint4*>(&xs[(hx + 2 * K) % K][i / XVPC][(i % XVPC) * XVEC]) = v[k];
    }
  };
  auto store_dh = [&](const uint4* v) {
#pragma unroll
    for (int k = 0; k < ND; ++k) {
      const int i = tid + k * THREADS;
      if (i < TW * DVPC) *reinterpret_cast<uint4*>(&dhs[i / DVPC][(i % DVPC) * DVEC]) = v[k];
    }
  };
  auto fill = [&](int b, int h) {  // the 7 x rows and the dh row of output row h
    uint4 v[NV > ND ? NV : ND];
    for (int hx = h - R; hx <= h + R; ++hx) {
#pragma unroll
      for (int k = 0; k < NV; ++k) v[k] = x_vector(x, b, hx, H, W, C, w0, c0, tid + k * THREADS);
      store_x(hx, v);
    }
#pragma unroll
    for (int k = 0; k < ND; ++k) v[k] = dh_vector(dh, b, h, H, W, C, w0, c0, tid + k * THREADS);
    store_dh(v);
  };

  float2 acc[K];
#pragma unroll
  for (int t = 0; t < K; ++t) acc[t] = make_float2(0.f, 0.f);

  int b = static_cast<int>(r0 / H);
  int h = static_cast<int>(r0 - static_cast<long long>(b) * H);
  if (r0 < r1) fill(b, h);
  __syncthreads();
  for (long long r = r0; r < r1; ++r) {
    // issue the next row's loads
    const bool more = r + 1 < r1;
    const int bn = h + 1 == H ? b + 1 : b, hn = h + 1 == H ? 0 : h + 1;
    const bool same = more && bn == b;  // the next row needs one new x row
    uint4 xn[NV], dn[ND];
#pragma unroll
    for (int k = 0; k < NV; ++k)
      xn[k] = same ? x_vector(x, b, hn + R, H, W, C, w0, c0, tid + k * THREADS)
                   : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int k = 0; k < ND; ++k)
      dn[k] = same ? dh_vector(dh, bn, hn, H, W, C, w0, c0, tid + k * THREADS)
                   : make_uint4(0u, 0u, 0u, 0u);
    // this row's products: x row h + ky - 3 against the dh row
    if (c < C) {
      const P* xr = reinterpret_cast<const P*>(&xs[(h + ky - R + 2 * K) % K][0][0]) + pair;
      const float2* gr = reinterpret_cast<const float2*>(&dhs[0][0]) + pair;
      // x columns wl .. wl + 6 of this thread's column wl in registers; the
      // next column (wl + 2) keeps five of them and loads two
      P win[K];
#pragma unroll
      for (int k = 0; k < K; ++k) win[k] = xr[(lane_w + k) * PAIRS];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int wl = lane_w + WL * j;
        if (wl >= wn) break;
        const float2 gv = gr[wl * PAIRS];
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          const float2 xv = widen(win[kx]);
          acc[kx].x = fmaf(xv.x, gv.x, acc[kx].x);
          acc[kx].y = fmaf(xv.y, gv.y, acc[kx].y);
        }
        if (j + 1 < NC) {
#pragma unroll
          for (int k = 0; k < K - WL; ++k) win[k] = win[k + WL];
#pragma unroll
          for (int k = K - WL; k < K; ++k) win[k] = xr[(wl + WL + k) * PAIRS];
        }
      }
    }
    __syncthreads();  // every thread is done with the rows being replaced
    if (same) {
      store_x(hn + R, xn);  // x row h + 4 takes the slot of h - 3
      store_dh(dn);
    } else if (more) {
      fill(bn, hn);
    }
    __syncthreads();
    b = bn;
    h = hn;
  }

  // The two column lanes of a channel pair and kernel row, by a shuffle;
  // lanes 0-15 then hold the block's 7 tap sums (ky, 0..6) of their pair.
#pragma unroll
  for (int t = 0; t < K; ++t) {
    acc[t].x += __shfl_down_sync(0xffffffffu, acc[t].x, 16);
    acc[t].y += __shfl_down_sync(0xffffffffu, acc[t].y, 16);
  }
  if (lane_w == 0 && c < C) {
    float* out =
        partials + (static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) * TAPS * C;
#pragma unroll
    for (int kx = 0; kx < K; ++kx)
      *reinterpret_cast<float2*>(out + static_cast<long long>(ky * K + kx) * C + c) = acc[kx];
  }
}

// Pass 2: dw[c][t] = the sum over every slab s of partials[s][t][c], in a
// fixed order: a block per tap and 32 channels, its FG rows of threads each
// adding every FG-th slab (four running sums, then their pairs), the FG rows
// then added in order.
constexpr int FG = 8;

__global__ void __launch_bounds__(32 * FG)
finalize_kernel(const float* __restrict__ partials, int slabs, int C, float* __restrict__ dw) {
  __shared__ float red[FG][32];
  const int t = blockIdx.x, c = blockIdx.y * 32 + threadIdx.x, row = threadIdx.y;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  if (c < C) {
    const long long stride = static_cast<long long>(TAPS) * C;
    const float* p = partials + static_cast<long long>(t) * C + c;
    int i = row;
    for (; i + 3 * FG < slabs; i += 4 * FG) {
      s0 += p[i * stride];
      s1 += p[(i + FG) * stride];
      s2 += p[(i + 2 * FG) * stride];
      s3 += p[(i + 3 * FG) * stride];
    }
    for (; i < slabs; i += FG) s0 += p[i * stride];
  }
  red[row][threadIdx.x] = (s0 + s1) + (s2 + s3);
  __syncthreads();
  if (row == 0 && c < C) {
    float total = 0.f;
#pragma unroll
    for (int r = 0; r < FG; ++r) total += red[r][threadIdx.x];
    dw[static_cast<long long>(c) * TAPS + t] = total;
  }
}

template <typename E>
cudaError_t run(const void* x, const float* dh, int B, int H, int W, int C, float* partials,
                float* dw, cudaStream_t stream) {
  const Plan p = make_plan(B, H, W, C);
  const dim3 grid(p.ctiles, p.wtiles, p.slices);
  partials_kernel<E><<<grid, THREADS, 0, stream>>>(static_cast<const E*>(x), dh, H, W, C,
                                                   static_cast<long long>(B) * H,
                                                   p.rows_per_slice, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finalize_kernel<<<dim3(TAPS, (C + 31) / 32), dim3(32, FG), 0, stream>>>(
      partials, p.slices * p.wtiles, C, dw);
  return cudaGetLastError();
}

}  // namespace tapgrad

// ---------------------------------------------------------------- the plan

// The fp32 workspace: (a)'s scratch (tok, dpre2 (n, C) and hmid, dpre1 (n,
// hidden) in x's type; dh (n, C) fp32), its blocks' partial rows and their
// first column-sum pass, the slice partials of dW1 and dW2 (when a product
// has more than one slice), and the tap gradient's partials.
struct Work {
  long long n, blocks, row;
  Slices s1, s2;
  tapgrad::Plan tp;
  size_t tok, dpre2, hmid, dpre1, dh, rows, scratch, part1, part2, taps, total;
};

Work plan_f32(int B, int H, int W, int C, int hidden) {
  Work w;
  const size_t es = sizeof(float);
  w.n = static_cast<long long>(B) * H * W;
  w.blocks = (w.n + kTileTokens - 1) / kTileTokens;
  w.row = hidden + 5LL * C;
  w.s1 = plan_slices(w.n, hidden, C);
  w.s2 = plan_slices(w.n, C, hidden);
  w.tp = tapgrad::make_plan(B, H, W, C);
  const long long parts = w.blocks > kChunk ? (w.blocks + kChunk - 1) / kChunk : 0;
  const size_t nc = static_cast<size_t>(w.n) * C, nh = static_cast<size_t>(w.n) * hidden;
  const size_t wsize = static_cast<size_t>(hidden) * C * 4;
  w.tok = 0;
  w.dpre2 = w.tok + align256(nc * es);
  w.hmid = w.dpre2 + align256(nc * es);
  w.dpre1 = w.hmid + align256(nh * es);
  w.dh = w.dpre1 + align256(nh * es);
  w.rows = w.dh + align256(nc * 4);
  w.scratch = w.rows + align256(static_cast<size_t>(w.blocks * w.row) * 4);
  w.part1 = w.scratch + align256(static_cast<size_t>(parts * w.row) * 4);
  w.part2 = w.part1 + (w.s1.count > 1 ? align256(w.s1.count * wsize) : 0);
  w.taps = w.part2 + (w.s2.count > 1 ? align256(w.s2.count * wsize) : 0);
  w.total = w.taps + align256(static_cast<size_t>(w.tp.slices) * w.tp.wtiles * tapgrad::TAPS * C * 4);
  return w;
}

bool shape_ok(int dtype, int B, int H, int W, int C, int hidden) {
  if ((dtype != kBF16 && dtype != kF32) || B <= 0 || H <= 0 || W <= 0) return false;
  if (C <= 0 || C % 16 || C > 1024 || hidden <= 0 || hidden % 64) return false;
  const long long n = static_cast<long long>(B) * H * W;
  const long long blocks = (n + kTileTokens - 1) / kTileTokens;
  // grid limits: (a)'s and (c)'s blocks, (a)'s rows in one two-pass column sum,
  // the tap kernel's column tiles
  return static_cast<long long>(B) * H <= (1LL << 31) - 1 && (n + kWarps - 1) / kWarps <= 0x7fffffffLL &&
         (blocks + kChunk - 1) / kChunk <= 65535 && (W + tapgrad::TW - 1) / tapgrad::TW <= 65535;
}

// fp32: (a), (b) and (c) above.
template <typename E>
cudaError_t run_all(const TileArgs& a, const Work& w, char* ws, int B, void* dx, void* ddw,
                    void* dw1, void* dw2, void* vecs) {
  cudaStream_t st = a.stream;
  cudaError_t e = dispatch_tile(a, false);  // (a)
  if (e != cudaSuccess) return e;
  const E* tok = reinterpret_cast<const E*>(ws + w.tok);
  const E* dpre2 = reinterpret_cast<const E*>(ws + w.dpre2);
  const E* hmid = reinterpret_cast<const E*>(ws + w.hmid);
  const E* dpre1 = reinterpret_cast<const E*>(ws + w.dpre1);
  const float* dh = reinterpret_cast<const float*>(ws + w.dh);
  // (b): dW1 = dpre1^T tok (hidden, C), dW2 = dpre2^T hmid (C, hidden), the vectors
  e = wgrad<E>(dpre1, tok, static_cast<float*>(dw1), reinterpret_cast<float*>(ws + w.part1), w.n,
               a.hidden, a.C, w.s1, st);
  if (e != cudaSuccess) return e;
  e = wgrad<E>(dpre2, hmid, static_cast<float*>(dw2), reinterpret_cast<float*>(ws + w.part2), w.n,
               a.C, a.hidden, w.s2, st);
  if (e != cudaSuccess) return e;
  e = colsum(reinterpret_cast<const float*>(ws + w.rows), w.blocks, w.row, static_cast<float*>(vecs),
             reinterpret_cast<float*>(ws + w.scratch), st);
  if (e != cudaSuccess) return e;
  // (c): dx, then the tap gradient
  e = dispatch_dx<E>(dh, static_cast<const float*>(a.taps), static_cast<E*>(dx), a.H, a.W, w.n,
                     a.C, st);
  if (e != cudaSuccess) return e;
  return tapgrad::run<E>(a.x, dh, B, a.H, a.W, a.C, reinterpret_cast<float*>(ws + w.taps),
                         static_cast<float*>(ddw), st);
}

// ---------------------------------------------------------------- bf16 (v)

}  // namespace

namespace imt {
namespace ring {

// Kernel 11's last bf16 stage, on convnext_branch_ring.cuh's walk: from x
// (bf16) and dh (fp32), dx = bf16(the fp32 correlation of dh with the
// flipped taps, in the twin's tap order), and the block's partial sums of
// the 49 tap gradients sum x * dh (fp32 products, not kernel 9's
// bf16-rounded ones) and of ddw_b = sum dh; conv_bwd_finish_kernel adds the
// blocks' partials in a fixed order.

// Shared memory of conv_bwd_kernel: the x ring (8 x rw x ct bf16) and the
// dh ring (8 x rw x ct fp32); the tap threads' partial sums (groups x 50 x
// ct fp32) reuse them at the end.
inline size_t bwd_smem(const Plan& p) {
  const size_t rings = static_cast<size_t>(8) * p.rw * p.ct * 6;
  const size_t red = static_cast<size_t>(p.groups) * kGradRows * p.ct * 4;
  return rings > red ? rings : red;
}

// conv_bwd_kernel's plan: a channel tile of ct (a multiple of 16, the last
// tile ragged) and a strip of kJ-column groups such that each role's items
// (ct / 2 pairs x groups) fit its kRoleThreads; of those whose rings fit,
// the one that keeps the most threads busy on useful columns and channels.
inline Plan plan_bwd(int B, int H, int W, int C, int sms) {
  Plan best = {};
  double best_score = -1.0;
  for (int ct = 2 * kRoleThreads; ct >= 16; ct -= 16) {
    if (ct > C) continue;
    Plan p = {};
    p.B = B;
    p.H = H;
    p.W = W;
    p.C = C;
    p.ct = ct;
    p.ctiles = (C + ct - 1) / ct;
    const int pairs = ct / 2;
    int groups = kRoleThreads / pairs;
    if (groups < 1) continue;
    const int need = (W + kJ - 1) / kJ;
    p.groups = groups < need ? groups : need;
    p.sw = p.groups * kJ < W ? p.groups * kJ : W;
    p.rw = p.groups * kJ + 2 * kR;
    p.slots = 8;
    p.smem = bwd_smem(p);
    if (p.smem > kRingBudget) continue;
    const double score = static_cast<double>(pairs * p.groups) / kRoleThreads *
                         p.sw / (p.groups * kJ + 2 * kR) * C / (static_cast<double>(p.ctiles) * ct);
    if (score > best_score) {
      best_score = score;
      best = p;
    }
  }
  best.strips = (W + best.sw - 1) / best.sw;
  plan_slices(best, sms);
  return best;
}

// ------------------------------------------------------------ conv backward

// One block per (image, channel tile, strip, row slice) of plan_bwd; see
// the top of this file. Threads [0, kRoleThreads) write dx, the others sum
// the tap gradients; the block's 49 tap sums and its sum of dh leave as its
// slab of `partials` (slabs x 50 x C fp32, rows 0-48 the taps, row 49 dh).
__global__ void __launch_bounds__(kRingThreads, 1)
conv_bwd_kernel(const Plan p, const bf16* __restrict__ x, const float* __restrict__ dh,
                const float* __restrict__ taps, bf16* __restrict__ dx,
                float* __restrict__ partials) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xring = reinterpret_cast<bf16*>(smem);
  float* dring = reinterpret_cast<float*>(smem + static_cast<size_t>(8) * p.rw * p.ct * 2);
  const Block k = block_of(p, blockIdx.x);
  const int tid = threadIdx.x;
  const bool tap_role = tid >= kRoleThreads;
  const int rt = tap_role ? tid - kRoleThreads : tid;  // the thread's place in its role
  const int P = p.ct / 2, ct = p.ct, C = p.C;
  const int pr = rt % P, xl = (rt / P) * kJ, c = 2 * pr;
  const bool active = rt < P * p.groups && k.c0 + c < C;

  for (int r = k.y0 - kR; r <= k.y0 + kR; ++r) {
    issue_row(xring, p, k, x, r, slot_of(r, 8), tid);
    issue_row(dring, p, k, dh, r, slot_of(r, 8), tid);
  }
  cp_commit();

  // dx threads: the pair's taps; tap threads: its 49 running sums
  float2 w[kTaps];
  if (tap_role || !active) {
#pragma unroll
    for (int t = 0; t < kTaps; ++t) w[t] = make_float2(0.f, 0.f);
  } else {
    load_taps(w, taps, C, k.c0 + c);
  }
  float2 sdh = make_float2(0.f, 0.f);

  for (int y = k.y0; y < k.y1; ++y) {
    if (y + kR + 1 < k.y1 + kR) {
      issue_row(xring, p, k, x, y + kR + 1, slot_of(y + kR + 1, 8), tid);
      issue_row(dring, p, k, dh, y + kR + 1, slot_of(y + kR + 1, 8), tid);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();

    if (active && !tap_role) {
      // dx[y][x] = sum over (ky, kx) in row-major order of dh[y + 3 - ky][x + 3 - kx] * w[ky][kx]
      float2 acc[kJ];
#pragma unroll
      for (int i = 0; i < kJ; ++i) acc[i] = make_float2(0.f, 0.f);
#pragma unroll
      for (int ky = 0; ky < kK; ++ky) {
        const float2* row = reinterpret_cast<const float2*>(
            dring + static_cast<size_t>(slot_of(y + kR - ky, 8)) * p.rw * ct);
        float2 win[kWin];
#pragma unroll
        for (int m = 0; m < kWin; ++m) win[m] = row[(xl + m) * P + pr];
#pragma unroll
        for (int kx = 0; kx < kK; ++kx) {
          const float2 wt = w[ky * kK + kx];
#pragma unroll
          for (int i = 0; i < kJ; ++i) {
            acc[i].x = fmaf(win[i + 2 * kR - kx].x, wt.x, acc[i].x);
            acc[i].y = fmaf(win[i + 2 * kR - kx].y, wt.y, acc[i].y);
          }
        }
      }
      const long long o = ((static_cast<long long>(k.b) * p.H + y) * p.W + k.xs0 + xl) * C + k.c0 + c;
#pragma unroll
      for (int i = 0; i < kJ; ++i)
        if (xl + i < k.swv) *reinterpret_cast<uint32_t*>(dx + o + static_cast<long long>(i) * C) =
            narrow2(acc[i].x, acc[i].y);
    } else if (active) {
      // the taps: w[ky][kx] += x[y + ky - 3][x + kx - 3] * dh[y][x] over the kJ columns
      const float2* drow = reinterpret_cast<const float2*>(
          dring + static_cast<size_t>(slot_of(y, 8)) * p.rw * ct);
      float2 d[kJ];
#pragma unroll
      for (int i = 0; i < kJ; ++i) {
        d[i] = xl + i < k.swv ? drow[(xl + i + kR) * P + pr] : make_float2(0.f, 0.f);
        sdh.x += d[i].x;
        sdh.y += d[i].y;
      }
#pragma unroll
      for (int ky = 0; ky < kK; ++ky) {
        const uint32_t* row = reinterpret_cast<const uint32_t*>(
            xring + static_cast<size_t>(slot_of(y + ky - kR, 8)) * p.rw * ct);
        float2 win[kWin];
#pragma unroll
        for (int m = 0; m < kWin; ++m) win[m] = widen2(row[(xl + m) * P + pr]);
#pragma unroll
        for (int kx = 0; kx < kK; ++kx) {
          float2 s = w[ky * kK + kx];
#pragma unroll
          for (int i = 0; i < kJ; ++i) {
            s.x = fmaf(win[i + kx].x, d[i].x, s.x);
            s.y = fmaf(win[i + kx].y, d[i].y, s.y);
          }
          w[ky * kK + kx] = s;
        }
      }
    }
    __syncthreads();  // every thread is done with the slot of row y - 3
  }

  // the tap threads' sums through shared memory (the rings are free), then
  // the block's slab: each channel's column groups in order
  cp_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [groups][50][ct]
  if (tap_role && rt < P * p.groups) {
    const int j = rt / P;
#pragma unroll
    for (int t = 0; t < kTaps; ++t)
      *reinterpret_cast<float2*>(red + (static_cast<size_t>(j) * kGradRows + t) * ct + c) = w[t];
    *reinterpret_cast<float2*>(red + (static_cast<size_t>(j) * kGradRows + kTaps) * ct + c) = sdh;
  }
  __syncthreads();
  float* slab = partials + k.slab * kGradRows * C;
  for (int e = tid; e < kGradRows * ct; e += kRingThreads) {
    const int t = e / ct, cc = e - t * ct;
    if (k.c0 + cc >= C) continue;
    float s = 0.f;
    for (int j = 0; j < p.groups; ++j) s += red[(static_cast<size_t>(j) * kGradRows + t) * ct + cc];
    slab[static_cast<long long>(t) * C + k.c0 + cc] = s;
  }
}

// ddw[c][t] (t < 49) and ddw_b[c] = the sums over every slab of partials[s][t][c],
// in a fixed order: a block per (row t, 32 channels), its 8 rows of threads
// each adding every 8th slab (four running sums, then their pairs), the 8
// rows then added in order.
__global__ void __launch_bounds__(256)
conv_bwd_finish_kernel(const float* __restrict__ partials, long long slabs, int C,
                       float* __restrict__ ddw, float* __restrict__ ddw_b) {
  constexpr int FG = 8;
  __shared__ float part[FG][32];
  const int t = blockIdx.x, c = blockIdx.y * 32 + threadIdx.x, row = threadIdx.y;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  if (c < C) {
    const long long stride = static_cast<long long>(kGradRows) * C;
    const float* q = partials + static_cast<long long>(t) * C + c;
    long long i = row;
    for (; i + 3 * FG < slabs; i += 4 * FG) {
      s0 += q[i * stride];
      s1 += q[(i + FG) * stride];
      s2 += q[(i + 2 * FG) * stride];
      s3 += q[(i + 3 * FG) * stride];
    }
    for (; i < slabs; i += FG) s0 += q[i * stride];
  }
  part[row][threadIdx.x] = (s0 + s1) + (s2 + s3);
  __syncthreads();
  if (row == 0 && c < C) {
    float total = 0.f;
#pragma unroll
    for (int r = 0; r < FG; ++r) total += part[r][threadIdx.x];
    if (t < kTaps)
      ddw[static_cast<long long>(c) * kTaps + t] = total;
    else
      ddw_b[c] = total;
  }
}

// Launches conv_bwd_kernel and conv_bwd_finish_kernel on plan p (plan_bwd's).
static cudaError_t launch_conv_bwd(const Plan& p, const bf16* x, const float* dh, const float* taps,
                                   bf16* dx, float* partials, float* ddw, float* ddw_b,
                                   cudaStream_t st) {
  static imt_mma::LaunchCache cache;
  cudaError_t e = cache.prepare(reinterpret_cast<const void*>(conv_bwd_kernel), kRingBudget,
                                kRingThreads, p.smem);
  if (e != cudaSuccess) return e;
  if (p.blocks() > 0x7fffffffLL || p.smem > kRingBudget || (p.C + 31) / 32 > 65535)
    return cudaErrorInvalidValue;
  conv_bwd_kernel<<<static_cast<unsigned>(p.blocks()), kRingThreads, p.smem, st>>>(
      p, x, dh, taps, dx, partials);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  conv_bwd_finish_kernel<<<dim3(kGradRows, (p.C + 31) / 32), dim3(32, 8), 0, st>>>(
      partials, p.slabs(), p.C, ddw, ddw_b);
  return cudaGetLastError();
}

}  // namespace ring
}  // namespace imt

namespace {

// ---------------------------------------------------------------- bf16

// The bf16 workspace: kernel 2's (lnmlp_bwd::plan), with a vector partial
// row for each prologue block (where those outnumber the token tiles) and
// x-hat, then the conv backward's partial slabs.
struct Bf16Work {
  ring::Plan ln, conv;
  lnmlp_bwd::Work w;
  size_t slabs, total;
};

Bf16Work plan_bf16(int B, int H, int W, int C, int hidden) {
  const int sms = sm_count();
  Bf16Work b;
  b.ln = ring::plan_ln(B, H, W, C, true, sms);
  b.conv = ring::plan_bwd(B, H, W, C, sms);
  b.w = lnmlp_bwd::plan(static_cast<long long>(B) * H * W, C, hidden, b.ln.blocks(), true);
  b.slabs = b.w.off[lnmlp_bwd::kParts];
  b.total = b.slabs + align256(static_cast<size_t>(b.conv.slabs()) * ring::kGradRows * C * 4);
  return b;
}

// Whether the bf16 pipeline takes a (B, H, W, C) map: both rings within a
// block's shared memory, and the grids' and column sums' limits.
bool bf16_ok(int B, int H, int W, int C, int hidden) {
  const long long n = static_cast<long long>(B) * H * W;
  if (n > 0x7fffffffLL) return false;
  const ring::Plan ln = ring::plan_ln(B, H, W, C, true, 132);
  const ring::Plan conv = ring::plan_bwd(B, H, W, C, 132);
  const long long prows = std::max((n + kBM - 1) / kBM, ln.blocks());
  return ln.smem <= ring::kRingBudget && conv.smem > 0 && conv.smem <= ring::kRingBudget &&
         ln.blocks() <= 0x7fffffffLL && conv.blocks() <= 0x7fffffffLL &&
         (prows + kChunk - 1) / kChunk <= 65535;
}

// Stages [first, last) of (i') the conv and LayerNorm, (ii)-(iv) kernel 2's
// GEMM stages with the A&S GELU and dh in fp32, (v) the conv's backward,
// numbered 0-4. The vector partial rows are zeroed first: the prologue's
// blocks and the token tiles fill different numbers of them.
cudaError_t run_bf16(const TileArgs& a, int B, char* ws, void* dx, void* ddw, void* dw1, void* dw2,
                     void* vecs, int first, int last) {
  const Bf16Work b = plan_bf16(B, a.H, a.W, a.C, a.hidden);
  const lnmlp_bwd::Buffers buf = lnmlp_bwd::buffers(b.w, ws);
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* g = static_cast<const bf16*>(a.g);
  const float* taps = static_cast<const float*>(a.taps);
  const float* gamma = static_cast<const float*>(a.gamma);
  float* v = static_cast<float*>(vecs);
  cudaStream_t st = a.stream;
  cudaError_t e = cudaSuccess;
  if (first <= 0 && last > 0) {  // (i')
    e = cudaMemsetAsync(buf.partial, 0, b.w.off[9] - b.w.off[8], st);
    if (e != cudaSuccess) return e;
    e = ring::launch_conv_ln<true>(b.ln, x, taps, static_cast<const float*>(a.dwb),
                                   static_cast<const float*>(a.ln_s),
                                   static_cast<const float*>(a.ln_b), a.eps, buf.tok, g, gamma,
                                   static_cast<const float*>(a.b2), buf.xhat, buf.rstd, buf.dpre2,
                                   buf.partial, a.hidden, st);
    if (e != cudaSuccess) return e;
  }
  const lnmlp_bwd::StageInputs s = {nullptr,
                                    g,
                                    static_cast<const bf16*>(a.w1),
                                    static_cast<const bf16*>(a.w2),
                                    static_cast<const float*>(a.ln_s),
                                    static_cast<const float*>(a.b1),
                                    gamma,
                                    nullptr,
                                    static_cast<float*>(dw1),
                                    static_cast<float*>(dw2),
                                    v,
                                    a.n,
                                    a.C,
                                    a.hidden};
  e = lnmlp_bwd::run_gemm_stages<kGeluAS, true>(s, b.w, buf, first, last, st);  // (ii)-(iv)
  if (e != cudaSuccess || first > 4 || last <= 4) return e;
  return ring::launch_conv_bwd(b.conv, x, buf.xhat, taps, static_cast<bf16*>(dx),  // (v)
                               reinterpret_cast<float*>(ws + b.slabs), static_cast<float*>(ddw),
                               v + a.hidden + 4 * a.C, st);
}

}  // namespace

extern "C" {

// Returns 1 when the kernel takes channel width C and hidden width `hidden`
// for operand type `dtype` (0 bf16, 1 fp32): C a multiple of 16 up to 1024,
// hidden a multiple of 64, and the fp32 tile, or the bf16 rings of a 7 x 7
// map, within a block's shared memory.
int imt_convnext_branch_bwd_supported(int C, int hidden, int dtype) {
  if (!shape_ok(dtype, 1, 1, 1, C, hidden)) return 0;
  if (dtype == kBF16) return bf16_ok(1, 7, 7, C, hidden);
  TileArgs a{};
  a.C = C;
  a.hidden = hidden;
  return dispatch_tile(a, true) == cudaSuccess;
}

// Bytes of device workspace the backward needs; 0 for a shape it does not take.
long long imt_convnext_branch_bwd_workspace_bytes(int B, int H, int W, int C, int hidden,
                                                  int dtype) {
  if (!shape_ok(dtype, B, H, W, C, hidden)) return 0;
  if (dtype == kBF16)
    return bf16_ok(B, H, W, C, hidden)
               ? static_cast<long long>(plan_bf16(B, H, W, C, hidden).total)
               : 0;
  return static_cast<long long>(plan_f32(B, H, W, C, hidden).total);
}

// x and g (B, H, W, C) NHWC of `dtype`; taps (49, C) fp32, tap ky * 7 + kx;
// dwb, ln_s, ln_b, b2, gamma (C) and b1 (hidden) fp32; w1 (hidden, C) and w2
// (C, hidden) of `dtype`. Writes dx like x; ddw (C, 49), dw1 (hidden, C), dw2
// (C, hidden) and vecs (hidden + 5C: db1, db2, dgamma, dln_s, dln_b, ddw_b),
// all fp32; `workspace` is scratch of imt_convnext_branch_bwd_workspace_bytes
// (1024-byte aligned for bf16). All contiguous and 16-byte aligned. bf16 runs
// stages [first, last) of (i') the conv and LayerNorm, (ii) the hidden
// products, (iii) dln and the LayerNorm backward, (iv) the weight products
// and sums, (v) the conv's backward (0 and 5 run it all; a stage run alone
// reads what the stages before it left in the workspace); fp32 runs it all,
// whatever first and last say. Launches on `stream`; returns the launch
// status (a cudaError_t; 0 is success).
int imt_convnext_branch_bwd(const void* x, const void* g, const void* taps, const void* dwb,
                            const void* ln_s, const void* ln_b, const void* w1, const void* b1,
                            const void* w2, const void* b2, const void* gamma, void* dx, void* ddw,
                            void* dw1, void* dw2, void* vecs, void* workspace, int dtype, int B,
                            int H, int W, int C, int hidden, float eps, int first, int last,
                            void* stream) {
  if (!shape_ok(dtype, B, H, W, C, hidden)) return cudaErrorInvalidValue;
  char* ws = static_cast<char*>(workspace);
  if (dtype == kBF16) {
    if (!bf16_ok(B, H, W, C, hidden) || reinterpret_cast<uintptr_t>(workspace) % 1024)
      return cudaErrorInvalidValue;
    const TileArgs a{x,       g,       taps,    dwb,     ln_s,    ln_b,    w1, b1, w2, b2, gamma,
                     nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, H,  W,  static_cast<long long>(B) * H * W,
                     C,       hidden,  eps,     static_cast<cudaStream_t>(stream)};
    return run_bf16(a, B, ws, dx, ddw, dw1, dw2, vecs, first, last);
  }
  const Work w = plan_f32(B, H, W, C, hidden);
  const TileArgs a{x, g, taps, dwb, ln_s, ln_b, w1, b1, w2, b2, gamma,
                   ws + w.tok, ws + w.hmid, ws + w.dpre1, ws + w.dpre2, ws + w.dh, ws + w.rows,
                   H, W, w.n, C, hidden, eps, static_cast<cudaStream_t>(stream)};
  return run_all<float>(a, w, ws, B, dx, ddw, dw1, dw2, vecs);
}

const char* imt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
