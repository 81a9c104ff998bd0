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
// formed. Nothing is added with float atomics: every sum over tokens meets
// in a fixed order, so the same inputs give the same bits on every run.
//
// What bounds it on the H100. The recomputed forward plus the backward are
// five products of N x hidden x C (8*N*C^2 flops each at hidden = 4C): pre1
// and dhmid, dln, dW1 and G, each far above the card's ~295 flop/byte
// balance, so the work is bound by the tensor cores, 0.15 ms at peak per
// launch at the B=128 stage shapes of map_convnext_tiny. The earlier design
// (one block of 8 warps per tile of 16-64 tokens, wmma fragments, W1 and W2
// streamed through shared memory for every tile) moved 24*C^2 bytes of
// weights per tile, 1.4-5.6 GB per launch, at 16-64 flops per byte, and ran
// 20x over that bound. This one splits the work into GEMM-shaped kernels
// with 128 x 128 tiles on `wgmma` (m64n128k16, fp32 sums in registers), fed
// by TMA into a four-stage ring of shared memory that a producer warp keeps
// full, with mbarriers, while two consumer warpgroups of 64 rows each
// multiply; the CTAs are persistent (one per SM, walking over the tiles),
// so the producer loads the next tile while the consumers finish one. Each
// weight byte now serves 128 tokens:
//
//  (i)   ln_mlp_bwd_prologue_kernel, a warp (16 lanes at C <= 128) per
//        token row, several rows in flight, memory-bound: the LN
//        statistics (mu, rstd), tok = bf16(LN(h)), dpre2 = bf16(g*gamma),
//        and each block's partial sums of db2 and of dgamma's b2 * sum g.
//  (ii)  ln_mlp_bwd_gemm_kernel<kHidden>: on a tile of 128 tokens x 128
//        hidden units, pre1 = tok W1^T and dhmid = dpre2 W2 (K = C, two
//        accumulators); the epilogue writes hmid = bf16(GELU(pre1 + b1))
//        and dpre1 = bf16(dhmid * gelu'(pre1 + b1)) into swizzled shared
//        memory, TMA stores take them out while the next tile multiplies,
//        and the tile's partial sums of db1 (of the fp32 dpre1).
//  (iii) ln_mlp_bwd_gemm_kernel<kDln>: dln = dpre1 W1 (K = hidden) on 128
//        tokens x 128 channels; the epilogue takes the LN backward as far
//        as a tile's channels allow: dxhat = dln * ln_s (fp32, to HBM),
//        each row's partial sums of dxhat and dxhat * xhat over the tile's
//        channels, and the tile's partial sums of dln_s and dln_b. A row's
//        means need all C channels, and a CTA cannot hold 128 tokens x C
//        fp32 sums for C up to 1024 (512 KB), so C is split into
//        128-channel tiles and ln_mlp_bwd_rows_kernel, a small second pass
//        (about 2 x N x C x 4 bytes more traffic, 11-23 us at the B=128
//        shapes of stages 1-3), adds the row sums and writes dx = rstd *
//        (dxhat - m1 - xhat * m2). Where one tile spans C (C <= 128, stage
//        0) the epilogue has whole rows and writes dx itself.
//  (iv)  ln_mlp_bwd_gemm_kernel<kWgrad>: dW1 = dpre1^T tok and G = g^T
//        hmid, both operands read token-major from shared memory as
//        MN-major (the transpose bits of a bf16 wgmma); each CTA owns a
//        128 x 128 output tile and one slice of the tokens (a multiple of
//        64, as many slices as fill the card's rounds), and the slices'
//        partials are added in the fixed order of wgrad_common.cuh. The
//        blocks' vector partial rows of (i)-(iii) are added the same way,
//        and dw2_finish_kernel turns G into dW2 = gamma * G and adds sum_j
//        W2 * G to dgamma.
//
// Ragged edges (N not a multiple of 128, C = 688 = 43 x 16, hidden tiles of
// 64) take TMA's zero fill on the loads and masks (or the store maps'
// clipping) on the stores: one path. What remains over the bound: the
// pipeline's traffic, hmid and dpre1 (two N x hidden bf16 tensors) written
// and read back three times: about 2 GB at stage 0 of B=128 (N = 401408,
// C = 96), 0.6 ms at 3.35 TB/s; the epilogues' GELU work at stages 0-1;
// and at stages 2-3 tiles too small for the L2's rate (128 x 128 tiles
// feed 64 flops per byte streamed).
//
// Stages (ii)-(iv), their workspace and their host code live in
// ln_mlp_bwd_stages.cuh, which kernel 11's bf16 instance (the fused ConvNeXt
// branch's backward, convnext_branch_bwd.cu) shares with its own prologue,
// the A&S GELU and an fp32 dh.
//
// fp32 tokens (an fp32 model) take the fp32 instance of ln_mlp_f32.cuh: the
// same four stages with no cast to bf16, on the CUDA cores.

#include "ln_mlp_bwd_stages.cuh"
#include "ln_mlp_common.cuh"
#include "ln_mlp_f32.cuh"

namespace {

using namespace imt;
using namespace imt::lnmlp_bwd;

// ---------------------------------------------------------- (i) prologue

// The row kernels' layout is ln_mlp_common.cuh's (row_sum, launch_rows).
// 128 rows (one token tile) per block of 8 warps: mu and rstd in fp32, tok
// = bf16(LN(h)), dpre2 = bf16(g * gamma), and the block's column sums of g *
// gamma (db2) and of g (times b2: dgamma's b2 part) into its vector partial
// row, the row groups' and warps' partials met in order (the warps' through
// shared memory, 8 x 2C floats).
template <int L, int S, int R>
__global__ void __launch_bounds__(kThreads)
ln_mlp_bwd_prologue_kernel(const bf16* __restrict__ h, const bf16* __restrict__ g,
                           const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                           const float* __restrict__ b2, const float* __restrict__ gamma,
                           bf16* __restrict__ tok, bf16* __restrict__ dpre2,
                           float* __restrict__ mu_out, float* __restrict__ rstd_out,
                           float* __restrict__ partial, long long n, int C, int hidden, float eps) {
  constexpr int G = 32 / L;
  extern __shared__ float pred[];  // [8][2C]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / L, sl = lane % L;
  const int segs = C / 8;
  float sdb[S][8], sg[S][8];
#pragma unroll
  for (int q = 0; q < S; ++q)
#pragma unroll
    for (int e = 0; e < 8; ++e) sdb[q][e] = sg[q][e] = 0.f;
  for (int rr = warp * G * R; rr < kBM; rr += kWarps * G * R) {
    const long long r0 = static_cast<long long>(blockIdx.x) * kBM + rr + grp;
    uint4 hraw[R][S], graw[R][S];
#pragma unroll
    for (int u = 0; u < R; ++u)
#pragma unroll
      for (int q = 0; q < S; ++q)
        if (r0 + u * G < n && sl + L * q < segs) {
          hraw[u][q] = reinterpret_cast<const uint4*>(h + (r0 + u * G) * C)[sl + L * q];
          graw[u][q] = reinterpret_cast<const uint4*>(g + (r0 + u * G) * C)[sl + L * q];
        }
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const long long r = r0 + u * G;
      const bool ok = r < n;  // not uniform over the warp: the sums run on every lane
      float f[8];
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < S; ++q) {
        if (ok && sl + L * q < segs) {
          unpack8(hraw[u][q], f);
#pragma unroll
          for (int e = 0; e < 8; ++e) s += f[e];
        }
      }
      const float mu = row_sum<L>(s) / C;
      float var = 0.f;
#pragma unroll
      for (int q = 0; q < S; ++q) {
        if (ok && sl + L * q < segs) {
          unpack8(hraw[u][q], f);
#pragma unroll
          for (int e = 0; e < 8; ++e) var += (f[e] - mu) * (f[e] - mu);
        }
      }
      const float rstd = rsqrtf(row_sum<L>(var) / C + eps);
      if (!ok) continue;
      if (sl == 0) {
        mu_out[r] = mu;
        rstd_out[r] = rstd;
      }
      uint4* trow = reinterpret_cast<uint4*>(tok + r * C);
      uint4* drow = reinterpret_cast<uint4*>(dpre2 + r * C);
#pragma unroll
      for (int q = 0; q < S; ++q) {
        const int sgi = sl + L * q;
        if (sgi < segs) {
          unpack8(hraw[u][q], f);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            f[e] = (f[e] - mu) * rstd * ln_s[sgi * 8 + e] + ln_b[sgi * 8 + e];
          trow[sgi] = pack8(f);
          unpack8(graw[u][q], f);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            sg[q][e] += f[e];
            f[e] *= gamma[sgi * 8 + e];
            sdb[q][e] += f[e];
          }
          drow[sgi] = pack8(f);
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < S; ++q) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
#pragma unroll
      for (int o = L; o < 32; o <<= 1) {
        sdb[q][e] += __shfl_xor_sync(0xffffffffu, sdb[q][e], o);
        sg[q][e] += __shfl_xor_sync(0xffffffffu, sg[q][e], o);
      }
    }
    const int sgi = sl + L * q;
    if (grp == 0 && sgi < segs) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        pred[warp * 2 * C + sgi * 8 + e] = sdb[q][e];
        pred[warp * 2 * C + C + sgi * 8 + e] = sg[q][e];
      }
    }
  }
  __syncthreads();
  float* prt = partial + blockIdx.x * (hidden + 4LL * C) + hidden;
  for (int c = threadIdx.x; c < 2 * C; c += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += pred[w * 2 * C + c];
    prt[c] = c < C ? s : s * b2[c - C];
  }
}

// ------------------------------------------------------------------ host

template <int L, int S, int R>
struct Prologue {
  static constexpr auto kernel = ln_mlp_bwd_prologue_kernel<L, S, R>;
};

struct Inputs {
  const bf16 *h, *g, *w1, *w2;
  const float *ln_s, *ln_b, *b1, *b2, *gamma;
  bf16* dx;
  float *dw1, *dw2, *vecs;
  char* ws;
  long long n;
  int C, hidden;
  float eps;
};

template <int GM>
cudaError_t run_stages(const Inputs& in, int first, int last, cudaStream_t st) {
  const long long n = in.n;
  const int C = in.C, H = in.hidden;
  const Work w = plan(n, C, H);
  const Buffers buf = buffers(w, in.ws);
  if (w.mtiles > 65535) return cudaErrorInvalidValue;
  if (first <= 0 && last > 0) {  // (i)
    const size_t smem = static_cast<size_t>(kWarps) * 2 * C * 4;
    const cudaError_t e = launch_rows<Prologue>(
        C, static_cast<unsigned>(w.mtiles), smem, st, in.h, in.g, in.ln_s, in.ln_b, in.b2,
        in.gamma, buf.tok, buf.dpre2, buf.mu, buf.rstd, buf.partial, n, C, H, in.eps);
    if (e != cudaSuccess) return e;
  }
  const StageInputs s = {in.h,  in.g,   in.w1,  in.w2,   in.ln_s, in.b1, in.gamma, in.dx,
                         in.dw1, in.dw2, in.vecs, n,      C,       H};
  return run_gemm_stages<GM, false>(s, w, buf, first, last, st);
}

}  // namespace

extern "C" {

// Widths the kernel takes, as the forward's: C a multiple of 16 up to 1024
// and hidden a multiple of 64. Returns 1 when (C, hidden) is supported.
int imt_ln_mlp_bwd_supported(int C, int hidden) {
  return C > 0 && C % 16 == 0 && C <= 1024 && hidden > 0 && hidden % 64 == 0;
}

// Bytes of device workspace a call on n tokens needs.
long long imt_ln_mlp_bwd_workspace_bytes(long long n, int C, int hidden) {
  if (!imt_ln_mlp_bwd_supported(C, hidden) || n <= 0) return 0;
  return static_cast<long long>(plan(n, C, hidden).off[kParts]);
}

// The backward, stages [first, last) of (i) prologue, (ii) hidden products,
// (iii) dln and dx, (iv) weight products and sums; 0 and 4 run it all. h
// and g (n, C) bf16, w1 (hidden, C) and w2 (C, hidden) bf16, vectors fp32,
// all contiguous and 16-byte aligned; `workspace` of
// imt_ln_mlp_bwd_workspace_bytes bytes, 1024-byte aligned. Writes dx (n, C)
// bf16, dw1 (hidden, C) and dw2 (C, hidden) fp32, and `vecs` (hidden + 4C
// fp32) = db1, db2, dgamma, dln_s, dln_b. A stage run alone reads what the
// stages before it left in the workspace. gelu_fast selects the training
// GELU. Launches on `stream`; returns the launch status (a cudaError_t; 0 is
// success).
int imt_ln_mlp_bwd_bf16(const void* h, const void* g, const void* ln_s, const void* ln_b,
                        const void* w1, const void* b1, const void* w2, const void* b2,
                        const void* gamma, void* dx, void* dw1, void* dw2, void* vecs,
                        void* workspace, long long n, int C, int hidden, float eps, int gelu_fast,
                        int first, int last, void* stream) {
  if (!imt_ln_mlp_bwd_supported(C, hidden) || n <= 0 || n > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(workspace) % 1024)
    return cudaErrorInvalidValue;
  const Inputs in = {static_cast<const bf16*>(h),      static_cast<const bf16*>(g),
                     static_cast<const bf16*>(w1),     static_cast<const bf16*>(w2),
                     static_cast<const float*>(ln_s),  static_cast<const float*>(ln_b),
                     static_cast<const float*>(b1),    static_cast<const float*>(b2),
                     static_cast<const float*>(gamma), static_cast<bf16*>(dx),
                     static_cast<float*>(dw1),         static_cast<float*>(dw2),
                     static_cast<float*>(vecs),        static_cast<char*>(workspace),
                     n, C, hidden, eps};
  auto st = static_cast<cudaStream_t>(stream);
  return gelu_fast ? run_stages<kGeluFit>(in, first, last, st)
                   : run_stages<kGeluErf>(in, first, last, st);
}

// Bytes of device workspace a call of the fp32 instance on n tokens needs.
long long imt_ln_mlp_bwd_f32_workspace_bytes(long long n, int C, int hidden) {
  if (!imt_ln_mlp_bwd_supported(C, hidden) || n <= 0) return 0;
  return static_cast<long long>(imt::f32::bwd_plan(n, C, hidden).total);
}

// As imt_ln_mlp_bwd_bf16 with fp32 h, g, w1, w2 and dx, and a workspace of
// imt_ln_mlp_bwd_f32_workspace_bytes bytes.
int imt_ln_mlp_bwd_f32(const void* h, const void* g, const void* ln_s, const void* ln_b,
                       const void* w1, const void* b1, const void* w2, const void* b2,
                       const void* gamma, void* dx, void* dw1, void* dw2, void* vecs,
                       void* workspace, long long n, int C, int hidden, float eps, int gelu_fast,
                       int first, int last, void* stream) {
  if (!imt_ln_mlp_bwd_supported(C, hidden) || n <= 0 ||
      reinterpret_cast<uintptr_t>(workspace) % 1024)
    return cudaErrorInvalidValue;
  auto bwd = gelu_fast ? &imt::f32::backward<true> : &imt::f32::backward<false>;
  return bwd(static_cast<const float*>(h), static_cast<const float*>(g),
             static_cast<const float*>(ln_s), static_cast<const float*>(ln_b),
             static_cast<const float*>(w1), static_cast<const float*>(b1),
             static_cast<const float*>(w2), static_cast<const float*>(b2),
             static_cast<const float*>(gamma), static_cast<float*>(dx), static_cast<float*>(dw1),
             static_cast<float*>(dw2), static_cast<float*>(vecs), static_cast<char*>(workspace), n,
             C, hidden, eps, first, last, static_cast<cudaStream_t>(stream));
}

const char* imt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
