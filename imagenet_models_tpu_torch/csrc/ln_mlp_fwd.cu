// Fused ConvNeXt branch body, forward, for Hopper (sm_90a): kernel 1.
//   out = (GELU(LN(h) @ W1^T + b1) @ W2^T + b2) * gamma,  per token.
//
// Replaces the TPU kernel `_kernel` / `_fused_ln_mlp_pallas` in
// imagenet_models_tpu/ops/convnext_block.py (:294-307, :341-362).
//
// Numerics (the Pallas kernel's): LayerNorm with fp32 statistics (two-pass
// mean and variance, eps given); LN'd tokens cast to bf16; first product in
// bf16 with fp32 sums, + b1 in fp32; GELU in fp32, cast to bf16 (exact erff
// at eval, the minimax erf fit in training: two instances); second product
// with fp32 sums, + b2, * gamma in fp32; one final cast to bf16. No sum is
// split across CTAs and nothing is added with atomics: the same inputs give
// the same bits on every run.
//
// What bounds it on the H100. Two products of N x hidden x C (4*N*C^2 flops
// each at hidden = 4C) against 4 bytes per token per channel of tokens in
// and out: far above the card's ~295 flop/byte balance, so the work is bound
// by the tensor cores, 0.03 ms at peak per launch at the B=64 stage shapes
// of map_convnext_tiny and 0.12 ms at B=256. The earlier design (one block
// of 8 warps per tile of 16-64 tokens, wmma, all of W1 and W2 streamed
// through shared memory for every tile, the hidden tile kept on chip) moved
// 16*C^2 bytes of weights per tile at 16-64 flops per byte and ran 9-19x
// over that bound. This one is kernel 2's machinery (hopper_gemm.cuh): two
// GEMM-shaped kernels with 128 x 128 tiles on `wgmma` (m64n128k16, fp32 sums
// in registers) fed by TMA into a four-stage ring of shared memory that a
// producer warp keeps full, with mbarriers, while two consumer warpgroups of
// 64 rows each multiply; persistent CTAs walk over the tiles, so the producer
// loads the next tile while the consumers finish one, and each weight byte
// serves 128 tokens:
//
//  (i)   ln_mlp_fwd_prologue_kernel, a warp (16 lanes at C <= 128) per token
//        row, several rows in flight, memory-bound: tok = bf16(LN(h)) into
//        the workspace. No statistics are kept: the backward recomputes them.
//  (ii)  ln_mlp_fwd_gemm_kernel<kHid>: pre1 = tok W1^T (K = C) on 128 tokens
//        x 128 hidden units; the epilogue writes hmid = bf16(GELU(pre1 + b1))
//        into swizzled shared memory, and a TMA store takes it to the
//        workspace while the next tile multiplies.
//  (iii) ln_mlp_fwd_gemm_kernel<kOut>: hmid W2^T (K = hidden; W2 is (C,
//        hidden), a K-major B operand) on 128 tokens x 128 channels; the
//        epilogue writes bf16((acc + b2) * gamma) the same way to out.
//
// Ragged edges (N not a multiple of 128, C = 64 or 688 = 43 x 16 in a
// 64-deep k-block or a 128-wide channel tile, hidden tiles of 64) take TMA's
// zero fill on the loads and the store maps' clipping on the stores: one
// path. What remains over the bound: hmid (N x hidden bf16) is written and
// read back through HBM, 16 bytes per token per channel (about 2.6 ms per
// B=256 forward at 3.35 TB/s, most of it at stages 0-1); the GELU epilogue
// (exact erff at eval) runs on the CUDA cores between a tile's products and
// the next tile's, not beside them: both consumer warpgroups work on one
// tile; and at stages 2-3 tiles too small for the L2's rate.
//
// Stages (ii) and (iii), their workspace and their host code live in
// ln_mlp_fwd_stages.cuh, which kernel 10's bf16 instance (the fused ConvNeXt
// branch, convnext_branch_fwd.cu) shares with its own prologue and the A&S
// GELU.
//
// fp32 tokens (an fp32 model) take the fp32 instance of ln_mlp_f32.cuh: the
// same three stages with no cast to bf16, on the CUDA cores.

#include "ln_mlp_common.cuh"
#include "ln_mlp_f32.cuh"
#include "ln_mlp_fwd_stages.cuh"

namespace {

using namespace imt;

// ---------------------------------------------------------- (i) prologue

// tok = bf16(LN(h)) for 8 (32 / L) R rows a block, in ln_mlp_common.cuh's
// row layout: all of a lane's loads in flight at once, then per row the mean
// and the centred second moment in fp32 from the same registers.
template <int L, int S, int R>
__global__ void __launch_bounds__(kThreads)
ln_mlp_fwd_prologue_kernel(const bf16* __restrict__ h, const float* __restrict__ ln_s,
                           const float* __restrict__ ln_b, bf16* __restrict__ tok, long long n,
                           int C, float eps) {
  constexpr int G = 32 / L;
  const int lane = threadIdx.x & 31;
  const int sl = lane % L;
  const long long r0 =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * G * R + lane / L;
  const int segs = C / 8;
  uint4 hraw[R][S];
#pragma unroll
  for (int u = 0; u < R; ++u)
#pragma unroll
    for (int q = 0; q < S; ++q)
      if (r0 + u * G < n && sl + L * q < segs)
        hraw[u][q] = reinterpret_cast<const uint4*>(h + (r0 + u * G) * C)[sl + L * q];
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
    uint4* trow = reinterpret_cast<uint4*>(tok + r * C);
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const int sgi = sl + L * q;
      if (sgi < segs) {
        unpack8(hraw[u][q], f);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          f[e] = (f[e] - mu) * rstd * ln_s[sgi * 8 + e] + ln_b[sgi * 8 + e];
        trow[sgi] = pack8(f);
      }
    }
  }
}

template <int L, int S, int R>
struct Prologue {
  static constexpr auto kernel = ln_mlp_fwd_prologue_kernel<L, S, R>;
};

struct Inputs {
  const bf16 *h, *w1, *w2;
  const float *ln_s, *ln_b, *b1, *b2, *gamma;
  bf16* out;
  char* ws;
  long long n;
  int C, hidden;
  float eps;
};

template <int GM>
cudaError_t run_stages(const Inputs& in, int first, int last, cudaStream_t st) {
  const long long n = in.n;
  const int C = in.C;
  if (first <= 0 && last > 0) {  // (i)
    bf16* tok = reinterpret_cast<bf16*>(in.ws + lnmlp_fwd::plan(n, C, in.hidden).tok);
    const long long rb = (n + row_step(C) - 1) / row_step(C);
    if (rb > 0x7fffffffLL) return cudaErrorInvalidValue;
    const cudaError_t e = launch_rows<Prologue>(C, static_cast<unsigned>(rb), 0, st, in.h,
                                                in.ln_s, in.ln_b, tok, n, C, in.eps);
    if (e != cudaSuccess) return e;
  }
  const lnmlp_fwd::GemmInputs g = {in.w1, in.w2, in.b1, in.b2, in.gamma, in.out, in.ws,
                                   n,     C,     in.hidden};
  return lnmlp_fwd::run_gemm_stages<GM>(g, first, last, st);
}

}  // namespace

extern "C" {

// Widths the kernel takes: C a multiple of 16 up to 1024 and hidden a
// multiple of 64. Returns 1 when (C, hidden) is supported.
int imt_ln_mlp_fwd_supported(int C, int hidden) {
  return C > 0 && C % 16 == 0 && C <= 1024 && hidden > 0 && hidden % 64 == 0;
}

// Bytes of device workspace a call on n tokens needs.
long long imt_ln_mlp_fwd_workspace_bytes(long long n, int C, int hidden) {
  if (!imt_ln_mlp_fwd_supported(C, hidden) || n <= 0) return 0;
  return static_cast<long long>(lnmlp_fwd::plan(n, C, hidden).total);
}

// The forward, stages [first, last) of (i) the LN prologue, (ii) the hidden
// product and GELU, (iii) the output product and layer scale; 0 and 3 run it
// all. h (n, C) bf16, w1 (hidden, C) and w2 (C, hidden) bf16, vectors fp32,
// out (n, C) bf16; all contiguous and 16-byte aligned; `workspace` of
// imt_ln_mlp_fwd_workspace_bytes bytes, 1024-byte aligned. A stage run alone
// reads what the stages before it left in the workspace. gelu_fast selects
// the training GELU (the minimax erf fit) over exact erf. Launches on
// `stream`; returns the launch status (a cudaError_t; 0 is success).
int imt_ln_mlp_fwd_bf16(const void* h, const void* ln_s, const void* ln_b, const void* w1,
                        const void* b1, const void* w2, const void* b2, const void* gamma,
                        void* out, void* workspace, long long n, int C, int hidden, float eps,
                        int gelu_fast, int first, int last, void* stream) {
  if (!imt_ln_mlp_fwd_supported(C, hidden) || n <= 0 || n > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(workspace) % 1024)
    return cudaErrorInvalidValue;
  const Inputs in = {static_cast<const bf16*>(h),      static_cast<const bf16*>(w1),
                     static_cast<const bf16*>(w2),     static_cast<const float*>(ln_s),
                     static_cast<const float*>(ln_b),  static_cast<const float*>(b1),
                     static_cast<const float*>(b2),    static_cast<const float*>(gamma),
                     static_cast<bf16*>(out),          static_cast<char*>(workspace),
                     n, C, hidden, eps};
  auto st = static_cast<cudaStream_t>(stream);
  return gelu_fast ? run_stages<kGeluFit>(in, first, last, st)
                   : run_stages<kGeluErf>(in, first, last, st);
}

// Bytes of device workspace a call of the fp32 instance on n tokens needs.
long long imt_ln_mlp_fwd_f32_workspace_bytes(long long n, int C, int hidden) {
  if (!imt_ln_mlp_fwd_supported(C, hidden) || n <= 0) return 0;
  return static_cast<long long>(imt::f32::fwd_workspace_bytes(n, C, hidden));
}

// As imt_ln_mlp_fwd_bf16 with fp32 h, w1, w2 and out, and a workspace of
// imt_ln_mlp_fwd_f32_workspace_bytes bytes.
int imt_ln_mlp_fwd_f32(const void* h, const void* ln_s, const void* ln_b, const void* w1,
                       const void* b1, const void* w2, const void* b2, const void* gamma,
                       void* out, void* workspace, long long n, int C, int hidden, float eps,
                       int gelu_fast, int first, int last, void* stream) {
  if (!imt_ln_mlp_fwd_supported(C, hidden) || n <= 0 ||
      reinterpret_cast<uintptr_t>(workspace) % 1024)
    return cudaErrorInvalidValue;
  auto fwd = gelu_fast ? &imt::f32::forward<true> : &imt::f32::forward<false>;
  return fwd(static_cast<const float*>(h), static_cast<const float*>(ln_s),
             static_cast<const float*>(ln_b), static_cast<const float*>(w1),
             static_cast<const float*>(b1), static_cast<const float*>(w2),
             static_cast<const float*>(b2), static_cast<const float*>(gamma),
             static_cast<float*>(out), static_cast<char*>(workspace), n, C, hidden, eps, first,
             last, static_cast<cudaStream_t>(stream));
}

const char* imt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
