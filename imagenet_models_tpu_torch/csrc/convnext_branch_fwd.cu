// The fused ConvNeXt branch, forward, for Hopper (sm_90a): kernel 10.
//
//   out = (GELU(LN(dwconv7(x) + dw_b) @ W1^T + b1) @ W2^T + b2) * gamma
//
// per token of a (B, H, W, C) NHWC map, in one launch: the pre-residual
// branch of a ConvNeXt block (the residual add and drop-path stay with the
// caller).
//
// Replaces the TPU kernel `_fwd_kernel` / `_branch_fwd_pallas` in
// imagenet_models_tpu/ops/convnext_branch.py (:74-92, :213-239).
//
// Numerics (the TPU kernel's, and `plain_convnext_branch`'s): the depthwise
// conv in fp32 from the upcast x (bias first, then the 49 taps in row-major
// order), so h is never rounded to x's type; LayerNorm in fp32 (two-pass
// statistics); the normalized tokens cast to x's type; both products on
// operands of x's type with fp32 sums (bf16 on wgmma; fp32 as 3xTF32, see
// convnext_branch_common.cuh); + b1 and the exact GELU (A&S erf, as
// `_erf_poly`) in fp32, cast to x's type; + b2, * gamma in fp32, one final
// cast.
//
// What bounds it on the H100. The two products are 16 N C^2 flops against
// some 4 N C bytes of x and out: at every ConvNeXt width far above the card's
// ~295 flop/byte balance, so the tensor cores bound it (0.060 ms per launch
// at B=128 in bf16 at every stage: N C^2 is the same). The conv's 49 N C
// multiply-adds run on the CUDA cores.
//
// bf16: a pipeline of three stages over a workspace, kernel 1's own
// (csrc/ln_mlp_fwd.cu) with its LayerNorm prologue replaced:
//  (i')  ring::conv_ln_kernel<false> (convnext_branch_ring.cuh): the conv
//        from a ring of x rows in shared memory and LayerNorm, tok =
//        bf16(LN(h)) into the workspace; h never leaves the block;
//  (ii)  kernel 1's ln_mlp_fwd_gemm_kernel<kHid> (ln_mlp_fwd_stages.cuh,
//        shared, not copied) with the A&S GELU: hmid into the workspace;
//  (iii) its ln_mlp_fwd_gemm_kernel<kOut>: out = bf16((hmid W2^T + b2) *
//        gamma).
// What remains over the bound is kernel 1's (hmid's round trip through
// device memory, the GELU epilogue) and the conv's 49 fp32 multiply-adds
// per element on the CUDA cores.
//
// fp32: the first design's kernel, below, bit for bit. The TPU kernel takes whole
// images per grid step, with a zero-padded slab of x and both weight
// matrices resident in VMEM. On Hopper:
//   * one block of 8 warps per tile of T consecutive tokens of the flattened
//     (B, H, W) map (a tile may span two images; each token's window is
//     bounds-checked within its own image, so nothing is padded or copied);
//   * stage 1, one warp per token: the 49-tap conv reads x and the (49, C)
//     fp32 taps through the read-only cache (neighbouring tokens of a tile
//     share their windows there), LayerNorm runs on the fp32 sums in
//     registers, and the normalized token goes to shared memory in x's type;
//   * stage 2 is kernel 1's LN+MLP body (csrc/ln_mlp_fwd.cu) on that tile:
//     W1 row chunks and W2 column chunks of HC hidden units stream through
//     shared memory with cp.async, the hidden chunk gets b1 and the GELU in
//     shared memory and never reaches HBM, and the (T, C) output sums stay in
//     wmma accumulators across the hidden loop; the ragged last tile is
//     masked. Kernel 1 is not changed: this file keeps its own copy of the
//     loop, written for both operand types.

#include "convnext_branch_common.cuh"
#include "convnext_branch_ring.cuh"
#include "hopper_gemm.cuh"
#include "ln_mlp_fwd_stages.cuh"

namespace {

using namespace imt;
using namespace imt::branch;

constexpr int kBF16 = 0, kF32 = 1;  // operand type codes of the C interface

// Shared-memory plan, identical on host and device. Region 0 holds the LN'd
// tile and both weight chunks during the loop and the fp32 output tile in the
// epilogue; the hidden chunk (fp32 partial sums, then x's type) follows it.
struct Layout {
  int ldx, ldw2, ldh, ldg, ldo;
  size_t xs, w1s, w2s, os, hf, gs, total;
};

template <typename E>
__host__ __device__ inline Layout make_layout(int C, int T, int HC, int KS) {
  constexpr int P = Pad<E>::value;
  constexpr size_t es = sizeof(E);
  Layout L;
  L.ldx = C + P;    // rows of the LN'd tile and of the W1 chunk
  L.ldw2 = HC + P;  // rows of the W2 chunk
  L.ldh = HC + 4;   // fp32 rows of the hidden chunk
  L.ldg = HC + P;   // rows of the GELU'd hidden chunk
  L.ldo = C + 4;    // fp32 rows of the output tile
  const size_t xs_b = align128(size_t(T) * L.ldx * es);
  const size_t w1_b = align128(size_t(HC) * L.ldx * es);
  const size_t w2_b = align128(size_t(C) * L.ldw2 * es);
  const size_t os_b = align128(size_t(T) * L.ldo * 4);
  L.xs = 0;
  L.w1s = xs_b;
  L.w2s = xs_b + w1_b;
  L.os = 0;
  const size_t region0 = (xs_b + w1_b + w2_b) > os_b ? (xs_b + w1_b + w2_b) : os_b;
  L.hf = region0;
  L.gs = L.hf + align128(size_t(KS) * T * L.ldh * 4);
  L.total = L.gs + align128(size_t(T) * L.ldg * es);
  return L;
}

// T tokens per block, HC hidden units per chunk; the (T x HC) first product on
// a Grid1<T, HC, MT1, NT1> warp grid, the (T x C) output on a WM2 x WN2 grid
// with MT2 row blocks and up to NT2 column blocks per warp; Q 4-channel units
// of a token row per lane in stage 1.
template <typename E, int T, int HC, int MT1, int NT1, int MT2, int NT2, int Q>
__global__ void __launch_bounds__(kThreads, 1)
branch_fwd_kernel(const E* __restrict__ x, const float* __restrict__ taps,
                  const float* __restrict__ dwb, const float* __restrict__ ln_s,
                  const float* __restrict__ ln_b, const E* __restrict__ w1,
                  const float* __restrict__ b1, const E* __restrict__ w2,
                  const float* __restrict__ b2, const float* __restrict__ gamma,
                  E* __restrict__ out, int H, int W, long long n, int C, int hidden, float eps) {
  typedef Mma<E> M;
  using G1 = Grid1<T, HC, MT1, NT1>;
  constexpr int WM1 = G1::WM1, WN1 = G1::WN1, KS = G1::KS;
  constexpr int WM2 = T / 16 / MT2;
  constexpr int WN2 = kWarps / WM2;
  static_assert(WM2 * MT2 == T / 16 && WM2 * WN2 == kWarps, "second-product warp grid");
  static_assert(HC % M::K == 0, "hidden chunk of whole k-steps");

  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout<E>(C, T, HC, KS);
  E* Xs = reinterpret_cast<E*>(smem + L.xs);
  E* W1s = reinterpret_cast<E*>(smem + L.w1s);
  E* W2s = reinterpret_cast<E*>(smem + L.w2s);
  float* Os = reinterpret_cast<float*>(smem + L.os);
  float* Hf = reinterpret_cast<float*>(smem + L.hf);
  E* Gs = reinterpret_cast<E*>(smem + L.gs);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long row0 = static_cast<long long>(blockIdx.x) * T;
  const int nchunks = hidden / HC;
  const int U = C / 4;

  copy_rows(W1s, L.ldx, w1, C, HC, C, tid);  // W1 chunk 0
  cp_commit();

  // stage 1: conv, LayerNorm, the token in x's type into Xs; rows past n zero
  for (int t = warp; t < T; t += kWarps) {
    E* xs = Xs + t * L.ldx;
    const long long r = row0 + t;
    if (r < n) {
      float h[Q][4];
      dw_token<Q, false>(x, taps, dwb, r, H, W, C, lane, h);
      const float2 st = ln_stats(h, C, lane, eps);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int u = lane + 32 * q;
        if (u < U) {
          float f[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            f[e] = (h[q][e] - st.x) * st.y * __ldg(ln_s + 4 * u + e) + __ldg(ln_b + 4 * u + e);
          store4(xs + 4 * u, f);
        }
      }
    } else {
      for (int u = lane; u < U; u += 32) zero4(xs + 4 * u);
    }
  }
  cp_wait<0>();
  __syncthreads();

  // first-product warp tile
  const int wm1 = warp % WM1, wn1 = (warp / WM1) % WN1;
  const int ks = warp / (WM1 * WN1);
  const int ksteps = C / M::K;
  const int kb = ks * ksteps / KS, ke = (ks + 1) * ksteps / KS;
  // second-product warp tile
  const int cblocks = C / 16;
  const int wm2 = warp % WM2, wn2 = warp / WM2;
  const int cb0 = wn2 * cblocks / WN2;
  const int nt2 = (wn2 + 1) * cblocks / WN2 - cb0;

  typename M::Acc acc[MT2][NT2];
  zero_acc<E, MT2, NT2>(acc);

  for (int j = 0; j < nchunks; ++j) {
    copy_rows(W2s, L.ldw2, w2 + static_cast<size_t>(j) * HC, hidden, C, HC, tid);  // W2 chunk j
    cp_commit();

    // first product: Hf[ks] = Xs[:, k-slice ks] @ W1chunk^T
    hidden_product<E, MT1, NT1, true>(Xs, L.ldx, W1s, L.ldx, Hf + ks * T * L.ldh, L.ldh, kb, ke,
                                      wm1 * MT1, wn1 * NT1);
    __syncthreads();  // W1 chunk consumed, Hf complete

    if (j + 1 < nchunks) copy_rows(W1s, L.ldx, w1 + static_cast<size_t>(j + 1) * HC * C, C, HC, C, tid);
    cp_commit();

    // + b1, GELU in fp32, cast to x's type
    for (int i = tid; i < T * HC; i += kThreads) {
      const int t = i / HC, c = i - t * HC;
      float v = __ldg(b1 + j * HC + c);
#pragma unroll
      for (int s = 0; s < KS; ++s) v += Hf[s * T * L.ldh + t * L.ldh + c];
      Gs[t * L.ldg + c] = to_elem<E>(gelu_as(v));
    }
    cp_wait<1>();  // W2 chunk j has landed (W1 chunk j+1 may still be in flight)
    __syncthreads();

    // second product: acc += Gs @ W2chunk^T
    out_product<E, MT2, NT2, HC / M::K, true>(acc, Gs, L.ldg, W2s, L.ldw2, wm2 * MT2, cb0, nt2);
    cp_wait<0>();
    __syncthreads();  // W1 chunk j+1 visible; W2s and Gs free
  }

  // epilogue: the fp32 tile through shared memory, + b2, * gamma, one cast
  store_acc<E, MT2, NT2>(acc, Os, L.ldo, wm2 * MT2, cb0, nt2);
  __syncthreads();
  for (int i = tid; i < T * U; i += kThreads) {
    const int t = i / U, u = i - t * U;
    const long long r = row0 + t;
    if (r < n) {
      const float* o = Os + t * L.ldo + 4 * u;
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = (o[e] + __ldg(b2 + 4 * u + e)) * __ldg(gamma + 4 * u + e);
      store4(out + r * C + 4 * u, f);
    }
  }
}

struct Args {
  const void *x, *taps, *dwb, *ln_s, *ln_b, *w1, *b1, *w2, *b2, *gamma;
  void* out;
  int H, W;
  long long n;
  int C, hidden;
  float eps;
  cudaStream_t stream;
};

// Launches one configuration, or with `check` only says whether it takes
// (C, hidden).
template <typename E, int T, int HC, int MT1, int NT1, int MT2, int NT2, int Q>
cudaError_t launch(const Args& a, bool check) {
  constexpr int KS = Grid1<T, HC, MT1, NT1>::KS;
  constexpr int WN2 = kWarps / (T / 16 / MT2);
  if ((a.C / 16 + WN2 - 1) / WN2 > NT2 || a.hidden % HC || units_per_lane(a.C) > Q)
    return cudaErrorInvalidValue;
  const Layout L = make_layout<E>(a.C, T, HC, KS);
  if (L.total > kMaxSmem) return cudaErrorInvalidValue;
  if (check) return cudaSuccess;
  auto kern = branch_fwd_kernel<E, T, HC, MT1, NT1, MT2, NT2, Q>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L.total));
  if (e == cudaSuccess) e = prefer_l1(reinterpret_cast<const void*>(kern), L.total);
  if (e != cudaSuccess) return e;
  const long long blocks = (a.n + T - 1) / T;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(blocks), kThreads, L.total, a.stream>>>(
      static_cast<const E*>(a.x), static_cast<const float*>(a.taps),
      static_cast<const float*>(a.dwb), static_cast<const float*>(a.ln_s),
      static_cast<const float*>(a.ln_b), static_cast<const E*>(a.w1),
      static_cast<const float*>(a.b1), static_cast<const E*>(a.w2),
      static_cast<const float*>(a.b2), static_cast<const float*>(a.gamma),
      static_cast<E*>(a.out), a.H, a.W, a.n, a.C, a.hidden, a.eps);
  return cudaGetLastError();
}

// <type, T, HC, first-product tile MT1 x NT1, second-product tile MT2 x NT2,
// units per lane Q>: fp32 (twice the bytes, three products per step) one
// small tile at every width. (bf16 runs run_bf16.)
cudaError_t dispatch_f32(const Args& a, bool check) {
  return launch<float, 16, 16, 1, 1, 1, 8, 8>(a, check);
}

bool shape_ok(int dtype, int C, int hidden) {
  return (dtype == kBF16 || dtype == kF32) && C > 0 && C % 16 == 0 && C <= 1024 && hidden > 0 &&
         hidden % 64 == 0;
}

// bf16: stages [first, last) of (i') the conv and LayerNorm into the
// workspace's tok, (ii) and (iii) kernel 1's GEMM stages with the A&S GELU.
cudaError_t run_bf16(const Args& a, int B, char* ws, int first, int last) {
  if (first <= 0 && last > 0) {
    const ring::Plan p = ring::plan_ln(B, a.H, a.W, a.C, false, sm_count());
    bf16* tok = reinterpret_cast<bf16*>(ws + lnmlp_fwd::plan(a.n, a.C, a.hidden).tok);
    const cudaError_t e = ring::launch_conv_ln<false>(
        p, static_cast<const bf16*>(a.x), static_cast<const float*>(a.taps),
        static_cast<const float*>(a.dwb), static_cast<const float*>(a.ln_s),
        static_cast<const float*>(a.ln_b), a.eps, tok, nullptr, nullptr, nullptr, nullptr,
        nullptr, nullptr, nullptr, a.hidden, a.stream);
    if (e != cudaSuccess) return e;
  }
  const lnmlp_fwd::GemmInputs g = {
      static_cast<const bf16*>(a.w1), static_cast<const bf16*>(a.w2),
      static_cast<const float*>(a.b1), static_cast<const float*>(a.b2),
      static_cast<const float*>(a.gamma), static_cast<bf16*>(a.out), ws, a.n, a.C, a.hidden};
  return lnmlp_fwd::run_gemm_stages<kGeluAS>(g, first, last, a.stream);
}

// Whether the bf16 pipeline takes a (B, H, W, C) map: the ring within a
// block's shared memory, and kernel 1's GEMM stages' limits.
bool bf16_ok(int B, int H, int W, int C) {
  const long long n = static_cast<long long>(B) * H * W;
  const ring::Plan p = ring::plan_ln(B, H, W, C, false, 132);
  return n <= 0x7fffffffLL && p.smem <= ring::kRingBudget && p.blocks() <= 0x7fffffffLL;
}

}  // namespace

extern "C" {

// Returns 1 when the kernel takes channel width C and hidden width `hidden`
// for operand type `dtype` (0 bf16, 1 fp32): C a multiple of 16 up to 1024,
// hidden a multiple of 64, and the fp32 tile, or the bf16 ring of a 7 x 7
// map, within a block's shared memory.
int imt_convnext_branch_fwd_supported(int C, int hidden, int dtype) {
  if (!shape_ok(dtype, C, hidden)) return 0;
  if (dtype == kBF16) return bf16_ok(1, 7, 7, C);
  Args a{};
  a.C = C;
  a.hidden = hidden;
  return dispatch_f32(a, true) == cudaSuccess;
}

// Bytes of device workspace a call needs (bf16: kernel 1's tok and hmid;
// fp32: none); 0 for a shape the kernel does not take.
long long imt_convnext_branch_fwd_workspace_bytes(int B, int H, int W, int C, int hidden,
                                                  int dtype) {
  if (!shape_ok(dtype, C, hidden) || B <= 0 || H <= 0 || W <= 0) return 0;
  if (dtype == kF32) return 1;
  if (!bf16_ok(B, H, W, C)) return 0;
  return static_cast<long long>(
      lnmlp_fwd::plan(static_cast<long long>(B) * H * W, C, hidden).total);
}

// x (B, H, W, C) NHWC of `dtype`; taps (49, C) fp32, tap ky * 7 + kx; dwb,
// ln_s, ln_b, b2, gamma (C) and b1 (hidden) fp32; w1 (hidden, C) and w2 (C,
// hidden) of `dtype`; out like x. All contiguous and 16-byte aligned;
// `workspace` of imt_convnext_branch_fwd_workspace_bytes bytes, 1024-byte
// aligned. bf16 runs stages [first, last) of (i') the conv and LayerNorm,
// (ii) the hidden product and GELU, (iii) the output product and layer
// scale (0 and 3 run it all; a stage run alone reads what the stages before
// it left in the workspace); fp32 is one launch, whatever first and last
// say. Launches on `stream`; returns the launch status (a cudaError_t; 0
// is success).
int imt_convnext_branch_fwd(const void* x, const void* taps, const void* dwb, const void* ln_s,
                            const void* ln_b, const void* w1, const void* b1, const void* w2,
                            const void* b2, const void* gamma, void* out, void* workspace,
                            int dtype, int B, int H, int W, int C, int hidden, float eps,
                            int first, int last, void* stream) {
  if (!shape_ok(dtype, C, hidden) || B <= 0 || H <= 0 || W <= 0) return cudaErrorInvalidValue;
  const Args a{x,  taps, dwb, ln_s, ln_b, w1, b1, w2, b2, gamma, out, H, W,
               static_cast<long long>(B) * H * W, C, hidden, eps, static_cast<cudaStream_t>(stream)};
  if (dtype == kF32) return dispatch_f32(a, false);
  if (!bf16_ok(B, H, W, C) || reinterpret_cast<uintptr_t>(workspace) % 1024)
    return cudaErrorInvalidValue;
  return run_bf16(a, B, static_cast<char*>(workspace), first, last);
}

const char* imt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
