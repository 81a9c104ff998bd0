// CSWin vertical-stripe attention with LePE, forward, for Hopper (sm_90a):
// per stripe of T = H*ws tokens (the full height of the map, ws columns) and
// per head h of D channels,
//   out = softmax((q*scale) k^T) v + LePE(v),
// LePE(v) = wb + the 3x3 depthwise stencil of v with taps w9, zero-padded at
// the stripe's own borders. q, k and v are read straight from unpartitioned
// (B, H, W, *) maps (each may be a channel slice of a wider map, such as the
// qkv projection's); out is the contiguous (B, H, W, C) map. T <= 256
// tokens, heads of D = 24 or 32 channels, bf16 or fp32 maps.
//
// Replaces the TPU kernel `_vs_fwd_kernel` / `_vs_fwd_pallas` in
// imagenet_models_tpu/ops/stripe_attention.py (:134-157, :264-281).
//
// Numerics (`_vs_fwd_kernel`, `_attend` in partition_attention.py:107-115):
// q times the scale rounded to bf16, as `qr * scale` in bf16; scores q.k in
// fp32 from exact products of bf16 operands; softmax in fp32 as
// exp(s - max) / sum; p rounded to bf16; p.v in fp32 from exact products; the
// LePE in fp32 from the fp32 taps and bias, added to the fp32 attention
// output; one cast at the output. The fp32 instance (fp32 maps, for an fp32
// model) is the same with every rounding to the operand type gone: q times
// the fp32 scale, p kept in fp32.
//
// What bounds it on the H100: bytes. Per token and head it reads 3 x 2D
// bytes of q, k, v and writes 2D, and does 4*T*D flops (12.5 kflop at
// T = 98): about 50 flops per byte, far below the card's ~295 flop/byte
// balance point. Neither partition nor reverse is a copy through device
// memory: a block finds a stripe's pixels by index arithmetic (the TPU
// kernel's BlockSpec over the W axis), and the LePE reads its 3x3
// neighbourhood of v from the block's shared copy.
//
// bf16: tensor cores (`stripe_attn_fwd_mma`). A block stays on one head
// (blockIdx.y) and walks stripes (a persistent grid of about one wave):
//   * each stripe's q, k and v rows arrive by 16-byte cp.async copies into
//     one of two buffers while the block computes the stripe before: one
//     barrier per stripe. The rows are padded to TP = 16*NKB (T = 98 -> 112)
//     and D to 32 channels with zeros written once per block;
//   * a block has one warp per 16-row slice (7 at T = 98, at most 8; past
//     128 tokens a warp takes two), so no warp waits on another's second
//     slice: 4 warps over 7 slices would leave one idle half the time;
//   * a warp's scores are mma.sync m16n8k16 bf16 products with fp32 sums,
//     q's fragments scaled (bf16(q*scale)) after ldmatrix, the keys' from
//     ldmatrix; the padded keys are -inf (JAX's -1e30 mask); the row max and
//     sum come from the quad of lanes sharing a row; p is normalised,
//     rounded to bf16 and packed straight from the score registers into the
//     A fragments of p v, whose v fragments come from ldmatrix.trans. The
//     whole row of scores stays in registers for T <= 128 (14 tiles, 56
//     registers at T = 98); longer stripes take two key chunks of 128 and
//     recompute the scores for the sum and for p, no online rescaling;
//   * the LePE (bias and 9 taps from the shared v, zero outside the stripe)
//     is added to the fp32 p v fragments, which are then rounded once and
//     staged through shared memory to 16-byte stores at the stripe's
//     pixels; the padded rows are never stored.
// The TPU kernel packs two stripes into one 128-row score matrix under a
// -1e30 block-diagonal mask: that is the TPU's tile geometry, and per-stripe
// tiles give the same result without it.
// Measured at ga_cswin_tiny's B=128 path shapes (chip_smoke.py phase 11;
// NVIDIA H100 80GB HBM3, 700.00 W): 0.0425 ms a launch at stage 3 by CUDA
// events around the wrapper (0.0405 ms of device time by the profiler),
// 0.0816 at the stage-5 block, 0.0358 at a gram layer: 1.152 ms per
// forward (device 1.079) against a byte bound of 0.205, the SDPA +
// depthwise-conv composition's 1.759 (and 4.92 of partition copies it
// needs), and the CUDA-core design's 5.35 before it (kernel_variants.py, in
// turns). At T = 98 the instance takes 128 registers, none spilled: two
// blocks of 7 warps on an SM. What is left above the bound is latency and
// issue: each warp's chain of products, softmax and LePE epilogue (9 taps
// of two rows and four channel pairs a thread) with 14 warps on an SM, the
// 14 padded rows of the seventh slice, and, at this batch, the wrapper's
// host time per launch, of the order of the device time.
//
// fp32: the CUDA-core kernel (`stripe_attn_fwd_kernel`): TF32 products would
// not keep the fp32 function's digits. One block of 4 warps per (stripe,
// head); a warp takes a query row, its lanes own keys for the scores and
// then channels for p v, p passed between lanes by shuffles.

#include <type_traits>

#include "stripe_attn_common.cuh"

namespace {

using namespace imt_sa;

// ---------------------------------------------------------------- fp32

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <typename E, int NJ, int D>
__global__ void __launch_bounds__(kThreads)
stripe_attn_fwd_kernel(Operand<E> q, Operand<E> k, Operand<E> v, const float* __restrict__ w9,
                       const float* __restrict__ wb, E* __restrict__ out, Stripes g,
                       float qscale) {
  constexpr int kLdw = Slot<E>::kLdw;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* Qs = smem;
  uint32_t* Ks = Qs + g.T * kLdw;
  uint32_t* Vs = Ks + g.T * kLdw;
  const long long s = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  load_stripe<E, D, true>(q, h * D, g, s, Qs, tid, kThreads, qscale);
  load_stripe<E, D, false>(k, h * D, g, s, Ks, tid, kThreads, 1.f);
  load_stripe<E, D, false>(v, h * D, g, s, Vs, tid, kThreads, 1.f);
  // lanes past D (D = 24) repeat channel D-1 and write nothing
  const int c = lane < D ? lane : D - 1;
  const int ch = h * D + c;
  float w[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) w[t] = w9[t * g.C + ch];
  const float bias = wb[ch];
  __syncthreads();

  for (int i = warp; i < g.T; i += kWarps) {
    float r[D], p[NJ];
    load_row<E, D>(Qs, i, r);
    softmax_row<E, NJ, D>(r, Ks, g.T, lane, p);
    const float o = imt_pa::mix_rows<E, NJ>(p, Vs, g.T, c);
    const int a = i / g.ws, y = i - a * g.ws;
    const float l = lepe_at<E>(Vs, a, y, g, c, w, bias);
    if (lane < D) out[stripe_pixel(g, s, i) * g.C + ch] = Slot<E>::cast(o + l);
  }
}

template <typename E, int NJ, int D>
cudaError_t launch(Operand<E> q, Operand<E> k, Operand<E> v, const float* w9, const float* wb,
                   E* out, const Stripes& g, long long stripes, float qscale, cudaStream_t stream) {
  const size_t smem = size_t(3) * g.T * Slot<E>::kLdw * 4;
  auto kern = stripe_attn_fwd_kernel<E, NJ, D>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<dim3(static_cast<unsigned>(stripes), g.nh), kThreads, smem, stream>>>(q, k, v, w9, wb, out,
                                                                              g, qscale);
  return cudaGetLastError();
}

template <typename E, int D>
cudaError_t launch_d(Operand<E> q, Operand<E> k, Operand<E> v, const float* w9, const float* wb,
                     E* out, const Stripes& g, long long stripes, float qscale, cudaStream_t st) {
  switch ((g.T + 31) / 32) {
    case 1: return launch<E, 1, D>(q, k, v, w9, wb, out, g, stripes, qscale, st);
    case 2: return launch<E, 2, D>(q, k, v, w9, wb, out, g, stripes, qscale, st);
    case 3: return launch<E, 3, D>(q, k, v, w9, wb, out, g, stripes, qscale, st);
    case 4: return launch<E, 4, D>(q, k, v, w9, wb, out, g, stripes, qscale, st);
    case 5: return launch<E, 5, D>(q, k, v, w9, wb, out, g, stripes, qscale, st);
    case 6: return launch<E, 6, D>(q, k, v, w9, wb, out, g, stripes, qscale, st);
    case 7: return launch<E, 7, D>(q, k, v, w9, wb, out, g, stripes, qscale, st);
    default: return launch<E, 8, D>(q, k, v, w9, wb, out, g, stripes, qscale, st);
  }
}

// ---------------------------------------------------------------- bf16

// Shared memory of a block of the tensor-core kernel, in bytes: two buffers
// of the stripe's q, k, v (TP rows of kDS bf16 each), a 16-row staging slice
// per warp, the head's taps and bias (10 x D floats).
__host__ __device__ inline size_t mma_smem_bytes(int nkb, int D) {
  return (size_t(2) * 3 * 16 * nkb + size_t(mma_warps(nkb)) * 16) * kDS * sizeof(bf16) +
         size_t(kTaps + 1) * D * sizeof(float);
}

// A thread holds, for score tile t of its 16-row slice, the elements
// [g][2 t4 + 0, 1] (registers 0, 1) and [g + 8][2 t4 + 0, 1] (registers 2, 3)
// of that 16 x 8 tile (g = lane / 4, t4 = lane % 4), the m16n8 accumulator
// layout.
template <int NKB>
__global__ void __launch_bounds__(mma_warps(NKB) * 32, NKB <= kChunk ? 2 : 1)
stripe_attn_fwd_mma(Operand<bf16> q, Operand<bf16> k, Operand<bf16> v, const float* __restrict__ w9,
                    const float* __restrict__ wb, bf16* __restrict__ out, Stripes g,
                    long long stripes, float qscale) {
  constexpr int NW = mma_warps(NKB), kBlock = NW * 32, TP = 16 * NKB;
  constexpr int kBuf = 3 * TP * kDS;  // bf16 of one buffer
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  bf16* bufs = reinterpret_cast<bf16*>(fwd_smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  bf16* stage = bufs + 2 * kBuf + warp * 16 * kDS;
  float* W = reinterpret_cast<float*>(bufs + 2 * kBuf + NW * 16 * kDS);
  const int D = g.C / g.nh, coff = blockIdx.y * D;

  // the padding stays zero: it is written once, and the copies fill only
  // rows < T and channels < D
  for (int i = tid; i < 2 * kBuf / 8; i += kBlock)
    reinterpret_cast<uint4*>(bufs)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int e = tid; e < (kTaps + 1) * D; e += kBlock) {
    const int t = e / D, c = e - t * D;
    W[e] = t < kTaps ? w9[t * g.C + coff + c] : wb[coff + c];
  }
  __syncthreads();

  auto issue = [&](long long s, int b) {  // stripe s's q, k, v into buffer b
    const long long base = stripe_base(g, s);
    bf16* dst = bufs + b * kBuf;
    copy_stripe(q, coff, D, g, base, dst, tid, kBlock);
    copy_stripe(k, coff, D, g, base, dst + TP * kDS, tid, kBlock);
    copy_stripe(v, coff, D, g, base, dst + 2 * TP * kDS, tid, kBlock);
    imt_mma::cp_async_commit();
  };

  long long s = blockIdx.x;
  const long long stride = gridDim.x;
  if (s < stripes) issue(s, 0);
  for (int it = 0; s < stripes; ++it, s += stride) {
    const int b = it & 1;
    imt_mma::cp_async_wait_all();
    __syncthreads();  // stripe s has landed; every warp is done with the last one
    if (s + stride < stripes) issue(s + stride, b ^ 1);
    const bf16* Qs = bufs + b * kBuf;
    const bf16* Ks = Qs + TP * kDS;
    const bf16* Vs = Ks + TP * kDS;
    const long long base = stripe_base(g, s);
    for (int m0 = 16 * warp; m0 < TP; m0 += 16 * NW) {
      uint32_t qa[2][4];
      load_rows<true>(qa, Qs, m0, lane, qscale);
      float sc[2 * kChunk][4], mx[2], sum[2];
      softmax_stats<NKB>(Ks, qa, g.T, lane, sc, mx, sum);
      const float rsum[2] = {1.f / sum[0], 1.f / sum[1]};
      // p = exp(s - max) / sum rounded to bf16, then o += p v
      float o[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < key_chunks(NKB); ++kc) {
        chunk_exp<NKB>(Ks, qa, kc, g.T, lane, mx, sc);
#pragma unroll
        for (int t2 = 0; t2 < kChunk; ++t2) {
          if (kc * kChunk + t2 < NKB) {
            uint32_t pa[4];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float* e = sc[2 * t2 + h];
              pa[2 * h] = imt_mma::pack_bf16(div_by(e[0], sum[0], rsum[0]),
                                             div_by(e[1], sum[0], rsum[0]));
              pa[2 * h + 1] = imt_mma::pack_bf16(div_by(e[2], sum[1], rsum[1]),
                                                 div_by(e[3], sum[1], rsum[1]));
            }
            uint32_t vb[4][2];
            load_cols<false>(vb, Vs, 16 * (kc * kChunk + t2), lane, 1.f);
#pragma unroll
            for (int t = 0; t < 4; ++t) imt_mma::mma_bf16(o[t], pa, vb[t][0], vb[t][1]);
          }
        }
      }
      add_lepe<false>(o, Vs, W, D, m0, g, lane);
      store_slice(stage, o, 1.f, m0, D, coff, g, base, out, lane);
    }
  }
}

template <int NKB>
cudaError_t launch_mma(Operand<bf16> q, Operand<bf16> k, Operand<bf16> v, const float* w9,
                       const float* wb, bf16* out, const Stripes& g, long long stripes,
                       float qscale, cudaStream_t stream) {
  auto kern = stripe_attn_fwd_mma<NKB>;
  constexpr int kBlock = mma_warps(NKB) * 32;
  const size_t bytes = mma_smem_bytes(NKB, g.C / g.nh);
  // the largest block any shape asks for, once per device; then the blocks
  // that fit on one SM at this size, cached per device
  static imt_mma::LaunchCache cache;
  int per_sm = 1;
  const cudaError_t e = cache.prepare(reinterpret_cast<const void*>(kern), kMaxSmem, kBlock,
                                      bytes, &per_sm);
  if (e != cudaSuccess) return e;
  // about one wave of resident blocks, spread over the heads
  long long per_head =
      (static_cast<long long>(imt_mma::device_sms()) * per_sm + g.nh - 1) / g.nh;
  if (per_head > stripes) per_head = stripes;
  if (per_head < 1) per_head = 1;
  kern<<<dim3(static_cast<unsigned>(per_head), g.nh), kBlock, bytes, stream>>>(
      q, k, v, w9, wb, out, g, stripes, qscale);
  return cudaGetLastError();
}

// One instantiation per 16-token block of the padded stripe.
cudaError_t dispatch_mma(Operand<bf16> q, Operand<bf16> k, Operand<bf16> v, const float* w9,
                         const float* wb, bf16* out, const Stripes& g, long long stripes,
                         float qscale, cudaStream_t st) {
  switch (round16(g.T) / 16) {
#define IMT_CASE(N) \
  case N: return launch_mma<N>(q, k, v, w9, wb, out, g, stripes, qscale, st);
    IMT_CASE(1) IMT_CASE(2) IMT_CASE(3) IMT_CASE(4) IMT_CASE(5) IMT_CASE(6) IMT_CASE(7)
    IMT_CASE(8) IMT_CASE(9) IMT_CASE(10) IMT_CASE(11) IMT_CASE(12) IMT_CASE(13) IMT_CASE(14)
    IMT_CASE(15) IMT_CASE(16)
#undef IMT_CASE
    default: return cudaErrorInvalidValue;
  }
}

// The C entries' body for operand type E; pixel strides are multiples of
// 16 bytes.
template <typename E>
int run(const void* q, long long ldq, const void* k, long long ldk, const void* v, long long ldv,
        const void* w9, const void* wb, void* out, int B, int H, int W, int C, int nh, int ws,
        float qscale, void* stream) {
  constexpr int kPer = Slot<E>::kPerVec;
  if (B <= 0 || H <= 0 || nh <= 0 || ws <= 0 || C % nh || W % ws || H * ws > kMaxT ||
      ldq % kPer || ldk % kPer || ldv % kPer || ldq < C || ldk < C || ldv < C)
    return cudaErrorInvalidValue;
  const int D = C / nh;
  const Stripes g = make_stripes(H, W, C, nh, ws);
  const long long stripes = static_cast<long long>(B) * g.per_img;
  if (stripes > 0x7fffffffLL || nh > 65535) return cudaErrorInvalidValue;
  const Operand<E> oq{static_cast<const E*>(q), ldq}, ok{static_cast<const E*>(k), ldk},
      ov{static_cast<const E*>(v), ldv};
  const float* w = static_cast<const float*>(w9);
  const float* b = static_cast<const float*>(wb);
  E* o = static_cast<E*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != 32 && D != 24) return cudaErrorInvalidValue;
  if constexpr (std::is_same<E, bf16>::value) {
    return dispatch_mma(oq, ok, ov, w, b, o, g, stripes, qscale, st);
  } else {
    if (D == 32) return launch_d<E, 32>(oq, ok, ov, w, b, o, g, stripes, qscale, st);
    return launch_d<E, 24>(oq, ok, ov, w, b, o, g, stripes, qscale, st);
  }
}

}  // namespace

extern "C" {

// q, k, v (B, H, W, *) bf16 with pixel strides ldq, ldk, ldv (multiples of 8,
// C channels from each 16-byte aligned start); w9 (9, C) and wb (C) fp32; out
// (B, H, W, C) bf16, contiguous. C = D * nh with D = 24 or 32; W % ws == 0;
// H * ws <= 256; qscale is the softmax scale already rounded to bf16.
// Launches on `stream` and returns the launch status (a cudaError_t; 0 is
// success).
int imt_stripe_attn_fwd_bf16(const void* q, long long ldq, const void* k, long long ldk,
                             const void* v, long long ldv, const void* w9, const void* wb,
                             void* out, int B, int H, int W, int C, int nh, int ws, float qscale,
                             void* stream) {
  return run<bf16>(q, ldq, k, ldk, v, ldv, w9, wb, out, B, H, W, C, nh, ws, qscale, stream);
}

// As imt_stripe_attn_fwd_bf16 with fp32 maps (pixel strides multiples of 4)
// and output; qscale is the fp32 softmax scale.
int imt_stripe_attn_fwd_f32(const void* q, long long ldq, const void* k, long long ldk,
                            const void* v, long long ldv, const void* w9, const void* wb,
                            void* out, int B, int H, int W, int C, int nh, int ws, float qscale,
                            void* stream) {
  return run<float>(q, ldq, k, ldk, v, ldv, w9, wb, out, B, H, W, C, nh, ws, qscale, stream);
}

const char* imt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
