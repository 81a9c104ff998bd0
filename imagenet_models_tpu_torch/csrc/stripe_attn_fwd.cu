// CSWin vertical-stripe attention with LePE, forward, for Hopper (sm_90a):
// per stripe of T = H*ws tokens (the full height of the map, ws columns) and
// per head h of D channels,
//   out = softmax((q*scale) k^T) v + LePE(v),
// LePE(v) = wb + the 3x3 depthwise stencil of v with taps w9, zero-padded at
// the stripe's own borders. q, k and v are read straight from unpartitioned
// (B, H, W, *) bf16 maps (each may be a channel slice of a wider map, such as
// the qkv projection's); out is the contiguous (B, H, W, C) bf16 map.
// T <= 256 tokens, heads of D = 24 or 32 channels.
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
// balance point. So the work is to move each byte once:
//   * one block of 4 warps per (stripe, head) copies that head's q, k and v
//     rows of the stripe into shared memory (16-byte loads; the stripe's
//     pixels are found by index arithmetic, so neither the partition nor the
//     reverse is a copy through device memory, which the TPU kernel avoided
//     with a BlockSpec over the W axis);
//   * a warp takes a query row: its lanes own keys (j = 32k + lane) for the
//     scores and the softmax, and then channels (lane = c) for p.v, with p
//     passed between lanes by shuffles; the scores live in registers, so no
//     T x T tile is kept;
//   * the LePE of the row's token reads its 3x3 neighbourhood of v from the
//     same shared copy, so the stencil costs no extra device-memory traffic.
// The TPU kernel packs two stripes into one 128-row score matrix under a
// -1e30 block-diagonal mask: that is the TPU's tile geometry, and per-stripe
// blocks give the same result without it. This first version runs the
// products on the FMA units in fp32 (exact, as the twin's), so it issues far
// more instructions than the bytes need; tensor-core tiles (mma.sync or wgmma
// on stripes padded to 64 rows) and several stripes per block are left for
// later work.

#include "stripe_attn_common.cuh"

namespace {

using namespace imt_sa;

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
  if (D == 32) return launch_d<E, 32>(oq, ok, ov, w, b, o, g, stripes, qscale, st);
  if (D == 24) return launch_d<E, 24>(oq, ok, ov, w, b, o, g, stripes, qscale, st);
  return cudaErrorInvalidValue;
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
