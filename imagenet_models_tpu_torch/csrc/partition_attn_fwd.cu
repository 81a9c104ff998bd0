// MaxViT partition attention, forward, for Hopper (sm_90a): per window of
// T = ph*pw tokens and per head h,
//   out = softmax(q k^T + bias[h]) v,
// read straight from the unpartitioned (B, H, W, 3C) bf16 qkv map (channel
// order [q | k | v], each [head, d]; q already scaled), written to the
// (B, H, W, C) bf16 output. Block windows ("block") or dilated grid windows
// ("grid"); T <= 256 tokens, head width d = 32.
//
// Replaces the TPU kernel `_fwd_kernel` / `_fwd_pallas` in
// imagenet_models_tpu/ops/partition_attention.py (:164-182, :286-307).
//
// Numerics (`_attend`, :107-115): scores q.k in fp32 from exact products of
// bf16 operands, + bias in fp32; softmax in fp32 as exp(s - max) / sum; p
// rounded to bf16; p.v in fp32 from exact products; one cast at the output.
//
// What bounds it on the H100: bytes. Per token and head it reads 3 x 64 bytes
// of qkv and writes 64 bytes, and does 4*T*d flops (about 6.3 kflop at T=49):
// 25 flops per byte, far below the card's ~295 flop/byte balance point. So
// the work is to move each byte once:
//   * one block of 4 warps per (window, head) copies that head's q, k and v
//     rows of the window into shared memory (16-byte loads; the window's
//     pixels are found by index arithmetic, so neither the partition nor the
//     reverse is a copy through device memory, which is what the TPU kernel
//     avoided with its strided views);
//   * a warp takes a query row: its lanes own keys (j = 32k + lane) for the
//     scores and the softmax, and then channels (lane = c) for p.v, with p
//     passed between lanes by shuffles; the scores live in registers, so no
//     T x T tile is kept and T = 256 needs 52 KB of shared memory;
//   * the bias (9.6 KB a head at T = 49) is read through L1/L2.
// This first version runs the products on the FMA units in fp32 (exact, as
// the twin's), so on an H100 it issues far more instructions than the bytes
// need and takes about 13x its byte bound (PERF.md). Tensor-core tiles
// (mma.sync or wgmma on windows padded to 64 rows), several windows per
// block and cheaper index arithmetic are left for later work.

#include "partition_attn_common.cuh"

namespace {

using namespace imt_pa;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <int NJ>
__global__ void __launch_bounds__(kThreads)
partition_attn_fwd_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                          bf16* __restrict__ out, Geometry g) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* Qs = smem;
  uint32_t* Ks = Qs + g.T * kLdw;
  uint32_t* Vs = Ks + g.T * kLdw;
  const long long win = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int C3 = 3 * g.C;

  load_slice(qkv, C3, h * kD, g, win, Qs, tid, kThreads);
  load_slice(qkv, C3, g.C + h * kD, g, win, Ks, tid, kThreads);
  load_slice(qkv, C3, 2 * g.C + h * kD, g, win, Vs, tid, kThreads);
  __syncthreads();

  const float* bh = bias + static_cast<size_t>(h) * g.T * g.T;
  for (int i = warp; i < g.T; i += kWarps) {
    float r[kD], p[NJ];
    load_row(Qs, i, r);
    softmax_row<NJ>(r, Ks, bh + static_cast<size_t>(i) * g.T, g.T, lane, p);
    const float o = mix_rows<NJ>(p, Vs, g.T, lane);
    out[token_pixel(g, win, i) * g.C + h * kD + lane] = __float2bfloat16(o);
  }
}

template <int NJ>
cudaError_t launch(const bf16* qkv, const float* bias, bf16* out, const Geometry& g,
                   long long windows, cudaStream_t stream) {
  const size_t smem = size_t(3) * g.T * kLdw * 4;
  auto kern = partition_attn_fwd_kernel<NJ>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<dim3(static_cast<unsigned>(windows), g.nh), kThreads, smem, stream>>>(qkv, bias, out, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv (B, H, W, 3C) bf16, bias (nh, T, T) fp32, out (B, H, W, C) bf16; all
// contiguous, qkv 16-byte aligned; C = 32 * nh; H % ph == W % pw == 0; grid
// selects dilated grid windows. Launches on `stream` and returns the launch
// status (a cudaError_t; 0 is success).
int imt_partition_attn_fwd_bf16(const void* qkv, const void* bias, void* out, int B, int H,
                                int W, int C, int nh, int ph, int pw, int grid, void* stream) {
  if (B <= 0 || nh <= 0 || ph <= 0 || pw <= 0 || C != kD * nh || H % ph || W % pw ||
      ph * pw > kMaxT)
    return cudaErrorInvalidValue;
  const Geometry g = make_geometry(H, W, C, nh, ph, pw, grid);
  const long long windows = static_cast<long long>(B) * g.wr * g.wc;
  if (windows > 0x7fffffffLL || nh > 65535) return cudaErrorInvalidValue;
  const bf16* q = static_cast<const bf16*>(qkv);
  const float* b = static_cast<const float*>(bias);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((g.T + 31) / 32) {
    case 1: return launch<1>(q, b, o, g, windows, st);
    case 2: return launch<2>(q, b, o, g, windows, st);
    case 3: return launch<3>(q, b, o, g, windows, st);
    case 4: return launch<4>(q, b, o, g, windows, st);
    case 5: return launch<5>(q, b, o, g, windows, st);
    case 6: return launch<6>(q, b, o, g, windows, st);
    case 7: return launch<7>(q, b, o, g, windows, st);
    default: return launch<8>(q, b, o, g, windows, st);
  }
}

const char* imt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
