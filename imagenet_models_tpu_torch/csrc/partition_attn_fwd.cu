// MaxViT partition attention, forward, for Hopper (sm_90a): per window of
// T = ph*pw tokens and per head h,
//   out = softmax(q k^T + bias[h]) v,
// read straight from the unpartitioned (B, H, W, 3C) qkv map (channel order
// [q | k | v], each [head, d]; q already scaled), written to the (B, H, W, C)
// output of the map's type: bf16, or fp32 for an fp32 model. Block windows ("block") or dilated grid windows
// ("grid"); T <= 256 tokens, head width d = 32.
//
// Replaces the TPU kernel `_fwd_kernel` / `_fwd_pallas` in
// imagenet_models_tpu/ops/partition_attention.py (:164-182, :286-307).
//
// Numerics (`_attend`, :107-115): scores q.k in fp32 from exact products of
// bf16 operands, + bias in fp32; softmax in fp32 as exp(s - max) / sum; p
// rounded to bf16; p.v in fp32 from exact products; one cast at the output.
// The fp32 instance is the same with every rounding to the operand type gone
// (fp32 products), as the TPU kernel runs an fp32 map.
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

template <typename E, int NJ>
__global__ void __launch_bounds__(kThreads)
partition_attn_fwd_kernel(const E* __restrict__ qkv, const float* __restrict__ bias,
                          E* __restrict__ out, Geometry g) {
  constexpr int kLdw = Slot<E>::kLdw;
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
    load_row<E>(Qs, i, r);
    softmax_row<E, NJ>(r, Ks, bh + static_cast<size_t>(i) * g.T, g.T, lane, p);
    const float o = mix_rows<E, NJ>(p, Vs, g.T, lane);
    out[token_pixel(g, win, i) * g.C + h * kD + lane] = Slot<E>::cast(o);
  }
}

template <typename E, int NJ>
cudaError_t launch(const E* qkv, const float* bias, E* out, const Geometry& g,
                   long long windows, cudaStream_t stream) {
  const size_t smem = size_t(3) * g.T * Slot<E>::kLdw * 4;
  auto kern = partition_attn_fwd_kernel<E, NJ>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<dim3(static_cast<unsigned>(windows), g.nh), kThreads, smem, stream>>>(qkv, bias, out, g);
  return cudaGetLastError();
}

template <typename E>
int run(const void* qkv, const void* bias, void* out, int B, int H, int W, int C, int nh, int ph,
        int pw, int grid, void* stream) {
  if (B <= 0 || nh <= 0 || ph <= 0 || pw <= 0 || C != kD * nh || H % ph || W % pw ||
      ph * pw > kMaxT)
    return cudaErrorInvalidValue;
  const Geometry g = make_geometry(H, W, C, nh, ph, pw, grid);
  const long long windows = static_cast<long long>(B) * g.wr * g.wc;
  if (windows > 0x7fffffffLL || nh > 65535) return cudaErrorInvalidValue;
  const E* q = static_cast<const E*>(qkv);
  const float* b = static_cast<const float*>(bias);
  E* o = static_cast<E*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((g.T + 31) / 32) {
    case 1: return launch<E, 1>(q, b, o, g, windows, st);
    case 2: return launch<E, 2>(q, b, o, g, windows, st);
    case 3: return launch<E, 3>(q, b, o, g, windows, st);
    case 4: return launch<E, 4>(q, b, o, g, windows, st);
    case 5: return launch<E, 5>(q, b, o, g, windows, st);
    case 6: return launch<E, 6>(q, b, o, g, windows, st);
    case 7: return launch<E, 7>(q, b, o, g, windows, st);
    default: return launch<E, 8>(q, b, o, g, windows, st);
  }
}

}  // namespace

extern "C" {

// qkv (B, H, W, 3C) bf16, bias (nh, T, T) fp32, out (B, H, W, C) bf16; all
// contiguous, qkv 16-byte aligned; C = 32 * nh; H % ph == W % pw == 0; grid
// selects dilated grid windows. Launches on `stream` and returns the launch
// status (a cudaError_t; 0 is success).
int imt_partition_attn_fwd_bf16(const void* qkv, const void* bias, void* out, int B, int H,
                                int W, int C, int nh, int ph, int pw, int grid, void* stream) {
  return run<bf16>(qkv, bias, out, B, H, W, C, nh, ph, pw, grid, stream);
}

// As imt_partition_attn_fwd_bf16 with an fp32 qkv map and output.
int imt_partition_attn_fwd_f32(const void* qkv, const void* bias, void* out, int B, int H,
                               int W, int C, int nh, int ph, int pw, int grid, void* stream) {
  return run<float>(qkv, bias, out, B, H, W, C, nh, ph, pw, grid, stream);
}

const char* imt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
