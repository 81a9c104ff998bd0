// Fused window attention with a per-head shared bias, forward, for Hopper
// (sm_90a): per window w and head h,
//   out[w, h] = softmax(q[w, h] k[w, h]^T + bias[h]) v[w, h],
// over contiguous (BW, H, n, d) q, k, v (q already scaled) in bf16 or fp32,
// with one fp32 (H, n, n) bias shared by every window (MaxViT's relative
// position tables); out (BW, H, n, d) in the input dtype.
//
// Replaces the TPU kernel `fused_window_attention_heads` /
// `_attn_kernel_heads` in imagenet_models_tpu/ops/flash_attention.py
// (:125-167). Numerics in window_attn_common.cuh, the same as kernel 12's.
//
// What bounds it on the H100: bytes, as kernel 12 (window_attn_fwd.cu): per
// (window, head) 4 n d elements of q, k, v and out against 4 n^2 d flops (49
// flops per byte in bf16 at MaxViT's n = 49, d = 32). The bias is never
// broadcast to the windows in device memory: as the JAX grid
// (bw // group, heads) does, a block takes a few windows of one head
// (blockIdx.y), so every block reads one head's bias, and all the blocks of a
// head read the same rows, which stay in L2 (and in the SM's L1 from one
// window of the block to the next). It is read through the read-only cache
// rather than staged in shared memory: at n = 256 the (n, n) fp32 table is
// 256 KB, more than the 227 KB a block can hold. Each window is copied into
// shared memory in turn (its keys, and where they fit its q and v); a warp
// takes two query rows at a time, as in kernel 12. Tensor-core tiles and several windows
// per warp group are left for later work (PERF.md).

#include "window_attn_common.cuh"

namespace {

using namespace imt_wa;

constexpr int kGroup = 2;  // windows of one head per block

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
window_attn_heads_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const float* __restrict__ bias,
                             T* __restrict__ out, long long bw, int heads, int n, int d,
                             int staged) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nj = key_chunks(n);
  float* P = smem + warp * 2 * nj * 32;
  float* Ks = smem + kWarps * 2 * nj * 32;
  T* Qs = staged ? reinterpret_cast<T*>(Ks + n * key_stride(d)) : nullptr;
  T* Vs = staged ? Qs + n * d : nullptr;
  const int h = blockIdx.y;
  const float* bh = bias + static_cast<size_t>(h) * n * n;
  for (int g = 0; g < kGroup; ++g) {
    const long long w = static_cast<long long>(blockIdx.x) * kGroup + g;
    if (w >= bw) break;  // the same for every thread of the block
    const size_t base = (static_cast<size_t>(w) * heads + h) * n * d;
    if (g > 0) __syncthreads();  // every warp is done with the last window
    load_window<T>(q + base, k + base, v + base, n, d, Ks, Qs, Vs, tid);
    __syncthreads();
    const T* qw = staged ? Qs : q + base;
    const T* vw = staged ? Vs : v + base;
    for (int r = warp; 2 * r < n; r += kWarps) {  // rows 2r and 2r + 1
      const int a = 2 * r, b = min(a + 1, n - 1);
      attend_rows<T, DC>(qw + a * d, qw + b * d, Ks, vw, bh + a * n, bh + b * n, P,
                         out + base + static_cast<size_t>(a) * d,
                         b > a ? out + base + static_cast<size_t>(b) * d : nullptr, n, d, lane);
    }
  }
}

template <typename T, int DC>
cudaError_t launch(const T* q, const T* k, const T* v, const float* bias, T* out, long long bw,
                   int heads, int n, int d, cudaStream_t stream) {
  const bool staged = stages_qv(n, d, sizeof(T));
  const size_t smem = smem_bytes(n, d, sizeof(T), staged);
  auto kern = window_attn_heads_fwd_kernel<T, DC>;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const unsigned blocks = static_cast<unsigned>((bw + kGroup - 1) / kGroup);
  kern<<<dim3(blocks, heads), kThreads, smem, stream>>>(q, k, v, bias, out, bw, heads, n, d,
                                                        staged);
  return cudaGetLastError();
}

// One instantiation per channel chunks of the head.
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* bias, void* out,
                     long long bw, int heads, int n, int d, cudaStream_t st) {
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const float* b = static_cast<const float*>(bias);
  T* o = static_cast<T*>(out);
  switch (channel_chunks(d)) {
    case 1: return launch<T, 1>(qq, kk, vv, b, o, bw, heads, n, d, st);
    case 2: return launch<T, 2>(qq, kk, vv, b, o, bw, heads, n, d, st);
    case 3: return launch<T, 3>(qq, kk, vv, b, o, bw, heads, n, d, st);
    default: return launch<T, 4>(qq, kk, vv, b, o, bw, heads, n, d, st);
  }
}

}  // namespace

extern "C" {

// Returns 1 when windows of n tokens and heads of d channels are supported:
// 1 <= n <= 256, d a multiple of 8 from 8 to 128.
int imt_window_attn_heads_fwd_supported(int n, int d) { return supported(n, d) ? 1 : 0; }

// q, k, v, out (bw, heads, n, d) in bf16 (is_bf16 = 1) or fp32 (0); bias
// (heads, n, n) fp32. All contiguous, q, k, v and out 16-byte aligned.
// Launches on `stream` and returns the launch status (a cudaError_t; 0 is
// success).
int imt_window_attn_heads_fwd(const void* q, const void* k, const void* v, const void* bias,
                              void* out, long long bw, int heads, int n, int d, int is_bf16,
                              void* stream) {
  if (!supported(n, d) || bw <= 0 || heads <= 0 || heads > 65535 || bias == nullptr ||
      (bw + kGroup - 1) / kGroup > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<bf16>(q, k, v, bias, out, bw, heads, n, d, st)
                 : dispatch<float>(q, k, v, bias, out, bw, heads, n, d, st);
}

const char* imt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
