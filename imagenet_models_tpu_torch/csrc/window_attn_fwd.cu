// Fused window attention, forward, for Hopper (sm_90a): per window w of n
// tokens,
//   out[w] = softmax(q[w] k[w]^T [+ bias[w]]) v[w],
// over contiguous (BW, n, d) q, k, v (q already scaled) in bf16 or fp32, with
// an optional fp32 (BW, n, n) bias; out (BW, n, d) in the input dtype. BW
// counts windows times heads (CSWin's stripes, flattened by the caller).
//
// Replaces the TPU kernel `fused_window_attention` / `_attn_kernel` in
// imagenet_models_tpu/ops/flash_attention.py (:55-122). Its padding of n to a
// multiple of 8 and d to 128, the -1e30 mask of padded keys and the window
// groups (`IMTPU_FLASH_GROUP`) are TPU tile geometry: here a block takes one
// window and masks the ragged key chunk itself. Numerics in
// window_attn_common.cuh.
//
// What bounds it on the H100: bytes. Per (window, head) it reads q, k, v and
// writes out (4 n d elements) and does 4 n^2 d flops: at n = 98, d = 32 in
// bf16 that is 49 flops per byte, far below the card's ~295 flop/byte
// balance point; the (BW, n, n) bias, where there is one, adds 4 n^2 bytes.
// So each byte is moved once and nothing of size n x n touches device memory:
//   * one block of 4 warps per window copies the window into shared memory
//     (16-byte loads, all issued before any is used): its keys as fp32 rows,
//     and where they fit (every path shape) its q and v rows;
//   * a warp takes two query rows at a time: their scores stay in registers,
//     their rounded probabilities go to two rows of shared memory for p.v,
//     and each read of a key or of a row of v serves both.
// The products run on the FMA units in fp32 (exact for bf16, as the twin's),
// so this first version issues far more instructions than the bytes need
// (PERF.md). Tensor-core tiles (mma.sync or wgmma), several windows per warp
// group and reading the windows straight out of the unpartitioned map are
// left for later work.

#include "window_attn_common.cuh"

namespace {

using namespace imt_wa;

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
window_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const float* __restrict__ bias, T* __restrict__ out, int n, int d,
                       int staged) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nj = key_chunks(n);
  float* P = smem + warp * 2 * nj * 32;
  float* Ks = smem + kWarps * 2 * nj * 32;
  T* Qs = staged ? reinterpret_cast<T*>(Ks + n * key_stride(d)) : nullptr;
  T* Vs = staged ? Qs + n * d : nullptr;
  const size_t base = static_cast<size_t>(blockIdx.x) * n * d;
  load_window<T>(q + base, k + base, v + base, n, d, Ks, Qs, Vs, tid);
  __syncthreads();
  const T* qw = staged ? Qs : q + base;
  const T* vw = staged ? Vs : v + base;
  const float* bw = bias == nullptr ? nullptr : bias + static_cast<size_t>(blockIdx.x) * n * n;
  for (int r = warp; 2 * r < n; r += kWarps) {  // rows 2r and 2r + 1
    const int a = 2 * r, b = min(a + 1, n - 1);
    attend_rows<T, DC>(qw + a * d, qw + b * d, Ks, vw, bw == nullptr ? nullptr : bw + a * n,
                       bw == nullptr ? nullptr : bw + b * n, P,
                       out + base + static_cast<size_t>(a) * d,
                       b > a ? out + base + static_cast<size_t>(b) * d : nullptr, n, d, lane);
  }
}

template <typename T, int DC>
cudaError_t launch(const T* q, const T* k, const T* v, const float* bias, T* out, long long bw,
                   int n, int d, cudaStream_t stream) {
  const bool staged = stages_qv(n, d, sizeof(T));
  const size_t smem = smem_bytes(n, d, sizeof(T), staged);
  auto kern = window_attn_fwd_kernel<T, DC>;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<static_cast<unsigned>(bw), kThreads, smem, stream>>>(q, k, v, bias, out, n, d,
                                                                 staged);
  return cudaGetLastError();
}

// One instantiation per channel chunks of the head.
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* bias, void* out,
                     long long bw, int n, int d, cudaStream_t st) {
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const float* b = static_cast<const float*>(bias);
  T* o = static_cast<T*>(out);
  switch (channel_chunks(d)) {
    case 1: return launch<T, 1>(qq, kk, vv, b, o, bw, n, d, st);
    case 2: return launch<T, 2>(qq, kk, vv, b, o, bw, n, d, st);
    case 3: return launch<T, 3>(qq, kk, vv, b, o, bw, n, d, st);
    default: return launch<T, 4>(qq, kk, vv, b, o, bw, n, d, st);
  }
}

}  // namespace

extern "C" {

// Returns 1 when windows of n tokens and heads of d channels are supported:
// 1 <= n <= 256, d a multiple of 8 from 8 to 128.
int imt_window_attn_fwd_supported(int n, int d) { return supported(n, d) ? 1 : 0; }

// q, k, v, out (bw, n, d) in bf16 (is_bf16 = 1) or fp32 (0); bias (bw, n, n)
// fp32 or null. All contiguous, q, k, v and out 16-byte aligned. Launches on
// `stream` and returns the launch status (a cudaError_t; 0 is success).
int imt_window_attn_fwd(const void* q, const void* k, const void* v, const void* bias, void* out,
                        long long bw, int n, int d, int is_bf16, void* stream) {
  if (!supported(n, d) || bw <= 0 || bw > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<bf16>(q, k, v, bias, out, bw, n, d, st)
                 : dispatch<float>(q, k, v, bias, out, bw, n, d, st);
}

const char* imt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
