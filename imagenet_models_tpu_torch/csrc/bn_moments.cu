// Per-channel BatchNorm statistics of the training forward, for Hopper
// (sm_90a): from x, (n, C) rows of bf16 or fp32 (row stride ld, channels
// contiguous), the fp32 sums s1[c] = sum over rows of x and s2[c] = sum of x^2.
//
// Replaces the TPU kernel `_moments_kernel` / `channel_moments` in
// imagenet_models_tpu/ops/batch_norm.py (:68-78, :115-130). That kernel walks
// the rows in tiles over a grid that runs in order and carries both sums
// from one grid step to the next in its output block. CUDA blocks run
// concurrently and in no order, so here each block sums a slice of rows into
// partials of its own and a second pass adds them in a fixed order
// (bn_reduce_common.cuh): no atomics, the same bits on every run. The TPU
// kernel's (h, w, b) token order, a bitcast of XLA's conv layouts, has no
// counterpart: channel sums do not depend on the order of the rows.
//
// What bounds it on the H100: bytes. It reads x once (n*C*2 bytes in bf16)
// and does two flops per element, 0.5 flops per byte read. The design keeps
// the memory system busy: 16-byte loads along C (8 bf16 or 4 fp32 channels
// per thread) when C, ld and the pointer allow, four rows in flight per
// thread, about eight 256-thread blocks per SM, and fp32 sums in registers.

#include "bn_reduce_common.cuh"

namespace {

using namespace imt_bn;

template <typename T>
cudaError_t run(const void* x, long long ld, long long n, int C, int vec, int slices,
                float* partials, float* out, cudaStream_t stream) {
  const T* p = static_cast<const T*>(x);
  switch (vec) {
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch<T, T, 8, false>(p, ld, nullptr, 0, n, C, slices, partials, out, stream);
      return cudaErrorInvalidValue;
    case 4:
      return launch<T, T, 4, false>(p, ld, nullptr, 0, n, C, slices, partials, out, stream);
    default:
      return launch<T, T, 1, false>(p, ld, nullptr, 0, n, C, slices, partials, out, stream);
  }
}

}  // namespace

extern "C" {

// Row slices of the plan for (n, C) rows read `vec` channels at a time; the
// partials buffer holds slices * 2C floats.
int imt_bn_slices(long long n, int C, int vec) { return plan_slices(n, C, vec); }

// x: (n, C) rows, row stride ld elements, dtype kBF16 or kF32; vec is 8 (bf16
// only), 4 or 1 channels per load, and the rows must be aligned for it; slices
// from imt_bn_slices. Writes out[0:C] = sum of x and out[C:2C] = sum of x^2
// (fp32); partials is scratch of slices * 2C floats. Two launches on
// `stream`; returns the launch status (a cudaError_t; 0 is success).
int imt_bn_moments(const void* x, long long ld, int dtype, long long n, int C, int vec,
                   int slices, void* partials, void* out, void* stream) {
  if (!valid_plan(n, C, vec, slices) || ld < C || (dtype != kBF16 && dtype != kF32) ||
      (vec == 8 && dtype != kBF16))
    return cudaErrorInvalidValue;
  float* part = static_cast<float*>(partials);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    if (!aligned<uint16_t>(x, ld, vec)) return cudaErrorMisalignedAddress;
    return run<uint16_t>(x, ld, n, C, vec, slices, part, o, st);
  }
  if (!aligned<float>(x, ld, vec)) return cudaErrorMisalignedAddress;
  return run<float>(x, ld, n, C, vec, slices, part, o, st);
}

const char* imt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
