// Per-channel sums of the BatchNorm training backward, for Hopper (sm_90a):
// from a = dy and b = x, (n, C) rows each of bf16 or fp32 (each with its own
// row stride, channels contiguous), the fp32 sums s1[c] = sum over rows of a
// and s2[c] = sum of a*b. They give dbias = s1, dscale = inv * (s2 - mean*s1)
// and the two reductions of dx.
//
// Replaces the TPU kernel `_dot_sums_kernel` / `channel_dot_sums` in
// imagenet_models_tpu/ops/batch_norm.py (:81-92, :133-148). As for kernel 7
// (bn_moments.cu), the TPU kernel's running sum over an ordered grid becomes
// per-block partials over row slices and a second pass that adds them in a
// fixed order (bn_reduce_common.cuh): no atomics, the same bits on every run.
//
// What bounds it on the H100: bytes. It reads a and b once each and does
// three flops per element pair (0.75 flops per byte in bf16). 16-byte loads
// along C where both operands allow it (8 channels when both are bf16, 4
// when either is fp32), four rows of each in flight per thread, about eight
// 256-thread blocks per SM, fp32 sums in registers.

#include "bn_reduce_common.cuh"

namespace {

using namespace imt_bn;

template <typename TA, typename TB>
cudaError_t run(const void* a, long long lda, const void* b, long long ldb, long long n, int C,
                int vec, int slices, float* partials, float* out, cudaStream_t stream) {
  const TA* pa = static_cast<const TA*>(a);
  const TB* pb = static_cast<const TB*>(b);
  switch (vec) {
    case 8:
      if constexpr (sizeof(TA) == 2 && sizeof(TB) == 2)
        return launch<TA, TB, 8, true>(pa, lda, pb, ldb, n, C, slices, partials, out, stream);
      return cudaErrorInvalidValue;
    case 4:
      return launch<TA, TB, 4, true>(pa, lda, pb, ldb, n, C, slices, partials, out, stream);
    default:
      return launch<TA, TB, 1, true>(pa, lda, pb, ldb, n, C, slices, partials, out, stream);
  }
}

template <typename TA>
cudaError_t dispatch_b(const void* a, long long lda, const void* b, long long ldb, int dtb,
                       long long n, int C, int vec, int slices, float* partials, float* out,
                       cudaStream_t stream) {
  if (dtb == kBF16) {
    if (!aligned<uint16_t>(b, ldb, vec)) return cudaErrorMisalignedAddress;
    return run<TA, uint16_t>(a, lda, b, ldb, n, C, vec, slices, partials, out, stream);
  }
  if (!aligned<float>(b, ldb, vec)) return cudaErrorMisalignedAddress;
  return run<TA, float>(a, lda, b, ldb, n, C, vec, slices, partials, out, stream);
}

bool known(int dtype) { return dtype == kBF16 || dtype == kF32; }

}  // namespace

extern "C" {

// Row slices of the plan for (n, C) rows read `vec` channels at a time; the
// partials buffer holds slices * 2C floats.
int imt_bn_slices(long long n, int C, int vec) { return plan_slices(n, C, vec); }

// a, b: (n, C) rows with row strides lda, ldb (elements) and dtypes dta, dtb
// (kBF16 or kF32); vec is 8 (both bf16 only), 4 or 1 channels per load, and
// both operands must be aligned for it; slices from imt_bn_slices. Writes
// out[0:C] = sum of a and out[C:2C] = sum of a*b (fp32); partials is scratch
// of slices * 2C floats. Two launches on `stream`; returns the launch status
// (a cudaError_t; 0 is success).
int imt_bn_dot_sums(const void* a, long long lda, int dta, const void* b, long long ldb, int dtb,
                    long long n, int C, int vec, int slices, void* partials, void* out,
                    void* stream) {
  if (!valid_plan(n, C, vec, slices) || lda < C || ldb < C || !known(dta) || !known(dtb) ||
      (vec == 8 && (dta != kBF16 || dtb != kBF16)))
    return cudaErrorInvalidValue;
  float* part = static_cast<float*>(partials);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dta == kBF16) {
    if (!aligned<uint16_t>(a, lda, vec)) return cudaErrorMisalignedAddress;
    return dispatch_b<uint16_t>(a, lda, b, ldb, dtb, n, C, vec, slices, part, o, st);
  }
  if (!aligned<float>(a, lda, vec)) return cudaErrorMisalignedAddress;
  return dispatch_b<float>(a, lda, b, ldb, dtb, n, C, vec, slices, part, o, st);
}

const char* imt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
