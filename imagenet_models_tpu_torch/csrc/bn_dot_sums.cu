// Per-channel sums of the BatchNorm training backward, for Hopper (sm_90a):
// from a = dy and b = x, (n, C) rows each of bf16 or fp32 (each with its own
// row stride, channels contiguous), the fp32 sums s1[c] = sum over rows of a
// and s2[c] = sum of a*b. They give dbias = s1, dscale = inv * (s2 - mean*s1)
// and the two reductions of dx.
//
// Replaces the TPU kernel `_dot_sums_kernel` / `channel_dot_sums` in
// imagenet_models_tpu/ops/batch_norm.py (:81-92, :133-148). The TPU kernel's
// running sum over an ordered grid becomes per-block partials over row
// slices, added in a fixed order by the blocks that finish last, in the same
// launch (bn_reduce_common.cuh): no float atomics, the same bits on every
// run.
//
// What bounds it on the H100: bytes, and on small maps the host. It reads a
// and b once each and does three flops per element pair (0.75 flops per
// byte in bf16). On the large maps (1.6 million rows) the design keeps the
// memory system busy: 16-byte loads along C where both operands allow it (8
// channels when both are bf16, 4 when either is fp32), four rows of each in
// flight per thread, five 256-thread blocks on every SM in one wave, fp32
// sums in registers. On the 7x7 and 14x14 maps of a ResNet-50 step (6272 and 25088
// rows) the bound is 2-8 us, and what a call costs is its launches and the
// Python around them. So one launch does it all: the last block of each
// group of slices, and then of each channel tile, adds the partials (an
// integer ticket tells a block that it is last), where a second kernel did;
// the entry point plans the slices itself; and the wrapper makes one
// allocation per call, the workspace that holds the sums, and keeps the
// ticket counters per device and stream.

#include "bn_reduce_common.cuh"

namespace {

using namespace imt_bn;

template <typename TA, typename TB>
cudaError_t run(const void* a, long long lda, const void* b, long long ldb, long long n, int C,
                const Plan& p, float* work, unsigned* tickets, cudaStream_t stream) {
  const TA* pa = static_cast<const TA*>(a);
  const TB* pb = static_cast<const TB*>(b);
  switch (p.vec) {
    case 8:
      if constexpr (sizeof(TA) == 2 && sizeof(TB) == 2)
        return launch<TA, TB, 8, true>(pa, lda, pb, ldb, n, C, p, work, tickets, stream);
      return cudaErrorInvalidValue;
    case 4:
      return launch<TA, TB, 4, true>(pa, lda, pb, ldb, n, C, p, work, tickets, stream);
    default:
      return launch<TA, TB, 1, true>(pa, lda, pb, ldb, n, C, p, work, tickets, stream);
  }
}

template <typename TA>
cudaError_t dispatch_b(const void* a, long long lda, const void* b, long long ldb, int dtb,
                       long long n, int C, const Plan& p, float* work, unsigned* tickets,
                       cudaStream_t stream) {
  if (dtb == kBF16) return run<TA, uint16_t>(a, lda, b, ldb, n, C, p, work, tickets, stream);
  return run<TA, float>(a, lda, b, ldb, n, C, p, work, tickets, stream);
}

}  // namespace

extern "C" {

// The workspace of a call on (n, C) rows: sizes[0] fp32 values, sizes[1]
// ticket counters, enough for any operand types and alignment. Returns 0,
// or cudaErrorInvalidValue for a shape no call takes.
int imt_bn_plan(long long n, int C, long long* sizes) {
  if (n <= 0 || C <= 0) return cudaErrorInvalidValue;
  const Plan p = largest_plan(n, C);
  sizes[0] = p.floats;
  sizes[1] = p.tickets;
  return 0;
}

// a, b: (n, C) rows with row strides lda, ldb (elements) and dtypes dta, dtb
// (kBF16 or kF32). The kernel reads 8 channels at a time where both are
// bf16, else 4, as far as C, the strides and the pointers allow, else 1.
// `work` holds imt_bn_plan's sizes[0] floats: the call writes work[0:C] =
// sum of a and work[C:2C] = sum of a*b (fp32), and uses the rest as
// scratch. `tickets` holds sizes[1] unsigned counters, zero before the call
// and zero after it; calls that may run at the same time need their own.
// One launch on `stream`; returns the launch status (a cudaError_t; 0 is
// success).
int imt_bn_dot_sums(const void* a, long long lda, int dta, const void* b, long long ldb, int dtb,
                    long long n, int C, void* work, void* tickets, void* stream) {
  if (n <= 0 || C <= 0 || lda < C || ldb < C || !known(dta) || !known(dtb))
    return cudaErrorInvalidValue;
  const void* ptrs[2] = {a, b};
  const long long lds[2] = {lda, ldb};
  const int dtypes[2] = {dta, dtb};
  const Plan p = make_plan(n, C, pick_vec(C, 2, ptrs, lds, dtypes));
  float* w = static_cast<float*>(work);
  unsigned* t = static_cast<unsigned*>(tickets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dta == kBF16) return dispatch_b<uint16_t>(a, lda, b, ldb, dtb, n, C, p, w, t, st);
  return dispatch_b<float>(a, lda, b, ldb, dtb, n, C, p, w, t, st);
}

const char* imt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
