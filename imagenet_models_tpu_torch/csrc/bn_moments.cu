// Per-channel BatchNorm statistics of the training forward, for Hopper
// (sm_90a): from x, (n, C) rows of bf16 or fp32 (row stride ld, channels
// contiguous), the fp32 sums s1[c] = sum over rows of x and s2[c] = sum of x^2.
//
// Replaces the TPU kernel `_moments_kernel` / `channel_moments` in
// imagenet_models_tpu/ops/batch_norm.py (:68-78, :115-130). That kernel walks
// the rows in tiles over a grid that runs in order and carries both sums
// from one grid step to the next in its output block. CUDA blocks run
// concurrently and in no order, so here each block sums a slice of rows into
// partials of its own, and the blocks that finish last add them in a fixed
// order in the same launch (bn_reduce_common.cuh, the template kernel 8
// shares): no float atomics, the same bits on every run. The TPU kernel's
// (h, w, b) token order, a bitcast of XLA's conv layouts, has no
// counterpart: channel sums do not depend on the order of the rows.
//
// What bounds it on the H100: bytes. It reads x once (n*C*2 bytes in bf16)
// and does two flops per element, 0.5 flops per byte read. The design keeps
// the memory system busy: 16-byte loads along C (8 bf16 or 4 fp32 channels
// per thread) when C, ld and the pointer allow, four rows in flight per
// thread, five 256-thread blocks on every SM in one wave, fp32 sums in
// registers. On small maps the launch and the host's work per call weigh
// more than the bytes; one launch per call and the lean wrapper of kernel 8
// serve both.

#include "bn_reduce_common.cuh"

namespace {

using namespace imt_bn;

template <typename T>
cudaError_t run(const void* x, long long ld, long long n, int C, const Plan& p, float* work,
                unsigned* tickets, cudaStream_t stream) {
  const T* px = static_cast<const T*>(x);
  switch (p.vec) {
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch<T, T, 8, false>(px, ld, nullptr, 0, n, C, p, work, tickets, stream);
      return cudaErrorInvalidValue;
    case 4:
      return launch<T, T, 4, false>(px, ld, nullptr, 0, n, C, p, work, tickets, stream);
    default:
      return launch<T, T, 1, false>(px, ld, nullptr, 0, n, C, p, work, tickets, stream);
  }
}

}  // namespace

extern "C" {

// The workspace of a call on (n, C) rows: sizes[0] fp32 values, sizes[1]
// ticket counters, enough for either type and any alignment. Returns 0, or
// cudaErrorInvalidValue for a shape no call takes.
int imt_bn_plan(long long n, int C, long long* sizes) {
  if (n <= 0 || C <= 0) return cudaErrorInvalidValue;
  const Plan p = largest_plan(n, C);
  sizes[0] = p.floats;
  sizes[1] = p.tickets;
  return 0;
}

// x: (n, C) rows, row stride ld elements, dtype kBF16 or kF32. The kernel
// reads 8 channels at a time in bf16, 4 in fp32, as far as C, ld and the
// pointer allow, else 1. `work` holds imt_bn_plan's sizes[0] floats: the
// call writes work[0:C] = sum of x and work[C:2C] = sum of x^2 (fp32), and
// uses the rest as scratch. `tickets` holds sizes[1] unsigned counters, zero
// before the call and zero after it; calls that may run at the same time
// need their own. One launch on `stream`; returns the launch status (a
// cudaError_t; 0 is success).
int imt_bn_moments(const void* x, long long ld, int dtype, long long n, int C, void* work,
                   void* tickets, void* stream) {
  if (n <= 0 || C <= 0 || ld < C || !known(dtype)) return cudaErrorInvalidValue;
  const Plan p = make_plan(n, C, pick_vec(C, 1, &x, &ld, &dtype));
  float* w = static_cast<float*>(work);
  unsigned* t = static_cast<unsigned*>(tickets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return run<uint16_t>(x, ld, n, C, p, w, t, st);
  return run<float>(x, ld, n, C, p, w, t, st);
}

const char* imt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
