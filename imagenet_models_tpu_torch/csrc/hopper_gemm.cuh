// Hopper (sm_90a) GEMM machinery shared by the LN+MLP kernels 1
// (ln_mlp_fwd.cu) and 2 (ln_mlp_bwd.cu), whose GEMM stages
// (ln_mlp_{fwd,bwd}_stages.cuh) the fused ConvNeXt branch's kernels 10 and
// 11 share too: the PTX of mbarriers, TMA loads and
// stores, bulk groups and `wgmma` (inline asm, no CUTLASS); the ring of
// shared-memory stages (128 x 128 output tiles, 64-deep k-blocks of bf16,
// four stages, two consumer warpgroups and a producer warpgroup); and the
// host side: the SM count for persistent grids and 2-D tensor maps encoded
// by cuTensorMapEncodeTiled, looked up at run time, so that nothing links
// libcuda.
//
// Layouts. Every operand box is 128-byte swizzled, 64 bf16 wide. A K-major
// operand (rows along M or N, K contiguous) advances its descriptor 32 bytes
// per k16 step inside its 128-byte rows, 8-row groups 1024 bytes apart; an
// MN-major one (the transpose bits of a bf16 wgmma) 16 rows of 128 bytes per
// k16 step, its 64-wide MN atoms `lbo` bytes apart.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace imt {

// ------------------------------------------------------------- Hopper PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits for the phase of `parity` to complete. A wait that outlasts any
// real one (2^30 polls, seconds) traps: a fault in the ring's bookkeeping
// then ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  uint32_t done = 0;
  for (unsigned polls = 0; !done; ++polls) {
    if (polls == (1u << 30)) asm volatile("trap;\n");
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// A box of a 2-D tensor map into shared memory; completion counts bytes on
// the mbarrier. c0 is the inner (contiguous) coordinate.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A box from shared memory to a 2-D tensor map (the map clips what falls
// outside the tensor), in the thread's bulk group; and that group's commit,
// the waits for its reads of shared memory and for its writes, and the
// fence that makes generic writes to shared memory visible to the stores.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of the accumulators across a wait.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 fp32 per warpgroup) += A (64 x 16) B (16 x 128), bf16 from
// shared memory; TA / TB: the operand is MN-major (transposed), else K-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// barrier 1 over the two consumer warpgroups (barrier 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// ------------------------------------------------------------------ the ring

constexpr int kBM = 128;                    // tokens (or output rows) per CTA: two warpgroups
constexpr int kBN = 128;                    // output columns per CTA
constexpr int kBK = 64;                     // reduction depth of one stage: 128 bytes of bf16
constexpr int kStages = 4;                  // ring depth
constexpr int kGemmThreads = 384;           // consumer warpgroups 0, 1; producer warpgroup 2
constexpr unsigned kOpBytes = kBM * kBK * 2;  // one operand of one stage: 16 KB
constexpr unsigned kStageBytes = 2 * kOpBytes;
constexpr int kHalfBox = 64 * 64 * 2;       // a 64 x 64 bf16 box: 8 KB
constexpr int kRing = kStages * kStageBytes;

// One stage's descriptors: a K-major operand advances 32 bytes per k16
// step inside its 128-byte rows (8-row groups 1024 bytes apart); an MN-major
// one 16 rows of 128 bytes, with 64-wide MN atoms `lbo` bytes apart.
template <int T>
__device__ __forceinline__ uint64_t op_desc(uint32_t base, int kk, uint32_t lbo) {
  return T ? gmma_desc(base + kk * 2048, lbo, 1024) : gmma_desc(base + kk * 32, 16, 1024);
}

template <int TA, int TB>
__device__ __forceinline__ void mma_stage(float (&acc)[64], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_m64n128k16<TA, TB>(acc, op_desc<TA>(a, kk, kHalfBox), op_desc<TB>(b, kk, kHalfBox));
}

// The byte offset of bf16 element (row r, column col) of a staged 128 x 128
// output tile: two 128-byte-swizzled boxes of 128 rows x 64 columns, the
// 16-byte chunk of each box row at chunk ^ (r % 8), as a TMA store reads it.
__device__ __forceinline__ int staged_offset(int r, int col) {
  return (col / 64) * (kBM * 128) + r * 128 + ((((col % 64) / 8) ^ (r % 8)) * 16) + (col % 8) * 2;
}

// ------------------------------------------------------------------ host

// The SMs of the current device: the persistent grids' width.
inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D bf16 tensor map over rows of `inner` contiguous elements (`outer`
// rows), boxes of box_inner x box_outer, 128-byte swizzle, zeros past the
// edges.
inline bool tensor_map(CUtensorMap* map, const void* ptr, long long inner, long long outer,
                       int box_inner, int box_outer) {
  EncodeTiled fn = encoder();
  if (!fn) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace imt
