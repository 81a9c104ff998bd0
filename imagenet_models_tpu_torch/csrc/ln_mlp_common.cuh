// Helpers shared by the LN+MLP forward (ln_mlp_fwd.cu) and backward
// (ln_mlp_bwd.cu) kernels and the fused branch (convnext_branch_common.cuh):
// cp.async copies, bf16 packing, warp sums, the warp grid of the branch's
// wmma products, the three GELU implementations, and the launch of the
// row-wise kernels by C.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

namespace imt {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr size_t kMaxSmem = 232448;  // 227 KB per block on sm_90

__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) & ~size_t(127); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(p[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// Warp grid of a (T x HC) product over 8 warps: MT1 x NT1 fragments per warp
// on a WM1 x WN1 grid, and the reduction split KS ways over the warps left
// over (the partial sums meet in shared memory).
template <int T, int HC, int MT1, int NT1>
struct Grid1 {
  static constexpr int WM1 = T / 16 / MT1, WN1 = HC / 16 / NT1;
  static constexpr int KS = kWarps / (WM1 * WN1);
  static_assert(WM1 * MT1 == T / 16 && WN1 * NT1 == HC / 16 && KS * WM1 * WN1 == kWarps,
                "first-product warp grid");
};

// GELU, in three modes (GeluMode). kGeluErf, kernels 1 and 2's "exact":
// erff. kGeluFit, their "fast": the single-segment odd minimax fits of the
// JAX package (ops/convnext_block.py:111-129), no transcendentals:
//   erf(z) ~ z*P8((z/2.75)^2) on |z| <= 2.75, clamped beyond;
//   gelu'(x) - 0.5 ~ x*Q10((x/5)^2) on |x| <= 5, clamped beyond.
// kGeluAS, the fused branch's (kernels 10 and 11, at eval and in training):
// the exact GELU with the Abramowitz & Stegun erf, and its derivative.
enum GeluMode { kGeluErf = 0, kGeluFit = 1, kGeluAS = 2 };

// Abramowitz & Stegun 7.1.26, |err| < 1.5e-7: the JAX package's `_erf_poly`
// (imagenet_models_tpu/ops/convnext_block.py:31-39), the erf of both TPU
// kernels of the fused branch.
__device__ __forceinline__ float erf_as(float x) {
  const float a = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * a);
  const float poly =
      t * (0.254829592f + t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return copysignf(1.0f - poly * expf(-a * a), x);
}

__device__ __forceinline__ float gelu_as(float v) {
  return 0.5f * v * (1.0f + erf_as(v * 0.70710678118654752f));
}

// d/dv of the exact GELU with the A&S erf (ops/convnext_block.py:365-369)
__device__ __forceinline__ float gelu_grad_as(float v) {
  return 0.5f * (1.0f + erf_as(v * 0.70710678118654752f)) + v * 0.3989422804014327f * expf(-0.5f * v * v);
}

// (gelu_as(v), gelu_grad_as(v)), their erf computed once
__device__ __forceinline__ float2 gelu_as_and_grad(float v) {
  const float e = erf_as(v * 0.70710678118654752f);
  return make_float2(0.5f * v * (1.0f + e),
                     0.5f * (1.0f + e) + v * 0.3989422804014327f * expf(-0.5f * v * v));
}

__device__ __forceinline__ float erf_fast(float z) {
  const float a = fminf(fabsf(z), 2.75f);
  const float u = (a * (1.0f / 2.75f)) * (a * (1.0f / 2.75f));
  float r = -0.9452048310751889f;
  r = r * u + 4.602827094685715f;
  r = r * u - 9.860067339137903f;
  r = r * u + 12.424005344159935f;
  r = r * u - 10.440794928636649f;
  r = r * u + 6.288517611119356f;
  r = r * u - 2.833873458377666f;
  r = r * u + 1.128179019700242f;
  return copysignf(a * r, z);
}

__device__ __forceinline__ float gelu_grad_fast(float x) {
  const float a = fminf(fabsf(x), 5.0f);
  const float u = (a * 0.2f) * (a * 0.2f);
  float r = -34.12709029923767f;
  r = r * u + 186.4500761464462f;
  r = r * u - 444.740199037125f;
  r = r * u + 610.367501707186f;
  r = r * u - 535.3888724157551f;
  r = r * u + 315.66741178811344f;
  r = r * u - 127.98971343596055f;
  r = r * u + 35.6419098348847f;
  r = r * u - 6.5780944269226085f;
  r = r * u + 0.7970334043621504f;
  return 0.5f + copysignf(a * r, x);
}

template <int GM>
__device__ __forceinline__ float gelu(float v) {
  if constexpr (GM == kGeluAS) return gelu_as(v);
  const float z = v * 0.70710678118654752f;
  return 0.5f * v * (1.f + (GM == kGeluFit ? erf_fast(z) : erff(z)));
}

template <int GM>
__device__ __forceinline__ float gelu_grad(float v) {
  if constexpr (GM == kGeluAS) return gelu_grad_as(v);
  if (GM == kGeluFit) return gelu_grad_fast(v);
  return 0.5f * (1.f + erff(v * 0.70710678118654752f)) +
         v * 0.3989422804014327f * expf(-0.5f * v * v);
}

// ------------------------------------------------------ row-wise kernels

// The row kernels of kernels 1 and 2 (one token row per L lanes, 16 when
// C <= 128, else 32; so 32 / L rows of a warp at a time, R such sets in
// flight, S 16-byte segments of a row per lane, C <= 8 L S): a sum over
// the L lanes of a row.
template <int L>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The row kernels' instances by C: <L, S, R> = <16, 1, 2> for C <= 128,
// <32, 1, 4>, <32, 2, 2>, <32, 4, 1> for C <= 256, 512, 1024; each takes
// 8 (32 / L) R rows a block-wide step.
constexpr int row_step(int C) { return C <= 128 ? 32 : C <= 256 ? 32 : C <= 512 ? 16 : 8; }

template <template <int, int, int> class Pick, typename... A>
cudaError_t launch_rows(int C, unsigned blocks, size_t smem, cudaStream_t st, A... args) {
  auto kern = C <= 128   ? Pick<16, 1, 2>::kernel
              : C <= 256 ? Pick<32, 1, 4>::kernel
              : C <= 512 ? Pick<32, 2, 2>::kernel
                         : Pick<32, 4, 1>::kernel;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<blocks, kThreads, smem, st>>>(args...);
  return cudaGetLastError();
}

}  // namespace imt
