// Device helpers shared by the LN+MLP forward (ln_mlp_fwd.cu) and backward
// (ln_mlp_bwd.cu) kernels: cp.async copies, bf16 packing, warp sums, the wmma
// fragment types and warp grid, and the two GELU implementations.
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
constexpr int kMaxSegs = 4;          // 16-byte segments of a row per lane: C <= 1024

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

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBRow;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

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

// GELU. "exact": erff. "fast": the single-segment odd minimax fits of the
// JAX package (ops/convnext_block.py:111-129), no transcendentals:
//   erf(z) ~ z*P8((z/2.75)^2) on |z| <= 2.75, clamped beyond;
//   gelu'(x) - 0.5 ~ x*Q10((x/5)^2) on |x| <= 5, clamped beyond.
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

template <bool FAST>
__device__ __forceinline__ float gelu(float v) {
  const float z = v * 0.70710678118654752f;
  return 0.5f * v * (1.f + (FAST ? erf_fast(z) : erff(z)));
}

template <bool FAST>
__device__ __forceinline__ float gelu_grad(float v) {
  if (FAST) return gelu_grad_fast(v);
  return 0.5f * (1.f + erff(v * 0.70710678118654752f)) +
         v * 0.3989422804014327f * expf(-0.5f * v * v);
}

}  // namespace imt
