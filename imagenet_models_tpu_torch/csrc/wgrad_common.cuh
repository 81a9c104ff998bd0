// The token-slice plan and the fixed-order column sums of the weight-gradient
// products A^T B over tokens, shared by the LN+MLP backward (ln_mlp_bwd.cu,
// kernel 2) and the fused ConvNeXt branch backward (convnext_branch_bwd.cu,
// kernel 11): each product's blocks own a kWB x kWB output tile and one slice
// of the tokens, and the slices' partials are then added column by column in
// a fixed order, so the sums are the same bits on every run.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace imt {

constexpr int kWB = 128;              // output tile: kWB x kWB
constexpr int kTargetBlocks = 264;    // two blocks per SM of a 132-SM card
constexpr long long kMinSlice = 256;  // fewest tokens a slice is given
constexpr long long kChunk = 64;      // rows one thread adds in a column sum

// dst[y][c] = sum of src rows [y*chunk, (y+1)*chunk) of column c, in row order.
static __global__ void colsum_kernel(const float* __restrict__ src, long long rows,
                                     long long cols, long long chunk, float* __restrict__ dst) {
  const long long c = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const long long r0 = static_cast<long long>(blockIdx.y) * chunk;
  const long long r1 = r0 + chunk < rows ? r0 + chunk : rows;
  float s = 0.f;
  for (long long r = r0; r < r1; ++r) s += src[r * cols + c];
  dst[static_cast<long long>(blockIdx.y) * cols + c] = s;
}

// Column sums of a (rows, cols) fp32 matrix, in a fixed order: one pass of
// kChunk-row sums into `scratch`, then one pass over those.
inline cudaError_t colsum(const float* src, long long rows, long long cols, float* dst,
                          float* scratch, cudaStream_t st) {
  const long long gx = (cols + 255) / 256;
  if (gx > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (rows <= kChunk) {
    colsum_kernel<<<dim3(static_cast<unsigned>(gx), 1), 256, 0, st>>>(src, rows, cols, rows, dst);
    return cudaGetLastError();
  }
  const long long parts = (rows + kChunk - 1) / kChunk;
  if (parts > 65535) return cudaErrorInvalidValue;
  colsum_kernel<<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(parts)), 256, 0, st>>>(
      src, rows, cols, kChunk, scratch);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  colsum_kernel<<<dim3(static_cast<unsigned>(gx), 1), 256, 0, st>>>(scratch, parts, cols, parts, dst);
  return cudaGetLastError();
}

inline size_t align256(size_t b) { return (b + 255) & ~size_t(255); }

// Token slices of one weight-grad product: enough blocks for the card, at
// least kMinSlice tokens each, at most kChunk slices (one column-sum pass).
struct Slices {
  long long count, per;
};

inline Slices plan_slices(long long n, int M, int P) {
  const long long tiles = static_cast<long long>((M + kWB - 1) / kWB) * ((P + kWB - 1) / kWB);
  long long s = (kTargetBlocks + tiles - 1) / tiles;
  const long long most = (n + kMinSlice - 1) / kMinSlice;
  s = s < most ? s : most;
  s = s < kChunk ? s : kChunk;
  s = s > 1 ? s : 1;
  const long long per = (n + s - 1) / s;
  return {(n + per - 1) / per, per};
}

}  // namespace imt
