// Device helpers shared by the BatchNorm statistics kernels, bn_moments.cu
// (kernel 7: sum x and sum x^2 per channel) and bn_dot_sums.cu (kernel 8:
// sum a and sum a*b per channel). Both reduce (n, C) rows, each row C
// contiguous channels and rows `ld` elements apart, of bf16 or fp32 operands,
// to two fp32 sums per channel, in two passes:
//
//   1. partial_sums_kernel: a grid of (channel tile) x (row slice) blocks.
//      Thread (tx, ty) of a block owns V consecutive channels of the tile and
//      walks over rows ty, ty + TY, ... of its block's slice, loading the V
//      values of a row at once (16 bytes where the layout allows it) and
//      adding them into fp32 registers; the TY row lanes of a channel are
//      then added in shared memory by a tree of fixed shape, and the block
//      writes one partial per channel and sum.
//   2. finalize_kernel: per channel, the partials of every slice added in a
//      fixed order (32 lanes over the slices, each with four running sums,
//      then a tree).
//
// Nothing is added with atomics and the number of slices depends on the
// shapes alone, so a sum comes out the same, bit for bit, on every run.
// Partial sums over slices of a few thousand rows also keep the fp32 error
// of a sum over 1.6 million rows far below that of one running sum.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace imt_bn {

constexpr int kThreads = 256;
constexpr int kBlocksTarget = 1056;  // 8 blocks of 256 threads per SM of 132
constexpr int kMaxSlices = 65535;    // gridDim.y
constexpr int kMinRows = 8;          // rows per thread, at the least, in a slice
constexpr int kBF16 = 0, kF32 = 1;   // operand type codes of the C interface

// V consecutive values at p as fp32; p is aligned to V elements when V > 1.
// A bf16 value is the top half of an fp32 one, so it widens by a shift.
template <int V>
__device__ __forceinline__ void load(const uint16_t* __restrict__ p, float (&o)[V]) {
  if constexpr (V == 8) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      o[2 * k] = __uint_as_float(w[k] << 16);
      o[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  } else if constexpr (V == 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    o[0] = __uint_as_float(u.x << 16);
    o[1] = __uint_as_float(u.x & 0xffff0000u);
    o[2] = __uint_as_float(u.y << 16);
    o[3] = __uint_as_float(u.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] = __uint_as_float(static_cast<unsigned>(p[k]) << 16);
  }
}

template <int V>
__device__ __forceinline__ void load(const float* __restrict__ p, float (&o)[V]) {
  if constexpr (V == 4) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = u.x;
    o[1] = u.y;
    o[2] = u.z;
    o[3] = u.w;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] = __ldg(p + k);
  }
}

// Channel lanes of a block: the smallest power of two that covers C/V
// vectors, at most 32. The block's other dimension, TY = 256 / TX, walks rows.
inline int lanes_for(int C, int V) {
  const int nv = C / V;
  int tx = 1;
  while (tx < nv && tx < 32) tx <<= 1;
  return tx;
}

inline long long channel_tiles(int C, int V) {
  const int tx = lanes_for(C, V);
  return (C / V + tx - 1) / tx;
}

// Row slices: about kBlocksTarget blocks in all, but at least kMinRows rows
// per thread: on a small map more slices would only lengthen pass 2.
inline int plan_slices(long long n, int C, int V) {
  const int ty = kThreads / lanes_for(C, V);
  const long long tiles = channel_tiles(C, V);
  long long s = (kBlocksTarget + tiles - 1) / tiles;
  const long long most = (n + ty * kMinRows - 1) / (ty * kMinRows);
  if (s > most) s = most;
  if (s > kMaxSlices) s = kMaxSlices;
  return static_cast<int>(s < 1 ? 1 : s);
}

inline bool valid_plan(long long n, int C, int V, int slices) {
  return n > 0 && C > 0 && (V == 1 || V == 4 || V == 8) && C % V == 0 &&
         slices == plan_slices(n, C, V);
}

// Pass 1. kDot: s1 += a, s2 += a*b; otherwise s1 += a, s2 += a*a (b unused).
// partials is (slices, 2C): sums of a in [0, C), the second sums in [C, 2C).
template <typename TA, typename TB, int V, bool kDot>
__global__ void __launch_bounds__(kThreads)
partial_sums_kernel(const TA* __restrict__ a, long long lda, const TB* __restrict__ b,
                    long long ldb, long long n, int C, long long rows,
                    float* __restrict__ partials) {
  __shared__ float red[2 * kThreads * V];  // [2][TY][V][TX]
  const int TX = blockDim.x, TY = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c0 = (blockIdx.x * TX + tx) * V;
  const long long r0 = static_cast<long long>(blockIdx.y) * rows;
  const long long r1 = r0 + rows < n ? r0 + rows : n;
  float s1[V], s2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s1[i] = s2[i] = 0.f;
  if (c0 < C) {
    const TA* pa = a + c0;
    const TB* pb = nullptr;
    if constexpr (kDot) pb = b + c0;
    long long r = r0 + ty;
    // four rows in flight per thread
    for (; r + 3LL * TY < r1; r += 4LL * TY) {
      float x[4][V], y[4][V];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        load<V>(pa + (r + u * TY) * lda, x[u]);
        if constexpr (kDot) {
          load<V>(pb + (r + u * TY) * ldb, y[u]);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) y[u][i] = x[u][i];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s1[i] += x[u][i];
          s2[i] = fmaf(x[u][i], y[u][i], s2[i]);
        }
      }
    }
    for (; r < r1; r += TY) {
      float x[V], y[V];
      load<V>(pa + r * lda, x);
      if constexpr (kDot) {
        load<V>(pb + r * ldb, y);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) y[i] = x[i];
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s1[i] += x[i];
        s2[i] = fmaf(x[i], y[i], s2[i]);
      }
    }
  }
  const int half = TY * V * TX;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    red[(ty * V + i) * TX + tx] = s1[i];
    red[half + (ty * V + i) * TX + tx] = s2[i];
  }
  __syncthreads();
  for (int s = TY / 2; s > 0; s >>= 1) {
    if (ty < s) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        red[(ty * V + i) * TX + tx] += red[((ty + s) * V + i) * TX + tx];
        red[half + (ty * V + i) * TX + tx] += red[half + ((ty + s) * V + i) * TX + tx];
      }
    }
    __syncthreads();
  }
  if (ty == 0 && c0 < C) {
    float* out = partials + static_cast<size_t>(blockIdx.y) * 2 * C + c0;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      out[i] = red[i * TX + tx];
      out[C + i] = red[half + i * TX + tx];
    }
  }
}

// Pass 2: out[q] = sum over slices k, in a fixed order, of partials[k][q],
// q < 2C. A block of 32 x 32 threads takes 32 consecutive q.
__global__ void __launch_bounds__(1024)
finalize_kernel(const float* __restrict__ partials, int slices, int C2, float* __restrict__ out) {
  __shared__ float red[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int q = blockIdx.x * 32 + tx;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  if (q < C2) {
    const float* p = partials + q;
    int k = ty;
    for (; k + 96 < slices; k += 128) {
      a0 += p[static_cast<size_t>(k) * C2];
      a1 += p[static_cast<size_t>(k + 32) * C2];
      a2 += p[static_cast<size_t>(k + 64) * C2];
      a3 += p[static_cast<size_t>(k + 96) * C2];
    }
    for (; k < slices; k += 32) a0 += p[static_cast<size_t>(k) * C2];
  }
  red[ty][tx] = (a0 + a1) + (a2 + a3);
  __syncthreads();
  for (int s = 16; s > 0; s >>= 1) {
    if (ty < s) red[ty][tx] += red[ty + s][tx];
    __syncthreads();
  }
  if (ty == 0 && q < C2) out[q] = red[0][tx];
}

// Both passes on `stream`: `out` gets the 2C sums (first C: sums of a).
template <typename TA, typename TB, int V, bool kDot>
cudaError_t launch(const TA* a, long long lda, const TB* b, long long ldb, long long n, int C,
                   int slices, float* partials, float* out, cudaStream_t stream) {
  const int tx = lanes_for(C, V);
  const dim3 grid(static_cast<unsigned>(channel_tiles(C, V)), slices);
  const long long rows = (n + slices - 1) / slices;
  partial_sums_kernel<TA, TB, V, kDot><<<grid, dim3(tx, kThreads / tx), 0, stream>>>(
      a, lda, b, ldb, n, C, rows, partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  finalize_kernel<<<(2 * C + 31) / 32, dim3(32, 32), 0, stream>>>(partials, slices, 2 * C, out);
  return cudaGetLastError();
}

// Whether rows of V values at p (row stride ld) are aligned for V-wide loads.
template <typename T>
inline bool aligned(const void* p, long long ld, int V) {
  return reinterpret_cast<uintptr_t>(p) % (V * sizeof(T)) == 0 && ld % V == 0;
}

}  // namespace imt_bn
