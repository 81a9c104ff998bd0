// Device helpers shared by the BatchNorm statistics kernels, bn_moments.cu
// (kernel 7: sum x and sum x^2 per channel) and bn_dot_sums.cu (kernel 8:
// sum a and sum a*b per channel). Both reduce (n, C) rows, each row C
// contiguous channels and rows `ld` elements apart, of bf16 or fp32 operands,
// to two fp32 sums per channel, in one launch:
//
//   A grid of (channel tile) x (row slice) blocks. Thread (tx, ty) of a block
//   owns V consecutive channels of the tile and walks over rows ty, ty + TY,
//   ... of its block's slice, loading the V values of a row at once (16 bytes
//   where the layout allows it), four rows in flight, adding them into fp32
//   registers; the TY row lanes of a channel are then added in shared memory
//   by a tree of fixed shape, and the block writes one partial per channel
//   and sum. The partials are then added in two levels, each by the block
//   that finishes last, told by an integer ticket:
//     1. the slices of a tile fall into groups of kGroup consecutive slices;
//        the last block of a group to write its partials adds the group's
//        partials, in slice order, into one group partial;
//     2. the last group of a tile to do so adds the tile's group partials,
//        in group order, into the output, and so does a tile of one group
//        at level 1.
//   Each block that draws the last ticket of its counter puts the counter
//   back to zero, so every call finds its counters at zero and leaves them
//   so. The order of every addition is fixed by the shapes alone, not by
//   which block comes last: a sum comes out the same, bit for bit, on every
//   run, and nothing is added with float atomics.
//
// The tickets are per tile and per group, not one for the call: one block
// adding every partial of a 1.6-million-row map (660 slices of 2C floats)
// would read megabytes alone at the end of the launch; the groups' finishers
// share that work while other blocks still stream rows, and leave the last
// block of a tile a few kilobytes. The counters live in a buffer that the
// caller keeps per device and stream (ops/batch_norm.py): calls on one
// stream run one after the other, so two calls in flight never share a
// counter.
//
// Partial sums over slices of a few thousand rows also keep the fp32 error
// of a sum over 1.6 million rows far below that of one running sum.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace imt_bn {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 5;      // blocks per SM the registers allow (48 a thread)
constexpr int kBlocksTarget = 660;  // one wave: kMinBlocks blocks on each of 132 SMs
constexpr int kMaxSlices = 65535;    // gridDim.y
constexpr int kMinRows = 8;          // rows per thread, at the least, in a slice
constexpr int kGroup = 32;           // slices added by one block at level 1
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

// Row slices: about kBlocksTarget blocks in all (all of them resident at
// once: no second, partial wave), but at least kMinRows rows per thread: on
// a small map more slices would only lengthen the sums of the partials.
inline int plan_slices(long long n, int C, int V) {
  const int ty = kThreads / lanes_for(C, V);
  const long long tiles = channel_tiles(C, V);
  long long s = (kBlocksTarget + tiles - 1) / tiles;
  const long long most = (n + ty * kMinRows - 1) / (ty * kMinRows);
  if (s > most) s = most;
  if (s > kMaxSlices) s = kMaxSlices;
  return static_cast<int>(s < 1 ? 1 : s);
}

// The plan of one call and the layout of its workspace, all fp32: the 2C
// sums, then (slices, 2C) slice partials, then (groups, 2C) group partials;
// and `tickets` counters, tiles * groups for level 1 then tiles for level 2.
struct Plan {
  int vec, slices, groups;
  long long tiles, floats, tickets;
};

inline Plan make_plan(long long n, int C, int V) {
  Plan p;
  p.vec = V;
  p.slices = plan_slices(n, C, V);
  p.groups = (p.slices + kGroup - 1) / kGroup;
  p.tiles = channel_tiles(C, V);
  p.floats = 2LL * C * (1 + p.slices + p.groups);
  p.tickets = p.tiles * p.groups + p.tiles;
  return p;
}

// The block's ticket on counter *t, shared with every thread: whether it
// drew the counter's last one (of `count`), after which it puts it back to
// zero. Each thread that wrote (`wrote`) fences its global writes before the
// draw, and the block that draws last fences again before it reads what the
// others wrote.
__device__ __forceinline__ bool last_to_arrive(unsigned* t, unsigned count, bool wrote) {
  __shared__ bool last;
  if (wrote) __threadfence();
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    last = atomicAdd(t, 1u) == count - 1;
    if (last) *t = 0u;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// dst[q] = sum over k in [k0, k1) of src[k * ld + q], for the 2W sums of one
// channel tile (q in [c0, c0 + W) and [C + c0, C + c0 + W)), by every thread
// of the block, one q each: the rows in batches of 16 loads in flight (this
// runs at the end of the launch, where only latency counts), added into four
// running sums (k - k0 mod 4), then (s0 + s1) + (s2 + s3). The loads bypass
// L1: other blocks wrote them.
__device__ __forceinline__ void add_rows(const float* src, long long ld, int k0, int k1,
                                         float* dst, int c0, int W, int C) {
  constexpr int kBatch = 16;
  const int nt = blockDim.x * blockDim.y;
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < 2 * W; i += nt) {
    const int q = i < W ? c0 + i : C + c0 + i - W;
    const float* p = src + q;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = k0; k < k1; k += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) v[u] = k + u < k1 ? __ldcg(p + (k + u) * ld) : 0.f;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) s[u % 4] += v[u];
    }
    dst[q] = (s[0] + s[1]) + (s[2] + s[3]);
  }
}

// kDot: s1 += a, s2 += a*b; otherwise s1 += a, s2 += a*a (b unused). `work`
// is the call's workspace (make_plan): out = work[0:2C], sums of a in [0, C)
// and the second sums in [C, 2C).
template <typename TA, typename TB, int V, bool kDot>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
channel_sums_kernel(const TA* __restrict__ a, long long lda, const TB* __restrict__ b,
                    long long ldb, long long n, int C, long long rows, int groups,
                    float* __restrict__ work, unsigned* __restrict__ tickets) {
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
  const int slices = gridDim.y;
  const long long ld = 2LL * C;
  float* out = work;
  float* part = work + ld;
  float* gpart = part + static_cast<long long>(slices) * ld;
  if (ty == 0 && c0 < C) {
    float* dst = (slices == 1 ? out : part + blockIdx.y * ld) + c0;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      dst[i] = red[i * TX + tx];
      dst[C + i] = red[half + i * TX + tx];
    }
  }
  if (slices == 1) return;
  // the tile's channels
  const int t0 = blockIdx.x * TX * V;
  const int W = (C - t0 < TX * V) ? C - t0 : TX * V;
  const int g = blockIdx.y / kGroup;
  const int k0 = g * kGroup;
  const int k1 = k0 + kGroup < slices ? k0 + kGroup : slices;
  if (!last_to_arrive(tickets + blockIdx.x * groups + g, k1 - k0, ty == 0 && c0 < C)) return;
  if (groups == 1) {
    add_rows(part, ld, k0, k1, out, t0, W, C);
    return;
  }
  add_rows(part, ld, k0, k1, gpart + g * ld, t0, W, C);
  if (!last_to_arrive(tickets + gridDim.x * groups + blockIdx.x, groups, true)) return;
  add_rows(gpart, ld, 0, groups, out, t0, W, C);
}

// One launch on `stream`: work[0:2C] gets the 2C sums (first C: sums of a).
template <typename TA, typename TB, int V, bool kDot>
cudaError_t launch(const TA* a, long long lda, const TB* b, long long ldb, long long n, int C,
                   const Plan& p, float* work, unsigned* tickets, cudaStream_t stream) {
  const int tx = lanes_for(C, V);
  const dim3 grid(static_cast<unsigned>(p.tiles), p.slices);
  const long long rows = (n + p.slices - 1) / p.slices;
  channel_sums_kernel<TA, TB, V, kDot><<<grid, dim3(tx, kThreads / tx), 0, stream>>>(
      a, lda, b, ldb, n, C, rows, p.groups, work, tickets);
  return cudaGetLastError();
}

inline bool known(int dtype) { return dtype == kBF16 || dtype == kF32; }

// Channels per load for operands at `ptrs` with row strides `lds` and type
// codes `dtypes`: 8 when every operand is bf16, else 4, as far as C, the
// strides and the pointers allow 16-byte (bf16 x 4: 8-byte) loads; else 1.
inline int pick_vec(int C, int nops, const void* const* ptrs, const long long* lds,
                    const int* dtypes) {
  bool all_bf16 = true;
  for (int i = 0; i < nops; ++i) all_bf16 = all_bf16 && dtypes[i] == kBF16;
  const int v = all_bf16 ? 8 : 4;
  if (C % v) return 1;
  for (int i = 0; i < nops; ++i)
    if (lds[i] % v || reinterpret_cast<uintptr_t>(ptrs[i]) % (v * (dtypes[i] == kBF16 ? 2 : 4)))
      return 1;
  return v;
}

// The workspace a call on (n, C) rows may need, whichever channels per load
// the operands allow: the larger sizes of the plans for 1, 4 and 8.
inline Plan largest_plan(long long n, int C) {
  Plan most = make_plan(n, C, 1);
  for (int v = 4; v <= 8; v += 4) {
    if (C % v) continue;
    const Plan p = make_plan(n, C, v);
    if (p.floats > most.floats) most.floats = p.floats;
    if (p.tickets > most.tickets) most.tickets = p.tickets;
  }
  return most;
}

}  // namespace imt_bn
