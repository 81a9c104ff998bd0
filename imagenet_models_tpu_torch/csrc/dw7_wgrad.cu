// The weight gradient of a stride-1 SAME depthwise 7x7 convolution, for
// Hopper (sm_90a): from the conv input x and the output cotangent dy, both
// (B, H, W, C) NHWC of bf16 or fp32, the 49 tap sums
//
//   dw[c][ky][kx] = sum over (b, h, w) of x[b, h + ky - 3, w + kx - 3, c] * dy[b, h, w, c]
//
// (x zero outside the map), written as (C, 1, 7, 7) fp32, the port's weight
// layout. With bf16 operands each product is rounded to bf16 before the fp32
// add, as in the TPU kernel.
//
// Replaces the TPU kernel `_wgrad_kernel` / `dw7_wgrad` in
// imagenet_models_tpu/ops/dw_conv.py (:41-58, :72-100). That kernel pads x
// into a copy and walks the batch over a grid that runs in order, adding each
// step's 49 sums into its output block. CUDA blocks run concurrently and in
// no order, so here each block sums its share into partials of its own and a
// second pass adds them in a fixed order, as the BatchNorm kernels do
// (bn_reduce_common.cuh): no atomics, the same bits on every run. x is read
// in place, unpadded; the borders are bounds checks that load zeros.
//
// Layout. A block takes a tile of 32 channels x 32 output columns and a slice
// of consecutive output rows (b, h), with one warp per kernel row ky: lane l
// of a warp's half owns channel pair l, the halves take alternate columns,
// and each thread keeps the 7 tap sums (ky, 0..6) of its pair in fp32
// registers (few registers, so several blocks share an SM and hide each
// other's latency). The 7 x rows an output row needs (with a 3-column
// border) sit in a ring in shared memory, filled with 16-byte loads along C;
// moving down one output row loads one new x row, and the dy row beside
// them. The next row's loads are issued before the current row's
// arithmetic. A bf16 product is one bf16x2 multiply (a single rounding),
// widened and added in fp32. The two column lanes meet in a shuffle; each
// block writes its 49 x 32 partial sums once.
//
// What bounds it on the H100: instruction issue on the CUDA cores (a
// per-channel reduction has no tensor-core shape). Its bytes (x and dy read
// once, 49C fp32 written) take 0.046 ms at ga_convnext_tiny's stage 0 at
// B=128 over 3.35 TB/s, and its 49 multiply-adds per element pair 0.056 ms
// at the fp32 rate of 67 TFLOP/s; this kernel issues some five
// instructions per channel pair and tap (the bf16x2 multiply, two
// widenings, two adds) and a few per column (two x values into the
// register window, the dy pair). Measured at that shape on an H100 80GB
// HBM3 at 700 W: 0.354 ms, against 0.230 ms for cuDNN's depthwise weight
// gradient (chip_smoke.py phase 18; PERF.md, kernel table).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int K = 7, R = 3, TAPS = K * K;
constexpr int CT = 32;              // channels per block
constexpr int PAIRS = CT / 2;       // channel-pair lanes of a warp's half
constexpr int WL = 2;               // column lanes: the two halves of a warp
constexpr int THREADS = PAIRS * WL * K;  // one warp per kernel row ky
constexpr int TW = 32;              // output columns per block
constexpr int SW = TW + 2 * R;      // x columns of a ring row
constexpr int kBlocksTarget = 1056; // 8 blocks per SM of 132 (about 4 fit at once)
constexpr int kMinRows = 4;         // output rows per slice, at the least
constexpr int kMaxSlices = 65535;   // gridDim.z
constexpr int kBF16 = 0, kF32 = 1;  // operand type codes of the C interface

template <typename T>
struct Pair;
template <>
struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
};
template <>
struct Pair<float> {
  using type = float2;
};

__device__ __forceinline__ void mul_add(float2& acc, __nv_bfloat162 a, __nv_bfloat162 b) {
  const float2 p = __bfloat1622float2(__hmul2(a, b));  // each product rounded to bf16 once
  acc.x += p.x;
  acc.y += p.y;
}

__device__ __forceinline__ void mul_add(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.y = fmaf(a.y, b.y, acc.y);
}

struct Plan {
  int ctiles, wtiles, slices, rows_per_slice;
};

Plan make_plan(int B, int H, int W, int C) {
  Plan p;
  p.ctiles = (C + CT - 1) / CT;
  p.wtiles = (W + TW - 1) / TW;
  const long long rows = static_cast<long long>(B) * H;
  const long long per = static_cast<long long>(p.ctiles) * p.wtiles;
  long long s = (kBlocksTarget + per - 1) / per;
  const long long most = (rows + kMinRows - 1) / kMinRows;
  if (s > most) s = most;
  if (s > kMaxSlices) s = kMaxSlices;
  if (s < 1) s = 1;
  const long long rps = (rows + s - 1) / s;
  p.rows_per_slice = static_cast<int>(rps);
  p.slices = static_cast<int>((rows + rps - 1) / rps);
  return p;
}

bool valid(int B, int H, int W, int C) {
  return B > 0 && H > 0 && W > 0 && C > 0 && C % 8 == 0 &&
         static_cast<long long>(B) * H <= (1LL << 31) - 1 && (W + TW - 1) / TW <= 65535;
}

__device__ __forceinline__ void set_zero(__nv_bfloat162& p) { p = __floats2bfloat162_rn(0.f, 0.f); }
__device__ __forceinline__ void set_zero(float2& p) { p = make_float2(0.f, 0.f); }

// The i-th 16-byte vector of ring row hx of image b (x columns w0 - 3 ..
// w0 + TW + 2, channels c0 .. c0 + CT - 1), zeros outside the map.
template <typename T>
__device__ __forceinline__ uint4 x_vector(const T* __restrict__ x, int b, int hx, int H, int W,
                                          int C, int w0, int c0, int i) {
  constexpr int VEC = 16 / sizeof(T), VPC = CT / VEC;
  const int wx = w0 - R + i / VPC, cc = c0 + (i % VPC) * VEC;
  if (i < SW * VPC && hx >= 0 && hx < H && wx >= 0 && wx < W && cc < C)
    return __ldg(reinterpret_cast<const uint4*>(
        x + ((static_cast<long long>(b) * H + hx) * W + wx) * C + cc));
  return make_uint4(0u, 0u, 0u, 0u);
}

// The i-th 16-byte vector of dy row h of image b (columns w0 .. w0 + TW - 1,
// channels c0 .. c0 + CT - 1), zeros outside the map.
template <typename T>
__device__ __forceinline__ uint4 dy_vector(const T* __restrict__ dy, int b, int h, int H, int W,
                                           int C, int w0, int c0, int i) {
  constexpr int VEC = 16 / sizeof(T), VPC = CT / VEC;
  const int w = w0 + i / VPC, cc = c0 + (i % VPC) * VEC;
  if (i < TW * VPC && w < W && cc < C)
    return __ldg(reinterpret_cast<const uint4*>(
        dy + ((static_cast<long long>(b) * H + h) * W + w) * C + cc));
  return make_uint4(0u, 0u, 0u, 0u);
}

// Pass 1: partials is (slices * wtiles, 49, C) fp32, one slab per block
// column (w tile) and row slice. Warp ky of a block owns kernel row ky: its
// two halves take alternate output columns, each lane one channel pair and
// the 7 tap sums (ky, 0..6) of that pair. The loads of the next output row
// (its new x row and its dy row) are issued before the current row's
// products, so their latency overlaps the arithmetic; a new image refills
// the whole ring.
template <typename T>
__global__ void __launch_bounds__(THREADS)
wgrad_partials_kernel(const T* __restrict__ x, const T* __restrict__ dy, int H, int W, int C,
                      long long rows, int rows_per_slice, float* __restrict__ partials) {
  using P = typename Pair<T>::type;
  constexpr int VEC = 16 / sizeof(T);                     // elements per 16-byte load
  constexpr int VPC = CT / VEC;                           // 16-byte loads per column
  constexpr int NV = (SW * VPC + THREADS - 1) / THREADS;  // of an x row, per thread
  constexpr int ND = (TW * VPC + THREADS - 1) / THREADS;  // of a dy row, per thread
  constexpr int NC = TW / WL;                             // columns per thread
  __shared__ __align__(16) T xs[K][SW][CT];
  __shared__ __align__(16) T dys[TW][CT];

  const int c0 = blockIdx.x * CT;
  const int w0 = blockIdx.y * TW;
  const long long r0 = static_cast<long long>(blockIdx.z) * rows_per_slice;
  const long long r1 = r0 + rows_per_slice < rows ? r0 + rows_per_slice : rows;
  const int tid = threadIdx.x;
  const int pair = tid % PAIRS;
  const int lane_w = (tid / PAIRS) % WL;
  const int ky = tid / (PAIRS * WL);
  const int c = c0 + 2 * pair;  // C % 8 == 0: c < C implies c + 1 < C
  const int wn = W - w0;        // the block's columns inside the map

  auto store_x = [&](int hx, const uint4* v) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = tid + k * THREADS;
      if (i < SW * VPC)
        *reinterpret_cast<uint4*>(&xs[(hx + 2 * K) % K][i / VPC][(i % VPC) * VEC]) = v[k];
    }
  };
  auto store_dy = [&](const uint4* v) {
#pragma unroll
    for (int k = 0; k < ND; ++k) {
      const int i = tid + k * THREADS;
      if (i < TW * VPC) *reinterpret_cast<uint4*>(&dys[i / VPC][(i % VPC) * VEC]) = v[k];
    }
  };
  auto fill = [&](int b, int h) {  // the 7 x rows and the dy row of output row h
    uint4 v[NV > ND ? NV : ND];
    for (int hx = h - R; hx <= h + R; ++hx) {
#pragma unroll
      for (int k = 0; k < NV; ++k) v[k] = x_vector(x, b, hx, H, W, C, w0, c0, tid + k * THREADS);
      store_x(hx, v);
    }
#pragma unroll
    for (int k = 0; k < ND; ++k) v[k] = dy_vector(dy, b, h, H, W, C, w0, c0, tid + k * THREADS);
    store_dy(v);
  };

  float2 acc[K];
#pragma unroll
  for (int t = 0; t < K; ++t) acc[t] = make_float2(0.f, 0.f);

  int b = static_cast<int>(r0 / H);
  int h = static_cast<int>(r0 - static_cast<long long>(b) * H);
  if (r0 < r1) fill(b, h);
  __syncthreads();
  for (long long r = r0; r < r1; ++r) {
    // issue the next row's loads
    const bool more = r + 1 < r1;
    const int bn = h + 1 == H ? b + 1 : b, hn = h + 1 == H ? 0 : h + 1;
    const bool same = more && bn == b;  // the next row needs one new x row
    uint4 xn[NV], dn[ND];
#pragma unroll
    for (int k = 0; k < NV; ++k)
      xn[k] = same ? x_vector(x, b, hn + R, H, W, C, w0, c0, tid + k * THREADS)
                   : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int k = 0; k < ND; ++k)
      dn[k] = same ? dy_vector(dy, bn, hn, H, W, C, w0, c0, tid + k * THREADS)
                   : make_uint4(0u, 0u, 0u, 0u);
    // this row's products: x row h + ky - 3 against the dy row
    if (c < C) {
      const P* xr = reinterpret_cast<const P*>(&xs[(h + ky - R + 2 * K) % K][0][0]) + pair;
      const P* gr = reinterpret_cast<const P*>(&dys[0][0]) + pair;
      // x columns wl .. wl + 6 of this thread's column wl in registers; the
      // next column (wl + 2) keeps five of them and loads two
      P win[K];
#pragma unroll
      for (int k = 0; k < K; ++k) win[k] = xr[(lane_w + k) * PAIRS];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int wl = lane_w + WL * j;
        if (wl >= wn) break;
        const P g = gr[wl * PAIRS];
#pragma unroll
        for (int kx = 0; kx < K; ++kx) mul_add(acc[kx], win[kx], g);
        if (j + 1 < NC) {
#pragma unroll
          for (int k = 0; k < K - WL; ++k) win[k] = win[k + WL];
#pragma unroll
          for (int k = K - WL; k < K; ++k) win[k] = xr[(wl + WL + k) * PAIRS];
        }
      }
    }
    __syncthreads();  // every thread is done with the rows being replaced
    if (same) {
      store_x(hn + R, xn);  // x row h + 4 takes the slot of h - 3
      store_dy(dn);
    } else if (more) {
      fill(bn, hn);
    }
    __syncthreads();
    b = bn;
    h = hn;
  }

  // The two column lanes of a channel pair and kernel row, by a shuffle;
  // lanes 0-15 then hold the block's 7 tap sums (ky, 0..6) of their pair.
#pragma unroll
  for (int t = 0; t < K; ++t) {
    acc[t].x += __shfl_down_sync(0xffffffffu, acc[t].x, 16);
    acc[t].y += __shfl_down_sync(0xffffffffu, acc[t].y, 16);
  }
  if (lane_w == 0 && c < C) {
    float* out =
        partials + (static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) * TAPS * C;
#pragma unroll
    for (int kx = 0; kx < K; ++kx)
      *reinterpret_cast<float2*>(out + static_cast<long long>(ky * K + kx) * C + c) = acc[kx];
  }
}

// Pass 2: dw[c][t] = the sum over every slab s of partials[s][t][c], in a
// fixed order: a block per tap and 32 channels, its FG rows of threads each
// adding every FG-th slab (four running sums, then their pairs), the FG rows
// then added in order.
constexpr int FG = 8;

__global__ void __launch_bounds__(32 * FG)
finalize_kernel(const float* __restrict__ partials, int slabs, int C, float* __restrict__ dw) {
  __shared__ float red[FG][32];
  const int t = blockIdx.x, c = blockIdx.y * 32 + threadIdx.x, row = threadIdx.y;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  if (c < C) {
    const long long stride = static_cast<long long>(TAPS) * C;
    const float* p = partials + static_cast<long long>(t) * C + c;
    int i = row;
    for (; i + 3 * FG < slabs; i += 4 * FG) {
      s0 += p[i * stride];
      s1 += p[(i + FG) * stride];
      s2 += p[(i + 2 * FG) * stride];
      s3 += p[(i + 3 * FG) * stride];
    }
    for (; i < slabs; i += FG) s0 += p[i * stride];
  }
  red[row][threadIdx.x] = (s0 + s1) + (s2 + s3);
  __syncthreads();
  if (row == 0 && c < C) {
    float total = 0.f;
#pragma unroll
    for (int r = 0; r < FG; ++r) total += red[r][threadIdx.x];
    dw[static_cast<long long>(c) * TAPS + t] = total;
  }
}

template <typename T>
cudaError_t run(const void* x, const void* dy, int B, int H, int W, int C, float* partials,
                float* dw, cudaStream_t stream) {
  const Plan p = make_plan(B, H, W, C);
  const dim3 grid(p.ctiles, p.wtiles, p.slices);
  wgrad_partials_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), H, W, C,
      static_cast<long long>(B) * H, p.rows_per_slice, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finalize_kernel<<<dim3(TAPS, (C + 31) / 32), dim3(32, FG), 0, stream>>>(
      partials, p.slices * p.wtiles, C, dw);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Slabs of partials for a (B, H, W, C) map: the partials buffer holds
// slabs * 49 * C floats. 0 for a shape the kernel does not take.
int imt_dw7_wgrad_slabs(int B, int H, int W, int C) {
  if (!valid(B, H, W, C)) return 0;
  const Plan p = make_plan(B, H, W, C);
  return p.slices * p.wtiles;
}

// x, dy: contiguous (B, H, W, C) NHWC maps of one dtype (kBF16 or kF32),
// 16-byte aligned; C % 8 == 0. Writes dw, (C, 49) fp32; partials is scratch
// of imt_dw7_wgrad_slabs(...) * 49 * C floats. Two launches on `stream`;
// returns the launch status (a cudaError_t; 0 is success).
int imt_dw7_wgrad(const void* x, const void* dy, int dtype, int B, int H, int W, int C,
                  void* partials, void* dw, void* stream) {
  if (!valid(B, H, W, C) || (dtype != kBF16 && dtype != kF32)) return cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(dy)) return cudaErrorMisalignedAddress;
  float* part = static_cast<float*>(partials);
  float* out = static_cast<float*>(dw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return run<__nv_bfloat16>(x, dy, B, H, W, C, part, out, st);
  return run<float>(x, dy, B, H, W, C, part, out, st);
}

const char* imt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
