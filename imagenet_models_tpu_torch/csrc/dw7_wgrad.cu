// The weight gradient of a stride-1 SAME depthwise 7x7 convolution, for
// Hopper (sm_90a): from the conv input x and the output cotangent dy, both
// (B, H, W, C) NHWC of bf16 or fp32, the 49 tap sums
//
//   dw[c][ky][kx] = sum over (b, h, w) of x[b, h + ky - 3, w + kx - 3, c] * dy[b, h, w, c]
//
// (x zero outside the map), written as (C, 1, 7, 7) fp32, the port's weight
// layout. With bf16 operands each product is rounded to bf16 before the fp32
// add, as in the TPU kernel; fp32 operands take exact FMAs.
//
// Replaces the TPU kernel `_wgrad_kernel` / `dw7_wgrad` in
// imagenet_models_tpu/ops/dw_conv.py (:41-58, :72-100). That kernel pads x
// into a copy and walks the batch over a grid that runs in order, adding each
// step's 49 sums into its output block. CUDA blocks run concurrently and in
// no order, so here each block sums its share into partials of its own and a
// second pass adds them in a fixed order, as the BatchNorm kernels do
// (bn_reduce_common.cuh): no atomics, the same bits on every run. x is read
// in place, unpadded; rows and columns outside the map read zeros.
//
// What bounds it on the H100: instruction issue on the CUDA cores. A
// per-channel reduction has no tensor-core shape, and a tensor core cannot
// round each product to bf16. Its bytes (x and dy read once, 49C fp32
// written) take 0.046 ms at ga_convnext_tiny's stage 0 at B=128 over
// 3.35 TB/s; its products take several times that at one instruction per
// clock per scheduler. So the design aims at pure issue:
//
//  * Two instructions per bf16 product. The ring in shared memory holds x
//    and dy widened to fp32 (a bf16 value with 16 zero bits below it). A
//    bf16x2 multiply of two such words rounds x * dy to bf16 once in the
//    high half and gives +0 * +0 = +0 in the low half, so the result is
//    the rounded product as an fp32 word, added with one FADD. The packed
//    form (a bf16x2 multiply of two channels, two widenings, two adds) took
//    five instructions per channel pair. Widening happens once per element,
//    when it enters the ring, not once per product.
//  * Tiles fit the map. A block takes a tile of 28, 14 or 8 output columns
//    (56- and 28-wide maps, 14-wide maps, 7-wide maps; other widths take
//    the tile that wastes the fewest columns, the ragged edge reading
//    zeros), 16 or 32 channels, and a slice of consecutive output rows. A
//    warp owns one kernel row ky: lane = (column lane, channel pair), each
//    lane keeps the 7 tap sums (ky, 0..6) of its pair in registers and
//    slides a 7-column window of x along its block of consecutive columns
//    (one new x value and one dy value a column). Every lane of the 14- and
//    7-wide maps has a column (one of 8 idles on the 7-wide map).
//  * One barrier per step. A step is 4 output rows (28-wide tiles: 16
//    channels, 4 column lanes of 7), 3 (14-wide) or 4 (8-wide), so a thread
//    does 220-390 products between barriers. The ring holds the x rows
//    of the current step and of the next (2 R + 6 rows, indexed by
//    b * H + h, so an image boundary needs no more room), dy is
//    double-buffered, and the next step's new rows (at an image boundary,
//    the whole first window of the next image) are loaded into registers
//    before the current step's products and stored after them, so their
//    latency hides behind the arithmetic and one barrier separates steps.
//    Each thread's share of those loads (addresses, ring offsets) is worked
//    out once per block. A kernel row above or below the map adds nothing:
//    its warp skips it (24% of the products of a 7-high map).
//  * Small partials. The plan fills one wave of resident blocks (the SMs
//    times the blocks that fit on one: four), so each block's slice is long
//    and the partials hold 528 x 49 x 16 or 32 floats (1.7 or 3.3 MB) at
//    every path shape, added by the second pass.
//
// The code (ptxas and cuobjdump -sass of the sm_90a build; chip_smoke.py
// phase 18 logs both). bf16, 28-wide tiles: 72 registers (16 bytes
// spilled), 1245 instructions a step of 4 rows: a row is 248, of which 196
// are the products (a column: 14 HMUL2 + 14 FADD for 7 taps of a channel
// pair, and 2 LDS.64), and a step's loads, stores, bookkeeping and barrier
// take 253. 14-wide: 71 registers; 8-wide: 69. At one instruction a clock
// on each of the 528 schedulers at 1980 MHz, the products alone take
// (computed, not measured) 0.113 ms at ga_convnext_tiny's stage 0 at B=128,
// 0.057 at stage 1, 0.028 at stage 2, 0.011 at stage 3 (rows outside the
// map skipped) and 0.012 in the gram layers; with the rest of the 28-wide
// step, 0.179 ms at stage 0. Measured there (H100 80GB HBM3, 700 W): 0.25
// ms, against cuDNN's 0.21; without the products 0.13, without the global
// loads 0.22: the refill and the products do not fully overlap (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int K = 7, R3 = 3, TAPS = K * K;
constexpr int kMinSteps = 2;        // steps per slice, at the least
constexpr int kMaxSlices = 65535;   // gridDim.z
constexpr int kBF16 = 0, kF32 = 1;  // operand type codes of the C interface

// A tile plan: P channel pairs (a warp per kernel row: P * WL == 32), WL
// column lanes of NC columns each (TW = WL * NC output columns), R output
// rows per step.
template <int P_, int WL_, int NC_, int R_>
struct Cfg {
  static constexpr int P = P_, WL = WL_, NC = NC_, R = R_;
  static constexpr int CT = 2 * P;            // channels per block
  static constexpr int TW = WL * NC;          // output columns per block
  static constexpr int SW = TW + 2 * R3;      // x columns of a ring row
  static constexpr int RING = 2 * R + 2 * R3; // x rows: this step's and the next's
  static constexpr int THREADS = P * WL * K;
  static constexpr int XROW = SW * CT;        // floats of a ring row
  static constexpr int DROW = TW * CT;        // floats of a dy row
  static constexpr int SMEM = (RING * XROW + 2 * R * DROW) * 4;
  static_assert(P * WL == 32, "a warp per kernel row");
};

using CfgWide = Cfg<8, 4, 7, 4>;     // TW = 28: 56- and 28-wide maps
using CfgMid = Cfg<16, 2, 7, 3>;     // TW = 14
using CfgNarrow = Cfg<16, 2, 4, 4>;  // TW = 8: 7-wide maps
constexpr int kTileWidths[3] = {CfgWide::TW, CfgMid::TW, CfgNarrow::TW};
constexpr int kTileChannels[3] = {CfgWide::CT, CfgMid::CT, CfgNarrow::CT};
constexpr int kStepRows[3] = {CfgWide::R, CfgMid::R, CfgNarrow::R};

// Loads of 16 bytes and their widening into the ring's fp32 form.
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int VEC = 8;
  // element 2i is the low half of word i; each becomes an fp32 word
  static __device__ __forceinline__ void store(float* dst, uint4 u) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
    float4 a, b;
    a.x = __uint_as_float(w[0] << 16);
    a.y = __uint_as_float(w[0] & 0xffff0000u);
    a.z = __uint_as_float(w[1] << 16);
    a.w = __uint_as_float(w[1] & 0xffff0000u);
    b.x = __uint_as_float(w[2] << 16);
    b.y = __uint_as_float(w[2] & 0xffff0000u);
    b.z = __uint_as_float(w[3] << 16);
    b.w = __uint_as_float(w[3] & 0xffff0000u);
    reinterpret_cast<float4*>(dst)[0] = a;
    reinterpret_cast<float4*>(dst)[1] = b;
  }
  // acc += round_bf16(x * g), for x and g bf16 values in fp32 form
  static __device__ __forceinline__ float mul_add(float acc, float x, float g) {
    __nv_bfloat162 p = __hmul2(reinterpret_cast<const __nv_bfloat162&>(x),
                               reinterpret_cast<const __nv_bfloat162&>(g));
    return acc + reinterpret_cast<const float&>(p);
  }
  // a0 += x.x * g.x, a1 += x.y * g.y (a channel pair)
  static __device__ __forceinline__ void mul_add_pair(float& a0, float& a1, float2 x, float2 g) {
    a0 = mul_add(a0, x.x, g.x);
    a1 = mul_add(a1, x.y, g.y);
  }
};

template <>
struct Elem<float> {
  static constexpr int VEC = 4;
  static __device__ __forceinline__ void store(float* dst, uint4 u) {
    *reinterpret_cast<uint4*>(dst) = u;
  }
  static __device__ __forceinline__ void mul_add_pair(float& a0, float& a1, float2 x, float2 g) {
    a0 = fmaf(x.x, g.x, a0);
    a1 = fmaf(x.y, g.y, a1);
  }
};

// Pass 1: partials is (slices * wtiles, 49, C) fp32, one slab per block
// column (w tile) and row slice; the block's channel tile writes its 32
// channels of the slab.
template <typename T, class Cf>
__global__ void __launch_bounds__(Cf::THREADS, 4)
wgrad_partials_kernel(const T* __restrict__ x, const T* __restrict__ dy, int H, int W, int C,
                      int rows, int rows_per_slice, float* __restrict__ partials) {
  using E = Elem<T>;
  constexpr int VPC = Cf::CT / E::VEC;  // 16-byte loads per column
  constexpr int XV = Cf::SW * VPC;      // of an x row
  constexpr int DV = Cf::TW * VPC;      // of a dy row
  constexpr int XMAX = Cf::R + R3;      // new x rows of a step, at the most
  constexpr int NPRE = (XMAX * XV + Cf::R * DV + Cf::THREADS - 1) / Cf::THREADS;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* dys = smem + Cf::RING * Cf::XROW;

  const int c0 = blockIdx.x * Cf::CT;
  const int w0 = blockIdx.y * Cf::TW;
  const int r0 = blockIdx.z * rows_per_slice;
  const int r1 = min(r0 + rows_per_slice, rows);
  const int tid = threadIdx.x;
  const int pair = tid % Cf::P;
  const int cl = (tid / Cf::P) % Cf::WL;
  const int ky = tid / (Cf::P * Cf::WL);
  const long long row_elems = static_cast<long long>(W) * C;

  // This thread's share of a step's new data, fixed for the whole block:
  // vector i = tid + k * THREADS of XMAX x rows (x columns w0 - 3 ..
  // w0 + TW + 2) then R dy rows (columns w0 .. w0 + TW - 1). goff is its
  // offset from the start of its first row in x or dy (-1 outside the map:
  // a zero), soff its offset in a ring row or in a dy buffer.
  int vrow[NPRE], soff[NPRE];
  bool visx[NPRE];
  long long goff[NPRE];
#pragma unroll
  for (int k = 0; k < NPRE; ++k) {
    int i = tid + k * Cf::THREADS;
    visx[k] = i < XMAX * XV;
    if (!visx[k]) i -= XMAX * XV;
    const int per = visx[k] ? XV : DV;
    vrow[k] = i / per;
    if (!visx[k] && vrow[k] >= Cf::R) vrow[k] = 1 << 30;  // past the layout: never live
    const int rem = i - (i / per) * per, sc = rem / VPC, q = rem - sc * VPC;
    const int w = visx[k] ? w0 - R3 + sc : w0 + sc, cc = c0 + q * E::VEC;
    goff[k] = w >= 0 && w < W && cc < C
                  ? (i / per) * row_elems + static_cast<long long>(w) * C + cc
                  : -1;
    soff[k] = (visx[k] ? 0 : (i / per) * Cf::DROW) + sc * Cf::CT + q * E::VEC;
  }

  float acc[K][2];
#pragma unroll
  for (int t = 0; t < K; ++t) acc[t][0] = acc[t][1] = 0.f;

  // The first step, rows h .. h + n - 1 of image b: all its x rows (the
  // image's rows lo .. hi - 1, ring slot (b * H + row) % RING) and dy rows.
  int b = r0 / H, h = r0 - (r0 / H) * H;
  int n = min(min(Cf::R, H - h), r1 - r0);
  int hi = min(H, h + n + R3);
  if (r0 < r1) {
    const int lo = max(0, h - R3);
    for (int i = tid; i < (hi - lo) * XV + n * DV; i += Cf::THREADS) {
      const bool isx = i < (hi - lo) * XV;
      const int j = isx ? i : i - (hi - lo) * XV, per = isx ? XV : DV;
      const int ro = j / per, rem = j - ro * per, sc = rem / VPC, q = rem - sc * VPC;
      const int w = isx ? w0 - R3 + sc : w0 + sc, cc = c0 + q * E::VEC;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (w >= 0 && w < W && cc < C)
        u = __ldg(reinterpret_cast<const uint4*>(
            (isx ? x : dy) + (static_cast<long long>(b) * H + (isx ? lo : h) + ro) * row_elems +
            static_cast<long long>(w) * C + cc));
      E::store(isx ? ring + ((b * H + lo + ro) % Cf::RING) * Cf::XROW + sc * Cf::CT + q * E::VEC
                   : dys + ro * Cf::DROW + sc * Cf::CT + q * E::VEC,
               u);
    }
  }
  __syncthreads();
  int buf = 0;
  for (int r = r0; r < r1;) {
    // the next step: its new x rows xlo .. nhi - 1 (all of its window at an
    // image boundary) and its dy rows, loaded now and stored after this
    // step's products
    const int rn = r + n;
    const bool more = rn < r1;
    const bool wrap = h + n == H;
    const int nb = wrap ? b + 1 : b, nh = wrap ? 0 : h + n;
    const int nn = min(min(Cf::R, H - nh), r1 - rn);
    const int nhi = min(H, nh + nn + R3);
    const int xlo = wrap ? 0 : hi;
    const int nx = more ? nhi - xlo : 0, nd = more ? nn : 0;
    const T* xsrc = x + (static_cast<long long>(nb) * H + xlo) * row_elems;
    const T* dsrc = dy + (static_cast<long long>(nb) * H + nh) * row_elems;
    uint4 pre[NPRE];
#pragma unroll
    for (int k = 0; k < NPRE; ++k) {
      pre[k] = make_uint4(0u, 0u, 0u, 0u);
      if (vrow[k] < (visx[k] ? nx : nd) && goff[k] >= 0)
        pre[k] = __ldg(reinterpret_cast<const uint4*>((visx[k] ? xsrc : dsrc) + goff[k]));
    }

    // this step's products: for each of its rows, x row h + r + ky - 3
    // against the dy row, along this lane's columns (a kernel row outside
    // the map adds nothing and is skipped: the whole warp shares ky)
    const float* dbuf = dys + buf * Cf::R * Cf::DROW + 2 * pair;  // + the lane's columns below
    for (int rr = 0; rr < n; ++rr) {
      const int hx = h + rr + ky - R3;
      if (hx < 0 || hx >= H) continue;
      // this lane's columns cl * NC .. cl * NC + NC - 1: x columns col ..
      // col + 6 of output column col in registers, one new one a column
      const float* xr =
          ring + ((b * H + hx) % Cf::RING) * Cf::XROW + cl * Cf::NC * Cf::CT + 2 * pair;
      const float* gr = dbuf + rr * Cf::DROW + cl * Cf::NC * Cf::CT;
      float2 win[K];
#pragma unroll
      for (int k = 0; k < K; ++k) win[k] = *reinterpret_cast<const float2*>(xr + k * Cf::CT);
#pragma unroll
      for (int j = 0; j < Cf::NC; ++j) {
        const float2 g = *reinterpret_cast<const float2*>(gr + j * Cf::CT);
#pragma unroll
        for (int kx = 0; kx < K; ++kx) E::mul_add_pair(acc[kx][0], acc[kx][1], win[kx], g);
        if (j + 1 < Cf::NC) {
#pragma unroll
          for (int k = 0; k < K - 1; ++k) win[k] = win[k + 1];
          win[K - 1] = *reinterpret_cast<const float2*>(xr + (j + K) * Cf::CT);
        }
      }
    }

    if (more) {
      int slot0 = (nb * H + xlo) % Cf::RING;
      float* next = dys + (buf ^ 1) * Cf::R * Cf::DROW;
#pragma unroll
      for (int k = 0; k < NPRE; ++k) {
        if (vrow[k] < (visx[k] ? nx : nd)) {
          int slot = slot0 + vrow[k];
          if (slot >= Cf::RING) slot -= Cf::RING;
          E::store((visx[k] ? ring + slot * Cf::XROW : next) + soff[k], pre[k]);
        }
      }
    }
    __syncthreads();  // the next step's rows are in; this step's are free
    r = rn;
    b = nb;
    h = nh;
    n = nn;
    hi = nhi;
    buf ^= 1;
  }

  // The column lanes of a channel pair and kernel row, by shuffles (lanes
  // cl * P + pair of the warp); lanes 0 .. P - 1 then hold the block's 7 tap
  // sums (ky, 0..6) of their pair.
#pragma unroll
  for (int o = 16; o >= Cf::P; o >>= 1) {
#pragma unroll
    for (int t = 0; t < K; ++t) {
      acc[t][0] += __shfl_down_sync(0xffffffffu, acc[t][0], o);
      acc[t][1] += __shfl_down_sync(0xffffffffu, acc[t][1], o);
    }
  }
  const int c = c0 + 2 * pair;  // C % 8 == 0: c < C implies c + 1 < C
  if (cl == 0 && c < C) {
    float* out =
        partials + (static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) * TAPS * C;
#pragma unroll
    for (int kx = 0; kx < K; ++kx)
      *reinterpret_cast<float2*>(out + static_cast<long long>(ky * K + kx) * C + c) =
          make_float2(acc[kx][0], acc[kx][1]);
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

// The tile width (an index into kTileWidths) that wastes the fewest columns
// of a W-wide map, the wider on a tie.
int tile_kind(int W) {
  int best = 0, waste = 1 << 30;
  for (int k = 0; k < 3; ++k) {
    const int tw = kTileWidths[k];
    const int w = (W + tw - 1) / tw * tw - W;
    if (w < waste) best = k, waste = w;
  }
  return best;
}

template <class Cf>
cudaError_t prepare(const void* kern) {
  if (Cf::SMEM <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Cf::SMEM);
}

// Blocks of the bf16 instance that fit on one SM at once (the fp32 plan is
// the same, so both dtypes give one slab count for a shape).
template <class Cf>
int resident_blocks() {
  auto kern = wgrad_partials_kernel<__nv_bfloat16, Cf>;
  if (prepare<Cf>(reinterpret_cast<const void*>(kern)) != cudaSuccess) return 1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, Cf::THREADS, Cf::SMEM) !=
      cudaSuccess)
    return 1;
  return n > 0 ? n : 1;
}

struct Plan {
  int kind, ctiles, wtiles, slices, rows_per_slice;
};

Plan make_plan(int B, int H, int W, int C) {
  Plan p;
  p.kind = tile_kind(W);
  static int per_sm[3] = {0, 0, 0};  // the same for every card of one build
  if (per_sm[p.kind] == 0)
    per_sm[p.kind] = p.kind == 0   ? resident_blocks<CfgWide>()
                     : p.kind == 1 ? resident_blocks<CfgMid>()
                                   : resident_blocks<CfgNarrow>();
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  p.ctiles = (C + kTileChannels[p.kind] - 1) / kTileChannels[p.kind];
  p.wtiles = (W + kTileWidths[p.kind] - 1) / kTileWidths[p.kind];
  const long long rows = static_cast<long long>(B) * H;
  const long long per = static_cast<long long>(p.ctiles) * p.wtiles;
  const long long target = static_cast<long long>(sms) * per_sm[p.kind];
  long long s = (target + per - 1) / per;
  const long long most = (rows + kMinSteps * kStepRows[p.kind] - 1) / (kMinSteps * kStepRows[p.kind]);
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
         static_cast<long long>(B) * H <= (1LL << 31) - 1 && (W + 7) / 8 <= 65535;
}

template <typename T, class Cf>
cudaError_t launch_partials(const Plan& p, const void* x, const void* dy, int B, int H, int W,
                            int C, float* partials, cudaStream_t stream) {
  auto kern = wgrad_partials_kernel<T, Cf>;
  cudaError_t err = prepare<Cf>(reinterpret_cast<const void*>(kern));
  if (err != cudaSuccess) return err;
  kern<<<dim3(p.ctiles, p.wtiles, p.slices), Cf::THREADS, Cf::SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), H, W, C, B * H, p.rows_per_slice,
      partials);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* x, const void* dy, int B, int H, int W, int C, float* partials,
                float* dw, cudaStream_t stream) {
  const Plan p = make_plan(B, H, W, C);
  cudaError_t err =
      p.kind == 0   ? launch_partials<T, CfgWide>(p, x, dy, B, H, W, C, partials, stream)
      : p.kind == 1 ? launch_partials<T, CfgMid>(p, x, dy, B, H, W, C, partials, stream)
                    : launch_partials<T, CfgNarrow>(p, x, dy, B, H, W, C, partials, stream);
  if (err != cudaSuccess) return err;
  finalize_kernel<<<dim3(TAPS, (C + 31) / 32), dim3(32, FG), 0, stream>>>(
      partials, p.slices * p.wtiles, C, dw);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Slabs of partials for a (B, H, W, C) map on the current device: the
// partials buffer holds slabs * 49 * C floats. 0 for a shape the kernel does
// not take.
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
