// The depthwise 7x7 stages of the fused ConvNeXt branch's bf16 instances
// (convnext_branch_fwd.cu, kernel 10; convnext_branch_bwd.cu, kernel 11):
//
//  * conv_ln_kernel<BWD>, both kernels' prologue: h = dwconv7(x) + dw_b in
//    fp32 from the upcast x (the bias first, then the 49 taps in row-major
//    order, as the fp32 instance and the twin add them: h is never rounded),
//    LayerNorm with two-pass fp32 statistics, and tok = bf16(LN(h)) into
//    the GEMM stages' workspace; with BWD also x-hat (fp32), rstd, dpre2 =
//    bf16(g * gamma) and the block's partial sums of db2 = sum g * gamma and
//    of dgamma's b2 * sum g (kernel 2's prologue, csrc/ln_mlp_bwd.cu);
//  * the machinery of kernel 11's conv backward (conv_bwd_kernel, in
//    convnext_branch_bwd.cu): the walk, its plans and the ring's copies.
//
// Design. One block of 12 warps walks down a column strip of one image,
// row by row, keeping a ring of 8 input rows (the strip's columns and 3 more
// on each side, all of a channel tile: every channel for the prologue,
// whose LayerNorm needs all of a token's channels) in shared memory. Moving
// down one row copies one new row of the map with cp.async (zero-filled
// outside the map), issued a row ahead, so the copy overlaps the row's
// arithmetic (with 7 rows, where 8 do not fit, it is issued once the row's
// conv is done); x and dh are read from device memory once, plus the 6-row
// halo of each row slice. A thread owns one channel pair and kJ = 7
// consecutive output columns of each row (the ConvNeXt widths 56, 28, 14
// and 7 are multiples of 7): it keeps the pair's 49 taps in registers
// (float2, 98 registers) and slides a window of kJ + 6 columns of each of
// the 7 kernel rows along them, so each input value is read from shared
// memory once per kernel row and used for 7 products. The prologue's
// LayerNorm statistics then take a group of lanes a token, and each thread
// normalizes and writes one channel pair of up to kJ of the row's tokens.
// The tap gradient's threads keep their 49 running sums in the registers
// that hold the taps elsewhere, so the backward's two roles (12 warps: 6 on
// dx, 6 on the taps) share one code path and one register budget. The
// block's partial sums leave once, and the blocks' partials meet in a fixed
// order: no float atomics, the same bits on every run.
//
// What bounds them: the conv's 49 fp32 multiply-adds per element (98 in the
// backward) on the CUDA cores and, about as much, x's, dh's and the outputs'
// bytes. They run at 2-5x that bound (PERF.md): one block of 384
// threads at 168 registers fills an SM, and its rows' phases (the conv, the
// statistics, the writes) follow each other behind barriers.
#pragma once

#include "ln_mlp_common.cuh"
#include "mma_sync.cuh"

namespace imt {
namespace ring {

constexpr int kK = 7, kR = 3, kTaps = kK * kK;
constexpr int kJ = 7;                 // output columns a thread owns in a row
constexpr int kWin = kJ + 2 * kR;     // input columns of its window
constexpr int kRingThreads = 384;     // 12 warps
constexpr int kRoleThreads = kRingThreads / 2;  // conv_bwd_kernel: dx threads, then tap threads
constexpr int kGradRows = kTaps + 1;  // a tap partial slab: the 49 taps and ddw_b
constexpr int kMinRows = 4;           // output rows of a row slice, at the least
constexpr int kWaves = 1;             // blocks to aim for: this many per SM
constexpr size_t kRingBudget = kMaxSmem - 1024;

// 16 bytes by cp.async; `valid` false fills 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ float2 widen2(uint32_t w) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162&>(w));
}

__device__ __forceinline__ uint32_t narrow2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return reinterpret_cast<const uint32_t&>(v);
}

// The walk: blocks of (image, channel tile, strip, row slice), numbered row
// slice fastest; each owns `ct` channels from c0, output columns [xs0,
// xs0 + sw) and output rows [y0, y0 + rows) of its image (clipped to the
// map). Ring rows are `rw` columns wide: the strip's input columns xs0 - 3
// .., in `groups` column groups of kJ plus 6.
struct Plan {
  int B, H, W, C;
  int ct, ctiles;
  int sw, strips, groups, rw;
  int rows, slices;
  int slots;  // ring rows: 8, or 7 where 8 do not fit (the next row then waits for the conv)
  size_t smem;
  long long blocks() const { return static_cast<long long>(B) * ctiles * strips * slices; }
  long long slabs() const { return static_cast<long long>(B) * strips * slices; }
};

struct Block {
  int b, c0, xs0, swv, y0, y1;
  long long slab;  // the block's spatial index (image, strip, slice)
};

__host__ __device__ inline Block block_of(const Plan& p, long long id) {
  Block k;
  const int r = static_cast<int>(id % p.slices);
  id /= p.slices;
  const int s = static_cast<int>(id % p.strips);
  id /= p.strips;
  const int ct = static_cast<int>(id % p.ctiles);
  k.b = static_cast<int>(id / p.ctiles);
  k.c0 = ct * p.ct;
  k.xs0 = s * p.sw;
  k.swv = p.W - k.xs0 < p.sw ? p.W - k.xs0 : p.sw;
  k.y0 = r * p.rows;
  k.y1 = k.y0 + p.rows < p.H ? k.y0 + p.rows : p.H;
  k.slab = (static_cast<long long>(k.b) * p.strips + s) * p.slices + r;
  return k;
}

// Row slices: about kWaves blocks per SM, at least kMinRows rows each. One
// block an SM (the block takes all its registers) in tall slices ran
// fastest: fewer halo rows and ring fills than 2, 4 or 8 per SM
// (PERF.md).
inline void plan_slices(Plan& p, int sms) {
  const long long per = static_cast<long long>(p.B) * p.ctiles * p.strips;
  long long s = (static_cast<long long>(kWaves) * (sms > 0 ? sms : 132) + per - 1) / per;
  const long long most = (p.H + kMinRows - 1) / kMinRows;
  s = s < most ? s : most;
  s = s > 1 ? s : 1;
  p.rows = static_cast<int>((p.H + s - 1) / s);
  p.slices = (p.H + p.rows - 1) / p.rows;
}

// Shared memory of conv_ln_kernel: the ring (slots x rw x C bf16), the
// strip row's h (sw x C fp32), its LayerNorm statistics (sw x 2 fp32) and,
// with BWD, each thread's running vector sums (2 x kRingThreads x 4 fp32).
struct LnLayout {
  size_t ring, hs, st, red, total;
};

__host__ __device__ inline LnLayout ln_layout(const Plan& p, bool bwd) {
  LnLayout L;
  L.ring = 0;
  L.hs = align128(static_cast<size_t>(p.slots) * p.rw * p.C * 2);
  L.st = L.hs + align128(static_cast<size_t>(p.sw) * p.C * 4);
  L.red = L.st + align128(static_cast<size_t>(p.sw) * 8);
  L.total = L.red + (bwd ? static_cast<size_t>(2) * kRingThreads * 16 : 0);
  return L;
}

// The prologue's plan: every channel in one tile; as many kJ-column groups
// in a strip as leave every thread at most one (channel pair, group) item
// (or one group where the pairs alone outnumber the threads), fewer where
// the ring does not fit, and 7 ring slots where 8 do not.
inline Plan plan_ln(int B, int H, int W, int C, bool bwd, int sms) {
  Plan p = {};
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.ct = C;
  p.ctiles = 1;
  const int pairs = C / 2;
  int groups = kRingThreads / pairs;
  groups = groups > 1 ? groups : 1;
  const int need = (W + kJ - 1) / kJ;
  groups = groups < need ? groups : need;
  for (; groups >= 1; --groups) {
    p.groups = groups;
    p.sw = groups * kJ < W ? groups * kJ : W;
    p.rw = groups * kJ + 2 * kR;
    for (p.slots = 8; p.slots >= 7; --p.slots) {
      p.smem = ln_layout(p, bwd).total;
      if (p.smem <= kRingBudget) break;
    }
    if (p.smem <= kRingBudget) break;
  }
  p.strips = (W + p.sw - 1) / p.sw;
  plan_slices(p, sms);
  return p;
}

// Copies input row `r` of image b (columns xs0 - 3 .. xs0 + swv + 2 of the
// map, channels c0 .. c0 + ct - 1) into ring slot `slot`, zeros outside the
// map, past those columns and past C. E is the element (bf16 or fp32).
template <typename E>
__device__ __forceinline__ void issue_row(E* ring, const Plan& p, const Block& k, const E* src,
                                          int r, int slot, int tid) {
  constexpr int V = 16 / static_cast<int>(sizeof(E));
  const int cv = p.ct / V;  // 16-byte chunks a ring column holds
  E* dst = ring + static_cast<size_t>(slot) * p.rw * p.ct;
  const bool row_in = r >= 0 && r < p.H;
  const E* row = src + (static_cast<long long>(k.b) * p.H + (row_in ? r : 0)) * p.W * p.C;
  for (int i = tid; i < p.rw * cv; i += kRingThreads) {
    const int col = i / cv, ch = (i - col * cv) * V;
    const int gx = k.xs0 - kR + col;
    const bool valid = row_in && gx >= 0 && gx < p.W && col < k.swv + 2 * kR && k.c0 + ch < p.C;
    cp_async16_zfill(dst + col * p.ct + ch,
                     valid ? static_cast<const void*>(row + static_cast<long long>(gx) * p.C + k.c0 + ch)
                           : static_cast<const void*>(src),
                     valid);
  }
}

// The ring slot of input row r (r >= -3)
__device__ __forceinline__ int slot_of(int r, int slots) { return (r + 8) % slots; }

// Channels c, c + 1 of an fp32 vector (read one by one: a caller's vector
// need not be 8-byte aligned)
__device__ __forceinline__ float2 pair_of(const float* __restrict__ v, int c) {
  return make_float2(__ldg(v + c), __ldg(v + c + 1));
}

// The 49 taps of channels c, c + 1 from the (49, C) fp32 taps (the
// wrapper's own copy, aligned)
__device__ __forceinline__ void load_taps(float2 (&w)[kTaps], const float* __restrict__ taps, int C,
                                          int c) {
#pragma unroll
  for (int t = 0; t < kTaps; ++t) w[t] = __ldg(reinterpret_cast<const float2*>(taps + t * C + c));
}

// ------------------------------------------------------------------ prologue

// One block per (image, strip, row slice) of plan_ln; see the top of this
// file. Writes tok (n, C) bf16; with BWD also xhat (n, C) fp32, rstd (n),
// dpre2 (n, C) bf16, and the block's partial sums of db2 and b2 * sum g
// into columns hidden .. hidden + 2C of its row of `partial` (pitch
// hidden + 4C).
template <bool BWD>
__global__ void __launch_bounds__(kRingThreads, 1)
conv_ln_kernel(const Plan p, const bf16* __restrict__ x, const float* __restrict__ taps,
               const float* __restrict__ dwb, const float* __restrict__ ln_s,
               const float* __restrict__ ln_b, float eps, bf16* __restrict__ tok,
               const bf16* __restrict__ g, const float* __restrict__ gamma,
               const float* __restrict__ b2, float* __restrict__ xhat, float* __restrict__ rstd,
               bf16* __restrict__ dpre2, float* __restrict__ partial, int hidden) {
  extern __shared__ __align__(128) unsigned char smem[];
  const LnLayout L = ln_layout(p, BWD);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  float* hs = reinterpret_cast<float*>(smem + L.hs);
  float2* st = reinterpret_cast<float2*>(smem + L.st);
  float4* red = reinterpret_cast<float4*>(smem + L.red);
  const Block k = block_of(p, blockIdx.x);
  const int tid = threadIdx.x;
  const int C = p.C, P = C / 2;
  const int items = P * p.groups;
  const bool multi = items > kRingThreads;  // then a thread takes more than one item a row

  for (int r = k.y0 - kR; r <= k.y0 + kR; ++r) issue_row(ring, p, k, x, r, slot_of(r, p.slots), tid);
  cp_commit();

  float2 w[kTaps];
  if (!multi && tid < items) load_taps(w, taps, C, 2 * (tid % P));
  // the per-channel pass: tpp threads a channel pair, each its share of a row's tokens
  const int tpp = kRingThreads / P > 1 ? kRingThreads / P : 1;
  if (BWD)
    for (int i = tid; i < 2 * kRingThreads; i += kRingThreads) red[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int y = k.y0; y < k.y1; ++y) {
    if (p.slots == 8) {
      if (y + kR + 1 < k.y1 + kR) issue_row(ring, p, k, x, y + kR + 1, slot_of(y + kR + 1, 8), tid);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    // the conv: item (pair, group) -> h of its kJ columns, into hs
    for (int it = tid; it < items; it += kRingThreads) {
      const int pr = it % P, xl = (it / P) * kJ, c = 2 * pr;
      if (multi) load_taps(w, taps, C, c);
      const float2 bias = pair_of(dwb, c);
      float2 acc[kJ];
#pragma unroll
      for (int i = 0; i < kJ; ++i) acc[i] = bias;
#pragma unroll
      for (int ky = 0; ky < kK; ++ky) {
        const uint32_t* row = reinterpret_cast<const uint32_t*>(
            ring + static_cast<size_t>(slot_of(y + ky - kR, p.slots)) * p.rw * C);
        float2 win[kWin];
#pragma unroll
        for (int m = 0; m < kWin; ++m) win[m] = widen2(row[(xl + m) * P + pr]);
#pragma unroll
        for (int kx = 0; kx < kK; ++kx) {
          const float2 wt = w[ky * kK + kx];
#pragma unroll
          for (int i = 0; i < kJ; ++i) {
            acc[i].x = fmaf(win[i + kx].x, wt.x, acc[i].x);
            acc[i].y = fmaf(win[i + kx].y, wt.y, acc[i].y);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kJ; ++i)
        if (xl + i < k.swv) *reinterpret_cast<float2*>(hs + (xl + i) * C + c) = acc[i];
    }
    __syncthreads();
    if (p.slots != 8) {  // the conv is done with the slot of row y - 3
      if (y + kR + 1 < k.y1 + kR) issue_row(ring, p, k, x, y + kR + 1, slot_of(y + kR + 1, p.slots), tid);
      cp_commit();
    }

    // LayerNorm statistics in fp32, the mean and then the centred second
    // moment: a group of G lanes a token (G a power of two up to 32, as many
    // as the row's tokens leave threads for), each lane summing every G-th
    // channel pair into four running sums (four loads in flight), added in
    // a fixed order, the group's sums met by butterflies
    const long long tok0 = (static_cast<long long>(k.b) * p.H + y) * p.W + k.xs0;
    int G = 32;
    while (G > 1 && k.swv * G > kRingThreads) G >>= 1;
    for (int t0 = 0; t0 < k.swv; t0 += kRingThreads / G) {
      const int t = t0 + tid / G, gl = tid % G;
      const bool ok = t < k.swv;  // not uniform over a warp: the butterflies run on every lane
      const float2* h = reinterpret_cast<const float2*>(hs + (ok ? t : 0) * C);
      const int n2 = ok ? P : 0;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      int c2 = gl;
      for (; c2 + 3 * G < n2; c2 += 4 * G)
#pragma unroll
        for (int u = 0; u < 4; ++u) a[u] += h[c2 + u * G].x + h[c2 + u * G].y;
      for (; c2 < n2; c2 += G) a[0] += h[c2].x + h[c2].y;
      float s = (a[0] + a[1]) + (a[2] + a[3]);
      for (int o = G / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      const float mu = s / C;
      a[0] = a[1] = a[2] = a[3] = 0.f;
      c2 = gl;
      for (; c2 + 3 * G < n2; c2 += 4 * G)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 d = make_float2(h[c2 + u * G].x - mu, h[c2 + u * G].y - mu);
          a[u] += d.x * d.x + d.y * d.y;
        }
      for (; c2 < n2; c2 += G) {
        const float2 d = make_float2(h[c2].x - mu, h[c2].y - mu);
        a[0] += d.x * d.x + d.y * d.y;
      }
      float v = (a[0] + a[1]) + (a[2] + a[3]);
      for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      const float rs = rsqrtf(v / C + eps);
      if (ok && gl == 0) {
        st[t] = make_float2(mu, rs);
        if (BWD) rstd[tok0 + t] = rs;
      }
    }
    __syncthreads();

    // the per-channel pass: tok (and with BWD x-hat, dpre2 and the sums).
    // A thread takes at most kJ tokens of a row (plan_ln: a strip holds at
    // most tpp groups of kJ columns), its cotangent pairs all loaded first.
    for (int it = tid; it < P * tpp; it += kRingThreads) {
      const int pr = it % P, c = 2 * pr, t0 = it / P;
      const float2 ls = pair_of(ln_s, c), lb = pair_of(ln_b, c);
      const float2 gm = BWD ? pair_of(gamma, c) : make_float2(0.f, 0.f);
      uint32_t gw[kJ];
      if (BWD) {
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          const int t = t0 + j * tpp;
          gw[j] = t < k.swv ? *reinterpret_cast<const uint32_t*>(g + (tok0 + t) * C + c) : 0u;
        }
      }
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);  // db2 pair, sum g pair
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int t = t0 + j * tpp;
        if (t >= k.swv) break;
        const long long o = (tok0 + t) * C + c;
        const float2 h = *reinterpret_cast<const float2*>(hs + t * C + c);
        const float2 sr = st[t];
        const float x0 = (h.x - sr.x) * sr.y, x1 = (h.y - sr.x) * sr.y;
        *reinterpret_cast<uint32_t*>(tok + o) = narrow2(x0 * ls.x + lb.x, x1 * ls.y + lb.y);
        if (BWD) {
          *reinterpret_cast<float2*>(xhat + o) = make_float2(x0, x1);
          const float2 gv = widen2(gw[j]);
          const float d0 = gv.x * gm.x, d1 = gv.y * gm.y;
          sum.x += d0;
          sum.y += d1;
          sum.z += gv.x;
          sum.w += gv.y;
          *reinterpret_cast<uint32_t*>(dpre2 + o) = narrow2(d0, d1);
        }
      }
      if (BWD) {
        float4& r = red[it];
        r = make_float4(r.x + sum.x, r.y + sum.y, r.z + sum.z, r.w + sum.w);
      }
    }
  }

  if (BWD) {
    // the block's sums of each channel pair, its tpp threads' in order
    __syncthreads();
    float* prt = partial + static_cast<size_t>(blockIdx.x) * (hidden + 4LL * C) + hidden;
    for (int pr = tid; pr < P; pr += kRingThreads) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q = 0; q < tpp; ++q) {
        const float4 r = red[q * P + pr];
        s = make_float4(s.x + r.x, s.y + r.y, s.z + r.z, s.w + r.w);
      }
      const int c = 2 * pr;
      prt[c] = s.x;
      prt[c + 1] = s.y;
      prt[C + c] = s.z * __ldg(b2 + c);
      prt[C + c + 1] = s.w * __ldg(b2 + c + 1);
    }
  }
}

// ------------------------------------------------------------------ host

// Launches conv_ln_kernel<BWD> on plan p (plan_ln's); the pointers past
// `tok` are BWD's. Static: its launch state is its library's own.
template <bool BWD>
static cudaError_t launch_conv_ln(const Plan& p, const bf16* x, const float* taps, const float* dwb,
                           const float* ln_s, const float* ln_b, float eps, bf16* tok,
                           const bf16* g, const float* gamma, const float* b2, float* xhat,
                           float* rstd, bf16* dpre2, float* partial, int hidden, cudaStream_t st) {
  static imt_mma::LaunchCache cache;
  auto kern = conv_ln_kernel<BWD>;
  cudaError_t e = cache.prepare(reinterpret_cast<const void*>(kern), kRingBudget, kRingThreads,
                                p.smem);
  if (e != cudaSuccess) return e;
  if (p.blocks() > 0x7fffffffLL || p.smem > kRingBudget) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(p.blocks()), kRingThreads, p.smem, st>>>(
      p, x, taps, dwb, ln_s, ln_b, eps, tok, g, gamma, b2, xhat, rstd, dpre2, partial, hidden);
  return cudaGetLastError();
}

}  // namespace ring
}  // namespace imt
