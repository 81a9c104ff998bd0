// Kernel 2's GEMM stages (ln_mlp_bwd.cu), shared with the bf16 instance of
// the fused ConvNeXt branch's backward, kernel 11 (convnext_branch_bwd.cu):
// the persistent wgmma + TMA GEMM kernel in its three kinds, (ii) kHidden
// (pre1 and dhmid; hmid, dpre1 and db1's partials), (iii) kDln (dln and the
// LN backward) and (iv) kWgrad (dW1 and G = g^T hmid); the LN backward's
// row pass where C spans more than one channel tile; dW2 = gamma * G and
// dgamma's sum_j W2 * G; the workspace; and the host code that runs stages
// (ii)-(iv) on it. The kernels differ only in their prologue (stage (i):
// kernel 2's LayerNorm rows, kernel 11's depthwise conv and LayerNorm), in
// the GELU of kHidden (a GeluMode of ln_mlp_common.cuh) and, for kernel 11,
// in x-hat, which comes in fp32 (h is the conv's fp32 output, never
// rounded), and in the LN backward's result, dh in fp32 for the conv's
// backward. See ln_mlp_bwd.cu for the design and what bounds it.
#pragma once

#include <algorithm>

#include "hopper_gemm.cuh"
#include "ln_mlp_common.cuh"
#include "wgrad_common.cuh"

namespace imt {
namespace lnmlp_bwd {

// ------------------------------------------------------------ tiled GEMMs

// shared memory: the ring; kHidden's staged output tiles (hmid and dpre1,
// each two 128-byte-swizzled 128 x 64 boxes, as the TMA stores read them);
// the column sums' `red` (2 x 8 x kBN floats); the ring's mbarriers; 1 KB
// to align
constexpr int kStagedBytes = 2 * kBM * kBN * 2;
constexpr int kRedBytes = 2 * 8 * kBN * 4;

enum Kind { kHidden = 0, kDln = 1, kWgrad = 2 };

__host__ __device__ constexpr int red_at(int kind) {
  return kRing + (kind == kHidden ? kStagedBytes : 0);
}
constexpr size_t gemm_smem(int kind) { return 1024 + red_at(kind) + kRedBytes + 2 * kStages * 8; }

struct GemmArgs {
  long long n;  // tokens
  int C, hidden;
  // kHidden (hmid and dpre1 leave by the store maps)
  const float* b1;
  // kHidden, kDln: (mtiles, hidden + 4C) vector partial rows
  float* partial;
  // kDln
  const bf16* h;
  const float* mu;
  const float* rstd;
  const float* ln_s;
  float* dxhat;
  float* rowpart;  // (ctiles, n, 2)
  bf16* dx;        // written here when one channel tile spans C
  // kWgrad: out (slices, M, P), M x P tiles, token slices of `per` (a
  // multiple of kBK)
  float* out;
  int M, P;
  long long per;
  // the tiles: gx along x, ntiles in all
  int gx, ntiles;
  // kDln with XHAT (the fused branch): x-hat (n, C) fp32 in; dh out where
  // one channel tile spans C
  float* xhat;
};

// A warp's column sums of its 16 rows at columns c and c + 1 (c = 8j +
// 2(lane % 4)), from each thread's sums over its two rows: butterflies over
// the 8 row lanes, then lanes 0-3 put them in the warp's row of `red` (8 x
// kBN floats, row cw). sum8 then adds the CTA's 8 warps in order: a fixed
// order throughout.
__device__ __forceinline__ void col_pair(float v0, float v1, float* red, int cw, int c, int lane) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    v0 += __shfl_xor_sync(0xffffffffu, v0, o);
    v1 += __shfl_xor_sync(0xffffffffu, v1, o);
  }
  if (lane < 4) *reinterpret_cast<float2*>(red + cw * kBN + c) = make_float2(v0, v1);
}

__device__ __forceinline__ float sum8(const float* red, int col) {
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < 8; ++w) s += red[w * kBN + col];
  return s;
}

// A CTA's tile: its first output row and column, the tile's x and y (for
// the partial rows), and its k-blocks (kb0 the first, nk of them).
struct Tile {
  int x, y, row0, col0, kb0, nk;
};

// Tiles are numbered x fastest, `gx` of them along x. kHidden: x the hidden
// tile, y the token tile; kDln: x the channel tile, y the token tile;
// kWgrad: x the M x P output tile (P fastest), y the token slice.
template <int KIND>
__device__ __forceinline__ Tile tile_of(const GemmArgs& args, int tile) {
  Tile t;
  t.x = tile % args.gx;
  t.y = tile / args.gx;
  if constexpr (KIND == kWgrad) {
    const int tiles_p = (args.P + kBN - 1) / kBN;
    t.row0 = (t.x / tiles_p) * kBM;
    t.col0 = (t.x % tiles_p) * kBN;
    const long long t0 = static_cast<long long>(t.y) * args.per;
    const long long t1 = t0 + args.per < args.n ? t0 + args.per : args.n;
    t.kb0 = static_cast<int>(t0 / kBK);
    t.nk = static_cast<int>((t1 - t0 + kBK - 1) / kBK);
  } else {
    t.col0 = t.x * kBN;
    t.row0 = t.y * kBM;
    t.kb0 = 0;
    t.nk = KIND == kHidden ? 2 * ((args.C + kBK - 1) / kBK) : args.hidden / kBK;
  }
  return t;
}

// Persistent: each CTA walks over tiles blockIdx.x, + gridDim.x, ...; the
// producer runs ahead into the next tile's k-blocks while the consumers
// finish a tile's epilogue (kHidden stages its bf16 tiles outside the
// ring). The maps: kHidden tok and W1 (K-major, boxes 64 x 128), dpre2
// (K-major) and W2 (MN-major, boxes 64 x 64); kDln dpre1 (K-major) and W1
// (MN-major); kWgrad A and B (both MN-major, token rows). GM: the GELU
// mode of kHidden. XHAT (kDln of the fused branch, kernel 11): x-hat comes
// in fp32 from args.xhat, not from h and its statistics, and where one tile
// spans C the LN backward ends in dh (fp32, over x-hat), not a bf16 dx.
template <int KIND, int GM, bool XHAT>
__global__ void __launch_bounds__(kGemmThreads, 1)
ln_mlp_bwd_gemm_kernel(const __grid_constant__ CUtensorMap ma0,
                       const __grid_constant__ CUtensorMap mb0,
                       const __grid_constant__ CUtensorMap ma1,
                       const __grid_constant__ CUtensorMap mb1,
                       const __grid_constant__ CUtensorMap ms0,
                       const __grid_constant__ CUtensorMap ms1, const GemmArgs args) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  float* red = reinterpret_cast<float*>(sbase + red_at(KIND));  // [2][8][kBN]
  const uint32_t full0 = base + red_at(KIND) + kRedBytes, empty0 = full0 + kStages * 8;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int kc = (args.C + kBK - 1) / kBK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the ring full, across tiles
    if (tid == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < args.ntiles; tile += gridDim.x) {
        const Tile T = tile_of<KIND>(args, tile);
        for (int kb = 0; kb < T.nk; ++kb, ++it) {
          const int s = it % kStages;
          mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
          const uint32_t fb = full0 + 8 * s;
          mbar_expect_tx(fb, kStageBytes);
          const uint32_t sa = base + s * kStageBytes, sb = sa + kOpBytes;
          if constexpr (KIND == kHidden) {
            if (kb < kc) {
              tma_load(sa, &ma0, fb, kb * kBK, T.row0);  // tok rows
              tma_load(sb, &mb0, fb, kb * kBK, T.col0);  // W1 rows
            } else {
              const int k = (kb - kc) * kBK;
              tma_load(sa, &ma1, fb, k, T.row0);                  // dpre2 rows
              tma_load(sb, &mb1, fb, T.col0, k);                  // W2 rows k.., hidden col0..
              tma_load(sb + kHalfBox, &mb1, fb, T.col0 + 64, k);  // .. and col0 + 64..
            }
          } else if constexpr (KIND == kDln) {
            tma_load(sa, &ma0, fb, kb * kBK, T.row0);  // dpre1 rows
            tma_load(sb, &mb0, fb, T.col0, kb * kBK);  // W1 rows kb.., channels col0..
            tma_load(sb + kHalfBox, &mb0, fb, T.col0 + 64, kb * kBK);
          } else {
            const int t = (T.kb0 + kb) * kBK;
            tma_load(sa, &ma0, fb, T.row0, t);
            tma_load(sa + kHalfBox, &ma0, fb, T.row0 + 64, t);
            tma_load(sb, &mb0, fb, T.col0, t);
            tma_load(sb + kHalfBox, &mb0, fb, T.col0 + 64, t);
          }
        }
      }
    }
    return;
  }

  const int lane = tid & 31;
  const int w = (tid / 32) & 3;
  const int cw = wg * 4 + w;                     // the warp's place among the CTA's 8
  const int r_in = wg * 64 + 16 * w + lane / 4;  // its first row in the tile; the second is +8
  const int q = 2 * (lane % 4);                  // its first column in each 8-column group
  int it = 0;
  for (int tile = blockIdx.x; tile < args.ntiles; tile += gridDim.x) {
    const Tile T = tile_of<KIND>(args, tile);
    const int row0 = T.row0, col0 = T.col0;
    float acc[64], acc2[64];  // acc2: dhmid of kHidden, unused by the others
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = acc2[i] = 0.f;

    for (int kb = 0; kb < T.nk; ++kb, ++it) {
      const int s = it % kStages;
      mbar_wait(full0 + 8 * s, (it / kStages) & 1);
      const uint32_t sa = base + s * kStageBytes, sb = sa + kOpBytes;
      // a warpgroup's 64 rows: K-major A rows 64 * 128 bytes on; MN-major A
      // its own 64 x 64 box
      const uint32_t a = sa + wg * (KIND == kWgrad ? kHalfBox : 64 * 128);
      wg_fence();
      if constexpr (KIND == kHidden) {
        if (kb < kc)
          mma_stage<0, 0>(acc, a, sb);
        else
          mma_stage<0, 1>(acc2, a, sb);
      } else if constexpr (KIND == kDln) {
        mma_stage<0, 1>(acc, a, sb);
      } else {
        mma_stage<1, 1>(acc, a, sb);
      }
      wg_commit();
      wg_wait<1>();
      if (kb > 0) mbar_arrive(empty0 + 8 * ((it - 1) % kStages));
    }
    wg_wait<0>();
    fence_acc(acc);
    if constexpr (KIND == kHidden) fence_acc(acc2);
    mbar_arrive(empty0 + 8 * ((it - 1) % kStages));

    if constexpr (KIND == kHidden) {
      // hmid = GELU(pre1 + b1), dpre1 = dhmid * gelu'(pre1 + b1), bf16
      // through shared memory and out by TMA stores, which run on while the
      // next tile multiplies (rows past n and columns past hidden are
      // clipped by the stores); and the tile's db1 column sums of the fp32
      // dpre1. Rows past n have zero dpre2 (TMA's fill), so they add nothing
      // to db1. The barrier: the last tile's stores have read the staged
      // tiles (thread 0 waited for them), and its sums have read `red`.
      if (tid == 0) bulk_wait_read<0>();
      consumers_sync();
      unsigned char* staged = sbase + kRing;  // [hmid, dpre1][box 0, 1][128 rows][128 bytes]
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 8 * j + q;
        const int hj = col0 + col;  // hidden % 64 == 0: hj and hj + 1 are both in or both out
        const float bb0 = hj < args.hidden ? args.b1[hj] : 0.f;
        const float bb1 = hj < args.hidden ? args.b1[hj + 1] : 0.f;
        float v0 = 0.f, v1 = 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float p0 = acc[4 * j + 2 * i] + bb0, p1 = acc[4 * j + 2 * i + 1] + bb1;
          if constexpr (GM == kGeluAS) {  // the GELU and its derivative share one erf
            const float2 a0 = gelu_as_and_grad(p0), a1 = gelu_as_and_grad(p1);
            const float d0 = acc2[4 * j + 2 * i] * a0.y;
            const float d1 = acc2[4 * j + 2 * i + 1] * a1.y;
            v0 += d0;
            v1 += d1;
            const int off = staged_offset(r_in + 8 * i, col);
            *reinterpret_cast<__nv_bfloat162*>(staged + off) = __floats2bfloat162_rn(a0.x, a1.x);
            *reinterpret_cast<__nv_bfloat162*>(staged + kBM * kBN * 2 + off) =
                __floats2bfloat162_rn(d0, d1);
          } else {
            const float d0 = acc2[4 * j + 2 * i] * gelu_grad<GM>(p0);
            const float d1 = acc2[4 * j + 2 * i + 1] * gelu_grad<GM>(p1);
            v0 += d0;
            v1 += d1;
            const int off = staged_offset(r_in + 8 * i, col);
            *reinterpret_cast<__nv_bfloat162*>(staged + off) =
                __floats2bfloat162_rn(gelu<GM>(p0), gelu<GM>(p1));
            *reinterpret_cast<__nv_bfloat162*>(staged + kBM * kBN * 2 + off) =
                __floats2bfloat162_rn(d0, d1);
          }
        }
        col_pair(v0, v1, red, cw, col, lane);
      }
      fence_async_smem();  // the staged tiles, visible to the TMA stores
      consumers_sync();
      if (tid == 0) {
        const uint32_t st0 = smem_u32(staged);
        for (int b = 0; b < 2; ++b) {
          tma_store(&ms0, st0 + b * kBM * 128, col0 + 64 * b, row0);
          tma_store(&ms1, st0 + kBM * kBN * 2 + b * kBM * 128, col0 + 64 * b, row0);
        }
        bulk_commit();
      }
      if (tid < kBN && col0 + tid < args.hidden) {
        const long long pw = args.hidden + 4LL * args.C;
        args.partial[T.y * pw + col0 + tid] = sum8(red, tid);
      }
    } else if constexpr (KIND == kDln && !XHAT) {
      // dxhat = dln * ln_s and xhat = (h - mu) * rstd per element; row sums
      // of dxhat and dxhat * xhat over the tile's channels (the 4 lanes of a
      // row), column sums of dln * xhat and dln (dln_s, dln_b). Where one
      // tile spans C (C <= kBN) the row sums are whole and dx is finished
      // here; else dxhat and the row sums go out to ln_mlp_bwd_rows_kernel.
      const int C = args.C;
      const bool whole = C <= kBN;
      float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f}, mu[2], rs[2];
      long long t[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        t[i] = row0 + r_in + 8 * i;
        mu[i] = t[i] < args.n ? args.mu[t[i]] : 0.f;
        rs[i] = t[i] < args.n ? args.rstd[t[i]] : 0.f;
      }
      // the thread's h pairs, all loads in flight at once (zeros outside)
      __nv_bfloat162 hp[2][16];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = col0 + 8 * j + q;  // C % 16 == 0: c and c + 1 are both in or both out
          hp[i][j] = t[i] < args.n && c < C
                         ? *reinterpret_cast<const __nv_bfloat162*>(
                               args.h + static_cast<size_t>(t[i]) * C + c)
                         : __floats2bfloat162_rn(0.f, 0.f);
        }
      consumers_sync();  // the last tile's sums have read `red`
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = col0 + 8 * j + q;
        float vs0 = 0.f, vs1 = 0.f, vb0 = 0.f, vb1 = 0.f;
        if (c < C) {
          const float ls0 = args.ln_s[c], ls1 = args.ln_s[c + 1];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (t[i] >= args.n) continue;
            const float2 hv = __bfloat1622float2(hp[i][j]);
            const float x0 = (hv.x - mu[i]) * rs[i], x1 = (hv.y - mu[i]) * rs[i];
            const float d0 = acc[4 * j + 2 * i], d1 = acc[4 * j + 2 * i + 1];
            const float e0 = d0 * ls0, e1 = d1 * ls1;
            s1[i] += e0 + e1;
            s2[i] += e0 * x0 + e1 * x1;
            vs0 += d0 * x0;
            vs1 += d1 * x1;
            vb0 += d0;
            vb1 += d1;
            if (!whole)
              *reinterpret_cast<float2*>(args.dxhat + static_cast<size_t>(t[i]) * C + c) =
                  make_float2(e0, e1);
          }
        }
        col_pair(vs0, vs1, red, cw, 8 * j + q, lane);
        col_pair(vb0, vb1, red + 8 * kBN, cw, 8 * j + q, lane);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], 1);
        s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], 2);
        s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], 1);
        s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], 2);
        if (!whole && lane % 4 == 0 && t[i] < args.n)
          *reinterpret_cast<float2*>(args.rowpart + (T.x * args.n + t[i]) * 2) =
              make_float2(s1[i], s2[i]);
      }
      if (whole) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = 8 * j + q;
          if (c >= C) continue;
          const float ls0 = args.ln_s[c], ls1 = args.ln_s[c + 1];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (t[i] >= args.n) continue;
            const size_t o = static_cast<size_t>(t[i]) * C + c;
            const float2 hv = __bfloat1622float2(hp[i][j]);
            const float m1 = s1[i] / C, m2 = s2[i] / C;
            const float x0 = (hv.x - mu[i]) * rs[i], x1 = (hv.y - mu[i]) * rs[i];
            *reinterpret_cast<__nv_bfloat162*>(args.dx + o) = __floats2bfloat162_rn(
                rs[i] * (acc[4 * j + 2 * i] * ls0 - m1 - x0 * m2),
                rs[i] * (acc[4 * j + 2 * i + 1] * ls1 - m1 - x1 * m2));
          }
        }
      }
      consumers_sync();
      if (tid < kBN && col0 + tid < C) {
        float* prt = args.partial + T.y * (args.hidden + 4LL * C) + args.hidden;
        prt[2 * C + col0 + tid] = sum8(red, tid);
        prt[3 * C + col0 + tid] = sum8(red + 8 * kBN, tid);
      }
    } else if constexpr (KIND == kDln) {
      // XHAT (the fused branch): the same LN backward on x-hat read in fp32
      // (h is the conv's fp32 output, never rounded), ending in dh in fp32
      // over x-hat where one tile spans C (C <= kBN); else dxhat and the row
      // sums go out to dh_rows_kernel.
      const int C = args.C;
      const bool whole = C <= kBN;
      float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f}, rs[2];
      long long t[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        t[i] = row0 + r_in + 8 * i;
        rs[i] = t[i] < args.n ? args.rstd[t[i]] : 0.f;
      }
      // the thread's x-hat pairs, all loads in flight at once (zeros outside)
      float2 xp[2][16];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = col0 + 8 * j + q;  // C % 16 == 0: c and c + 1 are both in or both out
          xp[i][j] = t[i] < args.n && c < C ? *reinterpret_cast<const float2*>(
                                                  args.xhat + static_cast<size_t>(t[i]) * C + c)
                                            : make_float2(0.f, 0.f);
        }
      consumers_sync();  // the last tile's sums have read `red`
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = col0 + 8 * j + q;
        float vs0 = 0.f, vs1 = 0.f, vb0 = 0.f, vb1 = 0.f;
        if (c < C) {
          const float ls0 = args.ln_s[c], ls1 = args.ln_s[c + 1];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (t[i] >= args.n) continue;
            const float x0 = xp[i][j].x, x1 = xp[i][j].y;
            const float d0 = acc[4 * j + 2 * i], d1 = acc[4 * j + 2 * i + 1];
            const float e0 = d0 * ls0, e1 = d1 * ls1;
            s1[i] += e0 + e1;
            s2[i] += e0 * x0 + e1 * x1;
            vs0 += d0 * x0;
            vs1 += d1 * x1;
            vb0 += d0;
            vb1 += d1;
            if (!whole)
              *reinterpret_cast<float2*>(args.dxhat + static_cast<size_t>(t[i]) * C + c) =
                  make_float2(e0, e1);
          }
        }
        col_pair(vs0, vs1, red, cw, 8 * j + q, lane);
        col_pair(vb0, vb1, red + 8 * kBN, cw, 8 * j + q, lane);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], 1);
        s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], 2);
        s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], 1);
        s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], 2);
        if (!whole && lane % 4 == 0 && t[i] < args.n)
          *reinterpret_cast<float2*>(args.rowpart + (T.x * args.n + t[i]) * 2) =
              make_float2(s1[i], s2[i]);
      }
      if (whole) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = 8 * j + q;
          if (c >= C) continue;
          const float ls0 = args.ln_s[c], ls1 = args.ln_s[c + 1];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (t[i] >= args.n) continue;
            const float m1 = s1[i] / C, m2 = s2[i] / C;
            *reinterpret_cast<float2*>(args.xhat + static_cast<size_t>(t[i]) * C + c) =
                make_float2(rs[i] * (acc[4 * j + 2 * i] * ls0 - m1 - xp[i][j].x * m2),
                            rs[i] * (acc[4 * j + 2 * i + 1] * ls1 - m1 - xp[i][j].y * m2));
          }
        }
      }
      consumers_sync();
      if (tid < kBN && col0 + tid < C) {
        float* prt = args.partial + T.y * (args.hidden + 4LL * C) + args.hidden;
        prt[2 * C + col0 + tid] = sum8(red, tid);
        prt[3 * C + col0 + tid] = sum8(red + 8 * kBN, tid);
      }
    } else {
      // this slice's partial of the (M, P) product, fp32, masked
      float* dst = args.out + static_cast<size_t>(T.y) * args.M * args.P;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = row0 + r_in + 8 * i;
        if (m >= args.M) continue;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int p = col0 + 8 * j + q;
          if (p < args.P)
            *reinterpret_cast<float2*>(dst + static_cast<size_t>(m) * args.P + p) =
                make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        }
      }
    }
  }
  // the last tile's stores read shared memory until they are done
  if constexpr (KIND == kHidden)
    if (tid == 0) bulk_wait<0>();
}

// -------------------------------------------------- (iii) LN backward rows

// The LN backward's last step where C spans more than one channel tile:
// per token, m1, m2 from the channel tiles' row sums (in tile order), then
// dx = rstd * (dxhat - m1 - xhat * m2) in bf16; rows laid out as the
// prologue's, 8 (32 / L) R rows per block.
template <int L, int S, int R>
__global__ void __launch_bounds__(kThreads)
ln_mlp_bwd_rows_kernel(const bf16* __restrict__ h, const float* __restrict__ dxhat,
                       const float* __restrict__ mu_in, const float* __restrict__ rstd_in,
                       const float* __restrict__ rowpart, bf16* __restrict__ dx, long long n,
                       int C) {
  constexpr int G = 32 / L;
  const int lane = threadIdx.x & 31;
  const int sl = lane % L;
  const long long r0 =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * G * R + lane / L;
  const int segs = C / 8, ctiles = (C + kBN - 1) / kBN;
  uint4 hraw[R][S];
  float4 d[R][S][2];
#pragma unroll
  for (int u = 0; u < R; ++u)
#pragma unroll
    for (int q = 0; q < S; ++q)
      if (r0 + u * G < n && sl + L * q < segs) {
        const long long r = r0 + u * G;
        const int sg = sl + L * q;
        hraw[u][q] = reinterpret_cast<const uint4*>(h + r * C)[sg];
        d[u][q][0] = reinterpret_cast<const float4*>(dxhat + r * C)[2 * sg];
        d[u][q][1] = reinterpret_cast<const float4*>(dxhat + r * C)[2 * sg + 1];
      }
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const long long r = r0 + u * G;
    if (r >= n) continue;
    float a = 0.f, b = 0.f;
    for (int k = 0; k < ctiles; ++k) {
      const float2 p = *reinterpret_cast<const float2*>(rowpart + (k * n + r) * 2);
      a += p.x;
      b += p.y;
    }
    const float m1 = a / C, m2 = b / C;
    const float mu = mu_in[r], rs = rstd_in[r];
    uint4* dst = reinterpret_cast<uint4*>(dx + r * C);
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const int sg = sl + L * q;
      if (sg < segs) {
        float f[8];
        unpack8(hraw[u][q], f);
        const float dd[8] = {d[u][q][0].x, d[u][q][0].y, d[u][q][0].z, d[u][q][0].w,
                             d[u][q][1].x, d[u][q][1].y, d[u][q][1].z, d[u][q][1].w};
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = rs * (dd[e] - m1 - (f[e] - mu) * rs * m2);
        dst[sg] = pack8(f);
      }
    }
  }
}

// The same last step for the fused branch (kernel 11): dh = rstd * (dxhat -
// m1 - xhat * m2) in fp32 from x-hat (fp32), written over x-hat, where C
// spans more than one channel tile; one warp a row.
__global__ void __launch_bounds__(kThreads)
dh_rows_kernel(const float* __restrict__ dxhat, const float* __restrict__ rstd_in,
               const float* __restrict__ rowpart, float* xhat, long long n, int C) {
  const long long r = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r >= n) return;
  const int lane = threadIdx.x & 31, ctiles = (C + kBN - 1) / kBN;
  float a = 0.f, b = 0.f;
  for (int k = 0; k < ctiles; ++k) {
    const float2 p = *reinterpret_cast<const float2*>(rowpart + (k * n + r) * 2);
    a += p.x;
    b += p.y;
  }
  const float m1 = a / C, m2 = b / C, rs = rstd_in[r];
  float4* x4 = reinterpret_cast<float4*>(xhat + r * C);
  const float4* d4 = reinterpret_cast<const float4*>(dxhat + r * C);
  for (int u = lane; u < C / 4; u += 32) {
    const float4 x = x4[u], d = d4[u];
    x4[u] = make_float4(rs * (d.x - m1 - x.x * m2), rs * (d.y - m1 - x.y * m2),
                        rs * (d.z - m1 - x.z * m2), rs * (d.w - m1 - x.w * m2));
  }
}

// Row c of G = g^T hmid (C, hidden): dgamma[c] += sum_j W2[c][j] * G[c][j],
// then G[c][j] *= gamma[c], which makes it dW2. One block per row; the row's
// sum meets in a fixed order (warp butterflies, then the warps in turn).
__global__ void __launch_bounds__(kThreads)
dw2_finish_kernel(const bf16* __restrict__ w2, const float* __restrict__ gamma,
                  float* __restrict__ dw2, float* __restrict__ dgamma, int hidden) {
  __shared__ float red[kWarps];
  const int c = blockIdx.x;
  const float gm = gamma[c];
  float* row = dw2 + static_cast<size_t>(c) * hidden;
  const bf16* wrow = w2 + static_cast<size_t>(c) * hidden;
  float s = 0.f;
  for (int j = threadIdx.x; j < hidden; j += kThreads) {
    const float gv = row[j];
    s += __bfloat162float(wrow[j]) * gv;
    row[j] = gm * gv;
  }
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += red[w];
    dgamma[c] += t;
  }
}

// ------------------------------------------------------------------ host

// The workspace, in this order: tok, dpre2 (n, C) bf16; mu, rstd (n) fp32;
// hmid, dpre1 (n, hidden) bf16; dxhat (n, C) fp32; rowpart (ctiles, n, 2)
// fp32; the vector partial rows (prows, hidden + 4C) and their column-sum
// scratch; the token-slice partials of dW1 and of G; for the fused branch,
// x-hat (n, C) fp32, which becomes dh.
constexpr int kParts = 13;

struct Work {
  long long mtiles, ctiles, row, prows;
  Slices s1, s2;
  size_t off[kParts + 1];
};

// The workspace's parts as pointers.
struct Buffers {
  bf16 *tok, *dpre2, *hmid, *dpre1;
  float *mu, *rstd, *dxhat, *rowpart, *partial, *scratch, *part1, *part2, *xhat;
};

// output tiles of an (M, P) weight product
long long wgrad_tiles(int M, int P) {
  return static_cast<long long>((M + kBM - 1) / kBM) * ((P + kBN - 1) / kBN);
}

// Token slices of a weight-grad product of `tiles` output tiles, each slice
// a whole number of kBK-token stages, at least kMinSlice tokens and at most
// kChunk slices (wgrad_common.cuh). The (tile, slice) units run on `sms`
// persistent CTAs in rounds: the fewest slices that fill the rounds to 90%
// (a tile's work spread evenly over the card), as few as will do, since
// every slice adds a partial product to sum.
Slices token_slices(long long n, long long tiles, int sms) {
  const long long most = std::min<long long>(kChunk, (n + kMinSlice - 1) / kMinSlice);
  long long s = 1;
  if (sms > 0) {
    s = std::max<long long>(1, std::min<long long>(most, (sms + tiles - 1) / tiles));
    for (long long c = s; c <= most; ++c) {
      const long long units = tiles * c, rounds = (units + sms - 1) / sms;
      if (10 * units >= 9 * rounds * sms) {
        s = c;
        break;
      }
    }
  }
  const long long per = ((n + s - 1) / s + kBK - 1) / kBK * kBK;
  return {(n + per - 1) / per, per};
}

// Kernel 2's plan; the fused branch asks for `prows` vector partial rows
// (its prologue's blocks, where they outnumber the token tiles) and x-hat.
Work plan(long long n, int C, int hidden, long long prows = 0, bool xhat = false) {
  Work w;
  w.mtiles = (n + kBM - 1) / kBM;
  w.ctiles = (C + kBN - 1) / kBN;
  w.row = hidden + 4LL * C;
  w.prows = std::max(w.mtiles, prows);
  const int sms = sm_count();
  w.s1 = token_slices(n, wgrad_tiles(hidden, C), sms);
  w.s2 = token_slices(n, wgrad_tiles(C, hidden), sms);
  const long long parts = w.prows > kChunk ? (w.prows + kChunk - 1) / kChunk : 0;
  const size_t wsize = static_cast<size_t>(hidden) * C * 4;
  const size_t sizes[kParts] = {
      static_cast<size_t>(n) * C * 2, static_cast<size_t>(n) * C * 2,
      static_cast<size_t>(n) * 4, static_cast<size_t>(n) * 4,
      static_cast<size_t>(n) * hidden * 2, static_cast<size_t>(n) * hidden * 2,
      static_cast<size_t>(n) * C * 4, static_cast<size_t>(w.ctiles * n) * 8,
      static_cast<size_t>(w.prows * w.row) * 4, static_cast<size_t>(parts * w.row) * 4,
      w.s1.count > 1 ? w.s1.count * wsize : 0, w.s2.count > 1 ? w.s2.count * wsize : 0,
      xhat ? static_cast<size_t>(n) * C * 4 : 0};
  w.off[0] = 0;
  for (int i = 0; i < kParts; ++i) w.off[i + 1] = w.off[i] + ((sizes[i] + 1023) & ~size_t(1023));
  return w;
}

inline Buffers buffers(const Work& w, char* ws) {
  const auto f = [&](int i) { return reinterpret_cast<float*>(ws + w.off[i]); };
  const auto b = [&](int i) { return reinterpret_cast<bf16*>(ws + w.off[i]); };
  return {b(0), b(1), b(4), b(5), f(2), f(3), f(6), f(7), f(8), f(9), f(10), f(11), f(12)};
}

// gx x gy tiles on min(tiles, SMs) persistent CTAs; s0, s1 the store maps
// (kHidden's hmid and dpre1), the others' unused.
template <int KIND, int GM, bool XHAT = false>
cudaError_t launch_gemm(long long gx, long long gy, const CUtensorMap& a0, const CUtensorMap& b0,
                        const CUtensorMap& a1, const CUtensorMap& b1, const CUtensorMap& s0,
                        const CUtensorMap& s1, GemmArgs args, cudaStream_t st) {
  if (gx * gy > 0x7fffffffLL) return cudaErrorInvalidValue;
  args.gx = static_cast<int>(gx);
  args.ntiles = static_cast<int>(gx * gy);
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidValue;
  auto kern = ln_mlp_bwd_gemm_kernel<KIND, GM, XHAT>;
  constexpr size_t smem = gemm_smem(KIND);
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int grid = args.ntiles < sms ? args.ntiles : sms;
  kern<<<grid, kGemmThreads, smem, st>>>(a0, b0, a1, b1, s0, s1, args);
  return cudaGetLastError();
}

template <int L, int S, int R>
struct Rows {
  static constexpr auto kernel = ln_mlp_bwd_rows_kernel<L, S, R>;
};

// What stages (ii)-(iv) read and write besides the workspace. h, kernel
// 2's tokens, is read by (iii) unless XHAT; dx (kernel 2's bf16 output) is
// written by (iii) unless XHAT (the fused branch's dh stays in the
// workspace's x-hat).
struct StageInputs {
  const bf16 *h, *g, *w1, *w2;
  const float *ln_s, *b1, *gamma;
  bf16* dx;
  float *dw1, *dw2, *vecs;
  long long n;
  int C, hidden;
};

// Stages (ii) hidden products, (iii) dln and the LN backward, (iv) weight
// products and the sums of [first, last) (numbered 1-3), on the workspace
// that the prologue (stage 0) filled; kHidden with the GELU of mode GM.
// The vector partial rows are summed over w.prows rows.
template <int GM, bool XHAT>
cudaError_t run_gemm_stages(const StageInputs& in, const Work& w, const Buffers& buf, int first,
                            int last, cudaStream_t st) {
  const long long n = in.n;
  const int C = in.C, H = in.hidden;
  GemmArgs args = {};
  args.n = n;
  args.C = C;
  args.hidden = H;
  args.partial = buf.partial;
  cudaError_t e = cudaSuccess;
  CUtensorMap a0, b0, a1, b1, s0, s1;

  if (first <= 1 && last > 1) {  // (ii)
    if (!tensor_map(&a0, buf.tok, C, n, 64, kBM) || !tensor_map(&b0, in.w1, C, H, 64, kBN) ||
        !tensor_map(&a1, buf.dpre2, C, n, 64, kBM) || !tensor_map(&b1, in.w2, H, C, 64, 64) ||
        !tensor_map(&s0, buf.hmid, H, n, 64, kBM) || !tensor_map(&s1, buf.dpre1, H, n, 64, kBM))
      return cudaErrorInvalidValue;
    args.b1 = in.b1;
    e = launch_gemm<kHidden, GM>((H + kBN - 1) / kBN, w.mtiles, a0, b0, a1, b1, s0, s1, args, st);
    if (e != cudaSuccess) return e;
  }
  if (first <= 2 && last > 2) {  // (iii)
    if (!tensor_map(&a0, buf.dpre1, H, n, 64, kBM) || !tensor_map(&b0, in.w1, C, H, 64, 64))
      return cudaErrorInvalidValue;
    args.h = in.h;
    args.mu = buf.mu;
    args.rstd = buf.rstd;
    args.ln_s = in.ln_s;
    args.dxhat = buf.dxhat;
    args.rowpart = buf.rowpart;
    args.dx = in.dx;
    args.xhat = buf.xhat;
    e = launch_gemm<kDln, kGeluErf, XHAT>(w.ctiles, w.mtiles, a0, b0, a0, b0, a0, a0, args, st);
    if (e != cudaSuccess) return e;
    if (C > kBN) {
      if constexpr (XHAT) {
        const long long rb = (n + kWarps - 1) / kWarps;
        if (rb > 0x7fffffffLL) return cudaErrorInvalidValue;
        dh_rows_kernel<<<static_cast<unsigned>(rb), kThreads, 0, st>>>(buf.dxhat, buf.rstd,
                                                                        buf.rowpart, buf.xhat, n, C);
        if ((e = cudaGetLastError()) != cudaSuccess) return e;
      } else {
        const long long rb = (n + row_step(C) - 1) / row_step(C);
        if (rb > 0x7fffffffLL) return cudaErrorInvalidValue;
        if ((e = launch_rows<Rows>(C, static_cast<unsigned>(rb), 0, st, in.h, buf.dxhat, buf.mu,
                                   buf.rstd, buf.rowpart, in.dx, n, C)) != cudaSuccess)
          return e;
      }
    }
  }
  if (first <= 3 && last > 3) {  // (iv)
    // dW1 (hidden, C) = dpre1^T tok; G (C, hidden) = g^T hmid
    if (!tensor_map(&a0, buf.dpre1, H, n, 64, 64) || !tensor_map(&b0, buf.tok, C, n, 64, 64) ||
        !tensor_map(&a1, in.g, C, n, 64, 64) || !tensor_map(&b1, buf.hmid, H, n, 64, 64))
      return cudaErrorInvalidValue;
    args.M = H;
    args.P = C;
    args.per = w.s1.per;
    args.out = w.s1.count > 1 ? buf.part1 : in.dw1;
    e = launch_gemm<kWgrad, kGeluErf>(wgrad_tiles(H, C), w.s1.count, a0, b0, a0, b0, a0, a0, args,
                                      st);
    if (e != cudaSuccess) return e;
    args.M = C;
    args.P = H;
    args.per = w.s2.per;
    args.out = w.s2.count > 1 ? buf.part2 : in.dw2;
    e = launch_gemm<kWgrad, kGeluErf>(wgrad_tiles(C, H), w.s2.count, a1, b1, a1, b1, a1, a1, args,
                                      st);
    if (e != cudaSuccess) return e;
    const long long wn = static_cast<long long>(H) * C;
    if (w.s1.count > 1 && (e = colsum(buf.part1, w.s1.count, wn, in.dw1, nullptr, st)) != cudaSuccess)
      return e;
    if (w.s2.count > 1 && (e = colsum(buf.part2, w.s2.count, wn, in.dw2, nullptr, st)) != cudaSuccess)
      return e;
    if ((e = colsum(buf.partial, w.prows, w.row, in.vecs, buf.scratch, st)) != cudaSuccess)
      return e;
    dw2_finish_kernel<<<C, kThreads, 0, st>>>(in.w2, in.gamma, in.dw2, in.vecs + H + C, H);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace lnmlp_bwd
}  // namespace imt
