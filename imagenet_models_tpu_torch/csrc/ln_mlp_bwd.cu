// Fused ConvNeXt branch body, backward, for Hopper (sm_90a): kernel 2.
//
// Replaces the TPU kernel `_bwd_kernel` / `_fused_ln_mlp_bwd_pallas` in
// imagenet_models_tpu/ops/convnext_block.py (:372-453, :474-516). Per token it
// pulls the cotangent g of out = (GELU(LN(h) W1^T + b1) W2^T + b2) * gamma back
// to dx, and sums over all N tokens the weight gradients dW1 (hidden x C),
// dW2 (C x hidden) and the vector gradients db1, db2, dgamma, dln_s, dln_b.
//
// Numerics (the Pallas kernel's, and plain_ln_mlp_bwd's): the forward is
// recomputed from h with fp32 LN statistics; the LN'd tokens, the GELU output
// hmid, dpre2 = g*gamma and dpre1 = (dpre2 W2) * gelu'(pre1) are rounded to
// bf16 as products' operands; every product sums in fp32; gelu' is the fit's
// (erff-exact at eval, the minimax fit in training), not the derivative of
// the forward polynomial; the LN backward runs in fp32 and dx is cast to bf16.
// One difference: dW2 is gamma * (g^T hmid), scaled after the fp32 sum, where
// the twin sums bf16(g*gamma)^T hmid; the two differ by that one rounding.
// And dgamma = sum_t g * pre2 is taken from the same product, as
// sum_j W2[c][j] * (g^T hmid)[c][j] + b2[c] * sum_t g[t][c], so pre2 is never
// formed. Nothing is added with float atomics: every sum over tokens meets
// in a fixed order, so the same inputs give the same bits on every run.
//
// What bounds it on the H100. The recomputed forward plus the backward are
// five products of N x hidden x C (8*N*C^2 flops each at hidden = 4C): pre1
// and dhmid, dln, dW1 and G, each far above the card's ~295 flop/byte
// balance, so the work is bound by the tensor cores, 0.15 ms at peak per
// launch at the B=128 stage shapes of map_convnext_tiny. The earlier design
// (one block of 8 warps per tile of 16-64 tokens, wmma fragments, W1 and W2
// streamed through shared memory for every tile) moved 24*C^2 bytes of
// weights per tile, 1.4-5.6 GB per launch, at 16-64 flops per byte, and ran
// 20x over that bound. This one splits the work into GEMM-shaped kernels
// with 128 x 128 tiles on `wgmma` (m64n128k16, fp32 sums in registers), fed
// by TMA into a four-stage ring of shared memory that a producer warp keeps
// full, with mbarriers, while two consumer warpgroups of 64 rows each
// multiply; the CTAs are persistent (one per SM, walking over the tiles),
// so the producer loads the next tile while the consumers finish one. Each
// weight byte now serves 128 tokens:
//
//  (i)   ln_mlp_bwd_prologue_kernel, a warp (16 lanes at C <= 128) per
//        token row, several rows in flight, memory-bound: the LN
//        statistics (mu, rstd), tok = bf16(LN(h)), dpre2 = bf16(g*gamma),
//        and each block's partial sums of db2 and of dgamma's b2 * sum g.
//  (ii)  ln_mlp_bwd_gemm_kernel<kHidden>: on a tile of 128 tokens x 128
//        hidden units, pre1 = tok W1^T and dhmid = dpre2 W2 (K = C, two
//        accumulators); the epilogue writes hmid = bf16(GELU(pre1 + b1))
//        and dpre1 = bf16(dhmid * gelu'(pre1 + b1)) into swizzled shared
//        memory, TMA stores take them out while the next tile multiplies,
//        and the tile's partial sums of db1 (of the fp32 dpre1).
//  (iii) ln_mlp_bwd_gemm_kernel<kDln>: dln = dpre1 W1 (K = hidden) on 128
//        tokens x 128 channels; the epilogue takes the LN backward as far
//        as a tile's channels allow: dxhat = dln * ln_s (fp32, to HBM),
//        each row's partial sums of dxhat and dxhat * xhat over the tile's
//        channels, and the tile's partial sums of dln_s and dln_b. A row's
//        means need all C channels, and a CTA cannot hold 128 tokens x C
//        fp32 sums for C up to 1024 (512 KB), so C is split into
//        128-channel tiles and ln_mlp_bwd_rows_kernel, a small second pass
//        (about 2 x N x C x 4 bytes more traffic, 11-23 us at the B=128
//        shapes of stages 1-3), adds the row sums and writes dx = rstd *
//        (dxhat - m1 - xhat * m2). Where one tile spans C (C <= 128, stage
//        0) the epilogue has whole rows and writes dx itself.
//  (iv)  ln_mlp_bwd_gemm_kernel<kWgrad>: dW1 = dpre1^T tok and G = g^T
//        hmid, both operands read token-major from shared memory as
//        MN-major (the transpose bits of a bf16 wgmma); each CTA owns a
//        128 x 128 output tile and one slice of the tokens (a multiple of
//        64, as many slices as fill the card's rounds), and the slices'
//        partials are added in the fixed order of wgrad_common.cuh. The
//        blocks' vector partial rows of (i)-(iii) are added the same way,
//        and dw2_finish_kernel turns G into dW2 = gamma * G and adds sum_j
//        W2 * G to dgamma.
//
// Ragged edges (N not a multiple of 128, C = 688 = 43 x 16, hidden tiles of
// 64) take TMA's zero fill on the loads and masks (or the store maps'
// clipping) on the stores: one path. What remains over the bound: the
// pipeline's traffic, hmid and dpre1 (two N x hidden bf16 tensors) written
// and read back three times: about 2 GB at stage 0 of B=128 (N = 401408,
// C = 96), 0.6 ms at 3.35 TB/s; the epilogues' GELU work at stages 0-1;
// and at stages 2-3 tiles too small for the L2's rate (128 x 128 tiles
// feed 64 flops per byte streamed).
//
// fp32 tokens (an fp32 model) take the fp32 instance of ln_mlp_f32.cuh: the
// same four stages with no cast to bf16, on the CUDA cores.

#include <algorithm>

#include "hopper_gemm.cuh"
#include "ln_mlp_common.cuh"
#include "ln_mlp_f32.cuh"
#include "wgrad_common.cuh"

namespace {

using namespace imt;

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
// (MN-major); kWgrad A and B (both MN-major, token rows).
template <int KIND, bool FAST>
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
          const float d0 = acc2[4 * j + 2 * i] * gelu_grad<FAST>(p0);
          const float d1 = acc2[4 * j + 2 * i + 1] * gelu_grad<FAST>(p1);
          v0 += d0;
          v1 += d1;
          const int off = staged_offset(r_in + 8 * i, col);
          *reinterpret_cast<__nv_bfloat162*>(staged + off) =
              __floats2bfloat162_rn(gelu<FAST>(p0), gelu<FAST>(p1));
          *reinterpret_cast<__nv_bfloat162*>(staged + kBM * kBN * 2 + off) =
              __floats2bfloat162_rn(d0, d1);
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
    } else if constexpr (KIND == kDln) {
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

// ---------------------------------------------------------- (i) prologue

// The row kernels' layout is ln_mlp_common.cuh's (row_sum, launch_rows).
// 128 rows (one token tile) per block of 8 warps: mu and rstd in fp32, tok
// = bf16(LN(h)), dpre2 = bf16(g * gamma), and the block's column sums of g *
// gamma (db2) and of g (times b2: dgamma's b2 part) into its vector partial
// row, the row groups' and warps' partials met in order (the warps' through
// shared memory, 8 x 2C floats).
template <int L, int S, int R>
__global__ void __launch_bounds__(kThreads)
ln_mlp_bwd_prologue_kernel(const bf16* __restrict__ h, const bf16* __restrict__ g,
                           const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                           const float* __restrict__ b2, const float* __restrict__ gamma,
                           bf16* __restrict__ tok, bf16* __restrict__ dpre2,
                           float* __restrict__ mu_out, float* __restrict__ rstd_out,
                           float* __restrict__ partial, long long n, int C, int hidden, float eps) {
  constexpr int G = 32 / L;
  extern __shared__ float pred[];  // [8][2C]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / L, sl = lane % L;
  const int segs = C / 8;
  float sdb[S][8], sg[S][8];
#pragma unroll
  for (int q = 0; q < S; ++q)
#pragma unroll
    for (int e = 0; e < 8; ++e) sdb[q][e] = sg[q][e] = 0.f;
  for (int rr = warp * G * R; rr < kBM; rr += kWarps * G * R) {
    const long long r0 = static_cast<long long>(blockIdx.x) * kBM + rr + grp;
    uint4 hraw[R][S], graw[R][S];
#pragma unroll
    for (int u = 0; u < R; ++u)
#pragma unroll
      for (int q = 0; q < S; ++q)
        if (r0 + u * G < n && sl + L * q < segs) {
          hraw[u][q] = reinterpret_cast<const uint4*>(h + (r0 + u * G) * C)[sl + L * q];
          graw[u][q] = reinterpret_cast<const uint4*>(g + (r0 + u * G) * C)[sl + L * q];
        }
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const long long r = r0 + u * G;
      const bool ok = r < n;  // not uniform over the warp: the sums run on every lane
      float f[8];
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < S; ++q) {
        if (ok && sl + L * q < segs) {
          unpack8(hraw[u][q], f);
#pragma unroll
          for (int e = 0; e < 8; ++e) s += f[e];
        }
      }
      const float mu = row_sum<L>(s) / C;
      float var = 0.f;
#pragma unroll
      for (int q = 0; q < S; ++q) {
        if (ok && sl + L * q < segs) {
          unpack8(hraw[u][q], f);
#pragma unroll
          for (int e = 0; e < 8; ++e) var += (f[e] - mu) * (f[e] - mu);
        }
      }
      const float rstd = rsqrtf(row_sum<L>(var) / C + eps);
      if (!ok) continue;
      if (sl == 0) {
        mu_out[r] = mu;
        rstd_out[r] = rstd;
      }
      uint4* trow = reinterpret_cast<uint4*>(tok + r * C);
      uint4* drow = reinterpret_cast<uint4*>(dpre2 + r * C);
#pragma unroll
      for (int q = 0; q < S; ++q) {
        const int sgi = sl + L * q;
        if (sgi < segs) {
          unpack8(hraw[u][q], f);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            f[e] = (f[e] - mu) * rstd * ln_s[sgi * 8 + e] + ln_b[sgi * 8 + e];
          trow[sgi] = pack8(f);
          unpack8(graw[u][q], f);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            sg[q][e] += f[e];
            f[e] *= gamma[sgi * 8 + e];
            sdb[q][e] += f[e];
          }
          drow[sgi] = pack8(f);
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < S; ++q) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
#pragma unroll
      for (int o = L; o < 32; o <<= 1) {
        sdb[q][e] += __shfl_xor_sync(0xffffffffu, sdb[q][e], o);
        sg[q][e] += __shfl_xor_sync(0xffffffffu, sg[q][e], o);
      }
    }
    const int sgi = sl + L * q;
    if (grp == 0 && sgi < segs) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        pred[warp * 2 * C + sgi * 8 + e] = sdb[q][e];
        pred[warp * 2 * C + C + sgi * 8 + e] = sg[q][e];
      }
    }
  }
  __syncthreads();
  float* prt = partial + blockIdx.x * (hidden + 4LL * C) + hidden;
  for (int c = threadIdx.x; c < 2 * C; c += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += pred[w * 2 * C + c];
    prt[c] = c < C ? s : s * b2[c - C];
  }
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
// fp32; the vector partial rows (mtiles, hidden + 4C) and their column-sum
// scratch; the token-slice partials of dW1 and of G.
constexpr int kParts = 12;

struct Work {
  long long mtiles, ctiles, row;
  Slices s1, s2;
  size_t off[kParts + 1];
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

Work plan(long long n, int C, int hidden) {
  Work w;
  w.mtiles = (n + kBM - 1) / kBM;
  w.ctiles = (C + kBN - 1) / kBN;
  w.row = hidden + 4LL * C;
  const int sms = sm_count();
  w.s1 = token_slices(n, wgrad_tiles(hidden, C), sms);
  w.s2 = token_slices(n, wgrad_tiles(C, hidden), sms);
  const long long parts = w.mtiles > kChunk ? (w.mtiles + kChunk - 1) / kChunk : 0;
  const size_t wsize = static_cast<size_t>(hidden) * C * 4;
  const size_t sizes[kParts] = {
      static_cast<size_t>(n) * C * 2, static_cast<size_t>(n) * C * 2,
      static_cast<size_t>(n) * 4, static_cast<size_t>(n) * 4,
      static_cast<size_t>(n) * hidden * 2, static_cast<size_t>(n) * hidden * 2,
      static_cast<size_t>(n) * C * 4, static_cast<size_t>(w.ctiles * n) * 8,
      static_cast<size_t>(w.mtiles * w.row) * 4, static_cast<size_t>(parts * w.row) * 4,
      w.s1.count > 1 ? w.s1.count * wsize : 0, w.s2.count > 1 ? w.s2.count * wsize : 0};
  w.off[0] = 0;
  for (int i = 0; i < kParts; ++i) w.off[i + 1] = w.off[i] + ((sizes[i] + 1023) & ~size_t(1023));
  return w;
}

// gx x gy tiles on min(tiles, SMs) persistent CTAs; s0, s1 the store maps
// (kHidden's hmid and dpre1), the others' unused.
template <int KIND, bool FAST>
cudaError_t launch_gemm(long long gx, long long gy, const CUtensorMap& a0, const CUtensorMap& b0,
                        const CUtensorMap& a1, const CUtensorMap& b1, const CUtensorMap& s0,
                        const CUtensorMap& s1, GemmArgs args, cudaStream_t st) {
  if (gx * gy > 0x7fffffffLL) return cudaErrorInvalidValue;
  args.gx = static_cast<int>(gx);
  args.ntiles = static_cast<int>(gx * gy);
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidValue;
  auto kern = ln_mlp_bwd_gemm_kernel<KIND, FAST>;
  constexpr size_t smem = gemm_smem(KIND);
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int grid = args.ntiles < sms ? args.ntiles : sms;
  kern<<<grid, kGemmThreads, smem, st>>>(a0, b0, a1, b1, s0, s1, args);
  return cudaGetLastError();
}

template <int L, int S, int R>
struct Prologue {
  static constexpr auto kernel = ln_mlp_bwd_prologue_kernel<L, S, R>;
};
template <int L, int S, int R>
struct Rows {
  static constexpr auto kernel = ln_mlp_bwd_rows_kernel<L, S, R>;
};

struct Inputs {
  const bf16 *h, *g, *w1, *w2;
  const float *ln_s, *ln_b, *b1, *b2, *gamma;
  bf16* dx;
  float *dw1, *dw2, *vecs;
  char* ws;
  long long n;
  int C, hidden;
  float eps;
};

template <bool FAST>
cudaError_t run_stages(const Inputs& in, int first, int last, cudaStream_t st) {
  const long long n = in.n;
  const int C = in.C, H = in.hidden;
  const Work w = plan(n, C, H);
  bf16* tok = reinterpret_cast<bf16*>(in.ws + w.off[0]);
  bf16* dpre2 = reinterpret_cast<bf16*>(in.ws + w.off[1]);
  float* mu = reinterpret_cast<float*>(in.ws + w.off[2]);
  float* rstd = reinterpret_cast<float*>(in.ws + w.off[3]);
  bf16* hmid = reinterpret_cast<bf16*>(in.ws + w.off[4]);
  bf16* dpre1 = reinterpret_cast<bf16*>(in.ws + w.off[5]);
  float* dxhat = reinterpret_cast<float*>(in.ws + w.off[6]);
  float* rowpart = reinterpret_cast<float*>(in.ws + w.off[7]);
  float* partial = reinterpret_cast<float*>(in.ws + w.off[8]);
  float* scratch = reinterpret_cast<float*>(in.ws + w.off[9]);
  float* part1 = reinterpret_cast<float*>(in.ws + w.off[10]);
  float* part2 = reinterpret_cast<float*>(in.ws + w.off[11]);
  if (w.mtiles > 65535) return cudaErrorInvalidValue;
  const unsigned mt = static_cast<unsigned>(w.mtiles);
  GemmArgs args = {};
  args.n = n;
  args.C = C;
  args.hidden = H;
  args.partial = partial;
  cudaError_t e = cudaSuccess;
  CUtensorMap a0, b0, a1, b1, s0, s1;

  if (first <= 0 && last > 0) {  // (i)
    const size_t smem = static_cast<size_t>(kWarps) * 2 * C * 4;
    if ((e = launch_rows<Prologue>(C, mt, smem, st, in.h, in.g, in.ln_s, in.ln_b, in.b2,
                                   in.gamma, tok, dpre2, mu, rstd, partial, n, C, H, in.eps)) !=
        cudaSuccess)
      return e;
  }
  if (first <= 1 && last > 1) {  // (ii)
    if (!tensor_map(&a0, tok, C, n, 64, kBM) || !tensor_map(&b0, in.w1, C, H, 64, kBN) ||
        !tensor_map(&a1, dpre2, C, n, 64, kBM) || !tensor_map(&b1, in.w2, H, C, 64, 64) ||
        !tensor_map(&s0, hmid, H, n, 64, kBM) || !tensor_map(&s1, dpre1, H, n, 64, kBM))
      return cudaErrorInvalidValue;
    args.b1 = in.b1;
    e = launch_gemm<kHidden, FAST>((H + kBN - 1) / kBN, w.mtiles, a0, b0, a1, b1, s0, s1, args,
                                   st);
    if (e != cudaSuccess) return e;
  }
  if (first <= 2 && last > 2) {  // (iii)
    if (!tensor_map(&a0, dpre1, H, n, 64, kBM) || !tensor_map(&b0, in.w1, C, H, 64, 64))
      return cudaErrorInvalidValue;
    args.h = in.h;
    args.mu = mu;
    args.rstd = rstd;
    args.ln_s = in.ln_s;
    args.dxhat = dxhat;
    args.rowpart = rowpart;
    args.dx = in.dx;
    e = launch_gemm<kDln, false>(w.ctiles, w.mtiles, a0, b0, a0, b0, a0, a0, args, st);
    if (e != cudaSuccess) return e;
    const long long rb = (n + row_step(C) - 1) / row_step(C);
    if (rb > 0x7fffffffLL) return cudaErrorInvalidValue;
    if (C > kBN && (e = launch_rows<Rows>(C, static_cast<unsigned>(rb), 0, st, in.h, dxhat, mu,
                                          rstd, rowpart, in.dx, n, C)) != cudaSuccess)
      return e;
  }
  if (first <= 3 && last > 3) {  // (iv)
    // dW1 (hidden, C) = dpre1^T tok; G (C, hidden) = g^T hmid
    if (!tensor_map(&a0, dpre1, H, n, 64, 64) || !tensor_map(&b0, tok, C, n, 64, 64) ||
        !tensor_map(&a1, in.g, C, n, 64, 64) || !tensor_map(&b1, hmid, H, n, 64, 64))
      return cudaErrorInvalidValue;
    args.M = H;
    args.P = C;
    args.per = w.s1.per;
    args.out = w.s1.count > 1 ? part1 : in.dw1;
    e = launch_gemm<kWgrad, false>(wgrad_tiles(H, C), w.s1.count, a0, b0, a0, b0, a0, a0, args,
                                   st);
    if (e != cudaSuccess) return e;
    args.M = C;
    args.P = H;
    args.per = w.s2.per;
    args.out = w.s2.count > 1 ? part2 : in.dw2;
    e = launch_gemm<kWgrad, false>(wgrad_tiles(C, H), w.s2.count, a1, b1, a1, b1, a1, a1, args,
                                   st);
    if (e != cudaSuccess) return e;
    const long long wn = static_cast<long long>(H) * C;
    if (w.s1.count > 1 && (e = colsum(part1, w.s1.count, wn, in.dw1, nullptr, st)) != cudaSuccess)
      return e;
    if (w.s2.count > 1 && (e = colsum(part2, w.s2.count, wn, in.dw2, nullptr, st)) != cudaSuccess)
      return e;
    if ((e = colsum(partial, w.mtiles, w.row, in.vecs, scratch, st)) != cudaSuccess) return e;
    dw2_finish_kernel<<<C, kThreads, 0, st>>>(in.w2, in.gamma, in.dw2, in.vecs + H + C, H);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Widths the kernel takes, as the forward's: C a multiple of 16 up to 1024
// and hidden a multiple of 64. Returns 1 when (C, hidden) is supported.
int imt_ln_mlp_bwd_supported(int C, int hidden) {
  return C > 0 && C % 16 == 0 && C <= 1024 && hidden > 0 && hidden % 64 == 0;
}

// Bytes of device workspace a call on n tokens needs.
long long imt_ln_mlp_bwd_workspace_bytes(long long n, int C, int hidden) {
  if (!imt_ln_mlp_bwd_supported(C, hidden) || n <= 0) return 0;
  return static_cast<long long>(plan(n, C, hidden).off[kParts]);
}

// The backward, stages [first, last) of (i) prologue, (ii) hidden products,
// (iii) dln and dx, (iv) weight products and sums; 0 and 4 run it all. h
// and g (n, C) bf16, w1 (hidden, C) and w2 (C, hidden) bf16, vectors fp32,
// all contiguous and 16-byte aligned; `workspace` of
// imt_ln_mlp_bwd_workspace_bytes bytes, 1024-byte aligned. Writes dx (n, C)
// bf16, dw1 (hidden, C) and dw2 (C, hidden) fp32, and `vecs` (hidden + 4C
// fp32) = db1, db2, dgamma, dln_s, dln_b. A stage run alone reads what the
// stages before it left in the workspace. gelu_fast selects the training
// GELU. Launches on `stream`; returns the launch status (a cudaError_t; 0 is
// success).
int imt_ln_mlp_bwd_bf16(const void* h, const void* g, const void* ln_s, const void* ln_b,
                        const void* w1, const void* b1, const void* w2, const void* b2,
                        const void* gamma, void* dx, void* dw1, void* dw2, void* vecs,
                        void* workspace, long long n, int C, int hidden, float eps, int gelu_fast,
                        int first, int last, void* stream) {
  if (!imt_ln_mlp_bwd_supported(C, hidden) || n <= 0 || n > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(workspace) % 1024)
    return cudaErrorInvalidValue;
  const Inputs in = {static_cast<const bf16*>(h),      static_cast<const bf16*>(g),
                     static_cast<const bf16*>(w1),     static_cast<const bf16*>(w2),
                     static_cast<const float*>(ln_s),  static_cast<const float*>(ln_b),
                     static_cast<const float*>(b1),    static_cast<const float*>(b2),
                     static_cast<const float*>(gamma), static_cast<bf16*>(dx),
                     static_cast<float*>(dw1),         static_cast<float*>(dw2),
                     static_cast<float*>(vecs),        static_cast<char*>(workspace),
                     n, C, hidden, eps};
  auto st = static_cast<cudaStream_t>(stream);
  return gelu_fast ? run_stages<true>(in, first, last, st) : run_stages<false>(in, first, last, st);
}

// Bytes of device workspace a call of the fp32 instance on n tokens needs.
long long imt_ln_mlp_bwd_f32_workspace_bytes(long long n, int C, int hidden) {
  if (!imt_ln_mlp_bwd_supported(C, hidden) || n <= 0) return 0;
  return static_cast<long long>(imt::f32::bwd_plan(n, C, hidden).total);
}

// As imt_ln_mlp_bwd_bf16 with fp32 h, g, w1, w2 and dx, and a workspace of
// imt_ln_mlp_bwd_f32_workspace_bytes bytes.
int imt_ln_mlp_bwd_f32(const void* h, const void* g, const void* ln_s, const void* ln_b,
                       const void* w1, const void* b1, const void* w2, const void* b2,
                       const void* gamma, void* dx, void* dw1, void* dw2, void* vecs,
                       void* workspace, long long n, int C, int hidden, float eps, int gelu_fast,
                       int first, int last, void* stream) {
  if (!imt_ln_mlp_bwd_supported(C, hidden) || n <= 0 ||
      reinterpret_cast<uintptr_t>(workspace) % 1024)
    return cudaErrorInvalidValue;
  auto bwd = gelu_fast ? &imt::f32::backward<true> : &imt::f32::backward<false>;
  return bwd(static_cast<const float*>(h), static_cast<const float*>(g),
             static_cast<const float*>(ln_s), static_cast<const float*>(ln_b),
             static_cast<const float*>(w1), static_cast<const float*>(b1),
             static_cast<const float*>(w2), static_cast<const float*>(b2),
             static_cast<const float*>(gamma), static_cast<float*>(dx), static_cast<float*>(dw1),
             static_cast<float*>(dw2), static_cast<float*>(vecs), static_cast<char*>(workspace), n,
             C, hidden, eps, first, last, static_cast<cudaStream_t>(stream));
}

const char* imt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
