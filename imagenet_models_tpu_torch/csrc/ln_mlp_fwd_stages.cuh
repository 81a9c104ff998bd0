// Kernel 1's GEMM stages (ln_mlp_fwd.cu), shared with the bf16 instance of
// the fused ConvNeXt branch's forward, kernel 10 (convnext_branch_fwd.cu):
// the persistent wgmma + TMA GEMM kernel in its two kinds, (ii) hmid =
// bf16(GELU(tok W1^T + b1)) and (iii) out = bf16((hmid W2^T + b2) * gamma),
// the workspace that holds tok and hmid, and the host code that runs the two
// stages on it. The GELU of (ii) is a GeluMode (ln_mlp_common.cuh): kernel
// 1's erff or minimax fit, kernel 10's A&S erf. See ln_mlp_fwd.cu for the
// design and what bounds it.
#pragma once

#include "hopper_gemm.cuh"
#include "ln_mlp_common.cuh"

namespace imt {
namespace lnmlp_fwd {

// ------------------------------------------------------ (ii), (iii) GEMMs

// shared memory: the ring; the staged output tile (two 128-byte-swizzled
// 128 x 64 boxes, as the TMA store reads them); the ring's mbarriers; 1 KB
// to align
constexpr int kStagedBytes = kBM * kBN * 2;
constexpr size_t kGemmSmem = 1024 + kRing + kStagedBytes + 2 * kStages * 8;

enum Kind { kHid = 0, kOut = 1 };

struct GemmArgs {
  const float* bias;   // b1 (kHid) or b2 (kOut), one per output column
  const float* gamma;  // kOut
  int cols;            // output columns: hidden (kHid) or C (kOut), a multiple of 16
  int nk;              // k-blocks of a tile: ceil(C / 64) (kHid) or hidden / 64 (kOut)
  int gx, ntiles;      // output-column tiles; tiles in all, numbered column tile fastest
};

// Persistent: each CTA walks over tiles blockIdx.x, + gridDim.x, ...; the
// producer runs ahead into the next tile's k-blocks while the consumers
// finish a tile's epilogue. The maps: ma the token-major A operand (tok or
// hmid, boxes 64 x 128), mb the K-major B operand (W1 or W2 rows, boxes 64
// x 128), ms the store map of the output (hmid or out, boxes 64 x 128).
template <int KIND, int GM>
__global__ void __launch_bounds__(kGemmThreads, 1)
ln_mlp_fwd_gemm_kernel(const __grid_constant__ CUtensorMap ma,
                       const __grid_constant__ CUtensorMap mb,
                       const __grid_constant__ CUtensorMap ms, const GemmArgs args) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* staged = smem_raw + (base - raw) + kRing;  // [box 0, 1][128 rows][128 bytes]
  const uint32_t full0 = base + kRing + kStagedBytes, empty0 = full0 + kStages * 8;

  const int tid = threadIdx.x;
  const int wg = tid / 128;

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
        const int row0 = (tile / args.gx) * kBM, col0 = (tile % args.gx) * kBN;
        for (int kb = 0; kb < args.nk; ++kb, ++it) {
          const int s = it % kStages;
          mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
          const uint32_t fb = full0 + 8 * s;
          mbar_expect_tx(fb, kStageBytes);
          const uint32_t sa = base + s * kStageBytes;
          tma_load(sa, &ma, fb, kb * kBK, row0);             // token rows
          tma_load(sa + kOpBytes, &mb, fb, kb * kBK, col0);  // weight rows
        }
      }
    }
    return;
  }

  const int lane = tid & 31;
  const int w = (tid / 32) & 3;
  const int r_in = wg * 64 + 16 * w + lane / 4;  // its first row in the tile; the second is +8
  const int q = 2 * (lane % 4);                  // its first column in each 8-column group
  int it = 0;
  for (int tile = blockIdx.x; tile < args.ntiles; tile += gridDim.x) {
    const int row0 = (tile / args.gx) * kBM, col0 = (tile % args.gx) * kBN;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

    for (int kb = 0; kb < args.nk; ++kb, ++it) {
      const int s = it % kStages;
      mbar_wait(full0 + 8 * s, (it / kStages) & 1);
      const uint32_t sa = base + s * kStageBytes;
      wg_fence();
      mma_stage<0, 0>(acc, sa + wg * 64 * 128, sa + kOpBytes);  // the warpgroup's 64 rows
      wg_commit();
      wg_wait<1>();
      if (kb > 0) mbar_arrive(empty0 + 8 * ((it - 1) % kStages));
    }
    wg_wait<0>();
    fence_acc(acc);
    mbar_arrive(empty0 + 8 * ((it - 1) % kStages));

    // The epilogue, in fp32 and one cast: kHid bf16(GELU(acc + b1)), kOut
    // bf16((acc + b2) * gamma), staged in shared memory and out by a TMA
    // store, which runs on while the next tile multiplies (rows past n and
    // columns past `cols` are clipped by the store map). The barrier: the
    // last tile's store has read the staged tile (thread 0 waited for it).
    if (tid == 0) bulk_wait_read<0>();
    consumers_sync();
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + q;
      const int cj = col0 + col;  // cols % 16 == 0: cj and cj + 1 are both in or both out
      const bool in = cj < args.cols;
      const float bb0 = in ? args.bias[cj] : 0.f, bb1 = in ? args.bias[cj + 1] : 0.f;
      float g0 = 1.f, g1 = 1.f;
      if constexpr (KIND == kOut) {
        g0 = in ? args.gamma[cj] : 0.f;
        g1 = in ? args.gamma[cj + 1] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float v0 = acc[4 * j + 2 * i] + bb0, v1 = acc[4 * j + 2 * i + 1] + bb1;
        if constexpr (KIND == kHid) {
          v0 = gelu<GM>(v0);
          v1 = gelu<GM>(v1);
        } else {
          v0 *= g0;
          v1 *= g1;
        }
        *reinterpret_cast<__nv_bfloat162*>(staged + staged_offset(r_in + 8 * i, col)) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
    fence_async_smem();  // the staged tile, visible to the TMA store
    consumers_sync();
    if (tid == 0) {
      const uint32_t st0 = smem_u32(staged);
      for (int b = 0; b < 2; ++b)
        if (col0 + 64 * b < args.cols) tma_store(&ms, st0 + b * kBM * 128, col0 + 64 * b, row0);
      bulk_commit();
    }
  }
  // the last tile's store reads shared memory until it is done
  if (tid == 0) bulk_wait<0>();
}

// ------------------------------------------------------------------ host

// The workspace: tok (n, C) and hmid (n, hidden), bf16, each 1024-byte
// aligned.
struct Work {
  size_t tok, hmid, total;
};

Work plan(long long n, int C, int hidden) {
  const auto up = [](size_t b) { return (b + 1023) & ~size_t(1023); };
  Work w;
  w.tok = 0;
  w.hmid = up(static_cast<size_t>(n) * C * 2);
  w.total = w.hmid + up(static_cast<size_t>(n) * hidden * 2);
  return w;
}

// gx x gy tiles on min(tiles, SMs) persistent CTAs.
template <int KIND, int GM>
cudaError_t launch_gemm(long long gx, long long gy, const CUtensorMap& a, const CUtensorMap& b,
                        const CUtensorMap& s, GemmArgs args, cudaStream_t st) {
  if (gx * gy > 0x7fffffffLL) return cudaErrorInvalidValue;
  args.gx = static_cast<int>(gx);
  args.ntiles = static_cast<int>(gx * gy);
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidValue;
  auto kern = ln_mlp_fwd_gemm_kernel<KIND, GM>;
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(kGemmSmem));
  if (e != cudaSuccess) return e;
  const int grid = args.ntiles < sms ? args.ntiles : sms;
  kern<<<grid, kGemmThreads, kGemmSmem, st>>>(a, b, s, args);
  return cudaGetLastError();
}

// What the GEMM stages read and write besides the workspace: the weights
// (bf16, hidden x C and C x hidden), b1, b2, gamma (fp32), the output (n, C)
// bf16.
struct GemmInputs {
  const bf16 *w1, *w2;
  const float *b1, *b2, *gamma;
  bf16* out;
  char* ws;  // plan(n, C, hidden)'s workspace; its tok holds stage (i)'s tokens
  long long n;
  int C, hidden;
};

// Stages (ii) and (iii) of [first, last) (numbered 1 and 2) on the
// workspace; (ii) with the GELU of mode GM.
template <int GM>
cudaError_t run_gemm_stages(const GemmInputs& in, int first, int last, cudaStream_t st) {
  const long long n = in.n;
  const int C = in.C, H = in.hidden;
  const Work w = plan(n, C, H);
  bf16* tok = reinterpret_cast<bf16*>(in.ws + w.tok);
  bf16* hmid = reinterpret_cast<bf16*>(in.ws + w.hmid);
  const long long mtiles = (n + kBM - 1) / kBM;
  cudaError_t e = cudaSuccess;
  CUtensorMap a, b, s;
  GemmArgs args = {};

  if (first <= 1 && last > 1) {  // (ii)
    if (!tensor_map(&a, tok, C, n, 64, kBM) || !tensor_map(&b, in.w1, C, H, 64, kBN) ||
        !tensor_map(&s, hmid, H, n, 64, kBM))
      return cudaErrorInvalidValue;
    args.bias = in.b1;
    args.cols = H;
    args.nk = (C + kBK - 1) / kBK;
    e = launch_gemm<kHid, GM>((H + kBN - 1) / kBN, mtiles, a, b, s, args, st);
    if (e != cudaSuccess) return e;
  }
  if (first <= 2 && last > 2) {  // (iii)
    if (!tensor_map(&a, hmid, H, n, 64, kBM) || !tensor_map(&b, in.w2, H, C, 64, kBN) ||
        !tensor_map(&s, in.out, C, n, 64, kBM))
      return cudaErrorInvalidValue;
    args.bias = in.b2;
    args.gamma = in.gamma;
    args.cols = C;
    args.nk = H / kBK;
    e = launch_gemm<kOut, kGeluErf>((C + kBN - 1) / kBN, mtiles, a, b, s, args, st);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace lnmlp_fwd
}  // namespace imt
