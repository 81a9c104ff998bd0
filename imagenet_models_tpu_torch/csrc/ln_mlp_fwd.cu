// Fused ConvNeXt branch body, forward, for Hopper (sm_90a):
//   out = (GELU(LN(h) @ W1^T + b1) @ W2^T + b2) * gamma,  per token.
//
// Replaces the TPU kernel `_kernel` / `_fused_ln_mlp_pallas` in
// imagenet_models_tpu/ops/convnext_block.py (:294-307, :341-362).
//
// Numerics (the Pallas kernel's): LayerNorm with fp32 statistics (two-pass
// mean and variance, eps given); LN'd tokens cast to bf16; first product in
// bf16 with fp32 accumulation, + b1 in fp32; exact GELU in fp32 (erff), cast
// to bf16; second product with fp32 accumulation, + b2, * gamma in fp32; one
// final cast to bf16.
//
// What bounds it on the H100. Per token the kernel reads and writes C bf16
// values but does 16*C*C flops (two C x 4C products), so at every ConvNeXt
// width it is far above the card's ~295 flop/byte balance point: it is bound
// by tensor-core issue and by how well the weights are staged, not by HBM.
// The (N, 4C) hidden activation is the traffic the fusion removes: written
// and read back in bf16 it would be 16 bytes per token per channel.
//
// Design. The TPU kernel keeps both whole weight matrices resident in VMEM
// with token tiles of up to 8192; on Hopper W1+W2 at C=768 are 4.7 MB, far
// beyond the 227 KB of shared memory. So:
//   * one block of 8 warps per tile of T tokens (T = 64, 32 or 16 by width);
//   * the LN'd bf16 tile stays in shared memory for the whole block;
//   * a loop over hidden chunks of HC units streams a W1 row block (HC x C)
//     and a W2 column block (C x HC) through shared memory with cp.async;
//     W2 chunk j loads while the first product of chunk j runs, and W1
//     chunk j+1 loads while GELU and the second product of chunk j run;
//   * the hidden chunk goes to shared memory in fp32, gets b1 and GELU, and is
//     cast to bf16 there: it never reaches HBM;
//   * the (T, C) fp32 output accumulator stays in registers (nvcuda::wmma
//     16x16x16 bf16 fragments) across the whole hidden loop;
//   * both products run on register-blocked warp tiles, so a fragment loaded
//     from shared memory feeds several mmas (measured on an H100: the wmma
//     phases were 55-70% of the kernel's time when each mma loaded its own);
//   * the ragged last tile is masked: rows past N are zeros on the way in and
//     are not stored on the way out.
// wgmma, TMA and persistent blocks are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr size_t kMaxSmem = 232448;  // 227 KB per block on sm_90

__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) & ~size_t(127); }

// Shared-memory plan, identical on host and device. Region 0 holds the LN'd
// tile and both weight chunks during the loop and the fp32 output tile in the
// epilogue; the hidden chunk (fp32 partial sums, then bf16) follows it.
struct Layout {
  int ldx, ldw2, ldh, ldg, ldo;
  size_t xs, w1s, w2s, os, hf, gs, total;
};

__host__ __device__ inline Layout make_layout(int C, int T, int HC, int ksplit) {
  Layout L;
  L.ldx = C + 8;    // bf16 rows of the LN'd tile and of the W1 chunk
  L.ldw2 = HC + 8;  // bf16 rows of the W2 chunk
  L.ldh = HC + 4;   // fp32 rows of the hidden chunk
  L.ldg = HC + 8;   // bf16 rows of the GELU'd hidden chunk
  L.ldo = C + 4;    // fp32 rows of the output tile
  const size_t xs_b = align128(size_t(T) * L.ldx * 2);
  const size_t w1_b = align128(size_t(HC) * L.ldx * 2);
  const size_t w2_b = align128(size_t(C) * L.ldw2 * 2);
  const size_t os_b = align128(size_t(T) * L.ldo * 4);
  L.xs = 0;
  L.w1s = xs_b;
  L.w2s = xs_b + w1_b;
  L.os = 0;
  const size_t region0 = (xs_b + w1_b + w2_b) > os_b ? (xs_b + w1_b + w2_b) : os_b;
  L.hf = region0;
  L.gs = L.hf + align128(size_t(ksplit) * T * L.ldh * 4);
  L.total = L.gs + align128(size_t(T) * L.ldg * 2);
  return L;
}

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
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

constexpr int kMaxSegs = 4;  // 16-byte segments of a row per lane: C <= 1024

// Warp grid of the first product for T tokens and HC hidden units: MT1 x NT1
// fragments per warp on a WM1 x WN1 grid, and the C reduction split KS ways
// over the warps left over (the partial sums meet in shared memory).
template <int T, int HC, int MT1, int NT1>
struct Grid1 {
  static constexpr int WM1 = T / 16 / MT1, WN1 = HC / 16 / NT1;
  static constexpr int KS = kWarps / (WM1 * WN1);
  static_assert(WM1 * MT1 == T / 16 && WN1 * NT1 == HC / 16 && KS * WM1 * WN1 == kWarps,
                "first-product warp grid");
};

// T tokens per block, HC hidden units per chunk. Both products run on
// register-blocked warp tiles: per k-step a warp loads its A and B fragments
// once and issues every mma between them.
//  * first product, (T/16) x (HC/16) fragments: Grid1<T, HC, MT1, NT1>; with
//    fewer than four fragments per warp, two accumulator sets (even and odd
//    k-steps) keep independent mmas in flight;
//  * second product, (T/16) x (C/16) fragments: a WM2 x WN2 warp grid, MT2 row
//    blocks and up to NT2 column blocks per warp (C/16 need not split evenly);
//    these accumulators live across the whole hidden loop.
template <int T, int HC, int MT1, int NT1, int MT2, int NT2, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
ln_mlp_fwd_kernel(const bf16* __restrict__ h, const float* __restrict__ ln_s,
                  const float* __restrict__ ln_b, const bf16* __restrict__ w1,
                  const float* __restrict__ b1, const bf16* __restrict__ w2,
                  const float* __restrict__ b2, const float* __restrict__ gamma,
                  bf16* __restrict__ out, long long n, int C, int hidden, float eps) {
  constexpr int WM1 = Grid1<T, HC, MT1, NT1>::WM1;
  constexpr int KS = Grid1<T, HC, MT1, NT1>::KS;
  constexpr int NACC = MT1 * NT1 >= 4 ? 1 : 2;
  constexpr int WM2 = T / 16 / MT2;
  constexpr int WN2 = kWarps / WM2;
  static_assert(WM2 * MT2 == T / 16 && WM2 * WN2 == kWarps, "second-product warp grid");

  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(C, T, HC, KS);
  bf16* Xs = reinterpret_cast<bf16*>(smem + L.xs);
  bf16* W1s = reinterpret_cast<bf16*>(smem + L.w1s);
  bf16* W2s = reinterpret_cast<bf16*>(smem + L.w2s);
  float* Os = reinterpret_cast<float*>(smem + L.os);
  float* Hf = reinterpret_cast<float*>(smem + L.hf);
  bf16* Gs = reinterpret_cast<bf16*>(smem + L.gs);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long row0 = static_cast<long long>(blockIdx.x) * T;
  const int nchunks = hidden / HC;
  const int segs = C / 8;

  auto load_w1 = [&](int j) {  // rows [j*HC, j*HC+HC) of W1 (hidden, C)
    const bf16* src = w1 + static_cast<size_t>(j) * HC * C;
    for (int i = tid; i < HC * segs; i += kThreads) {
      const int r = i / segs, s = i - r * segs;
      cp_async16(W1s + r * L.ldx + s * 8, src + static_cast<size_t>(r) * C + s * 8);
    }
  };
  auto load_w2 = [&](int j) {  // columns [j*HC, j*HC+HC) of W2 (C, hidden)
    constexpr int hsegs = HC / 8;
    for (int i = tid; i < C * hsegs; i += kThreads) {
      const int r = i / hsegs, s = i - r * hsegs;
      cp_async16(W2s + r * L.ldw2 + s * 8,
                 w2 + static_cast<size_t>(r) * hidden + static_cast<size_t>(j) * HC + s * 8);
    }
  };

  load_w1(0);
  cp_commit();

  // LayerNorm, one warp per row, 16-byte loads: mean, then the centred second
  // moment from the same registers, then the normalized row into Xs.
  for (int t = warp; t < T; t += kWarps) {
    uint4* xs = reinterpret_cast<uint4*>(Xs + t * L.ldx);
    const long long r = row0 + t;
    if (r < n) {
      const uint4* src = reinterpret_cast<const uint4*>(h + r * C);
      uint4 raw[kMaxSegs];
      float f[8];
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxSegs; ++q) {
        const int sg = lane + 32 * q;
        if (sg < segs) {
          raw[q] = src[sg];
          unpack8(raw[q], f);
#pragma unroll
          for (int e = 0; e < 8; ++e) s += f[e];
        }
      }
      const float mu = warp_sum(s) / C;
      float var = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxSegs; ++q) {
        if (lane + 32 * q < segs) {
          unpack8(raw[q], f);
#pragma unroll
          for (int e = 0; e < 8; ++e) var += (f[e] - mu) * (f[e] - mu);
        }
      }
      const float rstd = rsqrtf(warp_sum(var) / C + eps);
#pragma unroll
      for (int q = 0; q < kMaxSegs; ++q) {
        const int sg = lane + 32 * q;
        if (sg < segs) {
          unpack8(raw[q], f);
#pragma unroll
          for (int e = 0; e < 8; ++e) f[e] = (f[e] - mu) * rstd * ln_s[sg * 8 + e] + ln_b[sg * 8 + e];
          xs[sg] = pack8(f);
        }
      }
    } else {
      for (int sg = lane; sg < segs; sg += 32) xs[sg] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  cp_wait<0>();
  __syncthreads();

  // first-product warp tile
  const int wm1 = warp % WM1, wn1 = (warp / WM1) % Grid1<T, HC, MT1, NT1>::WN1;
  const int jb0 = wn1 * NT1;
  const int ks = warp / (WM1 * Grid1<T, HC, MT1, NT1>::WN1);
  const int k16 = C / 16;
  const int kb = ks * k16 / KS, ke = (ks + 1) * k16 / KS;
  // second-product warp tile
  const int cblocks = C / 16;
  const int wm2 = warp % WM2, wn2 = warp / WM2;
  const int cb0 = wn2 * cblocks / WN2;
  const int nt2 = (wn2 + 1) * cblocks / WN2 - cb0;

  FragC acc[MT2][NT2];
#pragma unroll
  for (int i = 0; i < MT2; ++i)
#pragma unroll
    for (int jj = 0; jj < NT2; ++jj) wmma::fill_fragment(acc[i][jj], 0.f);

  for (int j = 0; j < nchunks; ++j) {
    load_w2(j);
    cp_commit();

    // first product: Hf[ks] = Xs[:, k-slice ks] @ W1chunk^T
    {
      FragC c1[NACC][MT1][NT1];
#pragma unroll
      for (int p = 0; p < NACC; ++p)
#pragma unroll
        for (int i = 0; i < MT1; ++i)
#pragma unroll
          for (int jj = 0; jj < NT1; ++jj) wmma::fill_fragment(c1[p][i][jj], 0.f);
      for (int k = kb; k < ke; k += NACC) {
#pragma unroll
        for (int p = 0; p < NACC; ++p) {
          if (k + p < ke) {
            FragA a[MT1];
            FragB b[NT1];
#pragma unroll
            for (int i = 0; i < MT1; ++i)
              wmma::load_matrix_sync(a[i], Xs + (wm1 * MT1 + i) * 16 * L.ldx + (k + p) * 16, L.ldx);
#pragma unroll
            for (int jj = 0; jj < NT1; ++jj)
              wmma::load_matrix_sync(b[jj], W1s + (jb0 + jj) * 16 * L.ldx + (k + p) * 16, L.ldx);
#pragma unroll
            for (int i = 0; i < MT1; ++i)
#pragma unroll
              for (int jj = 0; jj < NT1; ++jj) wmma::mma_sync(c1[p][i][jj], a[i], b[jj], c1[p][i][jj]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MT1; ++i)
#pragma unroll
        for (int jj = 0; jj < NT1; ++jj) {
#pragma unroll
          for (int p = 1; p < NACC; ++p)
#pragma unroll
            for (int e = 0; e < c1[0][i][jj].num_elements; ++e) c1[0][i][jj].x[e] += c1[p][i][jj].x[e];
          wmma::store_matrix_sync(Hf + ks * T * L.ldh + (wm1 * MT1 + i) * 16 * L.ldh + (jb0 + jj) * 16,
                                  c1[0][i][jj], L.ldh, wmma::mem_row_major);
        }
    }
    __syncthreads();  // W1 chunk consumed, Hf complete

    if (j + 1 < nchunks) load_w1(j + 1);
    cp_commit();

    // + b1, exact GELU in fp32, cast to bf16
    for (int i = tid; i < T * HC; i += kThreads) {
      const int t = i / HC, c = i - t * HC;
      float v = b1[j * HC + c];
#pragma unroll
      for (int s = 0; s < KS; ++s) v += Hf[s * T * L.ldh + t * L.ldh + c];
      Gs[t * L.ldg + c] = __float2bfloat16(0.5f * v * (1.f + erff(v * 0.70710678118654752f)));
    }
    cp_wait<1>();  // W2 chunk j has landed (W1 chunk j+1 may still be in flight)
    __syncthreads();

    // second product: acc += Gs @ W2chunk^T
#pragma unroll
    for (int kk = 0; kk < HC / 16; ++kk) {
      FragA a[MT2];
#pragma unroll
      for (int i = 0; i < MT2; ++i)
        wmma::load_matrix_sync(a[i], Gs + (wm2 * MT2 + i) * 16 * L.ldg + kk * 16, L.ldg);
#pragma unroll
      for (int jj = 0; jj < NT2; ++jj) {
        if (jj < nt2) {
          FragB b;
          wmma::load_matrix_sync(b, W2s + (cb0 + jj) * 16 * L.ldw2 + kk * 16, L.ldw2);
#pragma unroll
          for (int i = 0; i < MT2; ++i) wmma::mma_sync(acc[i][jj], a[i], b, acc[i][jj]);
        }
      }
    }
    cp_wait<0>();
    __syncthreads();  // W1 chunk j+1 visible; W2s and Gs free
  }

  // epilogue: fp32 tile through shared memory, + b2, * gamma, one cast
#pragma unroll
  for (int i = 0; i < MT2; ++i)
#pragma unroll
    for (int jj = 0; jj < NT2; ++jj)
      if (jj < nt2)
        wmma::store_matrix_sync(Os + (wm2 * MT2 + i) * 16 * L.ldo + (cb0 + jj) * 16, acc[i][jj],
                                L.ldo, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < T * segs; i += kThreads) {
    const int t = i / segs, sg = i - t * segs;
    const long long r = row0 + t;
    if (r < n) {
      const float* o = Os + t * L.ldo + sg * 8;
      float f[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = (o[e] + b2[sg * 8 + e]) * gamma[sg * 8 + e];
      reinterpret_cast<uint4*>(out + r * C)[sg] = pack8(f);
    }
  }
}

template <int T, int HC, int MT1, int NT1, int MT2, int NT2, int MINB>
cudaError_t launch(const bf16* h, const float* ln_s, const float* ln_b, const bf16* w1,
                   const float* b1, const bf16* w2, const float* b2, const float* gamma,
                   bf16* out, long long n, int C, int hidden, float eps, cudaStream_t stream) {
  constexpr int KS = Grid1<T, HC, MT1, NT1>::KS;
  constexpr int WN2 = kWarps / (T / 16 / MT2);
  if ((C / 16 + WN2 - 1) / WN2 > NT2 || hidden % HC) return cudaErrorInvalidValue;
  const Layout L = make_layout(C, T, HC, KS);
  if (L.total > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = ln_mlp_fwd_kernel<T, HC, MT1, NT1, MT2, NT2, MINB>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L.total));
  if (e != cudaSuccess) return e;
  const long long blocks = (n + T - 1) / T;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(blocks), kThreads, L.total, stream>>>(
      h, ln_s, ln_b, w1, b1, w2, b2, gamma, out, n, C, hidden, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Widths the kernel takes: C a multiple of 16 up to 1024 and hidden a
// multiple of 64. Returns 1 when (C, hidden) is supported.
int imt_ln_mlp_fwd_supported(int C, int hidden) {
  return C > 0 && C % 16 == 0 && C <= 1024 && hidden > 0 && hidden % 64 == 0;
}

// h (n, C) bf16, w1 (hidden, C) bf16, w2 (C, hidden) bf16, vectors fp32,
// out (n, C) bf16; all contiguous and 16-byte aligned. Launches on `stream`
// and returns the launch status (a cudaError_t; 0 is success).
int imt_ln_mlp_fwd_bf16(const void* h, const void* ln_s, const void* ln_b, const void* w1,
                        const void* b1, const void* w2, const void* b2, const void* gamma,
                        void* out, long long n, int C, int hidden, float eps, void* stream) {
  if (!imt_ln_mlp_fwd_supported(C, hidden) || n <= 0) return cudaErrorInvalidValue;
  const auto* hp = static_cast<const bf16*>(h);
  const auto* w1p = static_cast<const bf16*>(w1);
  const auto* w2p = static_cast<const bf16*>(w2);
  const auto* sp = static_cast<const float*>(ln_s);
  const auto* bp = static_cast<const float*>(ln_b);
  const auto* b1p = static_cast<const float*>(b1);
  const auto* b2p = static_cast<const float*>(b2);
  const auto* gp = static_cast<const float*>(gamma);
  auto* op = static_cast<bf16*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  // <T, HC, first-product tile MT1 x NT1, second-product tile MT2 x NT2, min blocks/SM>
  if (C <= 128) return launch<64, 64, 1, 2, 1, 4, 2>(hp, sp, bp, w1p, b1p, w2p, b2p, gp, op, n, C, hidden, eps, st);
  if (C <= 256) return launch<64, 64, 1, 2, 2, 4, 2>(hp, sp, bp, w1p, b1p, w2p, b2p, gp, op, n, C, hidden, eps, st);
  if (C <= 384) return launch<64, 64, 2, 2, 4, 3, 1>(hp, sp, bp, w1p, b1p, w2p, b2p, gp, op, n, C, hidden, eps, st);
  if (C <= 768) return launch<32, 32, 2, 2, 2, 6, 1>(hp, sp, bp, w1p, b1p, w2p, b2p, gp, op, n, C, hidden, eps, st);
  return launch<16, 32, 1, 2, 1, 8, 1>(hp, sp, bp, w1p, b1p, w2p, b2p, gp, op, n, C, hidden, eps, st);
}

const char* imt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
