// CSWin vertical-stripe attention with LePE, backward, for Hopper (sm_90a):
// per stripe and head, from the bf16 q, k, v maps, the fp32 taps w9 (9, C)
// and the bf16 cotangent g (all (B, H, W, *), read in place as the forward
// reads them),
//   qs = bf16(q * scale),  p = bf16(softmax(qs k^T))   (recomputed)
//   dv = p^T g + the transposed LePE stencil of g,  dp = g v^T,
//   ds = p (dp - rowsum(dp p)),
//   dq = (bf16(ds) k) * scale,  dk = bf16(ds)^T qs,
// written as contiguous bf16 (B, H, W, C) maps, and over every stripe of the
// batch dw9[t] = sum of v[a+dx][y+dy] g[a][y] and dwb = sum of g, in fp32.
//
// Replaces the TPU kernel `_vs_bwd_kernel` / `_vs_bwd_pallas` in
// imagenet_models_tpu/ops/stripe_attention.py (:160-230, :284-304), with its
// numerics: ds from the bf16-rounded p, ds rounded to bf16 for the two
// products that take it, the fp32 product ds.k times the fp32 scale, dk from
// the scaled and rounded q, dv's attention part kept in fp32 until the LePE
// part is added, every product exact in fp32 with fp32 sums.
//
// What bounds it on the H100: bytes. Per token and head it reads 4 x 2D bytes
// (q, k, v, g) and writes 3 x 2D (dq, dk, dv), against about 10*T*D flops
// (31 kflop at T = 98): some 70 flops per byte. Every byte moves once; the
// stripe's pixels are found by index arithmetic in the unpartitioned maps,
// and everything else stays on chip.
//
// bf16: tensor cores (`stripe_attn_bwd_mma`). A block of one warp per
// 16-row slice (7 at T = 98, at most 8) owns one head and walks a fixed set
// of stripes; per stripe:
//   * cp.async copies the head's q, k, v and g rows into shared memory,
//     padded as the forward pads them (zeros written once per block);
//   * phase A, a warp per 16 query rows: S = qs k^T on mma.sync m16n8k16
//     (bf16 products, fp32 sums), its softmax, and p = bf16(exp / sum) into
//     a shared p tile; dp = g v^T on mma.sync; rowsum(dp p) from the
//     registers (not FlashAttention's rowsum(dO o), which would hold the
//     LePE and the bf16 output: not the function JAX differentiates); ds =
//     bf16(p (dp - rowsum)) into a shared ds tile and, packed straight from
//     the registers as A fragments, dq = (ds k) * scale on mma.sync, staged
//     to 16-byte stores. Past 128 tokens the keys come in two chunks and S
//     and dp are recomputed per pass, and the queries in two chunks of p and
//     ds;
//   * phase B, after one barrier, a warp per 16 keys: dv = p^T g and dk =
//     ds^T qs on mma.sync, their A fragments from the p and ds tiles by
//     ldmatrix.trans, summed over the query rows in order (no atomics, so
//     the bits repeat); dv's transposed LePE stencil of g is added in fp32
//     before its one cast;
//   * dw9 and dwb: the TPU kernel adds them across grid steps that run in
//     order. CUDA blocks run in no order, so thread (tg, cp) of a block sums
//     the 10 quantities (9 taps, the bias) of channels 2 cp and 2 cp + 1
//     over tokens tg, tg + NG, ... of each stripe, stripes in the block's
//     order; at the end the block adds its threads' sums over tg in order
//     into a partial of its own, and a second kernel adds the blocks'
//     partials in a fixed order. The number of blocks per head depends on
//     the shapes alone, so the result is the same on every run. Taps whose
//     source lies outside every stripe (the dy != 0 taps of ws = 1) add no
//     term and come out exactly 0, as the TPU kernel skips them.
// Measured at ga_cswin_tiny's B=128 path shapes (chip_smoke.py phase 11;
// NVIDIA H100 80GB HBM3, 700.00 W): 0.0834 ms a launch at stage 3 by CUDA
// events around the wrapper (0.0795 ms of device time, both kernels, by
// the profiler), 0.1475 at the stage-5 block, 0.1124 at a gram layer:
// 2.460 ms per train step (device 2.182) against a byte bound of 0.359, the
// autograd backward of the SDPA + depthwise-conv composition's 7.48, and
// the CUDA-core design's 14.55 before it (kernel_variants.py, in turns). At
// T = 98 the instance takes 128 registers, none spilled: with 97 KB of
// shared memory a block, two blocks of 7 warps on an SM. What is left above
// the bound: the same latency as the forward's with two barriers a stripe
// and no copy in flight during the products (one buffer), the weight
// gradients' terms (10 x D per token), and the wrapper's host time.
//
// fp32: the CUDA-core kernel (`stripe_attn_bwd_kernel`): TF32 products would
// not keep the fp32 function's digits. A block of 8 warps owns one head; a
// warp takes a query row (lanes own keys for p, dp and ds, then channels for
// dq); p and ds of a chunk of query rows go to shared memory, and each warp
// adds the chunk into the dk and dv rows it owns (fp32, in shared memory);
// dw9 and dwb as the bf16 kernel's, with thread (warp, lane) owning
// quantities `warp` and `warp + 8` of channel `lane`. Every rounding to the
// operand type is gone, as the TPU kernel runs fp32 operands.

#include <type_traits>

#include "stripe_attn_common.cuh"

namespace {

using namespace imt_sa;

// ---------------------------------------------------------------- fp32

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLdf = 33;            // fp32 row stride of the dk / dv accumulators
constexpr int kQuantities = kTaps + 1;  // dw9's 9 taps and dwb
constexpr int kBlocksTarget = 528;  // blocks per launch over all heads: 4 per SM of 132

// Shared-memory plan, identical on host and device: the q, k, v, g slices
// (of E), the dk and dv accumulators (fp32), the chunk's p and E(ds) (of E,
// R rows of 32*NJ).
struct Layout {
  size_t q, k, v, g, dk, dv, pc, dsc, total;
};

template <typename E>
__host__ __device__ inline Layout make_layout(int T, int NJ, int R) {
  Layout L;
  const size_t slice = size_t(T) * Slot<E>::kLdw * 4, facc = size_t(T) * kLdf * 4;
  const size_t chunk = size_t(R) * 32 * NJ * sizeof(E);
  L.q = 0;
  L.k = L.q + slice;
  L.v = L.k + slice;
  L.g = L.v + slice;
  L.dk = L.g + slice;
  L.dv = L.dk + facc;
  L.pc = L.dv + facc;
  L.dsc = L.pc + chunk;
  L.total = L.dsc + chunk;
  return L;
}

// Quantity qq of the weight gradients over one stripe, channel c: the bias's
// (qq = 9) sum of g, or tap qq's sum of v[a+dx][y+dy] * g[a][y] over the
// tokens whose source lies inside the stripe, tokens in order.
template <typename E>
__device__ __forceinline__ float stripe_dw(int qq, const uint32_t* Vs, const uint32_t* Gs,
                                           const Stripes& g, int c) {
  float sum = 0.f;
  if (qq == kTaps) {
    for (int t = 0; t < g.T; ++t) sum += elem<E>(Gs, t, c);
    return sum;
  }
  const int dx = qq / 3 - 1, dy = qq % 3 - 1;
  for (int a = 0; a < g.H; ++a) {
    const int aa = a + dx;
    if (aa < 0 || aa >= g.H) continue;
    for (int y = 0; y < g.ws; ++y) {
      const int yy = y + dy;
      if (yy < 0 || yy >= g.ws) continue;
      sum = fmaf(elem<E>(Vs, aa * g.ws + yy, c), elem<E>(Gs, a * g.ws + y, c), sum);
    }
  }
  return sum;
}

template <typename E, int NJ, int D>
__global__ void __launch_bounds__(kThreads)
stripe_attn_bwd_kernel(Operand<E> q, Operand<E> k, Operand<E> v, Operand<E> gout,
                       const float* __restrict__ w9, E* __restrict__ dq, E* __restrict__ dk,
                       E* __restrict__ dv, float* __restrict__ partials, Stripes g,
                       long long stripes, int R, float qscale, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout<E>(g.T, NJ, R);
  uint32_t* Qs = reinterpret_cast<uint32_t*>(smem + L.q);
  uint32_t* Ks = reinterpret_cast<uint32_t*>(smem + L.k);
  uint32_t* Vs = reinterpret_cast<uint32_t*>(smem + L.v);
  uint32_t* Gs = reinterpret_cast<uint32_t*>(smem + L.g);
  float* dKs = reinterpret_cast<float*>(smem + L.dk);
  float* dVs = reinterpret_cast<float*>(smem + L.dv);
  E* Pc = reinterpret_cast<E*>(smem + L.pc);
  E* DSc = reinterpret_cast<E*>(smem + L.dsc);
  const int T = g.T, TP = 32 * NJ;
  const int h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // lanes past D (D = 24) repeat channel D-1 and write nothing
  const int c = lane < D ? lane : D - 1;
  const int ch = h * D + c;
  float w[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) w[t] = w9[t * g.C + ch];
  const bool two = warp + kWarps < kQuantities;
  float acc0 = 0.f, acc1 = 0.f;  // quantities warp and warp + 8, channel c

  // Ownership, fixed for the whole launch: the dk / dv entries (j, lane) with
  // j = warp mod 8.
  for (int j = warp; j < T; j += kWarps) dKs[j * kLdf + lane] = dVs[j * kLdf + lane] = 0.f;

  for (long long s = blockIdx.x; s < stripes; s += gridDim.x) {
    load_stripe<E, D, true>(q, h * D, g, s, Qs, tid, kThreads, qscale);
    load_stripe<E, D, false>(k, h * D, g, s, Ks, tid, kThreads, 1.f);
    load_stripe<E, D, false>(v, h * D, g, s, Vs, tid, kThreads, 1.f);
    load_stripe<E, D, false>(gout, h * D, g, s, Gs, tid, kThreads, 1.f);
    __syncthreads();
    for (int r0 = 0; r0 < T; r0 += R) {
      const int rows = T - r0 < R ? T - r0 : R;
      // rows of the chunk: p, dp, ds per key; dq per channel
      for (int i = r0 + warp; i < r0 + rows; i += kWarps) {
        float r[D], p[NJ], ds[NJ];
        load_row<E, D>(Qs, i, r);
        softmax_row<E, NJ, D>(r, Ks, T, lane, p);
        load_row<E, D>(Gs, i, r);
        float rs = 0.f;
#pragma unroll
        for (int kk = 0; kk < NJ; ++kk) {
          const int j = kk * 32 + lane;
          ds[kk] = j < T ? dot_row<E, D>(r, Vs, j) : 0.f;  // dp
          rs = fmaf(ds[kk], p[kk], rs);
        }
        rs = warp_sum(rs);
        E* prow = Pc + (i - r0) * TP;
        E* dsrow = DSc + (i - r0) * TP;
#pragma unroll
        for (int kk = 0; kk < NJ; ++kk) {
          const int j = kk * 32 + lane;
          ds[kk] = Slot<E>::round(p[kk] * (ds[kk] - rs));
          prow[j] = Slot<E>::cast(p[kk]);
          dsrow[j] = Slot<E>::cast(ds[kk]);
        }
        const float dqv = imt_pa::mix_rows<E, NJ>(ds, Ks, T, c) * scale;
        if (lane < D) dq[stripe_pixel(g, s, i) * g.C + ch] = Slot<E>::cast(dqv);
      }
      __syncthreads();
      // dv[j] += sum_i p[i][j] g[i],  dk[j] += sum_i E(ds)[i][j] qs[i]
      for (int j = warp; j < T; j += kWarps) {
        float adv = 0.f, adk = 0.f;
        for (int ii = 0; ii < rows; ++ii) {
          adv = fmaf(to_f(Pc[ii * TP + j]), elem<E>(Gs, r0 + ii, c), adv);
          adk = fmaf(to_f(DSc[ii * TP + j]), elem<E>(Qs, r0 + ii, c), adk);
        }
        dVs[j * kLdf + lane] += adv;
        dKs[j * kLdf + lane] += adk;
      }
      __syncthreads();
    }
    acc0 += stripe_dw<E>(warp, Vs, Gs, g, c);
    if (two) acc1 += stripe_dw<E>(warp + kWarps, Vs, Gs, g, c);
    for (int j = warp; j < T; j += kWarps) {
      const int a = j / g.ws, y = j - a * g.ws;
      const float lepe = lepe_t_at<E>(Gs, a, y, g, c, w);
      if (lane < D) {
        const long long px = stripe_pixel(g, s, j) * g.C + ch;
        dk[px] = Slot<E>::cast(dKs[j * kLdf + lane]);
        dv[px] = Slot<E>::cast(dVs[j * kLdf + lane] + lepe);
      }
      dKs[j * kLdf + lane] = dVs[j * kLdf + lane] = 0.f;
    }
    __syncthreads();  // the next stripe's copies overwrite q, k, v and g
  }
  if (lane < D) {
    float* part = partials + (static_cast<size_t>(h) * gridDim.x + blockIdx.x) * kQuantities * D;
    part[warp * D + lane] = acc0;
    if (two) part[(warp + kWarps) * D + lane] = acc1;
  }
}

// dw9[t][h*D + c] (t < 9) and dwb[h*D + c] (t = 9) = sum over the blocks b of
// head h, in order, of partial[h][b][t][c].
__global__ void stripe_attn_dw_kernel(const float* __restrict__ partials, float* __restrict__ dw9,
                                      float* __restrict__ dwb, int blocks, int nh, int D, int C) {
  const int per_head = kQuantities * D;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nh * per_head) return;
  const int h = e / per_head, r = e - h * per_head;
  const int qq = r / D, c = r - qq * D;
  const float* p = partials + static_cast<size_t>(h) * blocks * per_head + r;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += p[static_cast<size_t>(b) * per_head];
  if (qq < kTaps)
    dw9[qq * C + h * D + c] = s;
  else
    dwb[h * D + c] = s;
}

// ---------------------------------------------------------------- bf16

// Shared-memory plan of a block of the tensor-core kernel, identical on host
// and device: the stripe's q, k, v, g (TP rows of kDS bf16 each); the query
// chunk's p and bf16(ds) (16*RQ rows of TP + 8 bf16 each), whose space also
// holds the weight-gradient partials of the block's threads at the end; a
// 16-row staging slice per warp; the head's taps (9 x D floats).
struct MmaLayout {
  size_t p, ds, stage, w, total;  // byte offsets; q, k, v, g start at 0
  int HP, NG;  // channel pairs, and groups of tokens, of the weight gradients' threads
};

__host__ __device__ inline MmaLayout mma_layout(int nkb, int D) {
  MmaLayout L;
  const int nw = mma_warps(nkb);
  const int rq = nkb < kChunk ? nkb : kChunk;  // query blocks of 16 per chunk of p and ds
  L.HP = D / 2;
  L.NG = nw * 32 / L.HP;
  const size_t slice = size_t(16) * nkb * kDS * sizeof(bf16);
  // rows of TP + 8 bf16: an odd number of 16-byte units, as kDS
  const size_t chunk = size_t(16) * rq * (16 * nkb + 8) * sizeof(bf16);
  const size_t dw = size_t(L.NG) * kQuantities * D * sizeof(float);
  L.p = 4 * slice;
  L.ds = L.p + chunk;
  L.stage = L.p + ((2 * chunk > dw ? 2 * chunk : dw) + 15) / 16 * 16;
  L.w = L.stage + size_t(nw) * 16 * kDS * sizeof(bf16);
  L.total = L.w + size_t(kTaps) * D * sizeof(float);
  return L;
}

// A thread holds, for tile t of its 16-row slice, the elements [g][2 t4 +
// 0, 1] and [g + 8][2 t4 + 0, 1] of that 16 x 8 tile (g = lane / 4, t4 =
// lane % 4), the m16n8 accumulator layout; phase A's slices are query rows,
// phase B's key rows.
template <int NKB>
__global__ void __launch_bounds__(mma_warps(NKB) * 32, NKB <= kChunk ? 2 : 1)
stripe_attn_bwd_mma(Operand<bf16> q, Operand<bf16> k, Operand<bf16> v, Operand<bf16> gout,
                    const float* __restrict__ w9, bf16* __restrict__ dq, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, float* __restrict__ partials, Stripes g,
                    long long stripes, float qscale, float scale) {
  constexpr int NW = mma_warps(NKB), kBlock = NW * 32, TP = 16 * NKB;
  constexpr int NCH = key_chunks(NKB), KS = (NKB + NW - 1) / NW;  // key slices per warp
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  const int D = g.C / g.nh, coff = blockIdx.y * D;
  const MmaLayout L = mma_layout(NKB, D);
  constexpr int RQ = NKB < kChunk ? NKB : kChunk, NQC = (NKB + RQ - 1) / RQ, TPS = TP + 8;
  static_assert(RQ <= NW, "phase A gives each warp at most one query slice of a chunk");
  bf16* Qs = reinterpret_cast<bf16*>(bwd_smem);
  bf16* Ks = Qs + TP * kDS;
  bf16* Vs = Ks + TP * kDS;
  bf16* Gs = Vs + TP * kDS;
  bf16* P = reinterpret_cast<bf16*>(bwd_smem + L.p);
  bf16* DSm = reinterpret_cast<bf16*>(bwd_smem + L.ds);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t4 = lane & 3;
  bf16* stage = reinterpret_cast<bf16*>(bwd_smem + L.stage) + warp * 16 * kDS;
  float* W = reinterpret_cast<float*>(bwd_smem + L.w);

  for (int i = tid; i < 4 * TP * kDS / 8; i += kBlock)
    reinterpret_cast<uint4*>(Qs)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int e = tid; e < kTaps * D; e += kBlock) {
    const int t = e / D, c = e - t * D;
    W[e] = w9[t * g.C + coff + c];
  }
  // the weight gradients: thread (tg, cp) sums quantities 0-9 of channels
  // 2 cp and 2 cp + 1 over tokens tg, tg + NG, ... of each stripe, stripes
  // in the block's order
  const int cp = tid % L.HP, tg = tid / L.HP;
  float acc[kQuantities][2];
#pragma unroll
  for (int i = 0; i < kQuantities; ++i) acc[i][0] = acc[i][1] = 0.f;
  __syncthreads();

  for (long long s = blockIdx.x; s < stripes; s += gridDim.x) {
    const long long base = stripe_base(g, s);
    copy_stripe(q, coff, D, g, base, Qs, tid, kBlock);
    copy_stripe(k, coff, D, g, base, Ks, tid, kBlock);
    copy_stripe(v, coff, D, g, base, Vs, tid, kBlock);
    copy_stripe(gout, coff, D, g, base, Gs, tid, kBlock);
    imt_mma::cp_async_commit();
    imt_mma::cp_async_wait_all();
    __syncthreads();
    float dka[KS][4][4], dva[KS][4][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[ks][t][e] = dva[ks][t][e] = 0.f;
#pragma unroll
    for (int qc = 0; qc < NQC; ++qc) {
      // phase A: the warp's 16 query rows of the chunk: p, dp, ds, dq
      const int qb = qc * RQ + warp;
      if (warp < RQ && qb < NKB) {
        const int m0 = 16 * qb;
        bf16* prow = P + 16 * warp * TPS;
        bf16* dsrow = DSm + 16 * warp * TPS;
        uint32_t a[2][4];
        load_rows<true>(a, Qs, m0, lane, qscale);
        float sc[2 * kChunk][4], mx[2], sum[2];
        softmax_stats<NKB>(Ks, a, g.T, lane, sc, mx, sum);
        const float rsum[2] = {1.f / sum[0], 1.f / sum[1]};
        // p = bf16(exp(s - max) / sum) into the chunk's p rows
#pragma unroll
        for (int kc = 0; kc < NCH; ++kc) {
          chunk_exp<NKB>(Ks, a, kc, g.T, lane, mx, sc);
#pragma unroll
          for (int t = 0; t < 2 * kChunk; ++t)
            if (2 * kc * kChunk + t < 2 * NKB) {
              const int col = 16 * kc * kChunk + 8 * t + 2 * t4;
              *reinterpret_cast<uint32_t*>(prow + gr * TPS + col) = imt_mma::pack_bf16(
                  div_by(sc[t][0], sum[0], rsum[0]), div_by(sc[t][1], sum[0], rsum[0]));
              *reinterpret_cast<uint32_t*>(prow + (gr + 8) * TPS + col) = imt_mma::pack_bf16(
                  div_by(sc[t][2], sum[1], rsum[1]), div_by(sc[t][3], sum[1], rsum[1]));
            }
        }
        __syncwarp();
        // dp = g v^T (into sc) and rowsum(dp p), p read back rounded
        load_rows<false>(a, Gs, m0, lane, 1.f);
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int kc = 0; kc < NCH; ++kc) {
          chunk_products<NKB>(Vs, a, kc, TP, lane, sc);
#pragma unroll
          for (int t = 0; t < 2 * kChunk; ++t)
            if (2 * kc * kChunk + t < 2 * NKB) {
              const int col = 16 * kc * kChunk + 8 * t + 2 * t4;
              const uint32_t p0 = *reinterpret_cast<const uint32_t*>(prow + gr * TPS + col);
              const uint32_t p1 = *reinterpret_cast<const uint32_t*>(prow + (gr + 8) * TPS + col);
              rs[0] = fmaf(sc[t][0], lo(p0), rs[0]);
              rs[0] = fmaf(sc[t][1], hi(p0), rs[0]);
              rs[1] = fmaf(sc[t][2], lo(p1), rs[1]);
              rs[1] = fmaf(sc[t][3], hi(p1), rs[1]);
            }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          rs[i] += __shfl_xor_sync(kFull, rs[i], 1);
          rs[i] += __shfl_xor_sync(kFull, rs[i], 2);
        }
        // ds = bf16(p (dp - rowsum)) into the chunk's ds rows and, as A
        // fragments, dq += ds k
        float dqa[4][4];
#pragma unroll
        for (int t = 0; t < 4; ++t) dqa[t][0] = dqa[t][1] = dqa[t][2] = dqa[t][3] = 0.f;
#pragma unroll
        for (int kc = 0; kc < NCH; ++kc) {
          if (NCH > 1) chunk_products<NKB>(Vs, a, kc, TP, lane, sc);
#pragma unroll
          for (int t2 = 0; t2 < kChunk; ++t2) {
            if (kc * kChunk + t2 < NKB) {
              uint32_t da[4];
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int t = 2 * t2 + h, col = 16 * (kc * kChunk + t2) + 8 * h + 2 * t4;
                const uint32_t p0 = *reinterpret_cast<const uint32_t*>(prow + gr * TPS + col);
                const uint32_t p1 =
                    *reinterpret_cast<const uint32_t*>(prow + (gr + 8) * TPS + col);
                da[2 * h] = imt_mma::pack_bf16(lo(p0) * (sc[t][0] - rs[0]),
                                               hi(p0) * (sc[t][1] - rs[0]));
                da[2 * h + 1] = imt_mma::pack_bf16(lo(p1) * (sc[t][2] - rs[1]),
                                                   hi(p1) * (sc[t][3] - rs[1]));
                *reinterpret_cast<uint32_t*>(dsrow + gr * TPS + col) = da[2 * h];
                *reinterpret_cast<uint32_t*>(dsrow + (gr + 8) * TPS + col) = da[2 * h + 1];
              }
              uint32_t kb[4][2];
              load_cols<false>(kb, Ks, 16 * (kc * kChunk + t2), lane, 1.f);
#pragma unroll
              for (int t = 0; t < 4; ++t) imt_mma::mma_bf16(dqa[t], da, kb[t][0], kb[t][1]);
            }
          }
        }
        store_slice(stage, dqa, scale, m0, D, coff, g, base, dq, lane);
      }
      __syncthreads();  // the chunk's p and ds rows are in
      // phase B: the warp's 16-key slices: dv += p^T g, dk += ds^T qs over
      // the chunk's query rows, in order
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int kb = warp + NW * ks;
        if (kb < NKB) {
#pragma unroll
          for (int j = 0; j < RQ; ++j) {
            const int qb = qc * RQ + j;
            if (qb < NKB) {
              const int off = (16 * j + (lane & 7) + 8 * (lane >> 4)) * TPS + 16 * kb +
                              8 * ((lane >> 3) & 1);
              uint32_t pa[4], da[4], gb[4][2], qb_[4][2];
              imt_mma::ldsm_x4_trans(pa, P + off);
              imt_mma::ldsm_x4_trans(da, DSm + off);
              load_cols<false>(gb, Gs, 16 * qb, lane, 1.f);
              load_cols<true>(qb_, Qs, 16 * qb, lane, qscale);
#pragma unroll
              for (int t = 0; t < 4; ++t) {
                imt_mma::mma_bf16(dva[ks][t], pa, gb[t][0], gb[t][1]);
                imt_mma::mma_bf16(dka[ks][t], da, qb_[t][0], qb_[t][1]);
              }
            }
          }
        }
      }
      if (qc + 1 < NQC) __syncthreads();  // the next chunk overwrites p and ds
    }
    // the weight gradients' terms of this stripe
    if (tg < L.NG) {
      for (int t = tg; t < g.T; t += L.NG) {
        const int a = t / g.ws, y = t - a * g.ws;
        const uint32_t gw = *reinterpret_cast<const uint32_t*>(Gs + t * kDS + 2 * cp);
        const float g0 = lo(gw), g1 = hi(gw);
        acc[kTaps][0] += g0;
        acc[kTaps][1] += g1;
#pragma unroll
        for (int tap = 0; tap < kTaps; ++tap) {
          const int aa = a + tap / 3 - 1, yy = y + tap % 3 - 1;
          if (aa < 0 || aa >= g.H || yy < 0 || yy >= g.ws) continue;
          const uint32_t vw = *reinterpret_cast<const uint32_t*>(Vs + (aa * g.ws + yy) * kDS + 2 * cp);
          acc[tap][0] = fmaf(lo(vw), g0, acc[tap][0]);
          acc[tap][1] = fmaf(hi(vw), g1, acc[tap][1]);
        }
      }
    }
    // dv (with the transposed stencil of g) and dk of the warp's key slices
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int kb = warp + NW * ks;
      if (kb < NKB) {
        add_lepe<true>(dva[ks], Gs, W, D, 16 * kb, g, lane);
        store_slice(stage, dva[ks], 1.f, 16 * kb, D, coff, g, base, dv, lane);
        store_slice(stage, dka[ks], 1.f, 16 * kb, D, coff, g, base, dk, lane);
      }
    }
    __syncthreads();  // the next stripe's copies overwrite q, k, v and g
  }
  // the block's partial: the threads' sums added over tg in order
  float* red = reinterpret_cast<float*>(bwd_smem + L.p);
  if (tg < L.NG) {
#pragma unroll
    for (int i = 0; i < kQuantities; ++i) {
      red[(tg * kQuantities + i) * D + 2 * cp] = acc[i][0];
      red[(tg * kQuantities + i) * D + 2 * cp + 1] = acc[i][1];
    }
  }
  __syncthreads();
  float* part = partials + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * kQuantities * D;
  for (int e = tid; e < kQuantities * D; e += kBlock) {
    float sum = 0.f;
    for (int i = 0; i < L.NG; ++i) sum += red[i * kQuantities * D + e];
    part[e] = sum;
  }
}

template <int NKB>
cudaError_t launch_mma(Operand<bf16> q, Operand<bf16> k, Operand<bf16> v, Operand<bf16> go,
                       const float* w9, bf16* dq, bf16* dk, bf16* dv, float* partials, float* dw9,
                       float* dwb, const Stripes& g, long long stripes, int blocks, float qscale,
                       float scale, cudaStream_t stream) {
  auto kern = stripe_attn_bwd_mma<NKB>;
  const int D = g.C / g.nh;
  const size_t bytes = mma_layout(NKB, D).total;
  static imt_mma::LaunchCache cache;  // the limit, once per device
  const cudaError_t ready = cache.prepare(reinterpret_cast<const void*>(kern), kMaxSmem,
                                          mma_warps(NKB) * 32, bytes);
  if (ready != cudaSuccess) return ready;
  kern<<<dim3(blocks, g.nh), mma_warps(NKB) * 32, bytes, stream>>>(
      q, k, v, go, w9, dq, dk, dv, partials, g, stripes, qscale, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int n = g.nh * kQuantities * D;
  stripe_attn_dw_kernel<<<(n + 255) / 256, 256, 0, stream>>>(partials, dw9, dwb, blocks, g.nh, D,
                                                             g.C);
  return cudaGetLastError();
}

// One instantiation per 16-token block of the padded stripe.
cudaError_t dispatch_mma(Operand<bf16> q, Operand<bf16> k, Operand<bf16> v, Operand<bf16> go,
                         const float* w9, bf16* dq, bf16* dk, bf16* dv, float* part, float* dw9,
                         float* dwb, const Stripes& g, long long stripes, int blocks,
                         float qscale, float scale, cudaStream_t st) {
  if (mma_layout(round16(g.T) / 16, g.C / g.nh).total > kMaxSmem) return cudaErrorInvalidValue;
  switch (round16(g.T) / 16) {
#define IMT_CASE(N)                                                                             \
  case N:                                                                                       \
    return launch_mma<N>(q, k, v, go, w9, dq, dk, dv, part, dw9, dwb, g, stripes, blocks, qscale, \
                         scale, st);
    IMT_CASE(1) IMT_CASE(2) IMT_CASE(3) IMT_CASE(4) IMT_CASE(5) IMT_CASE(6) IMT_CASE(7)
    IMT_CASE(8) IMT_CASE(9) IMT_CASE(10) IMT_CASE(11) IMT_CASE(12) IMT_CASE(13) IMT_CASE(14)
    IMT_CASE(15) IMT_CASE(16)
#undef IMT_CASE
    default: return cudaErrorInvalidValue;
  }
}

// Rows per chunk: the largest that fits in shared memory.
template <typename E>
bool plan(int T, int NJ, int* R) {
  const int full = (T + kWarps - 1) / kWarps * kWarps;
  const int sizes[] = {full, 64, 32, 16, 8};
  for (int r : sizes)
    if (r <= full && make_layout<E>(T, NJ, r).total <= kMaxSmem) {
      *R = r;
      return true;
    }
  return false;
}

template <typename E, int NJ, int D>
cudaError_t launch(Operand<E> q, Operand<E> k, Operand<E> v, Operand<E> go, const float* w9, E* dq,
                   E* dk, E* dv, float* partials, float* dw9, float* dwb, const Stripes& g,
                   long long stripes, int blocks, float qscale, float scale, cudaStream_t stream) {
  int R = 0;
  if (!plan<E>(g.T, NJ, &R)) return cudaErrorInvalidValue;
  const size_t smem = make_layout<E>(g.T, NJ, R).total;
  auto kern = stripe_attn_bwd_kernel<E, NJ, D>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<dim3(blocks, g.nh), kThreads, smem, stream>>>(q, k, v, go, w9, dq, dk, dv, partials, g,
                                                       stripes, R, qscale, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int n = g.nh * kQuantities * D;
  stripe_attn_dw_kernel<<<(n + 255) / 256, 256, 0, stream>>>(partials, dw9, dwb, blocks, g.nh, D,
                                                             g.C);
  return cudaGetLastError();
}

template <typename E, int D>
cudaError_t launch_d(Operand<E> q, Operand<E> k, Operand<E> v, Operand<E> go, const float* w9,
                     E* dq, E* dk, E* dv, float* part, float* dw9, float* dwb, const Stripes& g,
                     long long stripes, int blocks, float qscale, float scale, cudaStream_t st) {
  switch ((g.T + 31) / 32) {
#define IMT_CASE(NJ)                                                                       \
  case NJ:                                                                                 \
    return launch<E, NJ, D>(q, k, v, go, w9, dq, dk, dv, part, dw9, dwb, g, stripes, blocks, \
                         qscale, scale, st);
    IMT_CASE(1)
    IMT_CASE(2)
    IMT_CASE(3)
    IMT_CASE(4)
    IMT_CASE(5)
    IMT_CASE(6)
    IMT_CASE(7)
#undef IMT_CASE
    default:
      return launch<E, 8, D>(q, k, v, go, w9, dq, dk, dv, part, dw9, dwb, g, stripes, blocks,
                             qscale, scale, st);
  }
}

// Blocks per head for `stripes` stripes and nh heads: about kBlocksTarget
// blocks in all, at most one per stripe.
int blocks_for(long long stripes, int nh) {
  long long b = (kBlocksTarget + nh - 1) / nh;
  if (b > stripes) b = stripes;
  return static_cast<int>(b < 1 ? 1 : b);
}

// The C entries' body for operand type E; pixel strides are multiples of
// 16 bytes.
template <typename E>
int run(const void* q, long long ldq, const void* k, long long ldk, const void* v, long long ldv,
        const void* g, long long ldg, const void* w9, void* dq, void* dk, void* dv, void* partials,
        void* dw9, void* dwb, int B, int H, int W, int C, int nh, int ws, int blocks, float qscale,
        float scale, void* stream) {
  constexpr int kPer = Slot<E>::kPerVec;
  if (B <= 0 || H <= 0 || nh <= 0 || ws <= 0 || C % nh || W % ws || H * ws > kMaxT ||
      ldq % kPer || ldk % kPer || ldv % kPer || ldg % kPer || ldq < C || ldk < C || ldv < C ||
      ldg < C)
    return cudaErrorInvalidValue;
  const int D = C / nh;
  const Stripes geo = make_stripes(H, W, C, nh, ws);
  const long long stripes = static_cast<long long>(B) * geo.per_img;
  if (blocks != blocks_for(stripes, nh) || nh > 65535) return cudaErrorInvalidValue;
  const Operand<E> oq{static_cast<const E*>(q), ldq}, ok{static_cast<const E*>(k), ldk},
      ov{static_cast<const E*>(v), ldv}, og{static_cast<const E*>(g), ldg};
  const float* w = static_cast<const float*>(w9);
  E* a = static_cast<E*>(dq);
  E* b = static_cast<E*>(dk);
  E* c = static_cast<E*>(dv);
  float* part = static_cast<float*>(partials);
  float* d9 = static_cast<float*>(dw9);
  float* db = static_cast<float*>(dwb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != 32 && D != 24) return cudaErrorInvalidValue;
  if constexpr (std::is_same<E, bf16>::value) {
    return dispatch_mma(oq, ok, ov, og, w, a, b, c, part, d9, db, geo, stripes, blocks, qscale,
                        scale, st);
  } else {
    if (D == 32)
      return launch_d<E, 32>(oq, ok, ov, og, w, a, b, c, part, d9, db, geo, stripes, blocks,
                             qscale, scale, st);
    return launch_d<E, 24>(oq, ok, ov, og, w, a, b, c, part, d9, db, geo, stripes, blocks, qscale,
                           scale, st);
  }
}

}  // namespace

extern "C" {

// Blocks per head for `stripes` stripes and nh heads. The partials buffer
// holds nh * blocks * 10 * (C / nh) floats.
int imt_stripe_attn_bwd_blocks(long long stripes, int nh) { return blocks_for(stripes, nh); }

// q, k, v, g (B, H, W, *) bf16 with pixel strides ldq, ldk, ldv, ldg (as for
// imt_stripe_attn_fwd_bf16), w9 (9, C) fp32 -> dq, dk, dv (B, H, W, C) bf16
// (contiguous), dw9 (9, C) and dwb (C) fp32; partials is scratch of
// nh * blocks * 10 * (C / nh) floats, blocks from imt_stripe_attn_bwd_blocks.
// qscale is the softmax scale rounded to bf16 (q's), scale the fp32 one (dq's).
// Two launches on `stream`; returns the launch status (a cudaError_t; 0 is
// success).
int imt_stripe_attn_bwd_bf16(const void* q, long long ldq, const void* k, long long ldk,
                             const void* v, long long ldv, const void* g, long long ldg,
                             const void* w9, void* dq, void* dk, void* dv, void* partials,
                             void* dw9, void* dwb, int B, int H, int W, int C, int nh, int ws,
                             int blocks, float qscale, float scale, void* stream) {
  return run<bf16>(q, ldq, k, ldk, v, ldv, g, ldg, w9, dq, dk, dv, partials, dw9, dwb, B, H, W, C,
                   nh, ws, blocks, qscale, scale, stream);
}

// As imt_stripe_attn_bwd_bf16 with fp32 maps (pixel strides multiples of 4),
// cotangent and dq, dk, dv; qscale and scale are both the fp32 scale.
int imt_stripe_attn_bwd_f32(const void* q, long long ldq, const void* k, long long ldk,
                            const void* v, long long ldv, const void* g, long long ldg,
                            const void* w9, void* dq, void* dk, void* dv, void* partials,
                            void* dw9, void* dwb, int B, int H, int W, int C, int nh, int ws,
                            int blocks, float qscale, float scale, void* stream) {
  return run<float>(q, ldq, k, ldk, v, ldv, g, ldg, w9, dq, dk, dv, partials, dw9, dwb, B, H, W, C,
                    nh, ws, blocks, qscale, scale, stream);
}

const char* imt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
