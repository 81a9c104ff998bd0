// MaxViT partition attention, backward, for Hopper (sm_90a): per window and
// head, from the qkv map (B, H, W, 3C), the fp32 bias (nh, T, T) and the
// cotangent g (B, H, W, C), both of the map's type (bf16, or fp32 for an
// fp32 model),
//   p  = bf16(softmax(q k^T + bias[h]))        (recomputed, as the forward)
//   dv = p^T g,   dp = g v^T,   ds = p (dp - rowsum(dp p)),
//   dq = bf16(ds) k,   dk = bf16(ds)^T q,
// written as the (B, H, W, 3C) dqkv, and dbias[h] = sum over every window of
// the batch of the fp32 ds.
//
// Replaces the TPU kernel `_bwd_kernel` / `_bwd_pallas` in
// imagenet_models_tpu/ops/partition_attention.py (:185-229, :310-339), with
// its numerics: ds from the bf16-rounded p, ds rounded to bf16 for the two
// products that take it, every product exact in fp32 with fp32 sums, the
// unrounded ds summed into dbias. Every sum runs in a fixed order, so two
// runs give the same bits.
//
// What bounds it on the H100: bytes. Per token it reads 6C bytes of qkv and
// 2C of g and writes 6C of dqkv, against about 10*T*d flops per token and
// head (16 kflop at T = 49): some 35 flops per byte. Every byte moves once;
// the window's pixels are found by index arithmetic in the unpartitioned
// maps, and everything else stays on chip.
//
// dbias: the TPU kernel adds it across grid steps that run in order. CUDA
// blocks run in no order, so each block of one head sums its windows' ds
// into a partial of its own, every element owned by one thread, and a
// second kernel adds the blocks' partials in a fixed order. No atomics. The
// number of blocks per head depends on the shapes alone.
//
// bf16: tensor cores (`partition_attn_bwd_mma`), kernel 6's two-phase design
// (stripe_attn_bwd.cu) without its LePE and q scale, with the bias and
// dbias. A block of one warp per 16-row slice (4 at T = 49, at most 8) owns
// one head and walks a fixed set of windows; per window:
//   * cp.async copies the head's q, k, v and g rows into shared memory,
//     padded to TP = 16 NKB rows (zeros written once a block), each token's
//     pixel from the window's first pixel and a table of offsets (no
//     division per copy);
//   * phase A, a warp per 16 query rows: S = q k^T on mma.sync m16n8k16
//     (bf16 products, fp32 sums) plus the bias (-1e30 at the padded keys),
//     its softmax, and p = bf16(exp / sum) into a shared p tile; dp = g v^T
//     on mma.sync; rowsum(dp p) from the registers and the rounded p;
//     ds = p (dp - rowsum) added in fp32 into the thread's dbias
//     entries, then rounded into a shared ds tile and, packed straight from
//     the registers as A fragments, dq = ds k on mma.sync, staged to 16-byte
//     stores. Past 128 tokens the keys come in two chunks and S and dp are
//     recomputed per pass, and the queries in two chunks of p and ds;
//   * phase B, after one barrier, a warp per 16 keys: dv = p^T g and dk =
//     ds^T q on mma.sync, their A fragments from the p and ds tiles by
//     ldmatrix.trans, summed over the query rows in order; with one query
//     chunk the next window's k and v are copied in meanwhile (phase B does
//     not read them), its q and g after the window's last barrier;
//   * the bias and dbias: the fragment layout gives a thread the same (row,
//     key) entries of its slice in every window of its head. Up to 64
//     tokens (one slice a warp) it loads its bias terms once a block and
//     keeps them in registers, and adds its fp32 ds over the block's
//     windows, in order, into sums in registers that only it touches (32
//     floats each at T = 49): 2.39 against 3.32 ms per MaxViT train step
//     at B=128 on an H100 with the bias read through L1/L2 a window and
//     the sums in the partials buffer (scripts/kernel_variants.py). Past 64
//     tokens the bias is read through L1/L2 per window and the sums go to
//     the block's slice of the partials buffer.
// Measured at MaxViT's B=128 path shapes (chip_smoke.py phase 8; NVIDIA H100
// 80GB HBM3, 700.00 W): 2.376 ms per train step (2.266 of device time)
// against a byte bound of 0.913; the CUDA-core design before it 18.03 in
// turns, SDPA's backward (no dbias) 7.54. At T = 49 the instance takes 128
// registers with 60 bytes spilled, four blocks of 4 warps an SM.
//
// fp32: the CUDA-core kernel (`partition_attn_bwd_kernel`): TF32 products
// would not keep the fp32 function's digits. A block of 8 warps owns one
// head and walks a fixed set of windows; per window it copies the head's q,
// k, v and g rows into shared memory; a warp takes a query row (lanes own
// keys for p, dp and ds, then channels for dq, which it writes at once); p
// and ds of a chunk of query rows go to shared memory, and then each warp
// adds the chunk into the dk and dv rows it owns (fp32, in shared memory);
// the block's dbias partial is in shared memory when T x T fp32 fits beside
// the rest, else in its slice of the partials buffer.

#include <type_traits>

#include "partition_attn_common.cuh"

namespace {

using namespace imt_pa;
using namespace imt_mma;

// ---------------------------------------------------------------- fp32

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLdf = 33;            // fp32 row stride of the dk / dv accumulators
constexpr int kBlocksTarget = 528;  // blocks per launch over all heads: 4 per SM of 132

// Shared-memory plan, identical on host and device: the q, k, v, g slices
// (of E), the dk and dv accumulators (fp32), the chunk's p and E(ds) (of E,
// R rows of 32*NJ), and with `acc_in_smem` the block's dbias partial.
struct Layout {
  size_t q, k, v, g, dk, dv, pc, dsc, acc, total;
};

template <typename E>
__host__ __device__ inline Layout make_layout(int T, int NJ, int R, int acc_in_smem) {
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
  L.acc = L.dsc + chunk;
  L.total = L.acc + (acc_in_smem ? size_t(T) * T * 4 : 0);
  return L;
}

template <typename E, int NJ>
__global__ void __launch_bounds__(kThreads)
partition_attn_bwd_kernel(const E* __restrict__ qkv, const float* __restrict__ bias,
                          const E* __restrict__ gout, E* __restrict__ dqkv,
                          float* __restrict__ partials, Geometry g, long long windows, int R,
                          int acc_in_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout<E>(g.T, NJ, R, acc_in_smem);
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
  const int C3 = 3 * g.C;
  float* acc = acc_in_smem
                   ? reinterpret_cast<float*>(smem + L.acc)
                   : partials + (static_cast<size_t>(h) * gridDim.x + blockIdx.x) * T * T;
  const float* bh = bias + static_cast<size_t>(h) * T * T;

  // Ownership, fixed for the whole launch: thread (warp, lane) owns dbias
  // entries (i, j) with i = warp mod 8 and j = lane mod 32, and the dk / dv
  // entries (j, lane) with j = warp mod 8.
  for (int i = warp; i < T; i += kWarps)
    for (int j = lane; j < T; j += 32) acc[i * T + j] = 0.f;
  for (int j = warp; j < T; j += kWarps) dKs[j * kLdf + lane] = dVs[j * kLdf + lane] = 0.f;

  for (long long win = blockIdx.x; win < windows; win += gridDim.x) {
    load_slice(qkv, C3, h * kD, g, win, Qs, tid, kThreads);
    load_slice(qkv, C3, g.C + h * kD, g, win, Ks, tid, kThreads);
    load_slice(qkv, C3, 2 * g.C + h * kD, g, win, Vs, tid, kThreads);
    load_slice(gout, g.C, h * kD, g, win, Gs, tid, kThreads);
    __syncthreads();
    for (int r0 = 0; r0 < T; r0 += R) {
      const int rows = T - r0 < R ? T - r0 : R;
      // rows of the chunk: p, dp, ds per key; dq per channel
      for (int i = r0 + warp; i < r0 + rows; i += kWarps) {
        float r[kD], p[NJ], ds[NJ];
        load_row<E>(Qs, i, r);
        softmax_row<E, NJ>(r, Ks, bh + static_cast<size_t>(i) * T, T, lane, p);
        load_row<E>(Gs, i, r);
        float rs = 0.f;
#pragma unroll
        for (int k = 0; k < NJ; ++k) {
          const int j = k * 32 + lane;
          ds[k] = j < T ? dot_row<E>(r, Vs, j) : 0.f;  // dp
          rs = fmaf(ds[k], p[k], rs);
        }
        rs = warp_sum(rs);
        E* prow = Pc + (i - r0) * TP;
        E* dsrow = DSc + (i - r0) * TP;
#pragma unroll
        for (int k = 0; k < NJ; ++k) {
          const int j = k * 32 + lane;
          ds[k] = p[k] * (ds[k] - rs);
          if (j < T) acc[i * T + j] += ds[k];
          ds[k] = Slot<E>::round(ds[k]);
          prow[j] = Slot<E>::cast(p[k]);
          dsrow[j] = Slot<E>::cast(ds[k]);
        }
        const float dq = mix_rows<E, NJ>(ds, Ks, T, lane);
        dqkv[token_pixel(g, win, i) * C3 + h * kD + lane] = Slot<E>::cast(dq);
      }
      __syncthreads();
      // dv[j] += sum_i p[i][j] g[i],  dk[j] += sum_i E(ds)[i][j] q[i]
      for (int j = warp; j < T; j += kWarps) {
        float dv = 0.f, dk = 0.f;
        for (int ii = 0; ii < rows; ++ii) {
          dv = fmaf(to_f(Pc[ii * TP + j]), elem<E>(Gs, r0 + ii, lane), dv);
          dk = fmaf(to_f(DSc[ii * TP + j]), elem<E>(Qs, r0 + ii, lane), dk);
        }
        dVs[j * kLdf + lane] += dv;
        dKs[j * kLdf + lane] += dk;
      }
      __syncthreads();
    }
    for (int j = warp; j < T; j += kWarps) {
      E* row = dqkv + token_pixel(g, win, j) * C3 + h * kD + lane;
      row[g.C] = Slot<E>::cast(dKs[j * kLdf + lane]);
      row[2 * g.C] = Slot<E>::cast(dVs[j * kLdf + lane]);
      dKs[j * kLdf + lane] = dVs[j * kLdf + lane] = 0.f;
    }
  }
  if (acc_in_smem) {
    float* part = partials + (static_cast<size_t>(h) * gridDim.x + blockIdx.x) * T * T;
    for (int i = warp; i < T; i += kWarps)
      for (int j = lane; j < T; j += 32) part[i * T + j] = acc[i * T + j];
  }
}

// dbias[h][e] = sum over the blocks b of head h, in order, of partial[h][b][e].
__global__ void partition_attn_dbias_kernel(const float* __restrict__ partials,
                                            float* __restrict__ dbias, int blocks, int TT) {
  const int h = blockIdx.y;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= TT) return;
  const float* p = partials + static_cast<size_t>(h) * blocks * TT + e;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += p[static_cast<size_t>(b) * TT];
  dbias[static_cast<size_t>(h) * TT + e] = s;
}

// Rows per chunk and where the dbias partial lives: the partial in shared
// memory if any chunk size lets it fit, the largest chunk that fits.
template <typename E>
bool plan(int T, int NJ, int* R, int* acc_in_smem) {
  const int full = (T + kWarps - 1) / kWarps * kWarps;
  const int sizes[] = {full, 64, 32, 16, 8};
  for (int in_smem = 1; in_smem >= 0; --in_smem)
    for (int r : sizes)
      if (r <= full && make_layout<E>(T, NJ, r, in_smem).total <= kMaxSmem) {
        *R = r;
        *acc_in_smem = in_smem;
        return true;
      }
  return false;
}

template <typename E, int NJ>
cudaError_t launch(const E* qkv, const float* bias, const E* gout, E* dqkv,
                   float* partials, float* dbias, const Geometry& g, long long windows,
                   int blocks, cudaStream_t stream) {
  int R = 0, acc_in_smem = 0;
  if (!plan<E>(g.T, NJ, &R, &acc_in_smem)) return cudaErrorInvalidValue;
  const size_t smem = make_layout<E>(g.T, NJ, R, acc_in_smem).total;
  auto kern = partition_attn_bwd_kernel<E, NJ>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<dim3(blocks, g.nh), kThreads, smem, stream>>>(qkv, bias, gout, dqkv, partials, g,
                                                       windows, R, acc_in_smem);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int TT = g.T * g.T;
  partition_attn_dbias_kernel<<<dim3((TT + 255) / 256, g.nh), 256, 0, stream>>>(
      partials, dbias, blocks, TT);
  return cudaGetLastError();
}

// Blocks per head for `windows` windows and nh heads: about kBlocksTarget
// blocks in all, at most one per window.
int blocks_for(long long windows, int nh) {
  long long b = (kBlocksTarget + nh - 1) / nh;
  if (b > windows) b = windows;
  return static_cast<int>(b < 1 ? 1 : b);
}

// ---------------------------------------------------------------- bf16

// Shared-memory plan of a block of the tensor-core kernel, identical on host
// and device: the token offsets (TP ints); the window's q, k, v, g (TP rows
// of kDS bf16 each); the query chunk's p and bf16(ds) (16 RQ rows of TP + 8
// bf16 each, an odd number of 16-byte units as kDS); a 16-row staging slice
// per warp.
struct MmaLayout {
  size_t q, p, ds, stage, total;  // byte offsets; the token offsets start at 0
};

__host__ __device__ constexpr int query_blocks(int nkb) { return nkb < kChunk ? nkb : kChunk; }

__host__ __device__ inline MmaLayout mma_layout(int nkb) {
  MmaLayout L;
  const size_t tp = size_t(16) * nkb;
  const size_t chunk = 16 * size_t(query_blocks(nkb)) * (tp + 8) * sizeof(bf16);
  L.q = tp * sizeof(int);
  L.p = L.q + 4 * tp * kDS * sizeof(bf16);
  L.ds = L.p + chunk;
  L.stage = L.ds + chunk;
  L.total = L.stage + size_t(mma_warps(nkb)) * 16 * kDS * sizeof(bf16);
  return L;
}

// The copies of window w's operands into the tiles: q and g (kQG), k and v
// (kKV), as one commit group.
constexpr int kQG = 1, kKV = 2;

__device__ __forceinline__ void copy_operands(int which, const bf16* __restrict__ qkv,
                                              const bf16* __restrict__ gout, const Geometry& g,
                                              int h, int w, const int* tok, bf16* Qs, int TP,
                                              int tid, int nthreads) {
  const long long base = window_base(g, w);
  const int C3 = 3 * g.C;
  if (which & kQG) {
    copy_window(qkv, C3, h * kD, base, tok, g.T, Qs, tid, nthreads);
    copy_window(gout, g.C, h * kD, base, tok, g.T, Qs + 3 * TP * kDS, tid, nthreads);
  }
  if (which & kKV) {
    copy_window(qkv, C3, g.C + h * kD, base, tok, g.T, Qs + TP * kDS, tid, nthreads);
    copy_window(qkv, C3, 2 * g.C + h * kD, base, tok, g.T, Qs + 2 * TP * kDS, tid, nthreads);
  }
  cp_async_commit();
}

// A thread holds, for tile t of its 16-row slice, the elements [g][2 t4 +
// 0, 1] and [g + 8][2 t4 + 0, 1] of that 16 x 8 tile (g = lane / 4, t4 =
// lane % 4), the m16n8 accumulator layout; phase A's slices are query rows,
// phase B's key rows.
template <int NKB>
__global__ void __launch_bounds__(mma_warps(NKB) * 32, NKB <= 4 ? 16 / NKB : NKB <= kChunk ? 2 : 1)
partition_attn_bwd_mma(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                       const bf16* __restrict__ gout, bf16* __restrict__ dqkv,
                       float* __restrict__ partials, Geometry g, int windows) {
  constexpr int NW = mma_warps(NKB), kBlock = NW * 32, TP = 16 * NKB;
  constexpr int NCH = key_chunks(NKB), KS = (NKB + NW - 1) / NW;  // key slices per warp
  constexpr int RQ = query_blocks(NKB), NQC = (NKB + RQ - 1) / RQ, TPS = TP + 8;
  // up to 64 tokens (one slice a warp, one key chunk) the slice's bias terms
  // and dbias sums stay in registers across the block's windows
  constexpr bool kRegs = NKB <= 4;
  static_assert(RQ <= NW, "phase A gives each warp at most one query slice of a chunk");
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  const MmaLayout L = mma_layout(NKB);
  int* tok = reinterpret_cast<int*>(bwd_smem);
  bf16* Qs = reinterpret_cast<bf16*>(bwd_smem + L.q);
  const bf16* Ks = Qs + TP * kDS;
  const bf16* Vs = Ks + TP * kDS;
  const bf16* Gs = Vs + TP * kDS;
  bf16* P = reinterpret_cast<bf16*>(bwd_smem + L.p);
  bf16* DSm = reinterpret_cast<bf16*>(bwd_smem + L.ds);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t4 = lane & 3;
  bf16* stage = reinterpret_cast<bf16*>(bwd_smem + L.stage) + warp * 16 * kDS;
  const int h = blockIdx.y, T = g.T, C3 = 3 * g.C;
  const float* bh = bias + static_cast<size_t>(h) * T * T;
  float* part = partials + (static_cast<size_t>(h) * gridDim.x + blockIdx.x) * T * T;

  for (int i = tid; i < 4 * TP * kDS / 8; i += kBlock)
    reinterpret_cast<uint4*>(Qs)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int t = tid; t < T; t += kBlock) tok[t] = token_offset(g, t);
  if (!kRegs)
    for (int i = tid; i < T * T; i += kBlock) part[i] = 0.f;
  float dbacc[kRegs ? 2 * NKB : 1][4];
#pragma unroll
  for (int t = 0; t < (kRegs ? 2 * NKB : 1); ++t)
    dbacc[t][0] = dbacc[t][1] = dbacc[t][2] = dbacc[t][3] = 0.f;
  float bfr[2 * kChunk][4];
  if constexpr (kRegs) bias_frags<NKB>(bfr, bh, T, 16 * warp, lane);
  __syncthreads();

  int w = blockIdx.x;
  const int stride = gridDim.x;
  if (w < windows) copy_operands(kQG | kKV, qkv, gout, g, h, w, tok, Qs, TP, tid, kBlock);
  for (; w < windows; w += stride) {
    cp_async_wait_all();
    __syncthreads();  // window w has landed
    const long long base = window_base(g, w);
    const bool next = w + stride < windows;
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
        load_rows(a, Qs, m0, lane);
        auto scores = [&](int kc, float (&s)[2 * kChunk][4]) {
          slice_scores<NKB, kRegs>(Ks, a, kc, bfr, bh, T, m0, lane, s);
        };
        float sc[2 * kChunk][4], mx[2], sum[2];
        softmax_stats<NKB>(scores, sc, mx, sum);
        const float rsum[2] = {1.f / sum[0], 1.f / sum[1]};
        // p = bf16(exp(s - max) / sum) into the chunk's p rows
#pragma unroll
        for (int kc = 0; kc < NCH; ++kc) {
          chunk_exp<NKB>(scores, kc, mx, sc);
#pragma unroll
          for (int t = 0; t < 2 * kChunk; ++t)
            if (kc * kChunk + t / 2 < NKB) {
              const int col = 16 * kc * kChunk + 8 * t + 2 * t4;
              *reinterpret_cast<uint32_t*>(prow + gr * TPS + col) =
                  pack_bf16(div_by(sc[t][0], sum[0], rsum[0]), div_by(sc[t][1], sum[0], rsum[0]));
              *reinterpret_cast<uint32_t*>(prow + (gr + 8) * TPS + col) =
                  pack_bf16(div_by(sc[t][2], sum[1], rsum[1]), div_by(sc[t][3], sum[1], rsum[1]));
            }
        }
        __syncwarp();
        // dp = g v^T (into sc) and rowsum(dp p), p read back rounded
        load_rows(a, Gs, m0, lane);
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int kc = 0; kc < NCH; ++kc) {
          chunk_products<NKB>(Vs, a, kc, lane, sc);
#pragma unroll
          for (int t = 0; t < 2 * kChunk; ++t)
            if (kc * kChunk + t / 2 < NKB) {
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
        // ds = p (dp - rowsum): into the dbias sums, then bf16(ds) into the
        // chunk's ds rows and, as A fragments, dq += ds k
        float dqa[4][4];
#pragma unroll
        for (int t = 0; t < 4; ++t) dqa[t][0] = dqa[t][1] = dqa[t][2] = dqa[t][3] = 0.f;
#pragma unroll
        for (int kc = 0; kc < NCH; ++kc) {
          if (NCH > 1) chunk_products<NKB>(Vs, a, kc, lane, sc);
#pragma unroll
          for (int t2 = 0; t2 < kChunk; ++t2) {
            const int blk = kc * kChunk + t2;
            if (blk < NKB) {
              uint32_t da[4];
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int t = 2 * t2 + hh, col = 16 * blk + 8 * hh + 2 * t4;
                const uint32_t p0 = *reinterpret_cast<const uint32_t*>(prow + gr * TPS + col);
                const uint32_t p1 = *reinterpret_cast<const uint32_t*>(prow + (gr + 8) * TPS + col);
                const float ds[4] = {lo(p0) * (sc[t][0] - rs[0]), hi(p0) * (sc[t][1] - rs[0]),
                                     lo(p1) * (sc[t][2] - rs[1]), hi(p1) * (sc[t][3] - rs[1])};
                if constexpr (kRegs) {
#pragma unroll
                  for (int e = 0; e < 4; ++e) dbacc[t][e] += ds[e];
                } else {
#pragma unroll
                  for (int e = 0; e < 4; ++e) {
                    const int row = m0 + gr + 8 * (e >> 1), key = col + (e & 1);
                    if (row < T && key < T) part[row * T + key] += ds[e];
                  }
                }
                da[2 * hh] = pack_bf16(ds[0], ds[1]);
                da[2 * hh + 1] = pack_bf16(ds[2], ds[3]);
                *reinterpret_cast<uint32_t*>(dsrow + gr * TPS + col) = da[2 * hh];
                *reinterpret_cast<uint32_t*>(dsrow + (gr + 8) * TPS + col) = da[2 * hh + 1];
              }
              uint32_t kb[4][2];
              load_cols(kb, Ks, 16 * blk, lane);
#pragma unroll
              for (int t = 0; t < 4; ++t) mma_bf16(dqa[t], da, kb[t][0], kb[t][1]);
            }
          }
        }
        store_slice(stage, dqa, m0, T, base, tok, dqkv, C3, h * kD, lane);
      }
      __syncthreads();  // the chunk's p and ds rows are in
      // with one query chunk, k and v are free: the next window's come in
      // while phase B runs
      if (NQC == 1 && next)
        copy_operands(kKV, qkv, gout, g, h, w + stride, tok, Qs, TP, tid, kBlock);
      // phase B: the warp's 16-key slices: dv += p^T g, dk += ds^T q over
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
              uint32_t pa[4], da[4], gb[4][2], qf[4][2];
              ldsm_x4_trans(pa, P + off);
              ldsm_x4_trans(da, DSm + off);
              load_cols(gb, Gs, 16 * qb, lane);
              load_cols(qf, Qs, 16 * qb, lane);
#pragma unroll
              for (int t = 0; t < 4; ++t) {
                mma_bf16(dva[ks][t], pa, gb[t][0], gb[t][1]);
                mma_bf16(dka[ks][t], da, qf[t][0], qf[t][1]);
              }
            }
          }
        }
      }
      if (qc + 1 < NQC) __syncthreads();  // the next chunk overwrites p and ds
    }
    // dk and dv of the warp's key slices
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int kb = warp + NW * ks;
      if (kb < NKB) {
        store_slice(stage, dka[ks], 16 * kb, T, base, tok, dqkv, C3, g.C + h * kD, lane);
        store_slice(stage, dva[ks], 16 * kb, T, base, tok, dqkv, C3, 2 * g.C + h * kD, lane);
      }
    }
    __syncthreads();  // every warp is done with q, g (and k, v), p and ds
    if (next) copy_operands(NQC == 1 ? kQG : kQG | kKV, qkv, gout, g, h, w + stride, tok, Qs, TP,
                            tid, kBlock);
  }
  if constexpr (kRegs) {  // the block's partial: the sums of the warp's slice
#pragma unroll
    for (int t = 0; t < 2 * NKB; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * warp + gr + 8 * (e >> 1), key = 8 * t + 2 * t4 + (e & 1);
        if (row < T && key < T) part[row * T + key] = dbacc[t][e];
      }
  }
}

template <int NKB>
cudaError_t launch_mma(const bf16* qkv, const float* bias, const bf16* gout, bf16* dqkv,
                       float* partials, float* dbias, const Geometry& g, int windows, int blocks,
                       cudaStream_t stream) {
  auto kern = partition_attn_bwd_mma<NKB>;
  const size_t bytes = mma_layout(NKB).total;
  // the shared-memory limit is a per-device attribute: set once per device
  static imt_mma::LaunchCache cache;
  cudaError_t e = cache.prepare(reinterpret_cast<const void*>(kern), bytes,
                                mma_warps(NKB) * 32, bytes);
  if (e != cudaSuccess) return e;
  kern<<<dim3(blocks, g.nh), mma_warps(NKB) * 32, bytes, stream>>>(qkv, bias, gout, dqkv, partials,
                                                                  g, windows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int TT = g.T * g.T;
  partition_attn_dbias_kernel<<<dim3((TT + 255) / 256, g.nh), 256, 0, stream>>>(partials, dbias,
                                                                               blocks, TT);
  return cudaGetLastError();
}

// One instantiation per 16-token block of the padded window.
cudaError_t dispatch_mma(const bf16* qkv, const float* bias, const bf16* gout, bf16* dqkv,
                         float* part, float* dbias, const Geometry& g, int windows, int blocks,
                         cudaStream_t st) {
  switch ((g.T + 15) / 16) {
#define IMT_CASE(N) \
  case N: return launch_mma<N>(qkv, bias, gout, dqkv, part, dbias, g, windows, blocks, st);
    IMT_CASE(1) IMT_CASE(2) IMT_CASE(3) IMT_CASE(4) IMT_CASE(5) IMT_CASE(6) IMT_CASE(7)
    IMT_CASE(8) IMT_CASE(9) IMT_CASE(10) IMT_CASE(11) IMT_CASE(12) IMT_CASE(13) IMT_CASE(14)
    IMT_CASE(15) IMT_CASE(16)
#undef IMT_CASE
    default: return cudaErrorInvalidValue;
  }
}

template <typename E>
int run(const void* qkv, const void* bias, const void* g, void* dqkv, void* partials, void* dbias,
        int B, int H, int W, int C, int nh, int ph, int pw, int grid, int blocks, void* stream) {
  if (B <= 0 || nh <= 0 || ph <= 0 || pw <= 0 || C != kD * nh || H % ph || W % pw ||
      ph * pw > kMaxT)
    return cudaErrorInvalidValue;
  const Geometry geo = make_geometry(H, W, C, nh, ph, pw, grid);
  const long long windows = static_cast<long long>(B) * geo.wr * geo.wc;
  if (blocks != blocks_for(windows, nh) || nh > 65535 || windows > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const E* q = static_cast<const E*>(qkv);
  const float* b = static_cast<const float*>(bias);
  const E* go = static_cast<const E*>(g);
  E* d = static_cast<E*>(dqkv);
  float* part = static_cast<float*>(partials);
  float* db = static_cast<float*>(dbias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<E, bf16>::value) {
    return dispatch_mma(q, b, go, d, part, db, geo, static_cast<int>(windows), blocks, st);
  } else {
    switch ((geo.T + 31) / 32) {
      case 1: return launch<E, 1>(q, b, go, d, part, db, geo, windows, blocks, st);
      case 2: return launch<E, 2>(q, b, go, d, part, db, geo, windows, blocks, st);
      case 3: return launch<E, 3>(q, b, go, d, part, db, geo, windows, blocks, st);
      case 4: return launch<E, 4>(q, b, go, d, part, db, geo, windows, blocks, st);
      case 5: return launch<E, 5>(q, b, go, d, part, db, geo, windows, blocks, st);
      case 6: return launch<E, 6>(q, b, go, d, part, db, geo, windows, blocks, st);
      case 7: return launch<E, 7>(q, b, go, d, part, db, geo, windows, blocks, st);
      default: return launch<E, 8>(q, b, go, d, part, db, geo, windows, blocks, st);
    }
  }
}

}  // namespace

extern "C" {

// Blocks per head for `windows` windows and nh heads. The partials buffer
// holds nh * blocks * T * T floats.
int imt_partition_attn_bwd_blocks(long long windows, int nh) { return blocks_for(windows, nh); }

// qkv (B, H, W, 3C) bf16, bias (nh, T, T) fp32, g (B, H, W, C) bf16 ->
// dqkv (B, H, W, 3C) bf16 and dbias (nh, T, T) fp32; partials is scratch of
// nh * blocks * T * T floats, blocks from imt_partition_attn_bwd_blocks. All
// contiguous, qkv and g 16-byte aligned; C = 32 * nh. Two launches on
// `stream`; returns the launch status (a cudaError_t; 0 is success).
int imt_partition_attn_bwd_bf16(const void* qkv, const void* bias, const void* g, void* dqkv,
                                void* partials, void* dbias, int B, int H, int W, int C, int nh,
                                int ph, int pw, int grid, int blocks, void* stream) {
  return run<bf16>(qkv, bias, g, dqkv, partials, dbias, B, H, W, C, nh, ph, pw, grid, blocks,
                   stream);
}

// As imt_partition_attn_bwd_bf16 with an fp32 qkv map, cotangent and dqkv.
int imt_partition_attn_bwd_f32(const void* qkv, const void* bias, const void* g, void* dqkv,
                               void* partials, void* dbias, int B, int H, int W, int C, int nh,
                               int ph, int pw, int grid, int blocks, void* stream) {
  return run<float>(qkv, bias, g, dqkv, partials, dbias, B, H, W, C, nh, ph, pw, grid, blocks,
                    stream);
}

const char* imt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
