// MaxViT partition attention, backward, for Hopper (sm_90a): per window and
// head, from the bf16 qkv map (B, H, W, 3C), the fp32 bias (nh, T, T) and the
// bf16 cotangent g (B, H, W, C),
//   p  = bf16(softmax(q k^T + bias[h]))        (recomputed, as the forward)
//   dv = p^T g,   dp = g v^T,   ds = p (dp - rowsum(dp p)),
//   dq = bf16(ds) k,   dk = bf16(ds)^T q,
// written as the bf16 (B, H, W, 3C) dqkv, and dbias[h] = sum over every
// window of the batch of the fp32 ds.
//
// Replaces the TPU kernel `_bwd_kernel` / `_bwd_pallas` in
// imagenet_models_tpu/ops/partition_attention.py (:185-229, :310-339), with
// its numerics: ds from the bf16-rounded p, ds rounded to bf16 for the two
// products that take it, every product exact in fp32 with fp32 sums, the
// unrounded ds summed into dbias.
//
// What bounds it on the H100: bytes. Per token it reads 6C bytes of qkv and
// 2C of g and writes 6C of dqkv, against about 10*T*d flops per token and
// head (16 kflop at T = 49): some 35 flops per byte. The design moves each of
// those bytes once and keeps everything else on chip:
//   * a block of 8 warps owns one head and walks over a fixed set of
//     windows; per window it copies the head's q, k, v and g rows into shared
//     memory, reading the windows' pixels from the unpartitioned maps;
//   * a warp takes a query row (lanes own keys for p, dp and ds, then
//     channels for dq, which it writes at once); p and bf16(ds) of a chunk of
//     query rows go to shared memory, and then each warp adds the chunk into
//     the dk and dv rows it owns (fp32, in shared memory). Chunks keep T = 256
//     within 227 KB; the window's dk and dv are written after its last chunk;
//   * dbias: the TPU kernel adds it across grid steps that run in order. CUDA
//     blocks run in no order, so each block sums its windows' ds into a
//     partial of its own (in shared memory when T x T fp32 fits beside the
//     rest, else in its own slice of the partials buffer), every element
//     touched by one thread only; a second kernel adds the blocks' partials
//     in a fixed order. No atomics: the result is the same on every run. The
//     number of blocks per head depends on the shapes alone.
// As the forward, this first version runs its five products on the FMA units
// in fp32 and takes about 19x its byte bound on an H100 (PERF.md):
// tensor-core tiles are left for later work. The fp32 instance (an fp32 map
// and cotangent, fp32 dqkv) is the same with every rounding to the operand
// type gone, as the TPU kernel runs fp32 operands.

#include "partition_attn_common.cuh"

namespace {

using namespace imt_pa;

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

template <typename E>
int run(const void* qkv, const void* bias, const void* g, void* dqkv, void* partials, void* dbias,
        int B, int H, int W, int C, int nh, int ph, int pw, int grid, int blocks, void* stream) {
  if (B <= 0 || nh <= 0 || ph <= 0 || pw <= 0 || C != kD * nh || H % ph || W % pw ||
      ph * pw > kMaxT)
    return cudaErrorInvalidValue;
  const Geometry geo = make_geometry(H, W, C, nh, ph, pw, grid);
  const long long windows = static_cast<long long>(B) * geo.wr * geo.wc;
  if (blocks != blocks_for(windows, nh) || nh > 65535)
    return cudaErrorInvalidValue;
  const E* q = static_cast<const E*>(qkv);
  const float* b = static_cast<const float*>(bias);
  const E* go = static_cast<const E*>(g);
  E* d = static_cast<E*>(dqkv);
  float* part = static_cast<float*>(partials);
  float* db = static_cast<float*>(dbias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
