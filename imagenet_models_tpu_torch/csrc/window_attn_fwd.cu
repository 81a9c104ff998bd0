// Fused window attention, forward, for Hopper (sm_90a): per window w of n
// tokens,
//   out[w] = softmax(q[w] k[w]^T [+ bias[w]]) v[w],
// over contiguous (BW, n, d) q, k, v (q already scaled) in bf16 or fp32, with
// an optional fp32 (BW, n, n) bias; out (BW, n, d) in the input dtype. BW
// counts windows times heads (CSWin's stripes, flattened by the caller).
//
// Replaces the TPU kernel `fused_window_attention` / `_attn_kernel` in
// imagenet_models_tpu/ops/flash_attention.py (:55-122). Its padding of n to a
// multiple of 8 and d to 128 and the window groups (`IMTPU_FLASH_GROUP`) are
// TPU tile geometry. Numerics (`_attn_body`, :37-52): scores from exact
// products of the input-dtype operands with fp32 sums, the bias added in
// fp32, the softmax in fp32 over the whole row (max, then exp(s - max) /
// sum), p rounded to the input dtype, p v with fp32 sums, one cast at the
// output. Every sum runs in a fixed order, so two runs give the same bits.
//
// What bounds it on the H100: bytes. Per (window, head) it reads q, k, v and
// writes out (4 n d elements) and does 4 n^2 d flops: at n = 98, d = 32 in
// bf16 that is 49 flops per byte, far below the card's ~295 flop/byte
// balance point; the (BW, n, n) bias, where there is one, adds 4 n^2 bytes.
// So each byte is moved once and nothing of size n x n touches device memory.
//
// bf16: tensor cores (`window_attn_fwd_mma`). A block walks many windows (a
// persistent grid of about one wave):
//   * each window's q, k and v (each one contiguous block of n d elements)
//     arrive by 16-byte cp.async copies into one of two buffers while the
//     block computes the window before: one barrier per window. The window
//     is padded to NP = 16 NKB rows (56 -> 64, 98 -> 112, 49 -> 64) and d to
//     a multiple of 16 channels (24 -> 32), with zeros written once per
//     block; the largest windows (256 x 128) take one buffer;
//   * a block has one warp per 16-row slice (7 at n = 98; past 128 tokens
//     at most 8, a warp then takes two slices);
//   * a warp's scores are mma.sync m16n8k16 bf16 products (exact) with fp32
//     sums, q's fragments from ldmatrix, the keys' from ldmatrix; a bias is
//     read through L2 straight into the fragment layout and added in fp32;
//     the padded keys are -1e30 (JAX's mask); the row's max and sum come
//     from the quad of lanes sharing a row; p is normalised (the IEEE
//     quotient, from one reciprocal a row), rounded to bf16 and packed
//     straight from the score registers into the A fragments of p v, whose
//     v fragments come from ldmatrix.trans. The whole row of scores stays in
//     registers up to 128 keys; longer windows take two key chunks of 128
//     and recompute the scores for the sum and for p, no online rescaling;
//   * a slice's output is rounded once and staged through the slice's own q
//     rows (which no other warp reads) to 16-byte stores; the padded rows
//     are never stored.
// Heads of up to 32 channels (every model caller) have one instance per
// 16-row block of the padded window (NKB 1-16), so the score tiles and
// their guards are compile-time; wider heads (40-128 channels) one per
// 16 channels and key chunking, with the window's blocks counted at run
// time.
//
// fp32: the CUDA-core kernel (`window_attn_fwd_kernel`, numerics and layout
// in window_attn_common.cuh, shared with kernel 13's fp32 instance): TF32
// products would not keep the fp32 function's digits. One block of 4 warps
// per window copies the window into shared memory (its keys as fp32 rows,
// and where they fit its q and v rows); a warp takes two query rows at a
// time: their scores stay in registers, their rounded probabilities go to
// two rows of shared memory for p.v, and each read of a key or of a row of v
// serves both.

#include "mma_sync.cuh"
#include "window_attn_common.cuh"

namespace {

using namespace imt_wa;
using namespace imt_mma;

// ---------------------------------------------------------------- fp32

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
window_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const float* __restrict__ bias, T* __restrict__ out, int n, int d,
                       int staged) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nj = key_chunks(n);
  float* P = smem + warp * 2 * nj * 32;
  float* Ks = smem + kWarps * 2 * nj * 32;
  T* Qs = staged ? reinterpret_cast<T*>(Ks + n * key_stride(d)) : nullptr;
  T* Vs = staged ? Qs + n * d : nullptr;
  const size_t base = static_cast<size_t>(blockIdx.x) * n * d;
  load_window<T>(q + base, k + base, v + base, n, d, Ks, Qs, Vs, tid);
  __syncthreads();
  const T* qw = staged ? Qs : q + base;
  const T* vw = staged ? Vs : v + base;
  const float* bw = bias == nullptr ? nullptr : bias + static_cast<size_t>(blockIdx.x) * n * n;
  for (int r = warp; 2 * r < n; r += kWarps) {  // rows 2r and 2r + 1
    const int a = 2 * r, b = min(a + 1, n - 1);
    attend_rows<T, DC>(qw + a * d, qw + b * d, Ks, vw, bw == nullptr ? nullptr : bw + a * n,
                       bw == nullptr ? nullptr : bw + b * n, P,
                       out + base + static_cast<size_t>(a) * d,
                       b > a ? out + base + static_cast<size_t>(b) * d : nullptr, n, d, lane);
  }
}

template <typename T, int DC>
cudaError_t launch(const T* q, const T* k, const T* v, const float* bias, T* out, long long bw,
                   int n, int d, cudaStream_t stream) {
  const bool staged = stages_qv(n, d, sizeof(T));
  const size_t smem = smem_bytes(n, d, sizeof(T), staged);
  auto kern = window_attn_fwd_kernel<T, DC>;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<static_cast<unsigned>(bw), kThreads, smem, stream>>>(q, k, v, bias, out, n, d,
                                                                 staged);
  return cudaGetLastError();
}

// One instantiation per channel chunks of the head.
cudaError_t dispatch_f32(const void* q, const void* k, const void* v, const void* bias,
                         void* out, long long bw, int n, int d, cudaStream_t st) {
  const float* qq = static_cast<const float*>(q);
  const float* kk = static_cast<const float*>(k);
  const float* vv = static_cast<const float*>(v);
  const float* b = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  switch (channel_chunks(d)) {
    case 1: return launch<float, 1>(qq, kk, vv, b, o, bw, n, d, st);
    case 2: return launch<float, 2>(qq, kk, vv, b, o, bw, n, d, st);
    case 3: return launch<float, 3>(qq, kk, vv, b, o, bw, n, d, st);
    default: return launch<float, 4>(qq, kk, vv, b, o, bw, n, d, st);
  }
}

// ---------------------------------------------------------------- bf16

constexpr int kChunk = 8;     // key blocks of 16 per chunk of scores in registers
constexpr int kMmaMaxWarps = 8;
constexpr float kMask = -1e30f;  // JAX's mask of padded keys

__host__ __device__ constexpr int blocks16(int v) { return (v + 15) / 16; }
// warps of a block for nkb blocks of 16 tokens: one per 16-row slice, at most 8
__host__ __device__ constexpr int mma_warps(int nkb) { return nkb < kMmaMaxWarps ? nkb : kMmaMaxWarps; }
__host__ __device__ constexpr int mma_chunks(int nkb) { return (nkb + kChunk - 1) / kChunk; }
// 16-column steps of a padded head: heads of up to 32 channels are padded to 32
inline int head_steps(int d) { return d <= 32 ? 2 : blocks16(d); }

// Shared memory of a block, in bytes, for nbuf buffers of a window's q, k
// and v: np rows of dp + 8 bf16 each (an odd multiple of 16 bytes, so the 8
// rows of an ldmatrix hit 8 distinct groups of four banks).
inline size_t mma_smem_bytes(int np, int dp, int nbuf) {
  return static_cast<size_t>(nbuf) * 3 * np * (dp + 8) * sizeof(bf16);
}

// The score tiles of key chunk kc for the 16-row slice at m0, whose q
// fragments are qa: s[2 t2 + h] is the n8 tile of keys 16 (kChunk kc + t2)
// + 8 h .., for the key blocks below nkb; exact products of bf16 values with
// fp32 sums, plus the window's bias (bw, null without one) at rows and keys
// below n, and kMask at keys from n on. Thread (g, t4) holds elements
// [g][2 t4 + 0, 1] (registers 0, 1) and [g + 8][2 t4 + 0, 1] (2, 3) of a
// tile, the m16n8 accumulator layout.
template <int DK, int NKB, bool kExact>
__device__ __forceinline__ void chunk_scores(const bf16* Ks, const uint32_t (&qa)[DK][4], int kc,
                                             int nkb, int n, const float* __restrict__ bw,
                                             int m0, int lane, float (&s)[2 * kChunk][4]) {
  constexpr int DS = 16 * DK + 8;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int t2 = 0; t2 < kChunk; ++t2) {
    const int blk = kc * kChunk + t2;
    if (blk < (kExact ? NKB : nkb)) {
      const int key0 = 16 * blk;
#pragma unroll
      for (int e = 0; e < 4; ++e) s[2 * t2][e] = s[2 * t2 + 1][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        uint32_t kb[4];
        ldsm_x4(kb, Ks + (key0 + (lane & 7) + 8 * (lane >> 4)) * DS + 16 * kk +
                        8 * ((lane >> 3) & 1));
        mma_bf16(s[2 * t2], qa[kk], kb[0], kb[1]);
        mma_bf16(s[2 * t2 + 1], qa[kk], kb[2], kb[3]);
      }
      if (bw != nullptr) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = m0 + g + 8 * (e >> 1), col = key0 + 8 * h + 2 * t4 + (e & 1);
            if (row < n && col < n) s[2 * t2 + h][e] += __ldg(bw + row * n + col);
          }
      }
      if (key0 + 16 > n) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (key0 + 8 * h + 2 * t4 + (e & 1) >= n) s[2 * t2 + h][e] = kMask;
      }
    }
  }
}

// DK: 16-column steps of the padded head. kExact: NKB is the window's
// blocks of 16 tokens; else the window has nkb = ceil(n / 16) <= NKB blocks
// (NKB 8 or 16: one or two key chunks) and a block nkb's warps.
template <int DK, int NKB, bool kExact>
__global__ void __launch_bounds__(mma_warps(NKB) * 32, kExact ? 16 / mma_warps(NKB) : 1)
window_attn_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ bias,
                    bf16* __restrict__ out, long long bw, int n, int d, int nbuf) {
  constexpr int DS = 16 * DK + 8, CPR = 2 * DK;  // row stride; 16-byte chunks of a padded row
  constexpr int NCH = mma_chunks(NKB);
  const int nkb = kExact ? NKB : blocks16(n);
  const int np = 16 * nkb, nw = blockDim.x >> 5, nthreads = blockDim.x;
  const int buf = 3 * np * DS;  // bf16 of one buffer
  const int cpr = d >> 3;       // 16-byte chunks of a row in device memory
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* bufs = reinterpret_cast<bf16*>(mma_smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  // the padding stays zero: it is written once, and the copies fill only
  // rows < n and channels < d (the staged outputs too)
  for (int i = tid; i < nbuf * buf / 8; i += nthreads)
    reinterpret_cast<uint4*>(bufs)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  auto issue = [&](long long w, int b) {  // window w's q, k, v into buffer b
    const size_t base = static_cast<size_t>(w) * n * d;
    bf16* dst = bufs + b * buf;
    const bf16* src[3] = {q + base, k + base, v + base};
#pragma unroll
    for (int which = 0; which < 3; ++which)
      for (int e = tid; e < n * CPR; e += nthreads) {
        const int row = e / CPR, c = e - row * CPR;
        if (c < cpr) cp_async16(dst + which * np * DS + row * DS + 8 * c, src[which] + row * d + 8 * c);
      }
    cp_async_commit();
  };

  long long w = blockIdx.x;
  const long long stride = gridDim.x;
  if (w < bw) issue(w, 0);
  for (int it = 0; w < bw; ++it, w += stride) {
    const int b = nbuf == 2 ? (it & 1) : 0;
    cp_async_wait_all();
    __syncthreads();  // window w has landed; every warp is done with the last one
    if (nbuf == 2 && w + stride < bw) issue(w + stride, b ^ 1);
    bf16* Qs = bufs + b * buf;
    const bf16* Ks = Qs + np * DS;
    const bf16* Vs = Ks + np * DS;
    const size_t base = static_cast<size_t>(w) * n * d;
    const float* bwin = bias == nullptr ? nullptr : bias + static_cast<size_t>(w) * n * n;
    for (int m0 = 16 * warp; m0 < np; m0 += 16 * nw) {
      uint32_t qa[DK][4];
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        ldsm_x4(qa[kk], Qs + (m0 + (lane & 15)) * DS + 16 * kk + 8 * (lane >> 4));
      // the row max (rows g and g + 8 of the slice) over every key, then the
      // sum of exp(s - max); the quad of lanes sharing a row combines its parts
      float s[2 * kChunk][4];
      float mx[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)};  // -inf
#pragma unroll
      for (int kc = 0; kc < NCH; ++kc) {
        chunk_scores<DK, NKB, kExact>(Ks, qa, kc, nkb, n, bwin, m0, lane, s);
#pragma unroll
        for (int t = 0; t < 2 * kChunk; ++t)
          if (kc * kChunk + t / 2 < nkb) {
            mx[0] = fmaxf(mx[0], fmaxf(s[t][0], s[t][1]));
            mx[1] = fmaxf(mx[1], fmaxf(s[t][2], s[t][3]));
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int kc = 0; kc < NCH; ++kc) {
        if (NCH > 1) chunk_scores<DK, NKB, kExact>(Ks, qa, kc, nkb, n, bwin, m0, lane, s);
#pragma unroll
        for (int t = 0; t < 2 * kChunk; ++t)
          if (kc * kChunk + t / 2 < nkb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[t][e] = expf(s[t][e] - mx[e >> 1]);
              sum[e >> 1] += s[t][e];
            }
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(kFull, sum[i], 1);
        sum[i] += __shfl_xor_sync(kFull, sum[i], 2);
      }
      const float rsum[2] = {1.f / sum[0], 1.f / sum[1]};
      // p = exp(s - max) / sum rounded to bf16, then o += p v
      float o[2 * DK][4];
#pragma unroll
      for (int t = 0; t < 2 * DK; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < NCH; ++kc) {
        if (NCH > 1) {
          chunk_scores<DK, NKB, kExact>(Ks, qa, kc, nkb, n, bwin, m0, lane, s);
#pragma unroll
          for (int t = 0; t < 2 * kChunk; ++t)
            if (kc * kChunk + t / 2 < nkb) {
#pragma unroll
              for (int e = 0; e < 4; ++e) s[t][e] = expf(s[t][e] - mx[e >> 1]);
            }
        }
#pragma unroll
        for (int t2 = 0; t2 < kChunk; ++t2) {
          const int blk = kc * kChunk + t2;
          if (blk < nkb) {
            uint32_t pa[4];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float* e = s[2 * t2 + h];
              pa[2 * h] = pack_bf16(div_by(e[0], sum[0], rsum[0]), div_by(e[1], sum[0], rsum[0]));
              pa[2 * h + 1] =
                  pack_bf16(div_by(e[2], sum[1], rsum[1]), div_by(e[3], sum[1], rsum[1]));
            }
#pragma unroll
            for (int dt2 = 0; dt2 < DK; ++dt2) {
              uint32_t vb[4];
              ldsm_x4_trans(vb, Vs + (16 * blk + (lane & 7) + 8 * ((lane >> 3) & 1)) * DS +
                                    16 * dt2 + 8 * (lane >> 4));
              mma_bf16(o[2 * dt2], pa, vb[0], vb[1]);
              mma_bf16(o[2 * dt2 + 1], pa, vb[2], vb[3]);
            }
          }
        }
      }
      // the slice through its own q rows (channels < d, so the padding stays
      // zero), then its rows < n as 16-byte stores
      bf16* stage = Qs + m0 * DS;
      __syncwarp();
#pragma unroll
      for (int t = 0; t < 2 * DK; ++t) {
        const int col = 8 * t + 2 * t4;
        if (col < d) {
          *reinterpret_cast<uint32_t*>(stage + g * DS + col) = pack_bf16(o[t][0], o[t][1]);
          *reinterpret_cast<uint32_t*>(stage + (g + 8) * DS + col) = pack_bf16(o[t][2], o[t][3]);
        }
      }
      __syncwarp();
      for (int e = lane; e < 16 * CPR; e += 32) {
        const int r = e / CPR, c = e - r * CPR;
        if (m0 + r < n && c < cpr)
          *reinterpret_cast<uint4*>(out + base + static_cast<size_t>(m0 + r) * d + 8 * c) =
              *reinterpret_cast<const uint4*>(stage + r * DS + 8 * c);
      }
    }
    if (nbuf == 1) {
      __syncthreads();  // every warp is done with the only buffer
      if (w + stride < bw) issue(w + stride, 0);
    }
  }
}

template <int DK, int NKB, bool kExact>
cudaError_t launch_mma(const bf16* q, const bf16* k, const bf16* v, const float* bias, bf16* out,
                       long long bw, int n, int d, cudaStream_t stream) {
  auto kern = window_attn_fwd_mma<DK, NKB, kExact>;
  const int nkb = blocks16(n), threads = mma_warps(nkb) * 32;
  const int nbuf = mma_smem_bytes(16 * nkb, 16 * DK, 2) <= kMaxSmem ? 2 : 1;
  const size_t bytes = mma_smem_bytes(16 * nkb, 16 * DK, nbuf);
  // the largest block any window asks for, once per device; then the blocks
  // that fit on one SM at this size, cached per device
  static imt_mma::LaunchCache cache;
  int per_sm = 1;
  const cudaError_t e = cache.prepare(reinterpret_cast<const void*>(kern), kMaxSmem, threads,
                                      bytes, &per_sm);
  if (e != cudaSuccess) return e;
  // about one wave of resident blocks
  long long blocks = static_cast<long long>(imt_mma::device_sms()) * per_sm;
  if (blocks > bw) blocks = bw;
  kern<<<static_cast<unsigned>(blocks), threads, bytes, stream>>>(q, k, v, bias, out, bw, n, d,
                                                                   nbuf);
  return cudaGetLastError();
}

// Heads of up to 32 channels: one instantiation per 16-token block of the
// padded window; wider heads: one per 16 channels and key chunking.
cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, const void* bias,
                          void* out, long long bw, int n, int d, cudaStream_t st) {
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  const float* b = static_cast<const float*>(bias);
  bf16* o = static_cast<bf16*>(out);
  const int dk = head_steps(d), nkb = blocks16(n);
  if (dk == 2) {
    switch (nkb) {
#define IMT_CASE(N) \
  case N: return launch_mma<2, N, true>(qq, kk, vv, b, o, bw, n, d, st);
      IMT_CASE(1) IMT_CASE(2) IMT_CASE(3) IMT_CASE(4) IMT_CASE(5) IMT_CASE(6) IMT_CASE(7)
      IMT_CASE(8) IMT_CASE(9) IMT_CASE(10) IMT_CASE(11) IMT_CASE(12) IMT_CASE(13) IMT_CASE(14)
      IMT_CASE(15) IMT_CASE(16)
#undef IMT_CASE
      default: return cudaErrorInvalidValue;
    }
  }
  const bool one = nkb <= kChunk;
  switch (dk) {
#define IMT_CASE(DK)                                                                      \
  case DK: return one ? launch_mma<DK, kChunk, false>(qq, kk, vv, b, o, bw, n, d, st) \
                      : launch_mma<DK, 2 * kChunk, false>(qq, kk, vv, b, o, bw, n, d, st);
    IMT_CASE(3) IMT_CASE(4) IMT_CASE(5) IMT_CASE(6) IMT_CASE(7) IMT_CASE(8)
#undef IMT_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns 1 when windows of n tokens and heads of d channels are supported:
// 1 <= n <= 256, d a multiple of 8 from 8 to 128.
int imt_window_attn_fwd_supported(int n, int d) { return supported(n, d) ? 1 : 0; }

// q, k, v, out (bw, n, d) in bf16 (is_bf16 = 1) or fp32 (0); bias (bw, n, n)
// fp32 or null. All contiguous, q, k, v and out 16-byte aligned. Launches on
// `stream` and returns the launch status (a cudaError_t; 0 is success).
int imt_window_attn_fwd(const void* q, const void* k, const void* v, const void* bias, void* out,
                        long long bw, int n, int d, int is_bf16, void* stream) {
  if (!supported(n, d) || bw <= 0 || bw > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_bf16(q, k, v, bias, out, bw, n, d, st)
                 : dispatch_f32(q, k, v, bias, out, bw, n, d, st);
}

const char* imt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
