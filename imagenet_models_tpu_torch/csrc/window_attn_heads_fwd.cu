// Fused window attention with a per-head shared bias, forward, for Hopper
// (sm_90a): per window w and head h,
//   out[w, h] = softmax(q[w, h] k[w, h]^T + bias[h]) v[w, h],
// over contiguous (BW, H, n, d) q, k, v (q already scaled) in bf16 or fp32,
// with one fp32 (H, n, n) bias shared by every window (MaxViT's relative
// position tables); out (BW, H, n, d) in the input dtype.
//
// Replaces the TPU kernel `fused_window_attention_heads` /
// `_attn_kernel_heads` in imagenet_models_tpu/ops/flash_attention.py
// (:125-167). Numerics (`_attn_body`, :37-52): scores from exact products of
// the input-dtype operands with fp32 sums, the bias added in fp32, the
// softmax in fp32 over the whole row (max, then exp(s - max) / sum), p
// rounded to the input dtype, p v with fp32 sums, one cast at the output.
//
// What bounds it on the H100: bytes. Per (window, head) it reads q, k, v and
// writes out, 4 n d elements (12.5 KB at MaxViT's n = 49, d = 32 in bf16),
// against 4 n^2 d flops, some 1% of the tensor cores' time for those bytes.
// The bias is never broadcast to the windows in device memory: as the JAX
// grid (bw // group, heads) does, a block stays on one head (blockIdx.y).
//
// bf16: tensor cores (`heads_mma_kernel`). A block of 4 warps stays on one
// head and walks many windows (a persistent grid of about one wave):
//   * it stages the head's bias in shared memory once, padded and with the
//     padded key columns at -1e30 (JAX's mask), where it fits (n <= 112;
//     wider windows, 144 and 256, read it through L2 with the mask applied
//     in registers);
//   * each window's q, k and v (each one contiguous block of n d elements)
//     arrive by 16-byte cp.async copies into one of two buffers while the
//     block computes the window before: one barrier per window. The window
//     is padded to a multiple of 16 rows and d to a multiple of 16 columns,
//     with zeros that are written once per block;
//   * a warp takes a 16-row slice of the window: the scores are
//     mma.sync m16n8k16 bf16 products (exact) with fp32 sums, the q
//     fragments from ldmatrix, the keys' from ldmatrix; the bias is added and
//     the row's max and sum are taken across the quad that shares a row; p
//     is normalised, rounded to bf16 and packed straight from the score
//     registers into the A fragments of p v, whose v fragments come from
//     ldmatrix.trans. Each slice's output goes through shared memory to
//     16-byte stores, and the padded rows are never stored.
// Keys come in chunks of 64 (8 score tiles, 32 registers a thread). A window
// of at most 64 keys keeps its scores in registers from the max to p v; a
// wider one (144, 256) makes three passes over its key chunks: the row max,
// then the sum of exp(s - max), then p and p v, recomputing the scores each
// time. No online rescaling: p is normalised before it is rounded, as in the
// twin. The instance of the path (d = 32, n <= 64: heads_mma_kernel<2,
// true>) takes 116 registers, none spilled, so four blocks fit on an SM.
// Measured at MaxViT's stage 0 at B=256 (H100 80GB HBM3, 700 W;
// chip_smoke.py phase 21, PERF.md): 0.45 ms against a byte bound of 0.12 and
// SDPA's 1.65. What is left above the bound is instruction issue in the
// softmax (an exact fp32 exp and an IEEE division for each of a thread's 32
// scores, the bias loads, the quad shuffles) and the 15 padded rows of the
// last 16-row slice, which cost as much as real ones.
//
// fp32: the CUDA-core kernel (`window_attn_heads_fwd_kernel`, numerics and
// layout in window_attn_common.cuh, shared with kernel 12): TF32 products
// would not keep the fp32 function's digits. A block of 4 warps takes 2
// windows of one head; a warp takes two query rows at a time.

#include "mma_sync.cuh"
#include "window_attn_common.cuh"

namespace {

using namespace imt_wa;
using namespace imt_mma;

// ---------------------------------------------------------------- fp32

constexpr int kGroup = 2;  // windows of one head per block

template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
window_attn_heads_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const float* __restrict__ bias,
                             T* __restrict__ out, long long bw, int heads, int n, int d,
                             int staged) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nj = key_chunks(n);
  float* P = smem + warp * 2 * nj * 32;
  float* Ks = smem + kWarps * 2 * nj * 32;
  T* Qs = staged ? reinterpret_cast<T*>(Ks + n * key_stride(d)) : nullptr;
  T* Vs = staged ? Qs + n * d : nullptr;
  const int h = blockIdx.y;
  const float* bh = bias + static_cast<size_t>(h) * n * n;
  for (int g = 0; g < kGroup; ++g) {
    const long long w = static_cast<long long>(blockIdx.x) * kGroup + g;
    if (w >= bw) break;  // the same for every thread of the block
    const size_t base = (static_cast<size_t>(w) * heads + h) * n * d;
    if (g > 0) __syncthreads();  // every warp is done with the last window
    load_window<T>(q + base, k + base, v + base, n, d, Ks, Qs, Vs, tid);
    __syncthreads();
    const T* qw = staged ? Qs : q + base;
    const T* vw = staged ? Vs : v + base;
    for (int r = warp; 2 * r < n; r += kWarps) {  // rows 2r and 2r + 1
      const int a = 2 * r, b = min(a + 1, n - 1);
      attend_rows<T, DC>(qw + a * d, qw + b * d, Ks, vw, bh + a * n, bh + b * n, P,
                         out + base + static_cast<size_t>(a) * d,
                         b > a ? out + base + static_cast<size_t>(b) * d : nullptr, n, d, lane);
    }
  }
}

template <int DC>
cudaError_t launch_f32(const float* q, const float* k, const float* v, const float* bias,
                       float* out, long long bw, int heads, int n, int d, cudaStream_t stream) {
  const bool staged = stages_qv(n, d, sizeof(float));
  const size_t smem = smem_bytes(n, d, sizeof(float), staged);
  auto kern = window_attn_heads_fwd_kernel<float, DC>;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const unsigned blocks = static_cast<unsigned>((bw + kGroup - 1) / kGroup);
  kern<<<dim3(blocks, heads), kThreads, smem, stream>>>(q, k, v, bias, out, bw, heads, n, d,
                                                        staged);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v, const void* bias,
                         void* out, long long bw, int heads, int n, int d, cudaStream_t st) {
  const float* qq = static_cast<const float*>(q);
  const float* kk = static_cast<const float*>(k);
  const float* vv = static_cast<const float*>(v);
  const float* b = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  switch (channel_chunks(d)) {
    case 1: return launch_f32<1>(qq, kk, vv, b, o, bw, heads, n, d, st);
    case 2: return launch_f32<2>(qq, kk, vv, b, o, bw, heads, n, d, st);
    case 3: return launch_f32<3>(qq, kk, vv, b, o, bw, heads, n, d, st);
    default: return launch_f32<4>(qq, kk, vv, b, o, bw, heads, n, d, st);
  }
}

// ---------------------------------------------------------------- bf16

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kKeyChunk = 64;               // keys per pass: 8 score tiles of 8
constexpr size_t kBiasStageMax = 64 * 1024;  // the staged bias's largest size

inline __host__ __device__ int round16(int v) { return (v + 15) / 16 * 16; }

// Shared memory of a block, in bytes: the staged bias (np rows of np + 8
// floats), nbuf buffers of q, k, v (np rows of DS = dp + 8 bf16 each: odd
// multiples of 16 bytes, so the 8 rows of an ldmatrix hit 8 distinct groups
// of four banks) and a 16-row output slice per warp.
struct Layout {
  int np, dp, nbuf, bias_staged;
  size_t bytes;
};

inline Layout layout(int n, int d) {
  Layout L;
  L.np = round16(n);
  L.dp = round16(d);
  const size_t ds = static_cast<size_t>(L.dp) + 8;
  const size_t bias = static_cast<size_t>(L.np) * (L.np + 8) * sizeof(float);
  const size_t buf = 3 * static_cast<size_t>(L.np) * ds * sizeof(bf16);
  const size_t stage = static_cast<size_t>(kMmaWarps) * 16 * ds * sizeof(bf16);
  for (int nbuf = 2; nbuf >= 1; --nbuf) {
    for (int staged = bias <= kBiasStageMax ? 1 : 0; staged >= 0; --staged) {
      const size_t total = (staged ? bias : 0) + nbuf * buf + stage;
      if (total <= kMaxSmem) {
        L.nbuf = nbuf;
        L.bias_staged = staged;
        L.bytes = total;
        return L;
      }
    }
  }
  L.nbuf = 0;  // does not fit
  L.bias_staged = 0;
  L.bytes = 0;
  return L;
}

// A thread of a warp holds, for score tile t of its 16-row slice, the
// elements [g][2 t4 + 0, 1] (registers 0, 1) and [g + 8][2 t4 + 0, 1]
// (registers 2, 3) of that 16 x 8 tile (g = lane / 4, t4 = lane % 4), the
// m16n8 accumulator layout.
template <int DK, bool kOneChunk>
__global__ void __launch_bounds__(kMmaThreads, 4)
heads_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ bias,
                 bf16* __restrict__ out, long long bw, int heads, int n, int d, int np,
                 int nbuf, int bias_staged) {
  constexpr int DP = 16 * DK, DS = DP + 8;
  extern __shared__ __align__(16) float mma_smem[];  // one name per type in this file
  const int bstride = np + 8;
  float* bias_s = mma_smem;
  bf16* bufs = reinterpret_cast<bf16*>(mma_smem + (bias_staged ? np * bstride : 0));
  const int buf_elems = 3 * np * DS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  bf16* stage = bufs + nbuf * buf_elems + warp * 16 * DS;
  const int h = blockIdx.y;
  const float* bh = bias + static_cast<size_t>(h) * n * n;
  const int cpr = d / 8;  // 16-byte chunks of a row
  // key chunks: one (a compile-time loop) for windows of up to 64 tokens
  const int nkc = kOneChunk ? 1 : (np + kKeyChunk - 1) / kKeyChunk;

  // the padding stays zero: it is written once, and the copies fill only
  // rows < n and columns < d
  for (int i = tid; i < nbuf * buf_elems / 8; i += kMmaThreads)
    reinterpret_cast<uint4*>(bufs)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (bias_staged)
    for (int i = tid; i < np * np; i += kMmaThreads) {
      const int r = i / np, c = i - r * np;
      bias_s[r * bstride + c] = c >= n ? -1e30f : r < n ? __ldg(bh + r * n + c) : 0.f;
    }
  __syncthreads();

  auto issue = [&](long long w, int b) {  // window w's q, k, v into buffer b
    const size_t base = (static_cast<size_t>(w) * heads + h) * n * d;
    bf16* dst = bufs + b * buf_elems;
    const int per = n * cpr;
    for (int e = tid; e < 3 * per; e += kMmaThreads) {
      const int which = e / per, rem = e - which * per, row = rem / cpr, c = rem - row * cpr;
      const bf16* src = (which == 0 ? q : which == 1 ? k : v) + base + row * d + c * 8;
      cp_async16(dst + which * np * DS + row * DS + c * 8, src);
    }
    cp_async_commit();
  };

  // The scores of key chunk kc for the slice at row m0: s[t] is tile t (keys
  // 64 kc + 8 t ..), plus the bias, -1e30 on padded keys.
  auto scores = [&](const bf16* Ks, const uint32_t (&qa)[DK][4], int m0, int kc,
                    float (&s)[8][4]) {
#pragma unroll
    for (int t = 0; t < 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
    for (int t2 = 0; t2 < 4; ++t2) {
      const int key0 = kc * kKeyChunk + 16 * t2;
      if (key0 < np) {
#pragma unroll
        for (int kk = 0; kk < DK; ++kk) {
          uint32_t kb[4];
          ldsm_x4(kb, Ks + (key0 + (lane & 7) + 8 * (lane >> 4)) * DS + 16 * kk +
                          8 * ((lane >> 3) & 1));
          mma_bf16(s[2 * t2], qa[kk], kb[0], kb[1]);
          mma_bf16(s[2 * t2 + 1], qa[kk], kb[2], kb[3]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int col = kc * kKeyChunk + 8 * t + 2 * t4;
      if (col < np) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = m0 + g + 8 * (e >> 1), c = col + (e & 1);
          if (bias_staged)
            s[t][e] += bias_s[row * bstride + c];
          else
            s[t][e] += c >= n ? -1e30f : row < n ? __ldg(bh + row * n + c) : 0.f;
        }
      }
    }
  };

  long long w = blockIdx.x;
  const long long stride = gridDim.x;
  if (w < bw) issue(w, 0);
  for (int it = 0; w < bw; ++it, w += stride) {
    const int b = nbuf == 2 ? (it & 1) : 0;
    cp_async_wait_all();
    __syncthreads();  // window w has landed; every warp is done with the last one
    if (nbuf == 2 && w + stride < bw) issue(w + stride, b ^ 1);
    const bf16* Qs = bufs + b * buf_elems;
    const bf16* Ks = Qs + np * DS;
    const bf16* Vs = Ks + np * DS;
    const size_t base = (static_cast<size_t>(w) * heads + h) * n * d;
    for (int m0 = 16 * warp; m0 < np; m0 += 16 * kMmaWarps) {
      uint32_t qa[DK][4];
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        ldsm_x4(qa[kk], Qs + (m0 + (lane & 15)) * DS + 16 * kk + 8 * (lane >> 4));
      float s[8][4];
      // the row max (rows g and g + 8 of the slice), over every chunk
      float mx[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)};  // -inf
      for (int kc = 0; kc < nkc; ++kc) {
        scores(Ks, qa, m0, kc, s);
#pragma unroll
        for (int t = 0; t < 8; ++t)
          if (kc * kKeyChunk + 8 * t < np) {
            mx[0] = fmaxf(mx[0], fmaxf(s[t][0], s[t][1]));
            mx[1] = fmaxf(mx[1], fmaxf(s[t][2], s[t][3]));
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      }
      // the sum of exp(s - max)
      float sum[2] = {0.f, 0.f};
      for (int kc = 0; kc < nkc; ++kc) {
        if (nkc > 1) scores(Ks, qa, m0, kc, s);
#pragma unroll
        for (int t = 0; t < 8; ++t)
          if (kc * kKeyChunk + 8 * t < np) {
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
      // p = exp(s - max) / sum rounded to bf16, then o += p v
      float o[2 * DK][4];
#pragma unroll
      for (int t = 0; t < 2 * DK; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
      for (int kc = 0; kc < nkc; ++kc) {
        if (nkc > 1) {
          scores(Ks, qa, m0, kc, s);
#pragma unroll
          for (int t = 0; t < 8; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[t][e] = expf(s[t][e] - mx[e >> 1]);
        }
#pragma unroll
        for (int t2 = 0; t2 < 4; ++t2) {
          const int key0 = kc * kKeyChunk + 16 * t2;
          if (key0 < np) {
            uint32_t pa[4];
            pa[0] = pack_bf16(s[2 * t2][0] / sum[0], s[2 * t2][1] / sum[0]);
            pa[1] = pack_bf16(s[2 * t2][2] / sum[1], s[2 * t2][3] / sum[1]);
            pa[2] = pack_bf16(s[2 * t2 + 1][0] / sum[0], s[2 * t2 + 1][1] / sum[0]);
            pa[3] = pack_bf16(s[2 * t2 + 1][2] / sum[1], s[2 * t2 + 1][3] / sum[1]);
#pragma unroll
            for (int dt2 = 0; dt2 < DK; ++dt2) {
              uint32_t vb[4];
              ldsm_x4_trans(vb, Vs + (key0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * DS +
                                    16 * dt2 + 8 * (lane >> 4));
              mma_bf16(o[2 * dt2], pa, vb[0], vb[1]);
              mma_bf16(o[2 * dt2 + 1], pa, vb[2], vb[3]);
            }
          }
        }
      }
      // the slice through shared memory, then its rows < n as 16-byte stores
#pragma unroll
      for (int t = 0; t < 2 * DK; ++t) {
        const int col = 8 * t + 2 * t4;
        *reinterpret_cast<uint32_t*>(stage + g * DS + col) = pack_bf16(o[t][0], o[t][1]);
        *reinterpret_cast<uint32_t*>(stage + (g + 8) * DS + col) = pack_bf16(o[t][2], o[t][3]);
      }
      __syncwarp();
      for (int e = lane; e < 16 * cpr; e += 32) {
        const int r = e / cpr, c = e - r * cpr;
        if (m0 + r < n)
          *reinterpret_cast<uint4*>(out + base + static_cast<size_t>(m0 + r) * d + c * 8) =
              *reinterpret_cast<const uint4*>(stage + r * DS + c * 8);
      }
      __syncwarp();  // the slice buffer is the warp's next slice's
    }
    if (nbuf == 1) {
      __syncthreads();  // every warp is done with the only buffer
      if (w + stride < bw) issue(w + stride, 0);
    }
  }
}

template <int DK, bool kOneChunk>
cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v, const float* bias,
                        bf16* out, long long bw, int heads, int n, int d, const Layout& L,
                        cudaStream_t stream) {
  auto kern = heads_mma_kernel<DK, kOneChunk>;
  // the largest block any window asks for, once per device; then the blocks
  // that fit on one SM at this window's size, cached per device
  static imt_mma::LaunchCache cache;
  int per_sm = 1;
  const cudaError_t e = cache.prepare(reinterpret_cast<const void*>(kern), kMaxSmem,
                                      kMmaThreads, L.bytes, &per_sm);
  if (e != cudaSuccess) return e;
  // about one wave of resident blocks, spread over the heads
  long long per_head =
      (static_cast<long long>(imt_mma::device_sms()) * per_sm + heads - 1) / heads;
  if (per_head > bw) per_head = bw;
  if (per_head < 1) per_head = 1;
  kern<<<dim3(static_cast<unsigned>(per_head), heads), kMmaThreads, L.bytes, stream>>>(
      q, k, v, bias, out, bw, heads, n, d, L.np, L.nbuf, L.bias_staged);
  return cudaGetLastError();
}

// One instantiation per 16 channels of the padded head and per key chunking.
template <bool kOneChunk>
cudaError_t by_width(const bf16* q, const bf16* k, const bf16* v, const float* b, bf16* o,
                     long long bw, int heads, int n, int d, const Layout& L, cudaStream_t st) {
  switch (L.dp / 16) {
    case 1: return launch_bf16<1, kOneChunk>(q, k, v, b, o, bw, heads, n, d, L, st);
    case 2: return launch_bf16<2, kOneChunk>(q, k, v, b, o, bw, heads, n, d, L, st);
    case 3: return launch_bf16<3, kOneChunk>(q, k, v, b, o, bw, heads, n, d, L, st);
    case 4: return launch_bf16<4, kOneChunk>(q, k, v, b, o, bw, heads, n, d, L, st);
    case 5: return launch_bf16<5, kOneChunk>(q, k, v, b, o, bw, heads, n, d, L, st);
    case 6: return launch_bf16<6, kOneChunk>(q, k, v, b, o, bw, heads, n, d, L, st);
    case 7: return launch_bf16<7, kOneChunk>(q, k, v, b, o, bw, heads, n, d, L, st);
    default: return launch_bf16<8, kOneChunk>(q, k, v, b, o, bw, heads, n, d, L, st);
  }
}

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, const void* bias,
                          void* out, long long bw, int heads, int n, int d, cudaStream_t st) {
  const Layout L = layout(n, d);
  if (L.nbuf == 0) return cudaErrorInvalidValue;
  const bf16* qq = static_cast<const bf16*>(q);
  const bf16* kk = static_cast<const bf16*>(k);
  const bf16* vv = static_cast<const bf16*>(v);
  const float* b = static_cast<const float*>(bias);
  bf16* o = static_cast<bf16*>(out);
  return L.np <= kKeyChunk ? by_width<true>(qq, kk, vv, b, o, bw, heads, n, d, L, st)
                           : by_width<false>(qq, kk, vv, b, o, bw, heads, n, d, L, st);
}

}  // namespace

extern "C" {

// Returns 1 when windows of n tokens and heads of d channels are supported:
// 1 <= n <= 256, d a multiple of 8 from 8 to 128.
int imt_window_attn_heads_fwd_supported(int n, int d) { return supported(n, d) ? 1 : 0; }

// q, k, v, out (bw, heads, n, d) in bf16 (is_bf16 = 1) or fp32 (0); bias
// (heads, n, n) fp32. All contiguous, q, k, v and out 16-byte aligned.
// Launches on `stream` and returns the launch status (a cudaError_t; 0 is
// success).
int imt_window_attn_heads_fwd(const void* q, const void* k, const void* v, const void* bias,
                              void* out, long long bw, int heads, int n, int d, int is_bf16,
                              void* stream) {
  if (!supported(n, d) || bw <= 0 || heads <= 0 || heads > 65535 || bias == nullptr ||
      (bw + kGroup - 1) / kGroup > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_bf16(q, k, v, bias, out, bw, heads, n, d, st)
                 : dispatch_f32(q, k, v, bias, out, bw, heads, n, d, st);
}

const char* imt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
