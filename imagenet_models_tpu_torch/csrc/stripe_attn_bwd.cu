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
// (31 kflop at T = 98): some 70 flops per byte. The design moves each of
// those bytes once and keeps everything else on chip:
//   * a block of 8 warps owns one head and walks over a fixed set of
//     stripes; per stripe it copies the head's q (scaled), k, v and g rows
//     into shared memory, reading the stripe's pixels from the unpartitioned
//     maps;
//   * a warp takes a query row (lanes own keys for p, dp and ds, then
//     channels for dq, which it writes at once); p and bf16(ds) of a chunk of
//     query rows go to shared memory, and then each warp adds the chunk into
//     the dk and dv rows it owns (fp32, in shared memory); the stripe's dk and
//     dv are written after its last chunk, dv with the transposed stencil of
//     g from the same shared copy;
//   * dw9 and dwb: the TPU kernel adds them across grid steps that run in
//     order. CUDA blocks run in no order, so thread (warp, lane) of a block
//     owns quantity `warp` (a tap, or the bias as quantity 9) and `warp + 8`
//     when below 10, for channel `lane`: it sums them over each stripe's
//     tokens in order and over the block's stripes in order, and writes a
//     partial of its own; a second kernel adds the blocks' partials in a
//     fixed order. No atomics: the result is the same on every run, and the
//     number of blocks per head depends on the shapes alone. Taps whose
//     source lies outside every stripe (the dy != 0 taps of ws = 1) add no
//     term and come out exactly 0, as the TPU kernel skips them.
// As the forward, this first version runs its products on the FMA units in
// fp32; tensor-core tiles are left for later work. The fp32 instance (fp32
// maps and cotangent, fp32 dq, dk, dv) is the same with every rounding to the
// operand type gone, as the TPU kernel runs fp32 operands.

#include "stripe_attn_common.cuh"

namespace {

using namespace imt_sa;

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
  if (D == 32)
    return launch_d<E, 32>(oq, ok, ov, og, w, a, b, c, part, d9, db, geo, stripes, blocks, qscale,
                           scale, st);
  if (D == 24)
    return launch_d<E, 24>(oq, ok, ov, og, w, a, b, c, part, d9, db, geo, stripes, blocks, qscale,
                           scale, st);
  return cudaErrorInvalidValue;
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
