// MaxViT partition attention, forward, for Hopper (sm_90a): per window of
// T = ph*pw tokens and per head h,
//   out = softmax(q k^T + bias[h]) v,
// read straight from the unpartitioned (B, H, W, 3C) qkv map (channel order
// [q | k | v], each [head, d]; q already scaled), written to the (B, H, W, C)
// output of the map's type: bf16, or fp32 for an fp32 model. Block windows
// ("block") or dilated grid windows ("grid"); T <= 256 tokens, head width
// d = 32.
//
// Replaces the TPU kernel `_fwd_kernel` / `_fwd_pallas` in
// imagenet_models_tpu/ops/partition_attention.py (:164-182, :286-307).
//
// Numerics (`_attend`, :107-115): scores q.k in fp32 from exact products of
// bf16 operands, + bias in fp32; softmax in fp32 as exp(s - max) / sum; p
// rounded to bf16; p.v in fp32 from exact products; one cast at the output.
// The fp32 instance is the same with every rounding to the operand type gone
// (fp32 products), as the TPU kernel runs an fp32 map.
//
// What bounds it on the H100: bytes. Per token and head it reads 3 x 64 bytes
// of qkv and writes 64 bytes, and does 4*T*d flops (about 6.3 kflop at T=49):
// 25 flops per byte, far below the card's ~295 flop/byte balance point. Every
// byte moves once: the window's pixels are found by index arithmetic in the
// unpartitioned map, so neither the partition nor the reverse is a copy
// through device memory.
//
// Both instances run on the CUDA cores, and sum every score and output as
// an fp32 FMA chain in the order of the first design (a warp per query row,
// `partition_attn_fwd_kernel`), so that the bf16 instance gives that
// design's bits. MaxViT's first train step holds the kernel path's
// gradients within 0.08 of the plain path's in each (stage, block
// parameter) group (chip_smoke.py phase 10): with these bits they lie
// 0.0241 apart; a tensor-core forward that took p exactly as kernel 4
// recomputes it (mma.sync scores, 1.05 ms a B=128 train step) put them
// 0.0871 apart, the same in three calls (NVIDIA H100 80GB HBM3, 700.00 W).
//
// bf16 (`partition_attn_fwd_rows`): persistent blocks, each on one head,
// walk a fixed set of windows; the next window's q, k and v come in by
// cp.async while a window is computed, and are turned into fp32 rows in
// shared memory (the head's bias too, up to 64 tokens). A warp takes 7 or 8
// query rows (a pass) with its lanes on the keys, so each broadcast read of
// q serves 4 FMAs of each of a lane's keys; the rows' softmax runs side by
// side; then a thread takes 4 rows and 4 channels of p v. Measured at
// MaxViT's B=128 path shapes (chip_smoke.py phase 8; NVIDIA H100 80GB HBM3,
// 700.00 W): 0.384, 0.201 and 0.105 ms a launch at stages 0-2, 3.39 ms per
// train step against a byte bound of 0.522: shared memory's broadcast reads
// and the issue of the exact softmax (an expf and an IEEE division per
// score) hold it. The first design took 6.97 ms per step (the row kernel,
// which stays as the fp32 instance: TF32 products would not keep the fp32
// function's digits).

#include <type_traits>

#include "partition_attn_common.cuh"

namespace {

using namespace imt_pa;
using namespace imt_mma;

// ---------------------------------------------------------------- fp32

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <typename E, int NJ>
__global__ void __launch_bounds__(kThreads)
partition_attn_fwd_kernel(const E* __restrict__ qkv, const float* __restrict__ bias,
                          E* __restrict__ out, Geometry g) {
  constexpr int kLdw = Slot<E>::kLdw;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* Qs = smem;
  uint32_t* Ks = Qs + g.T * kLdw;
  uint32_t* Vs = Ks + g.T * kLdw;
  const long long win = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int C3 = 3 * g.C;

  load_slice(qkv, C3, h * kD, g, win, Qs, tid, kThreads);
  load_slice(qkv, C3, g.C + h * kD, g, win, Ks, tid, kThreads);
  load_slice(qkv, C3, 2 * g.C + h * kD, g, win, Vs, tid, kThreads);
  __syncthreads();

  const float* bh = bias + static_cast<size_t>(h) * g.T * g.T;
  for (int i = warp; i < g.T; i += kWarps) {
    float r[kD], p[NJ];
    load_row<E>(Qs, i, r);
    softmax_row<E, NJ>(r, Ks, bh + static_cast<size_t>(i) * g.T, g.T, lane, p);
    const float o = mix_rows<E, NJ>(p, Vs, g.T, lane);
    out[token_pixel(g, win, i) * g.C + h * kD + lane] = Slot<E>::cast(o);
  }
}

template <typename E, int NJ>
cudaError_t launch(const E* qkv, const float* bias, E* out, const Geometry& g,
                   long long windows, cudaStream_t stream) {
  const size_t smem = size_t(3) * g.T * Slot<E>::kLdw * 4;
  auto kern = partition_attn_fwd_kernel<E, NJ>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kern<<<dim3(static_cast<unsigned>(windows), g.nh), kThreads, smem, stream>>>(qkv, bias, out, g);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16

constexpr int kMaxWarps = 8;
constexpr int kLdq = 36;  // fp32 row stride of q and k: 16-byte steps, and 8 lanes reading
                          // 8 neighbouring rows hit 32 banks
constexpr int kLdv = 32;  // fp32 row stride of v

// Query rows of a pass: 7 where that cuts T into whole passes and 8 does
// not (T = 49: seven passes of seven), else 8. A chunk is up to 8 passes,
// whose p rows are in shared memory together.
__host__ __device__ constexpr int pass_rows(int T) { return T % 8 != 0 && T % 7 == 0 ? 7 : 8; }
__host__ __device__ constexpr int passes_of(int T) { return (T + pass_rows(T) - 1) / pass_rows(T); }
// Warps of a block for T tokens: one per pass of a chunk.
inline int row_warps(int T) { return passes_of(T) < kMaxWarps ? passes_of(T) : kMaxWarps; }
// fp32 row stride of p: 1 past a multiple of 32, so that the rows 4 apart
// that a warp's p v tiles read fall on distinct banks
__host__ __device__ constexpr int p_stride(int T) { return (T + 31) / 32 * 32 + 1; }

// Shared-memory plan of a block of the row kernel, identical on host and
// device: the token offsets; the window's q, k and v as cp.async lands them
// (bf16, T rows of 32); q and k in fp32 rows of kLdq (q padded with zero rows
// to whole passes), v in rows of kLdv; a chunk's p rows (fp32); up to 64
// tokens, the head's bias (fp32, T x T).
struct RowLayout {
  size_t stage, q, k, v, p, bias, total;  // byte offsets; the token offsets start at 0
};

__host__ __device__ constexpr bool bias_in_smem(int T) { return T <= 64; }

__host__ __device__ inline RowLayout row_layout(int T) {
  RowLayout L;
  const size_t f = sizeof(float);
  const int R = pass_rows(T);
  L.stage = (size_t(T) * sizeof(int) + 15) / 16 * 16;
  L.q = L.stage + 3 * size_t(T) * kD * sizeof(bf16);
  L.k = L.q + size_t(passes_of(T)) * R * kLdq * f;
  L.v = L.k + size_t(T) * kLdq * f;
  L.p = L.v + size_t(T) * kLdv * f;
  L.bias = L.p + size_t(kMaxWarps * R + 3) / 4 * 4 * p_stride(T) * f;
  L.total = L.bias + (bias_in_smem(T) ? size_t(T) * T * f : 0);
  return L;
}

// The first design's row kernel (`partition_attn_fwd_kernel`, which stays
// for fp32) with its arithmetic kept element by element, so that a bf16 map
// gives its bits: the score of (i, j) an fp32 FMA chain over the channels in
// order plus the bias; the row's max, then expf(s - max) per key, summed as
// a lane's keys j = 32 k + lane in k order and then across the warp's lanes
// by xor shuffles (16, 8, 4, 2, 1); p = bf16(e / sum), the IEEE quotient;
// the output an FMA chain over the keys in order, cast to bf16 once. What
// changes is who does it. A block of one head walks the windows
// blockIdx.x, + gridDim.x, .., with the next window's q, k and v copied in
// by cp.async while it computes one, in fp32 rows. A warp takes R query rows
// at a time (a pass): each lane holds 4 channels of each of its keys in
// registers, so that one broadcast read of 4 channels of a q row serves 4
// FMAs of each key; then the rows' softmax side by side, into p rows in
// shared memory. Then, after a barrier, a thread takes a tile of 4 rows and
// 4 channels of p v, so each read of p or v serves 4 FMAs (tiles of 2 x 4
// cost more shared-memory reads, tiles of 4 x 8 leave more warps idle: both
// took longer on the card, as did bf16 rows of q, k or p, whose unpacking
// costs more issue than their reads save).
template <int NJ, int R>
__global__ void __launch_bounds__(kMaxWarps * 32, NJ <= 2 ? 4 : NJ <= 4 ? 2 : 1)
partition_attn_fwd_rows(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                        bf16* __restrict__ out, Geometry g, int windows) {
  constexpr int kChunkRows = kMaxWarps * R;
  extern __shared__ __align__(16) unsigned char row_smem[];
  const int T = g.T, nw = blockDim.x >> 5, nthreads = blockDim.x;
  const int passes = (T + R - 1) / R, PS = p_stride(T);
  const RowLayout L = row_layout(T);
  int* tok = reinterpret_cast<int*>(row_smem);
  bf16* stage = reinterpret_cast<bf16*>(row_smem + L.stage);
  float* Qf = reinterpret_cast<float*>(row_smem + L.q);
  float* Kf = reinterpret_cast<float*>(row_smem + L.k);
  float* Vf = reinterpret_cast<float*>(row_smem + L.v);
  float* P = reinterpret_cast<float*>(row_smem + L.p);
  // up to 64 tokens the head's bias is read once a block into shared
  // memory, past 64 through L1/L2 a window
  constexpr bool kSmemBias = NJ <= 2;
  float* Bs = reinterpret_cast<float*>(row_smem + L.bias);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y, C3 = 3 * g.C;
  const float* bh = bias + static_cast<size_t>(h) * T * T;

  // q's rows past T stay zero: the conversion writes rows < T only
  for (int i = tid; i < (passes * R - T) * kLdq; i += nthreads) Qf[T * kLdq + i] = 0.f;
  for (int t = tid; t < T; t += nthreads) tok[t] = token_offset(g, t);
  if (kSmemBias)
    for (int i = tid; i < T * T; i += nthreads) Bs[i] = __ldg(bh + i);
  const float* brow = kSmemBias ? Bs : bh;
  __syncthreads();

  auto issue = [&](int w) {  // window w's q, k, v into the staging rows, one commit group
    const bf16* from = qkv + window_base(g, w) * C3 + h * kD;
#pragma unroll
    for (int which = 0; which < 3; ++which)
      for (int e = tid; e < 4 * T; e += nthreads) {
        const int t = e >> 2, c = e & 3;
        cp_async16(stage + (which * T + t) * kD + 8 * c,
                   from + static_cast<long long>(tok[t]) * C3 + which * g.C + 8 * c);
      }
    cp_async_commit();
  };

  int w = blockIdx.x;
  const int stride = gridDim.x;
  if (w < windows) issue(w);
  for (; w < windows; w += stride) {
    cp_async_wait_all();
    __syncthreads();  // window w has landed; every thread is done with the last one
#pragma unroll
    for (int which = 0; which < 3; ++which) {
      float* to = which == 0 ? Qf : which == 1 ? Kf : Vf;
      const int ld = which == 2 ? kLdv : kLdq;
      for (int e = tid; e < 4 * T; e += nthreads) {
        const int t = e >> 2, c = e & 3;
        const uint4 u = *reinterpret_cast<const uint4*>(stage + (which * T + t) * kD + 8 * c);
        float4* row = reinterpret_cast<float4*>(to + t * ld + 8 * c);
        row[0] = make_float4(lo(u.x), hi(u.x), lo(u.y), hi(u.y));
        row[1] = make_float4(lo(u.z), hi(u.z), lo(u.w), hi(u.w));
      }
    }
    __syncthreads();  // the fp32 rows are in; the staging rows are free
    if (static_cast<long long>(w) + stride < windows) issue(w + stride);
    const long long base = window_base(g, w);
    for (int c0 = 0; c0 < T; c0 += kChunkRows) {
      const int chunk_passes = (c0 + kChunkRows < T ? kChunkRows : T - c0 + R - 1) / R;
      for (int cp = warp; cp < chunk_passes; cp += nw) {
        const int i0 = c0 + cp * R;
        // the scores of the pass's rows with the lane's keys j = 32 kg + lane
        // (-inf past T, as `softmax_row` has them)
        float s[R][NJ];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int kg = 0; kg < NJ; ++kg) s[r][kg] = 0.f;
#pragma unroll
        for (int c4 = 0; c4 < kD / 4; ++c4) {
          float4 k[NJ];
#pragma unroll
          for (int kg = 0; kg < NJ; ++kg) {
            const int j = 32 * kg + lane;
            k[kg] = *reinterpret_cast<const float4*>(Kf + (j < T ? j : T - 1) * kLdq + 4 * c4);
          }
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4 q = *reinterpret_cast<const float4*>(Qf + (i0 + r) * kLdq + 4 * c4);
#pragma unroll
            for (int kg = 0; kg < NJ; ++kg) {
              s[r][kg] = fmaf(q.x, k[kg].x, s[r][kg]);
              s[r][kg] = fmaf(q.y, k[kg].y, s[r][kg]);
              s[r][kg] = fmaf(q.z, k[kg].z, s[r][kg]);
              s[r][kg] = fmaf(q.w, k[kg].w, s[r][kg]);
            }
          }
        }
#pragma unroll
        for (int kg = 0; kg < NJ; ++kg) {
          const int j = 32 * kg + lane;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float* b = brow + (i0 + r) * T + j;  // read only at rows and keys below T
            s[r][kg] = j < T ? s[r][kg] + (i0 + r < T ? (kSmemBias ? *b : __ldg(b)) : 0.f)
                             : __int_as_float(0xff800000);
          }
        }
        // the rows' softmax (`softmax_row`, with `warp_max` and `warp_sum`),
        // the rows side by side, into the chunk's p rows; the rows past T
        // (q = 0) give finite values that are never stored
        float m[R], sum[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          m[r] = __int_as_float(0xff800000);  // -inf
#pragma unroll
          for (int kg = 0; kg < NJ; ++kg) m[r] = fmaxf(m[r], s[r][kg]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int r = 0; r < R; ++r) m[r] = fmaxf(m[r], __shfl_xor_sync(kFull, m[r], o));
#pragma unroll
        for (int r = 0; r < R; ++r) {
          sum[r] = 0.f;
#pragma unroll
          for (int kg = 0; kg < NJ; ++kg) {
            s[r][kg] = 32 * kg + lane < T ? expf(s[r][kg] - m[r]) : 0.f;
            sum[r] += s[r][kg];
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int r = 0; r < R; ++r) sum[r] += __shfl_xor_sync(kFull, sum[r], o);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int kg = 0; kg < NJ; ++kg)
            if (32 * kg + lane < T)
              P[(i0 - c0 + r) * PS + 32 * kg + lane] = round_bf16(s[r][kg] / sum[r]);
      }
      __syncthreads();  // the chunk's p rows are in
      // p v (`mix_rows`): a thread's tile of rows 4 ti .. 4 ti + 3 of the
      // chunk and channels 4 oq .. 4 oq + 3, each an FMA chain over the keys
      // in order
      const int rows = chunk_passes * R;
      for (int t = tid; t < (rows + 3) / 4 * 8; t += nthreads) {
        const int ti = t >> 3, oq = t & 7;
        const float* prow = P + 4 * ti * PS;
        const float* vcol = Vf + 4 * oq;
        float o[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) o[r][0] = o[r][1] = o[r][2] = o[r][3] = 0.f;
#pragma unroll 4
        for (int j = 0; j < T; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(vcol + j * kLdv);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float pj = prow[r * PS + j];
            o[r][0] = fmaf(pj, v.x, o[r][0]);
            o[r][1] = fmaf(pj, v.y, o[r][1]);
            o[r][2] = fmaf(pj, v.z, o[r][2]);
            o[r][3] = fmaf(pj, v.w, o[r][3]);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = c0 + 4 * ti + r;
          if (4 * ti + r < rows && i < T)
            *reinterpret_cast<uint2*>(out + (base + tok[i]) * g.C + h * kD + 4 * oq) =
                make_uint2(pack_bf16(o[r][0], o[r][1]), pack_bf16(o[r][2], o[r][3]));
        }
      }
      if (c0 + kChunkRows < T) __syncthreads();  // the next chunk rewrites the p rows
    }
  }
}

template <int NJ, int R>
cudaError_t launch_rows(const bf16* qkv, const float* bias, bf16* out, const Geometry& g,
                        int windows, cudaStream_t stream) {
  auto kern = partition_attn_fwd_rows<NJ, R>;
  const int threads = row_warps(g.T) * 32;
  const size_t bytes = row_layout(g.T).total;
  // the largest block any window asks for, once per device; then the blocks
  // that fit on one SM at this size, cached per device
  static imt_mma::LaunchCache cache;
  int per_sm = 1;
  const cudaError_t e = cache.prepare(reinterpret_cast<const void*>(kern), kMaxSmem, threads,
                                      bytes, &per_sm);
  if (e != cudaSuccess) return e;
  // about one wave of resident blocks over the heads, at most one a window
  long long blocks = (static_cast<long long>(imt_mma::device_sms()) * per_sm + g.nh - 1) / g.nh;
  if (blocks > windows) blocks = windows;
  kern<<<dim3(static_cast<unsigned>(blocks), g.nh), threads, bytes, stream>>>(qkv, bias, out, g,
                                                                             windows);
  return cudaGetLastError();
}

// One instantiation per 32 keys of a window and rows of a pass.
cudaError_t dispatch_rows(const bf16* qkv, const float* bias, bf16* out, const Geometry& g,
                          int windows, cudaStream_t st) {
  const bool seven = pass_rows(g.T) == 7;
  switch ((g.T + 31) / 32) {
#define IMT_CASE(N)                                                        \
  case N: return seven ? launch_rows<N, 7>(qkv, bias, out, g, windows, st) \
                       : launch_rows<N, 8>(qkv, bias, out, g, windows, st);
    IMT_CASE(1) IMT_CASE(2) IMT_CASE(3) IMT_CASE(4) IMT_CASE(5) IMT_CASE(6) IMT_CASE(7)
    IMT_CASE(8)
#undef IMT_CASE
    default: return cudaErrorInvalidValue;
  }
}

template <typename E>
int run(const void* qkv, const void* bias, void* out, int B, int H, int W, int C, int nh, int ph,
        int pw, int grid, void* stream) {
  if (B <= 0 || nh <= 0 || ph <= 0 || pw <= 0 || C != kD * nh || H % ph || W % pw ||
      ph * pw > kMaxT)
    return cudaErrorInvalidValue;
  const Geometry g = make_geometry(H, W, C, nh, ph, pw, grid);
  const long long windows = static_cast<long long>(B) * g.wr * g.wc;
  if (windows > 0x7fffffffLL || nh > 65535) return cudaErrorInvalidValue;
  const E* q = static_cast<const E*>(qkv);
  const float* b = static_cast<const float*>(bias);
  E* o = static_cast<E*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<E, bf16>::value) {
    return dispatch_rows(q, b, o, g, static_cast<int>(windows), st);
  } else {
    switch ((g.T + 31) / 32) {
      case 1: return launch<E, 1>(q, b, o, g, windows, st);
      case 2: return launch<E, 2>(q, b, o, g, windows, st);
      case 3: return launch<E, 3>(q, b, o, g, windows, st);
      case 4: return launch<E, 4>(q, b, o, g, windows, st);
      case 5: return launch<E, 5>(q, b, o, g, windows, st);
      case 6: return launch<E, 6>(q, b, o, g, windows, st);
      case 7: return launch<E, 7>(q, b, o, g, windows, st);
      default: return launch<E, 8>(q, b, o, g, windows, st);
    }
  }
}

}  // namespace

extern "C" {

// qkv (B, H, W, 3C) bf16, bias (nh, T, T) fp32, out (B, H, W, C) bf16; all
// contiguous, qkv and out 16-byte aligned; C = 32 * nh; H % ph == W % pw == 0; grid
// selects dilated grid windows. Launches on `stream` and returns the launch
// status (a cudaError_t; 0 is success).
int imt_partition_attn_fwd_bf16(const void* qkv, const void* bias, void* out, int B, int H,
                                int W, int C, int nh, int ph, int pw, int grid, void* stream) {
  return run<bf16>(qkv, bias, out, B, H, W, C, nh, ph, pw, grid, stream);
}

// As imt_partition_attn_fwd_bf16 with an fp32 qkv map and output.
int imt_partition_attn_fwd_f32(const void* qkv, const void* bias, void* out, int B, int H,
                               int W, int C, int nh, int ph, int pw, int grid, void* stream) {
  return run<float>(qkv, bias, out, B, H, W, C, nh, ph, pw, grid, stream);
}

const char* imt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
