// Native host-side image pipeline of imagenet_models_tpu_torch: a copy of
// imagenet_models_tpu/native/imtpu_loader.cpp (the port shares no code with
// the JAX package), with the same C interface and the same arithmetic, so
// both packages decode a batch to the same bytes.
//
// Fused JPEG decode + random-resized-crop + resample + flips per image, with
// an internal std::thread pool for batch decoding, called from Python via
// ctypes (the GIL is released for the duration of the call).
//
// Recipe fidelity (every knob of timm create_loader that affects pixels):
//  - interpolation: bilinear / bicubic / random-per-image (the recipes use
//    --train-interpolation random, i.e. timm's str_to_pil_interp coin flip)
//  - PIL-style ANTIALIASED separable resampling: the filter support scales
//    with the downscale factor (PIL Resample.c semantics), so crops match
//    the PIL path's pixel statistics, not torch's non-antialiased sampler
//  - RandomResizedCrop --scale / --ratio ranges
//  - --hflip / --vflip probabilities
//
// Decode uses libjpeg with DCT scaling (scale_denom) so large JPEGs are
// decoded directly to ~target resolution instead of full size (eval path).
//
// Built at first use by imagenet_models_tpu_torch/data/native.py into
// imagenet_models_tpu_torch/_build/:
//   g++ -O3 -march=native -std=c++17 -fPIC -shared -o <lib>.so \
//       imtpu_loader.cpp -ljpeg -lpthread

#include <cstdio>  // must precede jpeglib.h (it needs FILE)

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <csetjmp>
#include <random>
#include <thread>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

struct Image {
  std::vector<uint8_t> data;  // RGB, HWC
  int w = 0, h = 0;
};

// Decode a JPEG file to RGB. min_side: if >0, use DCT scaling so the decoded
// shorter side stays >= min_side (but as small as possible).
bool decode_jpeg(const char* path, int min_side, Image* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;

  if (min_side > 0) {
    int shorter = std::min<int>(cinfo.image_width, cinfo.image_height);
    // scale_num/8: pick the largest denominator keeping shorter*num/8 >= min_side
    for (int num = 1; num <= 8; ++num) {
      if (shorter * num / 8 >= min_side || num == 8) {
        cinfo.scale_num = num;
        cinfo.scale_denom = 8;
        break;
      }
    }
  }
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->data.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// ---- PIL-style separable resampling (Pillow Resample.c semantics) ----
//
// For each output pixel the sample center is (o + 0.5) * scale + offset; the
// filter is stretched by filterscale = max(scale, 1) (antialiasing on
// downscale) and the weights are normalized to sum 1. Bilinear support = 1,
// bicubic = Keys a=-0.5 with support 2 (PIL's BICUBIC).

inline float filt_bilinear(float x) {
  x = fabsf(x);
  return x < 1.f ? 1.f - x : 0.f;
}

inline float filt_bicubic(float x) {
  constexpr float a = -0.5f;
  x = fabsf(x);
  if (x < 1.f) return ((a + 2.f) * x - (a + 3.f)) * x * x + 1.f;
  if (x < 2.f) return (((x - 5.f) * x + 8.f) * x - 4.f) * a;
  return 0.f;
}

struct ResampleAxis {
  // per output index: first source tap + normalized weights
  std::vector<int> first;
  std::vector<float> weights;  // out_size * ksize
  int ksize = 0;
};

// Precompute taps mapping src range [src0, src0+src_len) -> out_size samples.
// bounds clamp to [bound_lo, bound_hi) (the crop box, PIL crops then resizes
// so taps clamp at the crop edge).
void make_axis(int src0, int src_len, int out_size, bool bicubic,
               int bound_lo, int bound_hi, ResampleAxis* ax) {
  const float scale = float(src_len) / out_size;
  const float filterscale = std::max(scale, 1.0f);
  const float support = (bicubic ? 2.0f : 1.0f) * filterscale;
  const int ksize = int(ceilf(support)) * 2 + 1;
  ax->ksize = ksize;
  ax->first.resize(out_size);
  ax->weights.assign(size_t(out_size) * ksize, 0.f);
  for (int o = 0; o < out_size; ++o) {
    const float center = src0 + (o + 0.5f) * scale;
    int xmin = int(center - support + 0.5f);
    int xmax = int(center + support + 0.5f);
    xmin = std::max(xmin, bound_lo);
    xmax = std::min(xmax, bound_hi);
    float* w = &ax->weights[size_t(o) * ksize];
    float total = 0.f;
    for (int x = xmin; x < xmax; ++x) {
      float v = bicubic ? filt_bicubic((x + 0.5f - center) / filterscale)
                        : filt_bilinear((x + 0.5f - center) / filterscale);
      w[x - xmin] = v;
      total += v;
    }
    if (total > 0.f)
      for (int k = 0; k < xmax - xmin; ++k) w[k] /= total;
    ax->first[o] = xmin;
  }
}

// Resample the crop box (cx, cy, cw, ch) of src into dst (size x size RGB),
// optional horizontal/vertical flips. Two separable float passes.
void resample_crop(const Image& src, int cx, int cy, int cw, int ch,
                   uint8_t* dst, int size, bool bicubic, bool hflip,
                   bool vflip) {
  ResampleAxis axx, axy;
  make_axis(cx, cw, size, bicubic, std::max(cx, 0), std::min(cx + cw, src.w), &axx);
  make_axis(cy, ch, size, bicubic, std::max(cy, 0), std::min(cy + ch, src.h), &axy);

  // horizontal pass over the crop's source rows -> (ch, size) float
  const int y_lo = std::max(cy, 0), y_hi = std::min(cy + ch, src.h);
  const int rows = y_hi - y_lo;
  std::vector<float> tmp(size_t(rows) * size * 3);
  for (int y = 0; y < rows; ++y) {
    const uint8_t* srow = &src.data[size_t(y_lo + y) * src.w * 3];
    float* trow = &tmp[size_t(y) * size * 3];
    for (int o = 0; o < size; ++o) {
      const float* w = &axx.weights[size_t(o) * axx.ksize];
      const int x0 = axx.first[o];
      float acc[3] = {0.f, 0.f, 0.f};
      const int kmax = std::min(axx.ksize, std::min(cx + cw, src.w) - x0);
      for (int k = 0; k < kmax; ++k) {
        const float wk = w[k];
        if (wk == 0.f) continue;
        const uint8_t* p = srow + size_t(x0 + k) * 3;
        acc[0] += wk * p[0];
        acc[1] += wk * p[1];
        acc[2] += wk * p[2];
      }
      trow[o * 3 + 0] = acc[0];
      trow[o * 3 + 1] = acc[1];
      trow[o * 3 + 2] = acc[2];
    }
  }

  // vertical pass -> dst with flips applied at write-out
  for (int o = 0; o < size; ++o) {
    const float* w = &axy.weights[size_t(o) * axy.ksize];
    const int y0 = axy.first[o];
    const int out_y = vflip ? (size - 1 - o) : o;
    uint8_t* drow = dst + size_t(out_y) * size * 3;
    const int kmax = std::min(axy.ksize, y_hi - y0);
    for (int ox = 0; ox < size; ++ox) {
      float acc[3] = {0.f, 0.f, 0.f};
      for (int k = 0; k < kmax; ++k) {
        const float wk = w[k];
        if (wk == 0.f) continue;
        const float* p = &tmp[(size_t(y0 - y_lo + k) * size + ox) * 3];
        acc[0] += wk * p[0];
        acc[1] += wk * p[1];
        acc[2] += wk * p[2];
      }
      const int out_x = hflip ? (size - 1 - ox) : ox;
      uint8_t* d = drow + size_t(out_x) * 3;
      for (int c = 0; c < 3; ++c)
        d[c] = uint8_t(std::min(255.f, std::max(0.f, acc[c] + 0.5f)));
    }
  }
}

// timm-style RandomResizedCrop rect with configurable scale/ratio, 10 tries.
void rrc_rect(int w, int h, uint64_t seed, float scale_min, float scale_max,
              float ratio_min, float ratio_max, int* cx, int* cy, int* cw,
              int* ch) {
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<float> uni(0.f, 1.f);
  const float area = float(w) * h;
  const float log_rmin = logf(ratio_min), log_rmax = logf(ratio_max);
  for (int i = 0; i < 10; ++i) {
    float target = area * (scale_min + uni(rng) * (scale_max - scale_min));
    float aspect = expf(log_rmin + uni(rng) * (log_rmax - log_rmin));
    int tw = int(roundf(sqrtf(target * aspect)));
    int th = int(roundf(sqrtf(target / aspect)));
    if (tw > 0 && tw <= w && th > 0 && th <= h) {
      *cx = int(uni(rng) * (w - tw + 1));
      *cy = int(uni(rng) * (h - th + 1));
      *cw = tw;
      *ch = th;
      return;
    }
  }
  // center-crop fallback (timm RandomResizedCrop fallback branch)
  float in_ratio = float(w) / h;
  int tw = w, th = h;
  if (in_ratio < ratio_min) th = int(roundf(w / ratio_min));
  else if (in_ratio > ratio_max) tw = int(roundf(h * ratio_max));
  *cx = (w - tw) / 2;
  *cy = (h - th) / 2;
  *cw = tw;
  *ch = th;
}

}  // namespace

extern "C" {

// Train-mode: decode + RandomResizedCrop(scale, ratio) + resample + flips.
// interp: 0 = bilinear, 1 = bicubic, 2 = random per-image (timm
// --train-interpolation random). hflip/vflip are probabilities in [0, 1].
// out: size*size*3 uint8. Returns 0 on success.
int imtpu_decode_rrc(const char* path, uint64_t seed, int size, int interp,
                     float hflip, float vflip, float scale_min,
                     float scale_max, float ratio_min, float ratio_max,
                     uint8_t* out) {
  Image img;
  if (!decode_jpeg(path, /*min_side=*/0, &img) || img.w <= 0 || img.h <= 0)
    return 1;
  int cx, cy, cw, ch;
  rrc_rect(img.w, img.h, seed, scale_min, scale_max, ratio_min, ratio_max,
           &cx, &cy, &cw, &ch);
  // flips + interpolation coin flips on an independent stream so they do not
  // perturb the crop-rect sequence
  std::mt19937_64 rng(seed ^ 0x9e3779b97f4a7c15ull);
  std::uniform_real_distribution<float> uni(0.f, 1.f);
  const bool do_h = hflip > 0.f && uni(rng) < hflip;
  const bool do_v = vflip > 0.f && uni(rng) < vflip;
  bool bicubic = interp == 1;
  if (interp == 2) bicubic = (rng() & 1) != 0;
  resample_crop(img, cx, cy, cw, ch, out, size, bicubic, do_h, do_v);
  return 0;
}

// Eval-mode: decode (DCT-scaled) + resize shorter side to size/crop_pct +
// center crop, bicubic by default (timm eval default). Returns 0 on success.
int imtpu_decode_center(const char* path, int size, float crop_pct, int interp,
                        uint8_t* out) {
  int scale_size = int(floorf(size / crop_pct));
  Image img;
  if (!decode_jpeg(path, scale_size, &img) || img.w <= 0 || img.h <= 0)
    return 1;
  // resize shorter side to scale_size (aspect preserved), crop center size^2,
  // expressed directly in source coords
  float ratio = float(scale_size) / std::min(img.w, img.h);
  float inv = 1.0f / ratio;
  int crop_src = int(roundf(size * inv));
  int cx = std::max(0, (img.w - crop_src) / 2);
  int cy = std::max(0, (img.h - crop_src) / 2);
  resample_crop(img, cx, cy, std::min(crop_src, img.w),
                std::min(crop_src, img.h), out, size, interp != 0, false,
                false);
  return 0;
}

// Batch decode with an internal thread pool. mode 0=train(rrc) 1=eval.
// paths: array of n C strings; seeds: n seeds; out: n*size*size*3 uint8.
// Returns number of failures.
int imtpu_decode_batch(const char** paths, const uint64_t* seeds, int n,
                       int size, int mode, int interp, float hflip,
                       float vflip, float scale_min, float scale_max,
                       float ratio_min, float ratio_max, float crop_pct,
                       int num_threads, uint8_t* out) {
  std::atomic<int> next(0), failures(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      uint8_t* dst = out + size_t(i) * size * size * 3;
      int rc = mode == 0
                   ? imtpu_decode_rrc(paths[i], seeds[i], size, interp, hflip,
                                      vflip, scale_min, scale_max, ratio_min,
                                      ratio_max, dst)
                   : imtpu_decode_center(paths[i], size, crop_pct, interp, dst);
      if (rc) {
        memset(dst, 128, size_t(size) * size * 3);  // grey on decode failure
        failures.fetch_add(1);
      }
    }
  };
  int nt = std::max(1, std::min(num_threads, n));
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

}  // extern "C"
