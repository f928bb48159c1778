// Native image preprocessing for the data-loader / serving hot path.
//
// The reference leans on PIL inside its torch DataLoader workers
// (reference: llava/train/train.py:733-758, llava/serve/model_worker.py:131);
// here the per-image work (bicubic shortest-edge resize, center crop,
// rescale + CLIP normalization to CHW float32) runs as one C++ pass over
// the pixel buffer, exposed to Python via ctypes.  The PyTorch port's own
// copy of matryoshka_mm_tpu/native/image_ops.cpp.
//
// The resampler is BIT-EXACT with PIL's uint8 bicubic resize (and hence
// with HF CLIPImageProcessor, which resizes through PIL): Catmull-Rom
// cubic (a = -0.5, support = 2), per-output-pixel weights normalized in
// double then converted to Pillow's 22-bit fixed point, horizontal pass
// first with the intermediate CLIPPED to uint8 between passes (bicubic
// overshoot is clamped per pass — keeping a float intermediate diverges
// by up to ~20 levels on upscaled high-frequency content), rounding via
// the half-offset accumulator.  tests/test_torch_frontend.py holds this
// copy's output bit for bit against the JAX package's library and PIL.
//
// Built by matryoshka_mm_torch/native/__init__.py at first use:
// g++ -O3 -march=native -funroll-loops -shared -fPIC image_ops.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline double cubic_filter(double x) {
  // PIL's bicubic kernel (a = -0.5)
  constexpr double a = -0.5;
  x = std::abs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

// Pillow's 8-bit fixed-point precision: 32 bits minus 8 value bits minus
// 2 guard bits. Weights are scaled by 1 << kPrecisionBits; the rounding
// half-offset is pre-added to the accumulator.
constexpr int kPrecisionBits = 32 - 8 - 2;

inline uint8_t clip8(int v) {
  if (v >= (1 << kPrecisionBits << 8)) return 255;
  if (v <= 0) return 0;
  return static_cast<uint8_t>(v >> kPrecisionBits);
}

struct ResampleCoeffs {
  std::vector<int> bounds;       // per output pixel: first source index
  std::vector<int> counts;       // per output pixel: number of taps
  std::vector<double> weights;   // taps, normalized (double)
  std::vector<int32_t> iweights; // taps in 22-bit fixed point (8bpc path)
  int ksize;
};

// Precompute 1-D resampling coefficients exactly the way PIL does:
// center mapping (out + 0.5) * scale, filter support scaled by max(scale, 1).
ResampleCoeffs compute_coeffs(int in_size, int out_size) {
  ResampleCoeffs rc;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 2.0 * filterscale;  // bicubic support = 2
  rc.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  rc.bounds.resize(out_size);
  rc.counts.resize(out_size);
  rc.weights.assign(static_cast<size_t>(out_size) * rc.ksize, 0.0);

  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    int n = xmax - xmin;
    double* w = &rc.weights[static_cast<size_t>(xx) * rc.ksize];
    double total = 0.0;
    for (int i = 0; i < n; ++i) {
      double wv = cubic_filter((xmin + i - center + 0.5) / filterscale);
      w[i] = wv;
      total += wv;
    }
    if (total != 0.0)
      for (int i = 0; i < n; ++i) w[i] /= total;
    rc.bounds[xx] = xmin;
    rc.counts[xx] = n;
  }
  // Pillow's normalize_coeffs_8bpc: round-half-away-from-zero into fixed
  // point AFTER the double normalization (converting before normalizing
  // changes low bits).
  rc.iweights.assign(rc.weights.size(), 0);
  for (size_t i = 0; i < rc.weights.size(); ++i) {
    double v = rc.weights[i] * (1 << kPrecisionBits);
    rc.iweights[i] = static_cast<int32_t>(v < 0 ? v - 0.5 : v + 0.5);
  }
  return rc;
}

// Separable resize HWC uint8 -> HWC uint8, bit-exact with PIL: fixed-point
// weights, horizontal pass first, intermediate clipped to uint8.
void resize_bicubic(const uint8_t* src, int in_h, int in_w, uint8_t* dst,
                    int out_h, int out_w, int channels) {
  const int half = 1 << (kPrecisionBits - 1);
  const bool need_h = out_w != in_w;
  const bool need_v = out_h != in_h;

  std::vector<uint8_t> tmp;
  const uint8_t* mid = src;
  int mid_w = in_w;
  if (need_h) {
    ResampleCoeffs cx = compute_coeffs(in_w, out_w);
    tmp.resize(static_cast<size_t>(in_h) * out_w * channels);
    for (int y = 0; y < in_h; ++y) {
      const uint8_t* row = src + static_cast<size_t>(y) * in_w * channels;
      uint8_t* trow = &tmp[static_cast<size_t>(y) * out_w * channels];
      for (int x = 0; x < out_w; ++x) {
        const int32_t* w = &cx.iweights[static_cast<size_t>(x) * cx.ksize];
        int x0 = cx.bounds[x], n = cx.counts[x];
        for (int c = 0; c < channels; ++c) {
          int acc = half;
          for (int i = 0; i < n; ++i)
            acc += row[(x0 + i) * channels + c] * w[i];
          trow[x * channels + c] = clip8(acc);
        }
      }
    }
    mid = tmp.data();
    mid_w = out_w;
  }
  if (need_v) {
    ResampleCoeffs cy = compute_coeffs(in_h, out_h);
    for (int y = 0; y < out_h; ++y) {
      const int32_t* w = &cy.iweights[static_cast<size_t>(y) * cy.ksize];
      int y0 = cy.bounds[y], n = cy.counts[y];
      uint8_t* drow = dst + static_cast<size_t>(y) * out_w * channels;
      for (int x = 0; x < out_w; ++x) {
        for (int c = 0; c < channels; ++c) {
          int acc = half;
          for (int i = 0; i < n; ++i)
            acc += mid[(static_cast<size_t>(y0 + i) * mid_w + x) * channels
                       + c] * w[i];
          drow[x * channels + c] = clip8(acc);
        }
      }
    }
  } else if (mid != dst) {
    std::memcpy(dst, mid, static_cast<size_t>(out_h) * out_w * channels);
  }
}

}  // namespace

extern "C" {

// Resize an HWC uint8 RGB image with PIL-compatible bicubic filtering.
void image_resize_bicubic(const uint8_t* src, int in_h, int in_w,
                          uint8_t* dst, int out_h, int out_w) {
  resize_bicubic(src, in_h, in_w, dst, out_h, out_w, 3);
}

// Full CLIP preprocess: HWC uint8 -> shortest-edge bicubic resize ->
// center crop (crop x crop) -> rescale 1/255 -> normalize -> CHW float32.
void clip_preprocess(const uint8_t* src, int in_h, int in_w, int target_short,
                     int crop, const float* mean, const float* std_,
                     float* out /* 3*crop*crop */) {
  int short_side = std::min(in_h, in_w);
  int new_h, new_w;
  if (short_side == target_short) {
    new_h = in_h;
    new_w = in_w;
  } else {
    double s = static_cast<double>(target_short) / short_side;
    if (in_w <= in_h) {
      new_w = target_short;
      new_h = static_cast<int>(in_h * s);
    } else {
      new_h = target_short;
      new_w = static_cast<int>(in_w * s);
    }
  }
  std::vector<uint8_t> resized(static_cast<size_t>(new_h) * new_w * 3);
  if (new_h == in_h && new_w == in_w) {
    std::memcpy(resized.data(), src, resized.size());
  } else {
    resize_bicubic(src, in_h, in_w, resized.data(), new_h, new_w, 3);
  }

  int top = (new_h - crop) / 2;
  int left = (new_w - crop) / 2;
  // per-channel 256-entry LUT with the same float32 op order as the
  // Python/HF path ((v / 255 - mean) / std) so results are bit-identical
  float lut[3][256];
  for (int c = 0; c < 3; ++c)
    for (int v = 0; v < 256; ++v)
      lut[c][v] = (static_cast<float>(v) / 255.0f - mean[c]) / std_[c];
  for (int c = 0; c < 3; ++c) {
    float* oc = out + static_cast<size_t>(c) * crop * crop;
    for (int y = 0; y < crop; ++y) {
      int sy = std::min(std::max(top + y, 0), new_h - 1);
      const uint8_t* row = &resized[(static_cast<size_t>(sy) * new_w) * 3];
      for (int x = 0; x < crop; ++x) {
        int sx = std::min(std::max(left + x, 0), new_w - 1);
        oc[y * crop + x] = lut[c][row[sx * 3 + c]];
      }
    }
  }
}

// Batched variant over N images of identical input size.
void clip_preprocess_batch(const uint8_t* src, int n, int in_h, int in_w,
                           int target_short, int crop, const float* mean,
                           const float* std_, float* out) {
  const size_t in_stride = static_cast<size_t>(in_h) * in_w * 3;
  const size_t out_stride = static_cast<size_t>(3) * crop * crop;
  for (int i = 0; i < n; ++i) {
    clip_preprocess(src + i * in_stride, in_h, in_w, target_short, crop,
                    mean, std_, out + i * out_stride);
  }
}

}  // extern "C"
