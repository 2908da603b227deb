// kdlt host ops: native C++ image resize for the gateway hot path.
//
// The reference's IO tier resizes with Pillow via keras-image-helper
// (reference model_server.py:18); SURVEY.md 3.1 identifies image
// download + resize as the gateway's hot spot.  This library is the in-tree
// native replacement: uint8 RGB/HWC resize with PIL-identical output --
// nearest uses the same affine sampling, bilinear reproduces Pillow's
// two-pass fixed-point resampling (triangle filter with support scaling on
// downscale, 8-bit clip between passes) so swapping it in cannot move the
// golden logits (BASELINE.md) by even one ulp.
//
// The port's copy of the JAX package's native/hostops.cc, unchanged but for
// this note: built with g++ at first use, together with imagedec.cc, and
// bound with ctypes in kubernetes_deep_learning_tpu_torch/ops/_native.py.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;  // Pillow's 8bpc fixed-point scale

inline uint8_t clip8(int in) {
  int v = in >> kPrecisionBits;
  if (v < 0) return 0;
  if (v > 255) return 255;
  return static_cast<uint8_t>(v);
}

inline double triangle_filter(double x) {
  if (x < 0.0) x = -x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

// Precompute, for every output index, the source window [xmin, xmin+n) and
// its normalized fixed-point weights.  This is the standard separable
// resampling schedule: window center at (out + 0.5) * scale, filter support
// widened by the scale factor when minifying so every source pixel
// contributes (area averaging), plain triangle interpolation when
// magnifying.
struct Schedule {
  std::vector<int> xmin;
  std::vector<int> xsize;
  std::vector<std::vector<int>> coeffs;
};

Schedule make_schedule(int in_size, int out_size) {
  Schedule s;
  s.xmin.resize(out_size);
  s.xsize.resize(out_size);
  s.coeffs.resize(out_size);

  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;  // triangle filter support = 1

  std::vector<double> w;
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    const int n = xmax - xmin;

    w.assign(n, 0.0);
    double total = 0.0;
    for (int j = 0; j < n; ++j) {
      w[j] = triangle_filter((j + xmin - center + 0.5) / filterscale);
      total += w[j];
    }
    s.xmin[xx] = xmin;
    s.xsize[xx] = n;
    s.coeffs[xx].resize(n);
    for (int j = 0; j < n; ++j) {
      const double norm = total > 0.0 ? w[j] / total : 0.0;
      s.coeffs[xx][j] =
          static_cast<int>(std::lround(norm * (1 << kPrecisionBits)));
    }
  }
  return s;
}

void resample_horizontal(const uint8_t* src, int w_in, uint8_t* dst, int h,
                         int w_out, int c, const Schedule& s) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + static_cast<int64_t>(y) * w_in * c;
    uint8_t* out = dst + static_cast<int64_t>(y) * w_out * c;
    for (int x = 0; x < w_out; ++x) {
      const int xmin = s.xmin[x];
      const int n = s.xsize[x];
      const int* k = s.coeffs[x].data();
      for (int ch = 0; ch < c; ++ch) {
        int acc = 1 << (kPrecisionBits - 1);
        for (int j = 0; j < n; ++j)
          acc += row[(xmin + j) * c + ch] * k[j];
        out[x * c + ch] = clip8(acc);
      }
    }
  }
}

void resample_vertical(const uint8_t* src, uint8_t* dst, int h_out, int w,
                       int c, const Schedule& s) {
  for (int y = 0; y < h_out; ++y) {
    const int ymin = s.xmin[y];
    const int n = s.xsize[y];
    const int* k = s.coeffs[y].data();
    uint8_t* out = dst + static_cast<int64_t>(y) * w * c;
    for (int x = 0; x < w * c; ++x) {
      int acc = 1 << (kPrecisionBits - 1);
      for (int j = 0; j < n; ++j)
        acc += src[static_cast<int64_t>(ymin + j) * w * c + x] * k[j];
      out[x] = clip8(acc);
    }
  }
}

}  // namespace

extern "C" {

// dst must hold h_out * w_out * c bytes.  Returns 0 on success.
int kdlt_resize_bilinear(const uint8_t* src, int h_in, int w_in, int c,
                         uint8_t* dst, int h_out, int w_out) {
  if (h_in <= 0 || w_in <= 0 || h_out <= 0 || w_out <= 0 || c <= 0) return 1;
  const Schedule sh = make_schedule(w_in, w_out);
  const Schedule sv = make_schedule(h_in, h_out);
  // Two passes with a uint8 intermediate (clipping between passes), the
  // 8-bits-per-channel pipeline Pillow uses -- required for exact parity.
  std::vector<uint8_t> mid(static_cast<size_t>(h_in) * w_out * c);
  resample_horizontal(src, w_in, mid.data(), h_in, w_out, c, sh);
  resample_vertical(mid.data(), dst, h_out, w_out, c, sv);
  return 0;
}

// Nearest neighbour via the same affine sampling Pillow's NEAREST uses:
// source coordinate starts at scale/2 and is accumulated incrementally per
// output pixel (the accumulation order matters -- recomputing
// (x + 0.5) * scale per pixel rounds differently and shifts pixels on
// upscales).
int kdlt_resize_nearest(const uint8_t* src, int h_in, int w_in, int c,
                        uint8_t* dst, int h_out, int w_out) {
  if (h_in <= 0 || w_in <= 0 || h_out <= 0 || w_out <= 0 || c <= 0) return 1;
  const double sx = static_cast<double>(w_in) / w_out;
  const double sy = static_cast<double>(h_in) / h_out;
  std::vector<int> xmap(w_out);
  double xin = sx * 0.5;
  for (int x = 0; x < w_out; ++x, xin += sx) {
    int xs = static_cast<int>(xin);
    xmap[x] = xs < w_in ? xs : w_in - 1;
  }
  double yin = sy * 0.5;
  for (int y = 0; y < h_out; ++y, yin += sy) {
    int ys = static_cast<int>(yin);
    if (ys >= h_in) ys = h_in - 1;
    const uint8_t* row = src + static_cast<int64_t>(ys) * w_in * c;
    uint8_t* out = dst + static_cast<int64_t>(y) * w_out * c;
    for (int x = 0; x < w_out; ++x)
      std::memcpy(out + x * c, row + xmap[x] * c, c);
  }
  return 0;
}

// Batched resize across images, one std::thread per shard (the GIL is
// released for the whole batch on the Python side).  filter: 0=nearest,
// 1=bilinear.
int kdlt_resize_batch(const uint8_t* src, int n, int h_in, int w_in, int c,
                      uint8_t* dst, int h_out, int w_out, int filter,
                      int num_threads) {
  if (n <= 0) return 1;
  const int64_t in_stride = static_cast<int64_t>(h_in) * w_in * c;
  const int64_t out_stride = static_cast<int64_t>(h_out) * w_out * c;
  int threads = num_threads > 0 ? num_threads : 1;
  if (threads > n) threads = n;

  int err = 0;
  auto work = [&](int t) {
    for (int i = t; i < n; i += threads) {
      int rc = filter == 0
                   ? kdlt_resize_nearest(src + i * in_stride, h_in, w_in, c,
                                         dst + i * out_stride, h_out, w_out)
                   : kdlt_resize_bilinear(src + i * in_stride, h_in, w_in, c,
                                          dst + i * out_stride, h_out, w_out);
      if (rc != 0) err = rc;
    }
  };
  if (threads == 1) {
    work(0);
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int t = 0; t < threads; ++t) pool.emplace_back(work, t);
    for (auto& th : pool) th.join();
  }
  return err;
}

}  // extern "C"
