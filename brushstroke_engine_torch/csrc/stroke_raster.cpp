// Host-side stroke rasterization and triband preparation (the port's copy).
//
// The hot loops of the training-data path on the host: distance-to-polyline
// rasterization with a uniform-grid acceleration structure, and the separable
// gaussian blur of the triband image, behind a plain C ABI for ctypes.
// brushstroke_engine_torch/native.py builds it with g++ on first use and holds
// the numpy fallback.  The code below is the JAX package's
// native/stroke_raster.cpp unchanged, and is built with the same flags, so
// both packages draw bit-identical strokes.
//
// Semantics match brushstroke_engine_torch/data/curves.py:
//   draw_stroke: out[y][x] = clamp((dist_to_polyline - radius) / soft, 0, 1)
//   triband:     ch0 = gray, ch1 = binarize(gray), ch2 = gaussian(ch1)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec2 {
  double y, x;
};

inline double seg_dist_sq(const Vec2& p, const Vec2& a, const Vec2& b) {
  const double dy = b.y - a.y, dx = b.x - a.x;
  const double len_sq = dy * dy + dx * dx;
  double t = 0.0;
  if (len_sq > 1e-12) {
    t = ((p.y - a.y) * dy + (p.x - a.x) * dx) / len_sq;
    t = std::min(1.0, std::max(0.0, t));
  }
  const double py = a.y + t * dy - p.y;
  const double px = a.x + t * dx - p.x;
  return py * py + px * px;
}

}  // namespace

extern "C" {

// Rasterize a polyline as a soft-edged stroke.
//   pts: [n_pts * 2] (y, x) pixel coordinates.
//   out: [width * width] float32, 1.0 = background, 0.0 = stroke.
void bse_draw_stroke(const float* pts, int n_pts, float radius,
                     float soft_edge, int width, float* out) {
  if (n_pts < 2) {
    for (int i = 0; i < width * width; ++i) out[i] = 1.0f;
    return;
  }
  const double soft = std::max(static_cast<double>(soft_edge), 1e-6);
  const double reach = radius + soft + 1.5;

  // Uniform-grid bucket acceleration: register each segment in the cells its
  // bounding box (inflated by reach) covers; per pixel only test segments in
  // its cell.  Turns the O(W^2 * S) scan into near-O(W^2 + S).
  const int cell = std::max(8, static_cast<int>(reach));
  const int gw = (width + cell - 1) / cell;
  std::vector<std::vector<int>> buckets(gw * gw);
  for (int s = 0; s + 1 < n_pts; ++s) {
    const double y0 = std::min(pts[2 * s], pts[2 * s + 2]) - reach;
    const double y1 = std::max(pts[2 * s], pts[2 * s + 2]) + reach;
    const double x0 = std::min(pts[2 * s + 1], pts[2 * s + 3]) - reach;
    const double x1 = std::max(pts[2 * s + 1], pts[2 * s + 3]) + reach;
    const int cy0 = std::max(0, static_cast<int>(y0) / cell);
    const int cy1 = std::min(gw - 1, static_cast<int>(y1) / cell);
    const int cx0 = std::max(0, static_cast<int>(x0) / cell);
    const int cx1 = std::min(gw - 1, static_cast<int>(x1) / cell);
    for (int cy = cy0; cy <= cy1; ++cy)
      for (int cx = cx0; cx <= cx1; ++cx)
        buckets[cy * gw + cx].push_back(s);
  }

  for (int y = 0; y < width; ++y) {
    for (int x = 0; x < width; ++x) {
      const Vec2 p{static_cast<double>(y), static_cast<double>(x)};
      const auto& bucket = buckets[(y / cell) * gw + (x / cell)];
      double best = 1e30;
      for (int s : bucket) {
        const Vec2 a{pts[2 * s], pts[2 * s + 1]};
        const Vec2 b{pts[2 * s + 2], pts[2 * s + 3]};
        best = std::min(best, seg_dist_sq(p, a, b));
      }
      const double d = std::sqrt(best) - radius;
      out[y * width + x] =
          static_cast<float>(std::min(1.0, std::max(0.0, d / soft)));
    }
  }
}

// Separable gaussian blur of a [h*w] float image (edge-clamped).
void bse_gaussian_blur(const float* in, int h, int w, float sigma,
                       float* out) {
  if (sigma <= 0.0f) {
    std::memcpy(out, in, sizeof(float) * h * w);
    return;
  }
  const int rad = std::max(1, static_cast<int>(3.0f * sigma));
  std::vector<double> k(2 * rad + 1);
  double ksum = 0.0;
  for (int i = -rad; i <= rad; ++i) {
    k[i + rad] = std::exp(-0.5 * (i / static_cast<double>(sigma)) *
                          (i / static_cast<double>(sigma)));
    ksum += k[i + rad];
  }
  for (auto& v : k) v /= ksum;

  std::vector<float> tmp(h * w);
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      double acc = 0.0;
      for (int i = -rad; i <= rad; ++i) {
        const int xx = std::min(w - 1, std::max(0, x + i));
        acc += k[i + rad] * in[y * w + xx];
      }
      tmp[y * w + x] = static_cast<float>(acc);
    }
  }
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      double acc = 0.0;
      for (int i = -rad; i <= rad; ++i) {
        const int yy = std::min(h - 1, std::max(0, y + i));
        acc += k[i + rad] * tmp[yy * w + x];
      }
      out[y * w + x] = static_cast<float>(acc);
    }
  }
}

// gray [h*w] float -> triband uint8 [h*w*3] (R=gray, G=binary, B=blurred).
void bse_triband(const float* gray, int h, int w, float blur_sigma,
                 float threshold, uint8_t* out) {
  std::vector<float> binary(h * w);
  for (int i = 0; i < h * w; ++i)
    binary[i] = gray[i] > threshold ? 1.0f : 0.0f;
  std::vector<float> blurred(h * w);
  bse_gaussian_blur(binary.data(), h, w, blur_sigma, blurred.data());
  for (int i = 0; i < h * w; ++i) {
    out[3 * i + 0] = static_cast<uint8_t>(
        std::min(255.0f, std::max(0.0f, gray[i] * 255.0f)));
    out[3 * i + 1] = static_cast<uint8_t>(binary[i] * 255.0f);
    out[3 * i + 2] = static_cast<uint8_t>(
        std::min(255.0f, std::max(0.0f, blurred[i] * 255.0f)));
  }
}

}  // extern "C"
