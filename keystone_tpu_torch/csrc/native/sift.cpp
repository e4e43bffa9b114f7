// Dense SIFT descriptor extraction (clean-room).
//
// Standard dense SIFT: per-pixel gradients -> 8 soft-assigned orientation
// channels -> per-cell weighted sums over a 4x4 grid of spatial bins ->
// 128-dim descriptor with L2 / 0.2-clamp / re-L2 normalization.
// Parity target: utils.external.VLFeat.getSIFTs (SURVEY.md §2.3)
// [unverified].

#include "keystone_native.h"

#include <algorithm>
#include <cmath>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int kOriBins = 8;
constexpr int kSpatialBins = 4;  // 4x4 grid
constexpr int kDescDim = kSpatialBins * kSpatialBins * kOriBins;  // 128

struct Grid {
  int nx, ny, x0, y0, span;
};

// Keypoints are centers of a 4*bin_size-pixel support placed on a dense
// grid with the given step, fully inside the image.
Grid grid_for(int h, int w, int step, int bin_size) {
  Grid g;
  g.span = kSpatialBins * bin_size;  // descriptor support in pixels
  int usable_x = w - g.span;
  int usable_y = h - g.span;
  g.nx = usable_x >= 0 ? usable_x / step + 1 : 0;
  g.ny = usable_y >= 0 ? usable_y / step + 1 : 0;
  g.x0 = 0;
  g.y0 = 0;
  return g;
}

void descriptor_at(const float* gx, const float* gy, int w, int top,
                   int left, int bin_size, float* desc) {
  const int span = kSpatialBins * bin_size;
  const float center = 0.5f * (span - 1);
  const float sigma = 0.5f * span;  // Gaussian spatial window
  const float inv2s2 = 1.0f / (2.0f * sigma * sigma);
  std::memset(desc, 0, kDescDim * sizeof(float));

  for (int yy = 0; yy < span; ++yy) {
    const int iy = top + yy;
    for (int xx = 0; xx < span; ++xx) {
      const int ix = left + xx;
      const float dx = gx[iy * w + ix];
      const float dy = gy[iy * w + ix];
      const float mag = std::sqrt(dx * dx + dy * dy);
      if (mag == 0.0f) continue;
      float theta = std::atan2(dy, dx);  // [-pi, pi]
      if (theta < 0) theta += 2.0f * static_cast<float>(M_PI);
      // Soft orientation binning (linear interp between adjacent bins).
      const float fbin = theta * kOriBins / (2.0f * static_cast<float>(M_PI));
      int b0 = static_cast<int>(fbin) % kOriBins;
      int b1 = (b0 + 1) % kOriBins;
      const float w1 = fbin - std::floor(fbin);
      const float w0 = 1.0f - w1;
      // Soft spatial binning: position in bin units, bilinear over the
      // 4x4 cell grid.
      const float bx = (xx + 0.5f) / bin_size - 0.5f;
      const float by = (yy + 0.5f) / bin_size - 0.5f;
      const int cx0 = static_cast<int>(std::floor(bx));
      const int cy0 = static_cast<int>(std::floor(by));
      const float fx = bx - cx0;
      const float fy = by - cy0;
      // Gaussian weight from the patch center.
      const float rx = xx - center;
      const float ry = yy - center;
      const float gw = std::exp(-(rx * rx + ry * ry) * inv2s2);
      const float wm = mag * gw;

      for (int dyc = 0; dyc <= 1; ++dyc) {
        const int cy = cy0 + dyc;
        if (cy < 0 || cy >= kSpatialBins) continue;
        const float wy = dyc ? fy : 1.0f - fy;
        for (int dxc = 0; dxc <= 1; ++dxc) {
          const int cx = cx0 + dxc;
          if (cx < 0 || cx >= kSpatialBins) continue;
          const float wx = dxc ? fx : 1.0f - fx;
          float* cell = desc + (cy * kSpatialBins + cx) * kOriBins;
          const float wcell = wm * wy * wx;
          cell[b0] += wcell * w0;
          cell[b1] += wcell * w1;
        }
      }
    }
  }

  // L2 normalize -> clamp 0.2 -> renormalize (the standard SIFT step that
  // tames gradient-magnitude bursts).
  float norm = 0.0f;
  for (int i = 0; i < kDescDim; ++i) norm += desc[i] * desc[i];
  norm = std::sqrt(norm);
  if (norm > 1e-12f) {
    const float inv = 1.0f / norm;
    float norm2 = 0.0f;
    for (int i = 0; i < kDescDim; ++i) {
      desc[i] = std::min(desc[i] * inv, 0.2f);
      norm2 += desc[i] * desc[i];
    }
    norm2 = std::sqrt(norm2);
    if (norm2 > 1e-12f) {
      const float inv2 = 1.0f / norm2;
      for (int i = 0; i < kDescDim; ++i) desc[i] *= inv2;
    }
  }
}

}  // namespace

extern "C" {

int ks_abi_version() { return 2; }

int ks_sift_num_keypoints(int h, int w, int step, int bin_size) {
  if (h <= 0 || w <= 0 || step <= 0 || bin_size <= 0) return -1;
  Grid g = grid_for(h, w, step, bin_size);
  return g.nx * g.ny;
}

int ks_dense_sift(const float* images, int n, int h, int w, int step,
                  int bin_size, float* out) {
  if (!images || !out || n <= 0 || h <= 0 || w <= 0 || step <= 0 ||
      bin_size <= 0)
    return -1;
  Grid g = grid_for(h, w, step, bin_size);
  const int nkp = g.nx * g.ny;
  if (nkp == 0) return -2;

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int img = 0; img < n; ++img) {
    const float* im = images + static_cast<std::size_t>(img) * h * w;
    std::vector<float> gx(static_cast<std::size_t>(h) * w, 0.0f);
    std::vector<float> gy(static_cast<std::size_t>(h) * w, 0.0f);
    for (int y = 0; y < h; ++y) {
      for (int x = 0; x < w; ++x) {
        const int xm = x > 0 ? x - 1 : x;
        const int xp = x < w - 1 ? x + 1 : x;
        const int ym = y > 0 ? y - 1 : y;
        const int yp = y < h - 1 ? y + 1 : y;
        gx[y * w + x] = 0.5f * (im[y * w + xp] - im[y * w + xm]);
        gy[y * w + x] = 0.5f * (im[yp * w + x] - im[ym * w + x]);
      }
    }
    float* img_out = out + static_cast<std::size_t>(img) * nkp * kDescDim;
    for (int ky = 0; ky < g.ny; ++ky) {
      for (int kx = 0; kx < g.nx; ++kx) {
        descriptor_at(gx.data(), gy.data(), w, g.y0 + ky * step,
                      g.x0 + kx * step, bin_size,
                      img_out + (ky * g.nx + kx) * kDescDim);
      }
    }
  }
  return 0;
}

}  // extern "C"
