// Parallel JPEG decode pool — the native ingest path.
//
// The reference feeds ImageNet from JPEG tars through JVM-side decode
// (Ref: loaders/ImageNetLoader.scala [unverified]); the measured Python/PIL
// pool tops out around ~340 images/s/host at 256px, which a TPU-rate
// featurization pipeline outruns. This pool removes both limiters: libjpeg
// DCT-domain scaling cuts the IDCT work to the smallest 1/den >= target
// size, and OpenMP parallelizes across images with no interpreter in the
// loop. Clean-room; uses only the public libjpeg API.

#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>

#include "keystone_native.h"

namespace {

struct ErrorTrap {
  jpeg_error_mgr mgr;
  std::jmp_buf jump;
};

void on_error(j_common_ptr cinfo) {
  ErrorTrap* trap = reinterpret_cast<ErrorTrap*>(cinfo->err);
  std::longjmp(trap->jump, 1);
}

void silence(j_common_ptr, int) {}
void silence_msg(j_common_ptr) {}

// Bilinear resize (h, w, 3) uint8 -> (size, size, 3) float32 in [0, 1].
void resize_bilinear(const unsigned char* src, int h, int w, int size,
                     float* dst) {
  const float sy = static_cast<float>(h) / size;
  const float sx = static_cast<float>(w) / size;
  for (int oy = 0; oy < size; ++oy) {
    float fy = (oy + 0.5f) * sy - 0.5f;
    int y0 = fy < 0 ? 0 : static_cast<int>(fy);
    if (y0 > h - 2) y0 = h - 2 < 0 ? 0 : h - 2;
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    if (wy > 1) wy = 1;
    int y1 = y0 + 1 < h ? y0 + 1 : y0;
    for (int ox = 0; ox < size; ++ox) {
      float fx = (ox + 0.5f) * sx - 0.5f;
      int x0 = fx < 0 ? 0 : static_cast<int>(fx);
      if (x0 > w - 2) x0 = w - 2 < 0 ? 0 : w - 2;
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      if (wx > 1) wx = 1;
      int x1 = x0 + 1 < w ? x0 + 1 : x0;
      const unsigned char* p00 = src + (static_cast<size_t>(y0) * w + x0) * 3;
      const unsigned char* p01 = src + (static_cast<size_t>(y0) * w + x1) * 3;
      const unsigned char* p10 = src + (static_cast<size_t>(y1) * w + x0) * 3;
      const unsigned char* p11 = src + (static_cast<size_t>(y1) * w + x1) * 3;
      float* o = dst + (static_cast<size_t>(oy) * size + ox) * 3;
      for (int c = 0; c < 3; ++c) {
        float top = p00[c] + (p01[c] - p00[c]) * wx;
        float bot = p10[c] + (p11[c] - p10[c]) * wx;
        o[c] = (top + (bot - top) * wy) * (1.0f / 255.0f);
      }
    }
  }
}

// Decode one jpeg into (size, size, 3) float32. Returns false on failure.
// noexcept boundary: a C++ exception escaping an OpenMP worker (or the
// extern "C" frame into ctypes) would terminate the process, so everything
// — including bad_alloc from a jpeg header declaring absurd dimensions —
// converts to a per-image failure here.
bool decode_one(const std::uint8_t* buf, std::uint64_t len, int size,
                float* out) noexcept try {
  jpeg_decompress_struct cinfo;
  ErrorTrap trap;
  cinfo.err = jpeg_std_error(&trap.mgr);
  trap.mgr.error_exit = on_error;
  trap.mgr.emit_message = silence;
  trap.mgr.output_message = silence_msg;
  std::vector<unsigned char> pixels;
  if (setjmp(trap.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  // DCT-domain downscale: the largest 1/den in {1,2,4,8} whose output still
  // covers the target — most of the IDCT work disappears before resize.
  cinfo.scale_num = 1;
  cinfo.scale_denom = 1;
  for (int den = 8; den >= 2; den /= 2) {
    if (static_cast<int>(cinfo.image_width) / den >= size &&
        static_cast<int>(cinfo.image_height) / den >= size) {
      cinfo.scale_denom = den;
      break;
    }
  }
  jpeg_start_decompress(&cinfo);
  const int w = cinfo.output_width;
  const int h = cinfo.output_height;
  if (cinfo.output_components != 3 || w <= 0 || h <= 0) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  pixels.resize(static_cast<size_t>(h) * w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = pixels.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  resize_bilinear(pixels.data(), h, w, size, out);
  return true;
} catch (...) {
  return false;
}

}  // namespace

extern "C" int ks_decode_jpeg_batch(const std::uint8_t* data,
                                    const std::uint64_t* offsets, int n,
                                    int size, float* out) {
  if (!data || !offsets || !out || n < 0 || size <= 0) return -1000000;
  int failed = 0;  // first failing index + 1 (0 = none)
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < n; ++i) {
    const std::uint8_t* buf = data + offsets[i];
    const std::uint64_t len = offsets[i + 1] - offsets[i];
    float* dst = out + static_cast<size_t>(i) * size * size * 3;
    if (!decode_one(buf, len, size, dst)) {
#pragma omp critical
      {
        if (failed == 0 || i + 1 < failed) failed = i + 1;
      }
    }
  }
  return failed ? -failed : 0;
}
