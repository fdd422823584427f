// Native host-side image preprocessing: fused keep-ratio bilinear resize +
// BGR->RGB + normalize + zero-pad, writing directly into the batch tensor.
//
// The port's copy of ld_tpu/native/image_prep.cpp (same arithmetic, so the
// two give the same bits). It does the work of Resize, Normalize and Pad in
// ONE pass over the output, halving host memory traffic.
//
// Build: ld_tpu_torch/native.py (g++ -O3 -shared -fPIC, at first use).
//
// Contract:
//   src: (sh, sw, 3) uint8 BGR, row-major.
//   dst: (dh, dw, 3) float32 buffer (the padded batch slot), row-major.
//   new_h/new_w: resized image size (<= dh/dw); the rest is zero-padded.
//   mean/std: per-channel (RGB order) normalization.
//   to_rgb: swap channels 0/2 while sampling.
// Bilinear sampling matches cv2.INTER_LINEAR (half-pixel centers).
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

void image_prep(const uint8_t* src, int64_t sh, int64_t sw,
                float* dst, int64_t dh, int64_t dw,
                int64_t new_h, int64_t new_w,
                const float* mean, const float* stdv, int to_rgb) {
  const float inv_std[3] = {1.0f / stdv[0], 1.0f / stdv[1], 1.0f / stdv[2]};
  const float scale_y = (float)sh / (float)new_h;
  const float scale_x = (float)sw / (float)new_w;

  for (int64_t y = 0; y < dh; ++y) {
    float* row = dst + y * dw * 3;
    if (y >= new_h) {
      std::memset(row, 0, sizeof(float) * dw * 3);
      continue;
    }
    const float fy = ((float)y + 0.5f) * scale_y - 0.5f;
    const int64_t y0 = std::max<int64_t>(0, (int64_t)std::floor(fy));
    const int64_t y1 = std::min<int64_t>(sh - 1, y0 + 1);
    const float wy1 = std::min(1.0f, std::max(0.0f, fy - (float)y0));
    const float wy0 = 1.0f - wy1;
    const uint8_t* r0 = src + y0 * sw * 3;
    const uint8_t* r1 = src + y1 * sw * 3;

    for (int64_t x = 0; x < new_w; ++x) {
      const float fx = ((float)x + 0.5f) * scale_x - 0.5f;
      const int64_t x0 = std::max<int64_t>(0, (int64_t)std::floor(fx));
      const int64_t x1 = std::min<int64_t>(sw - 1, x0 + 1);
      const float wx1 = std::min(1.0f, std::max(0.0f, fx - (float)x0));
      const float wx0 = 1.0f - wx1;
      const float w00 = wy0 * wx0, w01 = wy0 * wx1;
      const float w10 = wy1 * wx0, w11 = wy1 * wx1;
      for (int c = 0; c < 3; ++c) {
        const int sc = to_rgb ? 2 - c : c;  // BGR source -> RGB output
        const float v = w00 * r0[x0 * 3 + sc] + w01 * r0[x1 * 3 + sc] +
                        w10 * r1[x0 * 3 + sc] + w11 * r1[x1 * 3 + sc];
        row[x * 3 + c] = (v - mean[c]) * inv_std[c];
      }
    }
    std::memset(row + new_w * 3, 0, sizeof(float) * (dw - new_w) * 3);
  }
}

}  // extern "C"
