// Affine warp of an 8-bit image for the identity crops
// (trex_tpu_torch/ops/crops.py::warp_affine_u8).
//
// The JAX package warps each crop with cv2.warpAffine(INTER_LINEAR,
// BORDER_CONSTANT 0); the machine with the card has no OpenCV. This is
// that warp bit for bit as OpenCV 5.0.0 computes it for one uint8
// channel on an x86 host with AVX2, found by testing against cv2
// (tests/test_torch_crops.py):
//
// - the forward matrix is inverted in double precision as warpAffine
//   does, then cast to float;
// - OpenCV's vector loop maps 16 destination pixels a step, with source
//   coordinates fma(M0, x, y*M1 + M2) (the row term rounded twice); the
//   pixels of a row past its last whole step go through its scalar loop,
//   fma(x, M0, y*M1) + M2;
// - bilinear interpolation in float with three fused multiply-adds,
//   v0 = fma(a, p01 - p00, p00), v1 likewise, v = fma(b, v1 - v0, v0);
//   taps outside the image read 0; rounded half to even.
//
// Built with -ffp-contract=off, so only the std::fma calls fuse.
#include <cmath>
#include <cstdint>

#include "simd_clones.h"

extern "C" {

TREX_HOT_CLONES
void trex_warp_affine_u8(const uint8_t* src, int32_t h, int32_t w,
                         const double* fwd, int32_t tw, int32_t th,
                         uint8_t* out) {
    double m[6];
    for (int i = 0; i < 6; ++i) m[i] = fwd[i];
    double d = m[0] * m[4] - m[1] * m[3];
    d = d != 0 ? 1. / d : 0.;
    const double a11 = m[4] * d, a22 = m[0] * d;
    m[0] = a11;
    m[1] *= -d;
    m[3] *= -d;
    m[4] = a22;
    const double b1 = -m[0] * m[2] - m[1] * m[5];
    const double b2 = -m[3] * m[2] - m[4] * m[5];
    m[2] = b1;
    m[5] = b2;
    float M[6];
    for (int i = 0; i < 6; ++i) M[i] = static_cast<float>(m[i]);

    const int nv = tw / 16 * 16;
    auto tap = [&](int64_t y, int64_t x) -> float {
        return (y >= 0 && y < h && x >= 0 && x < w)
            ? static_cast<float>(src[y * w + x]) : 0.f;
    };
    // coordinates beyond the image clamp to a point whose taps read 0
    auto clamp = [](float v, int64_t hi) -> int64_t {
        if (!(v > -2.f)) return -2;
        if (v > static_cast<float>(hi)) return hi;
        return static_cast<int64_t>(v);
    };
    for (int y = 0; y < th; ++y) {
        const float yf = static_cast<float>(y);
        const float mx = yf * M[1] + M[2];
        const float my = yf * M[4] + M[5];
        for (int x = 0; x < tw; ++x) {
            const float xf = static_cast<float>(x);
            float sx, sy;
            if (x < nv) {
                sx = std::fma(M[0], xf, mx);
                sy = std::fma(M[3], xf, my);
            } else {
                sx = std::fma(xf, M[0], yf * M[1]) + M[2];
                sy = std::fma(xf, M[3], yf * M[4]) + M[5];
            }
            const float fx = std::floor(sx), fy = std::floor(sy);
            const float a = sx - fx, b = sy - fy;
            const int64_t ix = clamp(fx, w), iy = clamp(fy, h);
            const float p00 = tap(iy, ix), p01 = tap(iy, ix + 1);
            const float p10 = tap(iy + 1, ix), p11 = tap(iy + 1, ix + 1);
            const float v0 = std::fma(a, p01 - p00, p00);
            const float v1 = std::fma(a, p11 - p10, p10);
            float v = std::nearbyint(std::fma(b, v1 - v0, v0));
            v = v < 0.f ? 0.f : (v > 255.f ? 255.f : v);
            out[static_cast<int64_t>(y) * tw + x] = static_cast<uint8_t>(v);
        }
    }
}

}  // extern "C"
