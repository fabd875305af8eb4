// Float32 linear resize of single-channel images (track/tag_image.py's
// resize_linear on float32), as OpenCV 5.0.0 computes
// cv2.resize(INTER_LINEAR) through its Intel IPP layer when both source
// sides are at least 2: each output is a lerp a + (b - a) * t with one
// fused multiply-add, first along the rows, then along the columns of
// the row results. The taps (x0, x1, tx), (y0, y1, ty) come in from the
// caller: source indices already clamped to the image, weights rounded
// to float32 from double coordinates.
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

void trex_resize_linear_f32(const float* src, int64_t n, int32_t sh,
                            int32_t sw, const int32_t* x0,
                            const int32_t* x1, const float* tx,
                            const int32_t* y0, const int32_t* y1,
                            const float* ty, int32_t h, int32_t w,
                            float* dst) {
    std::vector<float> rows(static_cast<size_t>(sh) * w);
    for (int64_t k = 0; k < n; ++k) {
        const float* s = src + k * static_cast<int64_t>(sh) * sw;
        float* d = dst + k * static_cast<int64_t>(h) * w;
        for (int32_t y = 0; y < sh; ++y) {
            const float* r = s + static_cast<int64_t>(y) * sw;
            float* o = rows.data() + static_cast<int64_t>(y) * w;
            for (int32_t x = 0; x < w; ++x) {
                const float a = r[x0[x]];
                o[x] = std::fma(r[x1[x]] - a, tx[x], a);
            }
        }
        for (int32_t y = 0; y < h; ++y) {
            const float* ra = rows.data() + static_cast<int64_t>(y0[y]) * w;
            const float* rb = rows.data() + static_cast<int64_t>(y1[y]) * w;
            float* o = d + static_cast<int64_t>(y) * w;
            const float t = ty[y];
            for (int32_t x = 0; x < w; ++x) {
                o[x] = std::fma(rb[x] - ra[x], t, ra[x]);
            }
        }
    }
}

}  // extern "C"
