// Host-side image reductions for video averaging.
//
// The reference computes the background average in commons
// AveragingAccumulator (method mode/mean/max/min; submodule absent,
// interface recovered from Segmenter usage). The per-pixel mode over N
// sampled frames is the hot finalize step: numpy needs either a
// (256 x P) histogram (GB-scale temporaries at 2304^2) or a python
// chunk loop. Here: blocked per-pixel histograms that stay L2-resident.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "simd_clones.h"

extern "C" {

// Same, but each frame stays in its own buffer (no (n, p) stack copy):
// rows[r] points at frame r's p pixels.
TREX_HOT_CLONES
void trex_mode_u8_rows(const uint8_t* const* rows, int64_t n, int64_t p,
                       uint8_t* out) {
    if (n <= 0 || p <= 0) return;
    constexpr int64_t B = 4096;
    if (n < 256) {
        std::vector<uint8_t> hist(B * 256);
        for (int64_t s = 0; s < p; s += B) {
            const int64_t b = std::min(B, p - s);
            std::memset(hist.data(), 0, b * 256);
            for (int64_t r = 0; r < n; ++r) {
                const uint8_t* row = rows[r] + s;
                for (int64_t i = 0; i < b; ++i)
                    ++hist[i * 256 + row[i]];
            }
            for (int64_t i = 0; i < b; ++i) {
                const uint8_t* h = hist.data() + i * 256;
                uint8_t bc = 0;
                for (int v = 0; v < 256; ++v)  // auto-vectorized max
                    bc = std::max(bc, h[v]);
                // first occurrence of the max = lowest modal value,
                // matching np.argmax tie-breaking
                out[s + i] = static_cast<uint8_t>(
                    static_cast<const uint8_t*>(
                        std::memchr(h, bc, 256)) - h);
            }
        }
    } else {
        std::vector<uint32_t> hist(B * 256);
        for (int64_t s = 0; s < p; s += B) {
            const int64_t b = std::min(B, p - s);
            std::memset(hist.data(), 0, sizeof(uint32_t) * b * 256);
            for (int64_t r = 0; r < n; ++r) {
                const uint8_t* row = rows[r] + s;
                for (int64_t i = 0; i < b; ++i)
                    ++hist[i * 256 + row[i]];
            }
            for (int64_t i = 0; i < b; ++i) {
                const uint32_t* h = hist.data() + i * 256;
                int best = 0;
                uint32_t bc = h[0];
                for (int v = 1; v < 256; ++v)
                    if (h[v] > bc) { bc = h[v]; best = v; }
                out[s + i] = static_cast<uint8_t>(best);
            }
        }
    }
}

}  // extern "C"

extern "C" {

// mean finalize: round(acc / count) clamped to u8 (np.round semantics
// = rint's half-to-even).
TREX_HOT_CLONES
void trex_mean_u8(const uint32_t* acc, int64_t p, int64_t count,
                  uint8_t* out) {
    if (count <= 0) return;
    const double inv = (double)count;
    for (int64_t i = 0; i < p; i++) {
        double v = std::rint((double)acc[i] / inv);
        if (v < 0.0) v = 0.0;
        if (v > 255.0) v = 255.0;
        out[i] = (uint8_t)v;
    }
}

}  // extern "C"
