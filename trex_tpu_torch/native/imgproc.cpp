// Host image routines of the conversion pipeline, the image-sequence
// decoder and the arena border (trex_tpu_torch/utils/imgproc.py,
// trex_tpu_torch/io/image_decode.py), as OpenCV 5.0.0 computes them on an
// x86 host with AVX2; each was found by testing against cv2
// (tests/test_torch_imgproc.py):
//
// - trex_box_blur_u8: blur(src, (kw, kh)), BORDER_REFLECT_101; the box
//   sum divided and rounded to nearest (OpenCV's float scale gives the
//   same for kernels of fewer than 16600 pixels).
// - trex_gaussian5_u8: GaussianBlur(src, (5, 5), 0) on 8 bits, OpenCV's
//   bit-exact fixed-point path: taps [16, 64, 96, 64, 16] / 256 a pass,
//   BORDER_REFLECT_101, (sum + 2^15) >> 16.
// - trex_adaptive_gaussian_u8: adaptiveThreshold(GAUSSIAN_C,
//   THRESH_BINARY). OpenCV blurs a float32 copy with GaussianBlur(block,
//   0, BORDER_REPLICATE | BORDER_ISOLATED): a row pass whose vector loop
//   (8 lanes, then one group of 4) fuses every tap and whose scalar loop
//   adds the taps unfused but for the last (n - 1) % 4, then a symmetric
//   column pass, fused in its 8-lane loop and unfused past it; a side of
//   one pixel takes a one-tap kernel. The mean is rounded half to even
//   and a pixel is set where src - mean > -ceil(delta).
// - trex_morph_runs_u8: erode / dilate with an element of one run a row
//   (getStructuringElement(MORPH_ELLIPSE), a k x k rectangle with its
//   anchor at k / 2), pixels outside the image neutral (OpenCV's default
//   morphology border).
// - trex_fill_poly_u8: fillPoly of one polygon, LINE_8, shift 0: every
//   edge drawn with the clipped 8-connected line, then OpenCV's edge
//   table with 16-bit fixed-point x through the vertices (no half-pixel
//   offset; an edge the frame cuts takes the x of its clipped ends, and
//   their y where those differ), each span filling the pixels from
//   ceil(x1) to floor(x2), the active edges bubble-sorted by x a row.
// - trex_undistort_maps_f32: initUndistortRectifyMap(K, D, None, K, size,
//   CV_32FC1): 8 pixels a step through OpenCV's double vector formula
//   with fused multiply-adds (the radial factor times the reciprocal of
//   its denominator), the pixels past a row's last step through its
//   scalar formula, each coordinate rounded to float32.
// - trex_remap_linear_u8: remap(src, map1, map2, INTER_LINEAR) on
//   float32 maps, 1 or 3 channels: the float bilinear of OpenCV 5's
//   vector remap, as native/warp.cpp computes warpAffine's.
// - trex_png_unfilter: PNG's per-row filters (None, Sub, Up, Average,
//   Paeth) undone in place over the inflated scan lines of one pass.
//
// Built with -ffp-contract=off, so only the std::fma calls fuse.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "simd_clones.h"

namespace {

// borderInterpolate for BORDER_REFLECT_101 (gfedcb|abcdefgh|gfedcba).
int reflect101(int p, int len) {
    if ((unsigned)p < (unsigned)len) return p;
    if (len == 1) return 0;
    do {
        if (p < 0)
            p = -p;
        else
            p = len - 1 - (p - len) - 1;
    } while ((unsigned)p >= (unsigned)len);
    return p;
}

int replicate(int p, int len) { return p < 0 ? 0 : (p >= len ? len - 1 : p); }

// cvRound of sum / n for a non-negative sum: to nearest, ties to even.
inline uint8_t round_div(int64_t sum, int64_t n) {
    int64_t q = sum / n, r = sum % n;
    if (2 * r > n || (2 * r == n && (q & 1))) ++q;
    return (uint8_t)(q > 255 ? 255 : q);
}

struct P64 {
    int64_t x, y;
};

// clipLine(Size2l, Point2l&, Point2l&) of drawing.cpp.
bool clip_line(int64_t w, int64_t h, P64& p1, P64& p2) {
    if (w <= 0 || h <= 0) return false;
    const int64_t right = w - 1, bottom = h - 1;
    int64_t &x1 = p1.x, &y1 = p1.y, &x2 = p2.x, &y2 = p2.y;
    int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
    int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
        int64_t a;
        if (c1 & 12) {
            a = c1 < 8 ? 0 : bottom;
            x1 += (int64_t)((double)(a - y1) * (x2 - x1) / (y2 - y1));
            y1 = a;
            c1 = (x1 < 0) + (x1 > right) * 2;
        }
        if (c2 & 12) {
            a = c2 < 8 ? 0 : bottom;
            x2 += (int64_t)((double)(a - y2) * (x2 - x1) / (y2 - y1));
            y2 = a;
            c2 = (x2 < 0) + (x2 > right) * 2;
        }
        if ((c1 & c2) == 0 && (c1 | c2) != 0) {
            if (c1) {
                a = c1 == 1 ? 0 : right;
                y1 += (int64_t)((double)(a - x1) * (y2 - y1) / (x2 - x1));
                x1 = a;
                c1 = 0;
            }
            if (c2) {
                a = c2 == 1 ? 0 : right;
                y2 += (int64_t)((double)(a - x2) * (y2 - y1) / (x2 - x1));
                x2 = a;
                c2 = 0;
            }
        }
    }
    return (c1 | c2) == 0;
}

// Line(img, pt1, pt2, color, 8): LineIterator(leftToRight = true) over
// the clipped segment.
void draw_line8(uint8_t* img, int h, int w, P64 p1, P64 p2, uint8_t color) {
    if ((uint64_t)p1.x >= (uint64_t)w || (uint64_t)p2.x >= (uint64_t)w ||
        (uint64_t)p1.y >= (uint64_t)h || (uint64_t)p2.y >= (uint64_t)h) {
        if (!clip_line(w, h, p1, p2)) return;
    }
    int64_t dx = p2.x - p1.x, dy = p2.y - p1.y;
    if (dx < 0) {
        dx = -dx;
        dy = -dy;
        std::swap(p1, p2);
    }
    int64_t sy = 1;
    if (dy < 0) {
        dy = -dy;
        sy = -1;
    }
    const bool vert = dy > dx;
    if (vert) std::swap(dx, dy);
    int64_t err = dx - (dy + dy);
    const int64_t plus = dx + dx, minus = -(dy + dy);
    int64_t x = p1.x, y = p1.y;
    for (int64_t i = 0; i <= dx; ++i) {
        img[y * w + x] = color;
        const bool minor = err < 0;
        err += minus + (minor ? plus : 0);
        if (vert) {
            y += sy;
            x += minor ? 1 : 0;
        } else {
            x += 1;
            y += minor ? sy : 0;
        }
    }
}

struct PolyEdge {
    int y0, y1;
    int64_t x, dx;
    PolyEdge* next;
};

const int kXYShift = 16;
const int64_t kXYOne = (int64_t)1 << kXYShift;

}  // namespace

extern "C" {

TREX_HOT_CLONES
void trex_box_blur_u8(const uint8_t* src, int32_t h, int32_t w, int32_t kw,
                      int32_t kh, uint8_t* dst) {
    const int ax = kw / 2, ay = kh / 2;
    std::vector<int32_t> xs(w + kw), ys(h + kh);
    for (int i = 0; i < w + kw; ++i) xs[i] = reflect101(i - ax, w);
    for (int i = 0; i < h + kh; ++i) ys[i] = reflect101(i - ay, h);
    std::vector<int32_t> rs((size_t)h * w);
    for (int y = 0; y < h; ++y) {
        const uint8_t* row = src + (size_t)y * w;
        int32_t* out = rs.data() + (size_t)y * w;
        int32_t s = 0;
        for (int j = 0; j < kw; ++j) s += row[xs[j]];
        out[0] = s;
        for (int x = 1; x < w; ++x) {
            s += row[xs[x + kw - 1]] - row[xs[x - 1]];
            out[x] = s;
        }
    }
    std::vector<int64_t> acc(w, 0);
    for (int i = 0; i < kh; ++i) {
        const int32_t* r = rs.data() + (size_t)ys[i] * w;
        for (int x = 0; x < w; ++x) acc[x] += r[x];
    }
    const int64_t n = (int64_t)kw * kh;
    for (int y = 0; y < h; ++y) {
        uint8_t* out = dst + (size_t)y * w;
        for (int x = 0; x < w; ++x) out[x] = round_div(acc[x], n);
        if (y + 1 < h) {
            const int32_t* add = rs.data() + (size_t)ys[y + kh] * w;
            const int32_t* sub = rs.data() + (size_t)ys[y] * w;
            for (int x = 0; x < w; ++x) acc[x] += add[x] - sub[x];
        }
    }
}

TREX_HOT_CLONES
void trex_gaussian5_u8(const uint8_t* src, int32_t h, int32_t w,
                       uint8_t* dst) {
    static const int32_t k[5] = {16, 64, 96, 64, 16};
    std::vector<int32_t> xs(w + 4), ys(h + 4);
    for (int i = 0; i < w + 4; ++i) xs[i] = reflect101(i - 2, w);
    for (int i = 0; i < h + 4; ++i) ys[i] = reflect101(i - 2, h);
    std::vector<int32_t> rs((size_t)h * w);
    for (int y = 0; y < h; ++y) {
        const uint8_t* row = src + (size_t)y * w;
        int32_t* out = rs.data() + (size_t)y * w;
        for (int x = 0; x < w; ++x) {
            int32_t s = 0;
            for (int j = 0; j < 5; ++j) s += k[j] * row[xs[x + j]];
            out[x] = s;
        }
    }
    for (int y = 0; y < h; ++y) {
        const int32_t* r[5];
        for (int j = 0; j < 5; ++j) r[j] = rs.data() + (size_t)ys[y + j] * w;
        uint8_t* out = dst + (size_t)y * w;
        for (int x = 0; x < w; ++x) {
            int64_t s = 0;
            for (int j = 0; j < 5; ++j) s += (int64_t)k[j] * r[j][x];
            s = (s + (1 << 15)) >> 16;
            out[x] = (uint8_t)(s > 255 ? 255 : s);
        }
    }
}

// `kernel` holds getGaussianKernel(block, 0, CV_32F).
TREX_HOT_CLONES
void trex_adaptive_gaussian_u8(const uint8_t* src, int32_t h, int32_t w,
                               int32_t block, const float* kernel,
                               int32_t idelta, uint8_t max_value,
                               uint8_t* dst) {
    static const float one = 1.f;
    const int nx = w == 1 ? 1 : block, ny = h == 1 ? 1 : block;
    const float* kx = w == 1 ? &one : kernel;
    const float* ky = h == 1 ? &one : kernel;
    const int rx = nx / 2, ry = ny / 2;
    const int nv = w / 8 * 8;
    const int nr = nv + (w - nv >= 4 ? 4 : 0);
    // the scalar row loop fuses its last (n - 1) % 4 taps
    const int plain_taps = (nx - 1) - (nx - 1) % 4;
    std::vector<float> tmp((size_t)h * w), row(w + nx), s(w);
    for (int y = 0; y < h; ++y) {
        const uint8_t* in = src + (size_t)y * w;
        for (int i = 0; i < w + nx - 1; ++i)
            row[i] = (float)in[replicate(i - rx, w)];
        for (int x = 0; x < w; ++x) s[x] = row[x] * kx[0];
        for (int j = 1; j < nx; ++j) {
            const float kj = kx[j];
            const float* rj = row.data() + j;
            for (int x = 0; x < nr; ++x) s[x] = std::fma(rj[x], kj, s[x]);
            if (j <= plain_taps)
                for (int x = nr; x < w; ++x) s[x] = s[x] + rj[x] * kj;
            else
                for (int x = nr; x < w; ++x) s[x] = std::fma(rj[x], kj, s[x]);
        }
        std::memcpy(tmp.data() + (size_t)y * w, s.data(), sizeof(float) * w);
    }
    for (int y = 0; y < h; ++y) {
        const float* c = tmp.data() + (size_t)y * w;
        for (int x = 0; x < w; ++x) s[x] = c[x] * ky[ry];
        for (int j = 1; j <= ry; ++j) {
            const float kj = ky[ry + j];
            const float* a = tmp.data() + (size_t)replicate(y + j, h) * w;
            const float* b = tmp.data() + (size_t)replicate(y - j, h) * w;
            for (int x = 0; x < nv; ++x) s[x] = std::fma(a[x] + b[x], kj, s[x]);
            for (int x = nv; x < w; ++x) s[x] = s[x] + (a[x] + b[x]) * kj;
        }
        const uint8_t* in = src + (size_t)y * w;
        uint8_t* out = dst + (size_t)y * w;
        for (int x = 0; x < w; ++x) {
            float m = std::nearbyint(s[x]);
            m = m < 0.f ? 0.f : (m > 255.f ? 255.f : m);
            out[x] = (int)in[x] - (int)m > -idelta ? max_value : 0;
        }
    }
}

// Erode (`dilate` 0) or dilate with an element whose row i (offset
// dy[i] from the anchor row) is the run [lo[i], hi[i]] about the anchor
// column (lo <= 0 <= hi); the runs, taken from the narrowest, must each
// hold the one before (an ellipse's rows, a rectangle's). Pixels outside
// the image are neutral.
TREX_HOT_CLONES
void trex_morph_runs_u8(const uint8_t* src, int32_t h, int32_t w,
                        const int32_t* dy, const int32_t* lo,
                        const int32_t* hi, int32_t n, int32_t dilate,
                        uint8_t* dst) {
    const uint8_t neutral = dilate ? 0 : 255;
    std::memset(dst, neutral, (size_t)h * w);
    std::vector<int32_t> order(n);
    for (int i = 0; i < n; ++i) order[i] = i;
    std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
        return hi[a] - lo[a] < hi[b] - lo[b];
    });
    int left = 0, right = 0;
    for (int i = 0; i < n; ++i) {
        left = std::max(left, -lo[i]);
        right = std::max(right, hi[i]);
    }
    std::vector<uint8_t> pad(w + left + right, neutral), cur(w);
    for (int sy = 0; sy < h; ++sy) {
        std::memcpy(pad.data() + left, src + (size_t)sy * w, w);
        std::memcpy(cur.data(), src + (size_t)sy * w, w);
        int cl = 0, cr = 0;
        for (int oi = 0; oi < n; ++oi) {
            const int i = order[oi];
            while (cl > lo[i] || cr < hi[i]) {
                const uint8_t* p = pad.data() + left +
                                   (cl > lo[i] ? --cl : ++cr);
                if (dilate)
                    for (int x = 0; x < w; ++x) cur[x] = std::max(cur[x], p[x]);
                else
                    for (int x = 0; x < w; ++x) cur[x] = std::min(cur[x], p[x]);
            }
            // source row sy feeds output row sy - dy[i]
            const int oy = sy - dy[i];
            if (oy < 0 || oy >= h) continue;
            uint8_t* out = dst + (size_t)oy * w;
            if (dilate)
                for (int x = 0; x < w; ++x) out[x] = std::max(out[x], cur[x]);
            else
                for (int x = 0; x < w; ++x) out[x] = std::min(out[x], cur[x]);
        }
    }
}

// fillPoly(img, [pts], color) of one int32 polygon, LINE_8, shift 0.
void trex_fill_poly_u8(uint8_t* img, int32_t h, int32_t w,
                       const int32_t* pts, int32_t count, uint8_t color) {
    if (count <= 0) return;
    std::vector<PolyEdge> edges;
    edges.reserve(count + 1);
    // CollectPolyEdges
    P64 pt0{(int64_t)pts[2 * (count - 1)] << kXYShift,
            (int64_t)pts[2 * (count - 1) + 1]};
    for (int i = 0; i < count; ++i) {
        P64 pt1{(int64_t)pts[2 * i] << kXYShift, (int64_t)pts[2 * i + 1]};
        P64 pt0c = pt0, pt1c = pt1;
        P64 t0{(pt0.x + (kXYOne >> 1)) >> kXYShift, pt0.y};
        P64 t1{(pt1.x + (kXYOne >> 1)) >> kXYShift, pt1.y};
        draw_line8(img, h, w, t0, t1, color);
        if ((uint64_t)t0.x >= (uint64_t)w || (uint64_t)t1.x >= (uint64_t)w ||
            (uint64_t)t0.y >= (uint64_t)h || (uint64_t)t1.y >= (uint64_t)h) {
            clip_line(w, h, t0, t1);
            pt0c.x = t0.x << kXYShift;
            pt1c.x = t1.x << kXYShift;
            if (t0.y != t1.y) {
                pt0c.y = t0.y;
                pt1c.y = t1.y;
            }
        }
        if (pt0.y != pt1.y) {
            PolyEdge e;
            e.next = nullptr;
            e.dx = (pt1c.x - pt0c.x) / (pt1c.y - pt0c.y);
            if (pt0.y < pt1.y) {
                e.y0 = (int)pt0.y;
                e.y1 = (int)pt1.y;
                e.x = pt0c.x + (pt0.y - pt0c.y) * e.dx;
            } else {
                e.y0 = (int)pt1.y;
                e.y1 = (int)pt0.y;
                e.x = pt1c.x + (pt1.y - pt1c.y) * e.dx;
            }
            edges.push_back(e);
        }
        pt0 = pt1;
    }
    // FillEdgeCollection
    const int total = (int)edges.size();
    if (total < 2) return;
    int y_max = INT32_MIN, y_min = INT32_MAX;
    int64_t x_max = INT64_MIN, x_min = INT64_MAX;
    for (const PolyEdge& e1 : edges) {
        const int64_t x1 = e1.x + (int64_t)(e1.y1 - e1.y0) * e1.dx;
        y_min = std::min(y_min, e1.y0);
        y_max = std::max(y_max, e1.y1);
        x_min = std::min(x_min, std::min(e1.x, x1));
        x_max = std::max(x_max, std::max(e1.x, x1));
    }
    if (y_max < 0 || y_min >= h || x_max < 0 ||
        x_min >= ((int64_t)w << kXYShift))
        return;
    std::sort(edges.begin(), edges.end(),
              [](const PolyEdge& a, const PolyEdge& b) {
                  if (a.y0 != b.y0) return a.y0 < b.y0;
                  if (a.x != b.x) return a.x < b.x;
                  return a.dx < b.dx;
              });
    PolyEdge tmp;
    tmp.y0 = INT32_MAX;
    tmp.next = nullptr;
    edges.push_back(tmp);
    int i = 0;
    PolyEdge* e = &edges[0];
    y_max = std::min(y_max, (int)h);
    for (int y = e->y0; y < y_max; ++y) {
        PolyEdge *last, *prelast, *keep_prelast;
        int draw = 0;
        const bool clipline = y < 0;
        prelast = &tmp;
        last = tmp.next;
        while (last || e->y0 == y) {
            if (last && last->y1 == y) {
                prelast->next = last->next;
                last = last->next;
                continue;
            }
            keep_prelast = prelast;
            if (last && (e->y0 > y || last->x < e->x)) {
                prelast = last;
                last = last->next;
            } else if (i < total) {
                prelast->next = e;
                e->next = last;
                prelast = e;
                e = &edges[++i];
            } else {
                break;
            }
            if (draw) {
                if (!clipline) {
                    int64_t x1, x2;
                    // the pixels whose centres lie within the span
                    if (keep_prelast->x > prelast->x) {
                        x1 = (prelast->x + kXYOne - 1) >> kXYShift;
                        x2 = keep_prelast->x >> kXYShift;
                    } else {
                        x1 = (keep_prelast->x + kXYOne - 1) >> kXYShift;
                        x2 = prelast->x >> kXYShift;
                    }
                    if (x1 < w && x2 >= 0) {
                        if (x1 < 0) x1 = 0;
                        if (x2 >= w) x2 = w - 1;
                        std::memset(img + (size_t)y * w + x1, color,
                                    (size_t)(x2 - x1 + 1));
                    }
                }
                keep_prelast->x += keep_prelast->dx;
                prelast->x += prelast->dx;
            }
            draw ^= 1;
        }
        // sort the active edges by x (bubble sort; each pass stops at the
        // previous pass's last exchange)
        keep_prelast = nullptr;
        do {
            prelast = &tmp;
            last = tmp.next;
            PolyEdge* last_exchange = nullptr;
            while (last != keep_prelast && last->next != nullptr) {
                PolyEdge* te = last->next;
                if (last->x > te->x) {
                    prelast->next = te;
                    last->next = te->next;
                    te->next = last;
                    prelast = te;
                    last_exchange = prelast;
                } else {
                    prelast = last;
                    last = te;
                }
            }
            if (last_exchange == nullptr) break;
            keep_prelast = last_exchange;
        } while (keep_prelast != tmp.next && keep_prelast != &tmp);
    }
}

// `a` is the 3x3 camera matrix (row major), `ir` its inverse as
// cv::invert(DECOMP_LU) gives it, `dist` the nd distortion terms.
TREX_HOT_CLONES
void trex_undistort_maps_f32(const double* a, const double* ir,
                             const double* dist, int32_t nd, int32_t w,
                             int32_t h, float* map1, float* map2) {
    const double u0 = a[2], v0 = a[5], fx = a[0], fy = a[4];
    const double k1 = dist[0], k2 = dist[1], p1 = dist[2], p2 = dist[3];
    const double k3 = nd >= 5 ? dist[4] : 0.;
    const double k4 = nd >= 8 ? dist[5] : 0., k5 = nd >= 8 ? dist[6] : 0.;
    const double k6 = nd >= 8 ? dist[7] : 0.;
    const double s1 = nd >= 12 ? dist[8] : 0., s2 = nd >= 12 ? dist[9] : 0.;
    const double s3 = nd >= 12 ? dist[10] : 0., s4 = nd >= 12 ? dist[11] : 0.;
    const double tau_x = nd >= 14 ? dist[12] : 0.;
    const double tau_y = nd >= 14 ? dist[13] : 0.;
    // computeTiltProjectionMatrix: matProjZ * (matRotY * matRotX)
    double t[9];
    {
        const double cx = std::cos(tau_x), sx = std::sin(tau_x);
        const double cy = std::cos(tau_y), sy = std::sin(tau_y);
        const double rx[9] = {1, 0, 0, 0, cx, sx, 0, -sx, cx};
        const double ry[9] = {cy, 0, -sy, 0, 1, 0, sy, 0, cy};
        double rxy[9];
        for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j) {
                double s = 0;
                for (int k = 0; k < 3; ++k) s += ry[i * 3 + k] * rx[k * 3 + j];
                rxy[i * 3 + j] = s;
            }
        const double pz[9] = {rxy[8], 0, -rxy[2], 0, rxy[8], -rxy[5], 0, 0, 1};
        for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j) {
                double s = 0;
                for (int k = 0; k < 3; ++k) s += pz[i * 3 + k] * rxy[k * 3 + j];
                t[i * 3 + j] = s;
            }
    }
    const int step = 8;
    for (int i = 0; i < h; ++i) {
        float* m1 = map1 + (size_t)i * w;
        float* m2 = map2 + (size_t)i * w;
        double _x = i * ir[1] + ir[2], _y = i * ir[4] + ir[5];
        double _w = i * ir[7] + ir[8];
        int j = 0;
        for (; j <= w - step; j += step, _x += step * ir[0],
                              _y += step * ir[3], _w += step * ir[6]) {
            for (int l = 0; l < step; ++l) {
                const double idx = l;
                const double ww = 1. / (_w + ir[6] * idx);
                double x = (_x + ir[0] * idx) * ww;
                double y = (_y + ir[3] * idx) * ww;
                double xd = x * x, yd = y * y;
                const double r2 = xd + yd;
                double kr = std::fma(std::fma(std::fma(k3, r2, k2), r2, k1),
                                     r2, 1.);
                kr *= 1. / std::fma(std::fma(std::fma(k6, r2, k5), r2, k4), r2, 1.);
                xd = std::fma(2., xd, r2);
                yd = std::fma(2., yd, r2);
                const double xy2 = x * y * 2.;
                x *= kr;
                y *= kr;
                xd = std::fma(xd, p2, x);
                yd = std::fma(yd, p1, y);
                xd = std::fma(p1, xy2, xd);
                yd = std::fma(p2, xy2, yd);
                const double r4 = r2 * r2;
                xd = std::fma(s1, r2, std::fma(s2, r4, xd));
                yd = std::fma(s3, r2, std::fma(s4, r4, yd));
                const double tx = std::fma(t[0], xd, std::fma(t[1], yd, t[2]));
                const double ty = std::fma(t[3], xd, std::fma(t[4], yd, t[5]));
                double tz = std::fma(t[6], xd, std::fma(t[7], yd, t[8]));
                tz = tz == 0. ? 1. : 1. / tz;
                m1[j + l] = (float)std::fma(fx * tz, tx, u0);
                m2[j + l] = (float)std::fma(fy * tz, ty, v0);
            }
        }
        for (; j < w; ++j, _x += ir[0], _y += ir[3], _w += ir[6]) {
            const double ww = 1. / _w, x = _x * ww, y = _y * ww;
            const double x2 = x * x, y2 = y * y;
            const double r2 = x2 + y2, xy2 = 2 * x * y;
            const double kr = (1 + ((k3 * r2 + k2) * r2 + k1) * r2) /
                              (1 + ((k6 * r2 + k5) * r2 + k4) * r2);
            const double xd = (x * kr + p1 * xy2 + p2 * (r2 + 2 * x2) +
                               s1 * r2 + s2 * r2 * r2);
            const double yd = (y * kr + p1 * (r2 + 2 * y2) + p2 * xy2 +
                               s3 * r2 + s4 * r2 * r2);
            double v[3];
            for (int r = 0; r < 3; ++r) {
                double s = 0;
                s += t[r * 3] * xd;
                s += t[r * 3 + 1] * yd;
                s += t[r * 3 + 2] * 1.;
                v[r] = s;
            }
            const double inv = v[2] ? 1. / v[2] : 1;
            m1[j] = (float)(fx * inv * v[0] + u0);
            m2[j] = (float)(fy * inv * v[1] + v0);
        }
    }
}

TREX_HOT_CLONES
void trex_remap_linear_u8(const uint8_t* src, int32_t h, int32_t w,
                          int32_t cn, const float* map1, const float* map2,
                          int32_t dh, int32_t dw, uint8_t* dst) {
    // coordinates beyond the image clamp to a point whose taps read 0
    auto clamp = [](float v, int64_t hi) -> int64_t {
        if (!(v > -2.f)) return -2;
        if (v > static_cast<float>(hi)) return hi;
        return static_cast<int64_t>(v);
    };
    for (int64_t i = 0; i < (int64_t)dh * dw; ++i) {
        const float sx = map1[i], sy = map2[i];
        const float fx = std::floor(sx), fy = std::floor(sy);
        const float a = sx - fx, b = sy - fy;
        const int64_t ix = clamp(fx, w), iy = clamp(fy, h);
        const bool x0in = ix >= 0 && ix < w, x1in = ix + 1 >= 0 && ix + 1 < w;
        const bool y0in = iy >= 0 && iy < h, y1in = iy + 1 >= 0 && iy + 1 < h;
        auto tap = [&](bool in, int64_t y, int64_t x, int c) -> float {
            return in ? static_cast<float>(src[(y * w + x) * cn + c]) : 0.f;
        };
        for (int c = 0; c < cn; ++c) {
            const float p00 = tap(y0in && x0in, iy, ix, c);
            const float p01 = tap(y0in && x1in, iy, ix + 1, c);
            const float p10 = tap(y1in && x0in, iy + 1, ix, c);
            const float p11 = tap(y1in && x1in, iy + 1, ix + 1, c);
            const float v0 = std::fma(a, p01 - p00, p00);
            const float v1 = std::fma(a, p11 - p10, p10);
            float v = std::nearbyint(std::fma(b, v1 - v0, v0));
            v = v < 0.f ? 0.f : (v > 255.f ? 255.f : v);
            dst[i * cn + c] = static_cast<uint8_t>(v);
        }
    }
}

// Undo the filters of `h` scan lines of `stride` bytes (a filter-type
// byte then stride - 1 data bytes) in place; `bpp` is the bytes per
// complete pixel (at least 1). Returns 0, or -1 on an unknown filter.
int32_t trex_png_unfilter(uint8_t* data, int64_t h, int64_t stride,
                          int32_t bpp) {
    const int64_t n = stride - 1;
    const uint8_t* prev = nullptr;
    for (int64_t y = 0; y < h; ++y) {
        uint8_t* line = data + y * stride;
        const uint8_t f = line[0];
        uint8_t* r = line + 1;
        switch (f) {
            case 0:
                break;
            case 1:
                for (int64_t i = bpp; i < n; ++i) r[i] = (uint8_t)(r[i] + r[i - bpp]);
                break;
            case 2:
                if (prev)
                    for (int64_t i = 0; i < n; ++i) r[i] = (uint8_t)(r[i] + prev[i]);
                break;
            case 3:
                for (int64_t i = 0; i < n; ++i) {
                    const int left = i >= bpp ? r[i - bpp] : 0;
                    const int up = prev ? prev[i] : 0;
                    r[i] = (uint8_t)(r[i] + ((left + up) >> 1));
                }
                break;
            case 4:
                for (int64_t i = 0; i < n; ++i) {
                    const int a = i >= bpp ? r[i - bpp] : 0;
                    const int b = prev ? prev[i] : 0;
                    const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
                    const int p = a + b - c;
                    const int pa = std::abs(p - a), pb = std::abs(p - b),
                              pc = std::abs(p - c);
                    const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                    r[i] = (uint8_t)(r[i] + pred);
                }
                break;
            default:
                return -1;
        }
        prev = r;
    }
    return 0;
}

}  // extern "C"
