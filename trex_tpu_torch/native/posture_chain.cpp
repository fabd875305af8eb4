// Native midline chain: calculate_midline_from_outline in one call.
//
// Mirrors track/posture.py (itself rebuilt from the reference's
// Outline.cpp:330-1010 + commons periodic::eft/curvature) bit-exactly:
// smoothing -> signed-area orientation -> EFT approximation ->
// periodic curvature -> tail/head peaks -> midline walk ->
// post_process -> normalize resample. Exactness rules replicated from
// numpy 2.x (verified empirically in tests/test_posture_native.py):
//   - last-axis reductions use numpy's pairwise summation (<8
//     sequential, <=128 8-way unrolled + sequential remainder, else
//     halved recursion on a multiple-of-8 boundary)
//   - axis-0 / middle-axis reductions and cumsum are sequential
//   - float32 hypot == (float)hypot(double, double); cos/sin/acos/
//     atan2 come from the same libm numpy calls into
//   - python round() == rint() (half-to-even)
// Compile with -ffp-contract=off (build.py) so mul+add never fuses.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

extern "C" int64_t trex_midline_walk(const float* pts, int64_t L,
                                     int32_t max_offset, float* seg_out,
                                     int64_t cap);

namespace {

// numpy pairwise_sum (numpy/_core/src/umath/loops_utils.h.src semantics)
template <typename T>
T pairwise_sum(const T* a, int64_t n) {
    if (n == 0) return T(0);
    if (n < 8) {
        T s = a[0];
        for (int64_t i = 1; i < n; i++) s = s + a[i];
        return s;
    }
    if (n <= 128) {
        T r[8];
        for (int i = 0; i < 8; i++) r[i] = a[i];
        int64_t i = 8;
        for (; i < n - (n % 8); i += 8)
            for (int j = 0; j < 8; j++) r[j] = r[j] + a[i + j];
        T res = ((r[0] + r[1]) + (r[2] + r[3]))
              + ((r[4] + r[5]) + (r[6] + r[7]));
        for (; i < n; i++) res = res + a[i];
        return res;
    }
    int64_t n2 = n / 2;
    n2 -= n2 % 8;
    return pairwise_sum(a, n2) + pairwise_sum(a + n2, n - n2);
}

inline float hypot32(float x, float y) {
    return (float)std::hypot((double)x, (double)y);
}

struct P32 { float x, y; };

// smooth_points (Outline.cpp:380-436): triangular periodic weights
std::vector<P32> smooth_points(const std::vector<P32>& pts,
                               double samples, int step) {
    const int64_t L = (int64_t)pts.size();
    if ((double)L <= samples || samples <= 0) return pts;
    const int step_row = (int)(samples * (double)step);
    if (step_row < 1) return pts;  // 0 < samples*step < 1: no smoothing
                                   // (a 0 step_row NaN-poisons weights)
    std::vector<int> offs;
    for (int o = -step_row; o <= step_row; o += step) offs.push_back(o);
    const int64_t K = (int64_t)offs.size();
    std::vector<double> w(K);
    for (int64_t k = 0; k < K; k++)
        w[k] = (double)(step_row - std::abs(offs[k])) / (double)step_row;
    const double wsum = pairwise_sum(w.data(), K);
    for (int64_t k = 0; k < K; k++) w[k] = w[k] / wsum;
    std::vector<P32> out(L);
    for (int64_t i = 0; i < L; i++) {
        double sx = 0.0, sy = 0.0;  // sequential middle-axis reduction
        for (int64_t k = 0; k < K; k++) {
            int64_t j = (i + offs[k]) % L;
            if (j < 0) j += L;
            const double px = (double)pts[j].x * w[k];
            const double py = (double)pts[j].y * w[k];
            if (k == 0) { sx = px; sy = py; }
            else { sx = sx + px; sy = sy + py; }
        }
        out[i].x = (float)sx;
        out[i].y = (float)sy;
    }
    return out;
}

double signed_area(const std::vector<P32>& p) {
    const int64_t L = (int64_t)p.size();
    std::vector<float> terms(L);
    for (int64_t i = 0; i < L; i++) {
        const int64_t j = (i + 1) % L;
        terms[i] = p[i].x * p[j].y - p[j].x * p[i].y;
    }
    return 0.5 * (double)pairwise_sum(terms.data(), L);
}

// EFT round-trip (commons periodic::eft/ieft, Kuhl & Giardina),
// matching track/posture.py eft()/ieft() dtype flow exactly.
void eft_roundtrip(std::vector<P32>& pts, int harmonics) {
    const int64_t L = (int64_t)pts.size();
    // center = points.mean(axis=0) in float32 (sequential axis-0 sum)
    float cx = pts[0].x, cy = pts[0].y;
    for (int64_t i = 1; i < L; i++) { cx = cx + pts[i].x; cy = cy + pts[i].y; }
    cx = cx / (float)L;
    cy = cy / (float)L;
    // d = diff of centered closed contour; dt = f32 hypot (0 -> 1e-12)
    std::vector<float> dx(L), dy(L), dt(L);
    for (int64_t i = 0; i < L; i++) {
        const int64_t j = (i + 1) % L;
        const float x0 = pts[i].x - cx, y0 = pts[i].y - cy;
        const float x1 = pts[j].x - cx, y1 = pts[j].y - cy;
        dx[i] = x1 - x0;
        dy[i] = y1 - y0;
        float h = hypot32(dx[i], dy[i]);
        dt[i] = (h == 0.0f) ? (float)1e-12 : h;
    }
    // t = [0, cumsum_f32(dt)] widened to double
    std::vector<double> t(L + 1);
    t[0] = 0.0;
    float run = dt[0];
    t[1] = (double)run;
    for (int64_t i = 1; i < L; i++) { run = run + dt[i]; t[i + 1] = (double)run; }
    const double T = t[L];
    const int H = harmonics;
    std::vector<double> A(H), B(H), C(H), D(H);
    std::vector<double> ta(L), tb(L), tc(L), td(L);
    for (int h = 1; h <= H; h++) {
        const double w = 2.0 * M_PI * (double)h;
        // np.pi ** 2 goes through CPython float_pow -> libm pow
        const double c = T / ((double)(2 * h * h) * std::pow(M_PI, 2.0));
        for (int64_t i = 0; i < L; i++) {
            const double p1 = w * t[i + 1] / T, p0 = w * t[i] / T;
            const double dcos = std::cos(p1) - std::cos(p0);
            const double dsin = std::sin(p1) - std::sin(p0);
            const float qx = dx[i] / dt[i];  // f32 division first
            const float qy = dy[i] / dt[i];
            ta[i] = (double)qx * dcos;
            tb[i] = (double)qx * dsin;
            tc[i] = (double)qy * dcos;
            td[i] = (double)qy * dsin;
        }
        A[h - 1] = c * pairwise_sum(ta.data(), L);
        B[h - 1] = c * pairwise_sum(tb.data(), L);
        C[h - 1] = c * pairwise_sum(tc.data(), L);
        D[h - 1] = c * pairwise_sum(td.data(), L);
    }
    // ieft back to L uniformly spaced points
    const double delta = T / (double)L;  // linspace endpoint=False
    for (int64_t k = 0; k < L; k++) {
        const double tk = (double)k * delta;
        double sx = 0.0, sy = 0.0;
        for (int h = 1; h <= H; h++) {  // sequential axis-0 sum
            const double phi = (2.0 * M_PI * (double)h) * tk / T;
            const double cph = std::cos(phi), sph = std::sin(phi);
            const double rx = A[h - 1] * cph + B[h - 1] * sph;
            const double ry = C[h - 1] * cph + D[h - 1] * sph;
            if (h == 1) { sx = rx; sy = ry; }
            else { sx = sx + rx; sy = sy + ry; }
        }
        pts[k].x = (float)((double)cx + sx);
        pts[k].y = (float)((double)cy + sy);
    }
}

struct P64 { double x, y; };

// Midline::midline_direction over float64 segments
P64 midline_direction(const std::vector<P64>& segs, double stiff) {
    const int64_t M = (int64_t)segs.size();
    int64_t n = std::max<int64_t>(1, (int64_t)((double)M * stiff));
    double dx = 0.0, dy = 0.0;
    int64_t cnt = 0;
    for (int64_t i = 0; i < n; i++) {
        if (i + 1 >= M) break;
        dx += segs[i + 1].x - segs[i].x;
        dy += segs[i + 1].y - segs[i].y;
        cnt++;
    }
    if (cnt) {
        dx /= (double)cnt;
        dy /= (double)cnt;
        const double norm = std::hypot(dx, dy);
        if (norm > 0) { dx /= norm; dy /= norm; }
    }
    return {dx, dy};
}

inline double clip1(double v) {
    return v < -1.0 ? -1.0 : (v > 1.0 ? 1.0 : v);
}

// Midline::post_process (Outline.cpp:890-1010)
void post_process(std::vector<P64>& segs, std::vector<double>& heights,
                  int32_t* tail_index, int32_t* head_index,
                  int32_t* inverted,
                  double stiff, int midline_invert, int start_with_head,
                  const double* movement_dir) {
    const int64_t M = (int64_t)segs.size();
    if (M <= 2) return;
    bool needs_invert = !midline_invert;
    P64 dir = midline_direction(segs, stiff);
    double dx = needs_invert ? dir.x : -dir.x;
    double dy = needs_invert ? dir.y : -dir.y;
    if (movement_dir && (movement_dir[0] != 0.0 || movement_dir[1] != 0.0)) {
        double mx = movement_dir[0], my = movement_dir[1];
        const double nv = std::hypot(mx, my);
        if (nv > 0) { mx /= nv; my /= nv; }
        const double neg = std::acos(clip1((-dx) * mx + (-dy) * my));
        const double pos = std::acos(clip1(dx * mx + dy * my));
        if (neg < pos) {
            needs_invert = !needs_invert;
            *inverted = 1;
            std::swap(*tail_index, *head_index);
        }
    }
    bool reverse = false;
    if (needs_invert) {
        if (!start_with_head) reverse = true;
    } else if (start_with_head) {
        reverse = true;
    }
    if (reverse) {
        std::reverse(segs.begin(), segs.end());
        std::reverse(heights.begin(), heights.end());
    }
    if (stiff > 0) {
        const int64_t n = M;
        const int64_t center = (int64_t)std::min(
            (double)(n - 1), std::rint((double)n * stiff) + 1.0);
        const P64 center_point = segs[center];
        double ax = 0.0, ay = 0.0;
        int64_t count = 0;
        const int64_t extra = (int64_t)std::min(
            (double)n, (double)center + std::max(0.0, (double)n * 0.1));
        for (int64_t i = center; i < extra; i++) {
            if (i + 1 >= n) break;
            const double vx = segs[i].x - segs[i + 1].x;
            const double vy = segs[i].y - segs[i + 1].y;
            const double nv = std::hypot(vx, vy);
            if (nv > 0) { ax += vx / nv; ay += vy / nv; }
            count++;
        }
        if (count > 0) { ax /= (double)count; ay /= (double)count; }
        std::vector<P64> copy(segs);
        for (int64_t i = center; i > 0; i--) {
            const P64 p1 = segs[i];
            const double seg_len = std::hypot(copy[i].x - copy[i - 1].x,
                                              copy[i].y - copy[i - 1].y);
            double tx = segs[i - 1].x - center_point.x;
            double ty = segs[i - 1].y - center_point.y;
            double nv = std::hypot(tx, ty);
            if (nv > 0) { tx /= nv; ty /= nv; }
            double ex = (tx + ax) * 0.5, ey = (ty + ay) * 0.5;
            nv = std::hypot(ex, ey);
            if (nv > 0) { ex /= nv; ey /= nv; }
            segs[i - 1].x = p1.x + seg_len * ex;
            segs[i - 1].y = p1.y + seg_len * ey;
        }
    }
}

// Midline::normalize arc-length resampler (Outline.cpp:1279-1376),
// matching _normalize_resample's float32 positions / double walk.
bool normalize_resample(const std::vector<P64>& segments, int resolution,
                        std::vector<P32>& reduced) {
    const int64_t n = (int64_t)segments.size();
    if (n < 2) return false;
    std::vector<P32> segs(n);
    for (int64_t i = 0; i < n; i++) {
        segs[i].x = (float)segments[i].x;
        segs[i].y = (float)segments[i].y;
    }
    std::vector<double> lens(n - 1);
    for (int64_t i = 0; i + 1 < n; i++)
        lens[i] = (double)hypot32(segs[i + 1].x - segs[i].x,
                                  segs[i + 1].y - segs[i].y);
    const double raw_len = pairwise_sum(lens.data(), n - 1);
    if (raw_len == 0.0) return false;
    const int max_segments = resolution - 1;
    const double step = raw_len / (double)max_segments;
    reduced.clear();
    reduced.push_back(segs[0]);
    int64_t index = 0;
    double last_pt_distance = 0.0, distance = 0.0;
    while (distance <= raw_len && index < n - 1) {
        while (distance - last_pt_distance < step && index < n - 1) {
            distance += lens[index];
            index++;
        }
        double off = distance - last_pt_distance;
        if (off < step) break;
        while (off >= step) {
            off -= step;
            if (index > 0) {
                const P32 s0 = segs[index - 1], s1 = segs[index];
                const float lx = s1.x - s0.x, ly = s1.y - s0.y;
                const double local_d = (double)hypot32(lx, ly);
                double percent = off;
                if (local_d > 0) percent /= local_d;
                percent = 1.0 - percent;
                const float pf = (float)percent;
                P32 pos{s0.x + lx * pf, s0.y + ly * pf};
                reduced.push_back(pos);
                const float rf = (float)(1.0 - percent);
                const float rx = lx * rf, ry = ly * rf;
                last_pt_distance = distance - (double)hypot32(rx, ry);
            } else {
                reduced.push_back(segs[index]);
                last_pt_distance = distance;
            }
        }
    }
    const P32 last = reduced.back();
    if ((double)hypot32(last.x - segs[n - 1].x,
                        last.y - segs[n - 1].y) >= 0.01)
        reduced.push_back(segs[n - 1]);
    return (int64_t)reduced.size() == resolution;
}

}  // namespace

extern "C" {

// Full calculate_midline_from_outline. Returns 0 on success; 1..4 map
// to the python path's None outcomes (too few points / no peaks /
// walk too short / resample mismatch), -1 on capacity overflow.
int32_t trex_midline_chain(
    const float* points_in, int64_t n_in,
    double smooth_samples, int32_t smooth_step, int32_t n_approx,
    double curvature_range_ratio, int32_t midline_invert,
    double walk_offset, double stiff_percentage,
    int32_t start_with_head, int32_t resolution,
    const double* movement_dir,  // nullptr when absent
    double* out_segments, double* out_heights, int64_t max_seg,
    int64_t* out_nseg, int32_t* out_tail, int32_t* out_head,
    double* out_len, double* out_angle, int32_t* out_inverted) {
    if (n_in < 3) return 1;
    std::vector<P32> pts(n_in);
    std::memcpy(pts.data(), points_in, sizeof(float) * 2 * n_in);

    if (smooth_samples > 0)
        pts = smooth_points(pts, smooth_samples,
                            std::max(1, (int)smooth_step));
    if (signed_area(pts) < 0)
        std::reverse(pts.begin(), pts.end());
    if (n_approx > 0 && (int64_t)pts.size() > 2)
        eft_roundtrip(pts, n_approx);

    const int64_t L = (int64_t)pts.size();
    if (L < 3) return 1;
    const int64_t rng = std::max<int64_t>(
        1, (int64_t)(curvature_range_ratio * (double)L));

    // periodic Menger curvature, float32 like the numpy path
    std::vector<float> curv(L);
    for (int64_t i = 0; i < L; i++) {
        const int64_t i1 = ((i - rng) % L + L) % L;
        const int64_t i3 = (i + rng) % L;
        const float ax = pts[i].x - pts[i1].x, ay = pts[i].y - pts[i1].y;
        const float bx = pts[i3].x - pts[i].x, by = pts[i3].y - pts[i].y;
        const float cross = ax * by - ay * bx;
        const float d12 = hypot32(ax, ay);
        const float d23 = hypot32(bx, by);
        const float d13 = hypot32(pts[i3].x - pts[i1].x,
                                  pts[i3].y - pts[i1].y);
        const float prod = d12 * d23 * d13;
        const float m = std::max(prod, (float)1e-12);
        const float denom = std::sqrt(m);
        curv[i] = 2.0f * cross / denom;
    }
    // peaks: curv >= left && curv > right (periodic)
    std::vector<int64_t> peaks;
    for (int64_t i = 0; i < L; i++) {
        const float left = curv[((i - 1) % L + L) % L];
        const float right = curv[(i + 1) % L];
        if (curv[i] >= left && curv[i] > right) peaks.push_back(i);
    }
    if (peaks.empty()) return 2;
    int64_t tail = peaks[0];
    for (int64_t p : peaks)
        if (curv[p] > curv[tail]) tail = p;  // first max wins
    int64_t head = -1, max_d = -1;
    for (int64_t p : peaks) {
        int64_t d = std::abs(p - tail);
        d = std::min(d, L - d);
        if (d > max_d) { max_d = d; head = p; }
    }
    // rotate tail to index 0
    std::vector<float> rot(2 * L);
    for (int64_t i = 0; i < L; i++) {
        const int64_t j = (i + tail) % L;
        rot[2 * i] = pts[j].x;
        rot[2 * i + 1] = pts[j].y;
    }
    int32_t tail_index = 0;
    int32_t head_index = head >= 0
        ? (int32_t)(((head - tail) % L + L) % L) : -1;
    if (midline_invert) std::swap(tail_index, head_index);

    const int32_t max_offset = std::max(
        3, (int)(walk_offset * (double)L));
    std::vector<float> seg(3 * (L + 4));
    const int64_t m = trex_midline_walk(rot.data(), L, max_offset,
                                        seg.data(), L + 4);
    if (m <= 2) return 3;
    if (m > max_seg) return -1;

    std::vector<P64> segs(m);
    std::vector<double> heights(m);
    for (int64_t i = 0; i < m; i++) {
        segs[i].x = (double)seg[3 * i];
        segs[i].y = (double)seg[3 * i + 1];
        heights[i] = (double)seg[3 * i + 2];
    }
    int32_t inverted = 0;
    post_process(segs, heights, &tail_index, &head_index, &inverted,
                 stiff_percentage, midline_invert, start_with_head,
                 movement_dir);
    std::vector<P32> reduced;
    if (!normalize_resample(segs, resolution, reduced)) return 4;
    // len = pairwise f32 sum of resampled chord lengths
    std::vector<float> chord(reduced.size() - 1);
    for (size_t i = 0; i + 1 < reduced.size(); i++)
        chord[i] = hypot32(reduced[i + 1].x - reduced[i].x,
                           reduced[i + 1].y - reduced[i].y);
    const double len = (double)pairwise_sum(chord.data(),
                                            (int64_t)chord.size());
    const P64 dir = midline_direction(segs, stiff_percentage);
    const double angle = std::atan2(dir.y, dir.x);

    for (int64_t i = 0; i < m; i++) {
        out_segments[2 * i] = segs[i].x;
        out_segments[2 * i + 1] = segs[i].y;
        out_heights[i] = heights[i];
    }
    *out_nseg = m;
    *out_tail = tail_index;
    *out_head = head_index;
    *out_len = len;
    *out_angle = angle;
    *out_inverted = inverted;
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched full posture (engine throughput path): per blob, the whole
// chain from RLE lines+pixels to midline length/angle — crop build,
// posture-threshold escalation with biggest-component selection
// (track/posture.py calculate_posture + biggest_component semantics),
// 4x supersampled boundary trace, resample, midline chain — run
// natively with an internal thread pool (every step releases the GIL;
// the per-blob work is independent). Reference: Posture.cpp:305-410,
// TrackingHelper::process_postures thread pool.
// ---------------------------------------------------------------------------
#include <atomic>
#include <thread>

extern "C" {
void* trex_label_image2(const uint8_t* img, const uint8_t* bg,
                        int32_t width, int32_t height,
                        int32_t threshold, int32_t absolute,
                        int32_t track_threshold, int32_t track_absolute);
const double* trex_label_stats(void* ctx);
int64_t trex_label_n_blobs(void* ctx);
const int32_t* trex_label_lines(void* ctx);
const uint32_t* trex_label_blob_line_start(void* ctx);
void trex_label_free(void* ctx);
int64_t trex_trace_boundary(const uint8_t* mask, int32_t width,
                            int32_t height, float* out,
                            int64_t max_points);
int64_t trex_outline_resample(const float* pts, int64_t n,
                              double distance, float* out, int64_t cap);
int32_t trex_midline_chain(
    const float* points_in, int64_t n_in,
    double smooth_samples, int32_t smooth_step, int32_t n_approx,
    double curvature_range_ratio, int32_t midline_invert,
    double walk_offset, double stiff_percentage,
    int32_t start_with_head, int32_t resolution,
    const double* movement_dir,
    double* out_segments, double* out_heights, int64_t max_seg,
    int64_t* out_nseg, int32_t* out_tail, int32_t* out_head,
    double* out_len, double* out_angle, int32_t* out_inverted);
}

namespace {

struct PostureParams {
    int32_t posture_threshold;
    int32_t absolute;
    double outline_resample;
    double smooth_samples;
    int32_t smooth_step;
    int32_t n_approx;
    double curvature_range_ratio;
    int32_t midline_invert;
    double walk_offset;
    double stiff_percentage;
    int32_t start_with_head;
    int32_t resolution;
};

// optional full-geometry sink for one blob (the archive/export path):
// resampled outline points (crop-local f32 pairs), midline segments +
// heights, tail/head indices and the GLOBAL crop origin. `trunc` is
// set when a buffer capacity was exceeded — the caller falls back to
// the python chain for that blob.
struct FullOut {
    float* outline = nullptr;   // 2 * outline_cap
    int32_t* n_outline = nullptr;
    double* seg = nullptr;      // 2 * seg_cap
    double* heights = nullptr;  // seg_cap
    int32_t* nseg = nullptr;
    int32_t* tail = nullptr;
    int32_t* head = nullptr;
    int32_t* inverted = nullptr;
    double* off = nullptr;      // (ox, oy) global crop origin
    int64_t outline_cap = 0;
    int64_t seg_cap = 0;
    int32_t* trunc = nullptr;
};

// one blob end-to-end; returns true on success
bool posture_one(const int32_t* lines, int64_t K,
                 const uint8_t* pixels, int64_t n_px,
                 const uint8_t* bg, int32_t bg_w, int32_t bg_h,
                 const PostureParams& p, const double* mdir,
                 double* out_len, double* out_angle,
                 double* out_dirx, double* out_diry,
                 FullOut* full = nullptr) {
    if (K == 0) return false;
    int32_t y0 = INT32_MAX, y1 = INT32_MIN, x0 = INT32_MAX,
            x1 = INT32_MIN;
    for (int64_t k = 0; k < K; k++) {
        y0 = std::min(y0, lines[3 * k]);
        y1 = std::max(y1, lines[3 * k]);
        x0 = std::min(x0, lines[3 * k + 1]);
        x1 = std::max(x1, lines[3 * k + 2]);
    }
    const int32_t pad = 1;
    const int32_t W = x1 - x0 + 1 + 2 * pad, H = y1 - y0 + 1 + 2 * pad;
    const int32_t ox = x0 - pad, oy = y0 - pad;
    std::vector<uint8_t> mask((size_t)W * H, 0), gray((size_t)W * H, 0),
        bgc((size_t)W * H, 0);
    for (int32_t r = 0; r < H; r++) {
        const int32_t by = oy + r;
        if (by < 0 || by >= bg_h) continue;
        const int32_t cx0 = std::max(0, -ox),
                      cx1 = std::min(W, bg_w - ox);
        if (cx1 > cx0)
            std::memcpy(bgc.data() + (size_t)r * W + cx0,
                        bg + (size_t)by * bg_w + ox + cx0, cx1 - cx0);
    }
    int64_t i = 0;
    for (int64_t k = 0; k < K; k++) {
        const int32_t ly = lines[3 * k], lx0 = lines[3 * k + 1],
                      lx1 = lines[3 * k + 2];
        const int32_t n = lx1 - lx0 + 1;
        std::memset(mask.data() + (size_t)(ly - oy) * W + (lx0 - ox),
                    1, n);
        std::memcpy(gray.data() + (size_t)(ly - oy) * W + (lx0 - ox),
                    pixels + i, n);
        i += n;
    }
    const int64_t num_pixels = n_px;
    const int64_t minimum_pixels = std::max<int64_t>(1, num_pixels / 10);
    int32_t base = p.posture_threshold, threshold = base;

    std::vector<uint8_t> keep((size_t)W * H);
    std::vector<uint8_t> dense((size_t)W * H);
    std::vector<uint8_t> mask4;
    std::vector<float> pts, rp;
    std::vector<double> segbuf, hbuf;

    while (true) {
        // biggest_component at `threshold` (posture.py:157-195,
        // closing_steps == 0 path)
        int64_t kept = 0;
        for (size_t q = 0; q < (size_t)W * H; q++) {
            int32_t d = (int32_t)bgc[q] - (int32_t)gray[q];
            if (p.absolute) d = std::abs(d);
            keep[q] = (threshold > 0)
                ? (uint8_t)((d >= threshold && mask[q]) ? 255 : 0)
                : (uint8_t)(mask[q] ? 255 : 0);
            kept += keep[q] ? 1 : 0;
        }
        int64_t dense_sum = 0;
        if (kept > 0) {
            void* ctx = trex_label_image2(keep.data(), nullptr, W, H,
                                          0, 0, 0, 0);
            const int64_t nb = trex_label_n_blobs(ctx);
            if (nb > 0) {
                const double* st = trex_label_stats(ctx);
                int64_t big = 0;
                for (int64_t b = 1; b < nb; b++)
                    if (st[8 * b] > st[8 * big]) big = b;  // first max
                const int32_t* bl = trex_label_lines(ctx);
                const uint32_t* ls = trex_label_blob_line_start(ctx);
                std::fill(dense.begin(), dense.end(), 0);
                for (uint32_t li = ls[big]; li < ls[big + 1]; li++) {
                    const int32_t ly = bl[3 * li], a = bl[3 * li + 1],
                                  b2 = bl[3 * li + 2];
                    std::memset(dense.data() + (size_t)ly * W + a, 1,
                                b2 - a + 1);
                    dense_sum += b2 - a + 1;
                }
            }
            trex_label_free(ctx);
        }
        if (dense_sum < 1) break;

        // 4x supersample + trace (posture.py:724-727)
        const int32_t W4 = W * 4, H4 = H * 4;
        mask4.assign((size_t)W4 * H4, 0);
        for (int32_t r = 0; r < H; r++)
            for (int32_t c = 0; c < W; c++)
                if (dense[(size_t)r * W + c])
                    for (int32_t rr = 0; rr < 4; rr++)
                        std::memset(mask4.data()
                                        + (size_t)(r * 4 + rr) * W4
                                        + c * 4, 1, 4);
        const int64_t cap = 8LL * (H4 + W4) + 64;
        pts.resize(2 * std::max<int64_t>(cap, 8LL * W4 * H4 + 8));
        int64_t n = trex_trace_boundary(mask4.data(), W4, H4,
                                        pts.data(), cap);
        if (n >= cap)
            n = trex_trace_boundary(mask4.data(), W4, H4, pts.data(),
                                    8LL * W4 * H4 + 8);
        if (n >= 3) {
            for (int64_t q = 0; q < 2 * n; q++) pts[q] *= 0.25f;
            int64_t m = n;
            if (p.outline_resample > 0 && n > 1) {
                const int64_t rcap = 8 * n + 16;
                rp.resize(2 * rcap);
                const int64_t rn = trex_outline_resample(
                    pts.data(), n, p.outline_resample, rp.data(),
                    rcap);
                if (rn >= 0) {
                    m = rn;
                } else {
                    rp.assign(pts.begin(), pts.begin() + 2 * n);
                    m = n;
                }
            } else {
                rp.assign(pts.begin(), pts.begin() + 2 * n);
            }
            if (m >= 3) {
                const int64_t max_seg = m + 8;
                segbuf.resize(2 * max_seg);
                hbuf.resize(max_seg);
                int64_t nseg = 0;
                int32_t tail = 0, head = 0, inverted = 0;
                double len = 0, angle = 0;
                const int32_t rc = trex_midline_chain(
                    rp.data(), m, p.smooth_samples, p.smooth_step,
                    p.n_approx, p.curvature_range_ratio,
                    p.midline_invert, p.walk_offset,
                    p.stiff_percentage, p.start_with_head,
                    p.resolution, mdir, segbuf.data(), hbuf.data(),
                    max_seg, &nseg, &tail, &head, &len, &angle,
                    &inverted);
                if (rc == 0) {
                    *out_len = len;
                    *out_angle = angle;
                    // midline_direction over the final segments for
                    // the next frame's movement direction
                    std::vector<P64> segs(nseg);
                    for (int64_t q = 0; q < nseg; q++) {
                        segs[q].x = segbuf[2 * q];
                        segs[q].y = segbuf[2 * q + 1];
                    }
                    const P64 dir = midline_direction(
                        segs, p.stiff_percentage);
                    *out_dirx = dir.x;
                    *out_diry = dir.y;
                    if (full) {
                        if (m > full->outline_cap
                            || nseg > full->seg_cap) {
                            if (full->trunc) *full->trunc = 1;
                        } else {
                            std::memcpy(full->outline, rp.data(),
                                        sizeof(float) * 2 * m);
                            *full->n_outline = (int32_t)m;
                            std::memcpy(full->seg, segbuf.data(),
                                        sizeof(double) * 2 * nseg);
                            std::memcpy(full->heights, hbuf.data(),
                                        sizeof(double) * nseg);
                            *full->nseg = (int32_t)nseg;
                            *full->tail = tail;
                            *full->head = head;
                            *full->inverted = inverted;
                            full->off[0] = (double)ox;
                            full->off[1] = (double)oy;
                        }
                    }
                    return true;
                }
            }
        }
        threshold += 2;
        if (dense_sum < minimum_pixels || threshold >= base + 100)
            break;
    }
    return false;
}

}  // namespace

extern "C" {

// Batched posture over one frame's assigned blobs. movement_dirs is
// (n, 2) with has_movement flags (0 -> nullptr semantics). Outputs
// len/angle/dir per blob; ok[i] = 1 on success. n_threads <= 0 picks
// hardware_concurrency (capped 8).
void trex_posture_batch(
    const int32_t* lines, const int64_t* line_start,
    const uint8_t* pixels, const int64_t* pixel_start,
    int64_t n_blobs,
    const uint8_t* bg, int32_t bg_w, int32_t bg_h,
    int32_t posture_threshold, int32_t absolute,
    double outline_resample, double smooth_samples,
    int32_t smooth_step, int32_t n_approx,
    double curvature_range_ratio, int32_t midline_invert,
    double walk_offset, double stiff_percentage,
    int32_t start_with_head, int32_t resolution,
    const double* movement_dirs, const uint8_t* has_movement,
    double* out_len, double* out_angle,
    double* out_dirx, double* out_diry, int32_t* out_ok,
    int32_t n_threads) {
    PostureParams p{posture_threshold, absolute, outline_resample,
                    smooth_samples, smooth_step, n_approx,
                    curvature_range_ratio, midline_invert, walk_offset,
                    stiff_percentage, start_with_head, resolution};
    std::atomic<int64_t> next{0};
    auto work = [&]() {
        while (true) {
            const int64_t b = next.fetch_add(1);
            if (b >= n_blobs) return;
            const int64_t K = (line_start[b + 1] - line_start[b]);
            const double* mdir = (movement_dirs && has_movement
                                  && has_movement[b])
                ? movement_dirs + 2 * b : nullptr;
            const bool ok = posture_one(
                lines + 3 * line_start[b], K,
                pixels + pixel_start[b],
                pixel_start[b + 1] - pixel_start[b],
                bg, bg_w, bg_h, p, mdir,
                out_len + b, out_angle + b, out_dirx + b,
                out_diry + b);
            out_ok[b] = ok ? 1 : 0;
            if (!ok) {
                out_len[b] = out_angle[b] = 0.0;
                out_dirx[b] = out_diry[b] = 0.0;
            }
        }
    };
    int32_t nt = n_threads > 0
        ? n_threads
        : std::min(8u, std::max(1u,
              std::thread::hardware_concurrency()));
    nt = (int32_t)std::min<int64_t>(nt, std::max<int64_t>(1, n_blobs));
    if (nt <= 1) {
        work();
        return;
    }
    std::vector<std::thread> threads;
    for (int32_t t = 0; t < nt; t++) threads.emplace_back(work);
    for (auto& t : threads) t.join();
}

// trex_posture_batch plus full geometry per blob (the archive/export
// path): crop-local resampled outline points, midline segments +
// heights, tail/head/inverted indices and the global crop origin.
// out_trunc[i] = 1 when blob i exceeded outline_cap/seg_cap (the
// caller re-runs that blob through the python chain). Layouts:
//   out_outline (n, 2*outline_cap) f32,  out_n_outline (n,) i32
//   out_seg     (n, 2*seg_cap)     f64,  out_heights (n, seg_cap) f64
//   out_nseg/out_tail/out_head/out_inverted (n,) i32
//   out_off     (n, 2)             f64 (global ox, oy)
void trex_posture_batch_full(
    const int32_t* lines, const int64_t* line_start,
    const uint8_t* pixels, const int64_t* pixel_start,
    int64_t n_blobs,
    const uint8_t* bg, int32_t bg_w, int32_t bg_h,
    int32_t posture_threshold, int32_t absolute,
    double outline_resample, double smooth_samples,
    int32_t smooth_step, int32_t n_approx,
    double curvature_range_ratio, int32_t midline_invert,
    double walk_offset, double stiff_percentage,
    int32_t start_with_head, int32_t resolution,
    const double* movement_dirs, const uint8_t* has_movement,
    double* out_len, double* out_angle,
    double* out_dirx, double* out_diry, int32_t* out_ok,
    float* out_outline, int32_t* out_n_outline, int64_t outline_cap,
    double* out_seg, double* out_heights, int64_t seg_cap,
    int32_t* out_nseg, int32_t* out_tail, int32_t* out_head,
    int32_t* out_inverted, double* out_off, int32_t* out_trunc,
    int32_t n_threads) {
    PostureParams p{posture_threshold, absolute, outline_resample,
                    smooth_samples, smooth_step, n_approx,
                    curvature_range_ratio, midline_invert, walk_offset,
                    stiff_percentage, start_with_head, resolution};
    std::atomic<int64_t> next{0};
    auto work = [&]() {
        while (true) {
            const int64_t b = next.fetch_add(1);
            if (b >= n_blobs) return;
            const int64_t K = (line_start[b + 1] - line_start[b]);
            const double* mdir = (movement_dirs && has_movement
                                  && has_movement[b])
                ? movement_dirs + 2 * b : nullptr;
            FullOut full;
            full.outline = out_outline + 2 * outline_cap * b;
            full.n_outline = out_n_outline + b;
            full.seg = out_seg + 2 * seg_cap * b;
            full.heights = out_heights + seg_cap * b;
            full.nseg = out_nseg + b;
            full.tail = out_tail + b;
            full.head = out_head + b;
            full.inverted = out_inverted + b;
            full.off = out_off + 2 * b;
            full.outline_cap = outline_cap;
            full.seg_cap = seg_cap;
            full.trunc = out_trunc + b;
            out_trunc[b] = 0;
            out_n_outline[b] = 0;
            out_nseg[b] = 0;
            const bool ok = posture_one(
                lines + 3 * line_start[b], K,
                pixels + pixel_start[b],
                pixel_start[b + 1] - pixel_start[b],
                bg, bg_w, bg_h, p, mdir,
                out_len + b, out_angle + b, out_dirx + b,
                out_diry + b, &full);
            out_ok[b] = ok ? 1 : 0;
            if (!ok) {
                out_len[b] = out_angle[b] = 0.0;
                out_dirx[b] = out_diry[b] = 0.0;
            }
        }
    };
    int32_t nt = n_threads > 0
        ? n_threads
        : std::min(8u, std::max(1u,
              std::thread::hardware_concurrency()));
    nt = (int32_t)std::min<int64_t>(nt, std::max<int64_t>(1, n_blobs));
    if (nt <= 1) {
        work();
        return;
    }
    std::vector<std::thread> threads;
    for (int32_t t = 0; t < nt; t++) threads.emplace_back(work);
    for (auto& t : threads) t.join();
}

}  // extern "C"
