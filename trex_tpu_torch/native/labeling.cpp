// Connected-component labeling over thresholded background-difference
// images, emitting RLE horizontal lines + pixel values per blob.
//
// Host-side hot path of the conversion pipeline: equivalent role to the
// reference's commons CPULabeling::run + RawProcessing::generate_binary
// (usage: reference Application/src/tracker/python/
// BackgroundSubtraction.cpp:126-347). Design is line-run union-find
// (8-connectivity): extract foreground runs per row, merge runs that
// touch/overlap runs of the previous row, then compact into per-blob
// line/pixel arrays sorted in scan order.
//
// C API (ctypes):
//   ctx = trex_label_image(img, bg, w, h, threshold, absolute)
//   ...accessors...
//   trex_label_free(ctx)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <functional>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <vector>

#include "simd_clones.h"

namespace {

struct Run {
    int32_t y, x0, x1;
    uint32_t label;
};

struct Result {
    // per blob: [start, end) index into lines
    std::vector<uint32_t> blob_line_start;
    std::vector<uint32_t> blob_pixel_start;
    std::vector<int32_t> lines;    // 3 ints per line: y, x0, x1
    std::vector<uint8_t> pixels;   // concatenated per blob, line order
    // per blob, 8 doubles: n_px, track_count, sum_x, sum_y,
    //                      sum_xx, sum_yy, sum_xy, reserved
    std::vector<double> stats;
};

inline uint32_t find_root(std::vector<uint32_t>& parent, uint32_t x) {
    while (parent[x] != x) {
        parent[x] = parent[parent[x]];
        x = parent[x];
    }
    return x;
}

inline void unite(std::vector<uint32_t>& parent, uint32_t a, uint32_t b) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a != b) parent[std::max(a, b)] = std::min(a, b);
}

}  // namespace

extern "C" {

// mode for the threshold test applied to (img, background):
//   absolute != 0 : keep where |img - bg| >= threshold
//   absolute == 0 : keep where (bg - img) >= threshold   (darker-than-bg)
// threshold <= 0 keeps every pixel (blob = nonzero region of img).
// track_threshold > 0 additionally counts, per blob, the pixels that
// also pass the tracking-stage test (absolute: |img-bg| >= t,
// signed: bg-img >= t) — the pv::Blob::recount fused into this pass.
TREX_HOT_CLONES
void* trex_label_image2(const uint8_t* img, const uint8_t* bg,
                        int32_t width, int32_t height,
                        int32_t threshold, int32_t absolute,
                        int32_t track_threshold, int32_t track_absolute) {
    auto* res = new Result();
    std::vector<Run> prev_runs, cur_runs;
    std::vector<Run> all_runs;
    std::vector<uint32_t> parent;
    all_runs.reserve(1024);
    parent.reserve(1024);

    // vectorizable per-row foreground bytes + word-skipping run
    // extraction (background-dominated frames skip 8 px per test)
    std::vector<uint8_t> fgrow((size_t)width + 8, 0);
    for (int32_t y = 0; y < height; y++) {
        const uint8_t* row = img + (size_t)y * width;
        const uint8_t* brow = bg ? bg + (size_t)y * width : nullptr;
        cur_runs.clear();
        uint8_t* fgp = fgrow.data();
        if (threshold <= 0) {
            for (int32_t x = 0; x < width; x++) fgp[x] = row[x] != 0;
        } else if (!brow) {
            for (int32_t x = 0; x < width; x++)
                fgp[x] = row[x] >= threshold;
        } else if (absolute) {
            for (int32_t x = 0; x < width; x++) {
                int d = (int)row[x] - (int)brow[x];
                // nonzero test mirrors labeling over the masked image
                fgp[x] = ((d < 0 ? -d : d) >= threshold) & (row[x] != 0);
            }
        } else {
            for (int32_t x = 0; x < width; x++)
                fgp[x] = (((int)brow[x] - (int)row[x]) >= threshold)
                         & (row[x] != 0);
        }
        for (int32_t x = 0; x < width;) {
            // skip background: 8-byte word probes, escalating to
            // 64-byte blocks (8 uint64 loads ORed, branch-free and
            // vectorizable) through long empty stretches; ctz finds
            // the first set byte of a nonzero word directly
            if (!fgp[x]) {
                if ((x & 7) == 0) {
                    uint64_t w8;
                    std::memcpy(&w8, fgp + x, 8);
                    if (w8 == 0) {
                        x += 8;
                        while (x + 64 <= width) {
                            uint64_t acc = 0;
                            for (int k = 0; k < 8; k++) {
                                uint64_t t;
                                std::memcpy(&t, fgp + x + 8 * k, 8);
                                acc |= t;
                            }
                            if (acc) break;
                            x += 64;
                        }
                        continue;
                    }
                    // fg bytes are 0/1: the lowest set byte of w8 is
                    // the first foreground pixel in this word
                    x += (int32_t)(__builtin_ctzll(w8) >> 3);
                } else {
                    x++;
                    continue;
                }
            }
            const int32_t start = x;
            while (x < width && fgp[x]) x++;
            const int32_t end = x - 1;
            uint32_t label = (uint32_t)all_runs.size();
            parent.push_back(label);
            cur_runs.push_back({y, start, end, label});
            all_runs.push_back(cur_runs.back());
        }
        // merge with previous row (8-connectivity: touch or overlap ±1)
        size_t j = 0;
        for (auto& r : cur_runs) {
            while (j < prev_runs.size() && prev_runs[j].x1 + 1 < r.x0) j++;
            for (size_t k = j; k < prev_runs.size()
                               && prev_runs[k].x0 <= r.x1 + 1; k++) {
                unite(parent, prev_runs[k].label, r.label);
            }
        }
        std::swap(prev_runs, cur_runs);
    }

    // compact: map roots -> blob ids in order of first appearance
    const size_t n_runs = all_runs.size();
    std::vector<uint32_t> root_of(n_runs);
    std::vector<uint32_t> blob_of(n_runs, UINT32_MAX);
    std::vector<uint32_t> blob_order;  // root per blob, in first-run order
    for (size_t i = 0; i < n_runs; i++) {
        uint32_t r = find_root(parent, (uint32_t)i);
        root_of[i] = r;
        if (blob_of[r] == UINT32_MAX) {
            blob_of[r] = (uint32_t)blob_order.size();
            blob_order.push_back(r);
        }
    }
    const size_t n_blobs = blob_order.size();

    // count lines + pixels per blob
    std::vector<uint32_t> line_count(n_blobs, 0), pixel_count(n_blobs, 0);
    for (size_t i = 0; i < n_runs; i++) {
        uint32_t b = blob_of[root_of[i]];
        line_count[b]++;
        pixel_count[b] += (uint32_t)(all_runs[i].x1 - all_runs[i].x0 + 1);
    }
    res->blob_line_start.resize(n_blobs + 1);
    res->blob_pixel_start.resize(n_blobs + 1);
    res->blob_line_start[0] = 0;
    res->blob_pixel_start[0] = 0;
    for (size_t b = 0; b < n_blobs; b++) {
        res->blob_line_start[b + 1] = res->blob_line_start[b] + line_count[b];
        res->blob_pixel_start[b + 1] = res->blob_pixel_start[b] + pixel_count[b];
    }
    res->lines.resize(3 * n_runs);
    res->pixels.resize(res->blob_pixel_start[n_blobs]);
    res->stats.assign(8 * n_blobs, 0.0);

    // scatter runs (already in scan order) into their blob slots and
    // accumulate per-blob statistics (moments + track recount)
    std::vector<uint32_t> line_cursor(res->blob_line_start.begin(),
                                      res->blob_line_start.end() - 1);
    std::vector<uint32_t> pixel_cursor(res->blob_pixel_start.begin(),
                                       res->blob_pixel_start.end() - 1);
    for (size_t i = 0; i < n_runs; i++) {
        const auto& r = all_runs[i];
        uint32_t b = blob_of[root_of[i]];
        uint32_t li = line_cursor[b]++;
        res->lines[3 * li + 0] = r.y;
        res->lines[3 * li + 1] = r.x0;
        res->lines[3 * li + 2] = r.x1;
        uint32_t n = (uint32_t)(r.x1 - r.x0 + 1);
        std::memcpy(res->pixels.data() + pixel_cursor[b],
                    img + (size_t)r.y * width + r.x0, n);
        pixel_cursor[b] += n;

        double* st = res->stats.data() + 8 * b;
        const double a = r.x0, e = r.x1, nn = n, y = r.y;
        // st[7] packs the blob's x-bounds (x0 * 65536 + x1, exact in
        // a double) so consumers skip a per-line reduction
        if (st[0] == 0.0) {
            st[7] = a * 65536.0 + e;
        } else {
            double bx0 = std::floor(st[7] / 65536.0);
            double bx1 = st[7] - bx0 * 65536.0;
            if (a < bx0) bx0 = a;
            if (e > bx1) bx1 = e;
            st[7] = bx0 * 65536.0 + bx1;
        }
        st[0] += nn;
        st[2] += 0.5 * (a + e) * nn;                       // sum x
        st[3] += y * nn;                                   // sum y
        st[4] += (e * (e + 1) * (2 * e + 1)
                  - (a - 1) * a * (2 * a - 1)) / 6.0;      // sum x^2
        st[5] += y * y * nn;                               // sum y^2
        st[6] += y * 0.5 * (a + e) * nn;                   // sum x*y
        if (track_threshold > 0 && bg) {
            const uint8_t* row = img + (size_t)r.y * width;
            const uint8_t* brow = bg + (size_t)r.y * width;
            uint32_t cnt = 0;
            if (track_absolute) {
                for (int32_t x = r.x0; x <= r.x1; x++) {
                    int d = (int)row[x] - (int)brow[x];
                    cnt += ((d < 0 ? -d : d) >= track_threshold);
                }
            } else {
                for (int32_t x = r.x0; x <= r.x1; x++) {
                    cnt += (((int)brow[x] - (int)row[x]) >= track_threshold);
                }
            }
            st[1] += cnt;
        }
    }
    return res;
}

void* trex_label_image(const uint8_t* img, const uint8_t* bg,
                       int32_t width, int32_t height,
                       int32_t threshold, int32_t absolute) {
    return trex_label_image2(img, bg, width, height, threshold, absolute,
                             0, 0);
}

const double* trex_label_stats(void* ctx) {
    return ((Result*)ctx)->stats.data();
}

int64_t trex_label_n_blobs(void* ctx) {
    return (int64_t)((Result*)ctx)->blob_line_start.size() - 1;
}
int64_t trex_label_n_lines(void* ctx) {
    return (int64_t)((Result*)ctx)->lines.size() / 3;
}
int64_t trex_label_n_pixels(void* ctx) {
    return (int64_t)((Result*)ctx)->pixels.size();
}
const uint32_t* trex_label_blob_line_start(void* ctx) {
    return ((Result*)ctx)->blob_line_start.data();
}
const uint32_t* trex_label_blob_pixel_start(void* ctx) {
    return ((Result*)ctx)->blob_pixel_start.data();
}
const int32_t* trex_label_lines(void* ctx) {
    return ((Result*)ctx)->lines.data();
}
const uint8_t* trex_label_pixels(void* ctx) {
    return ((Result*)ctx)->pixels.data();
}
void trex_label_free(void* ctx) { delete (Result*)ctx; }

// One-call copy-out of every result array into caller buffers sized
// from the n_* accessors (replaces five per-array ctypes wrappers in
// the hot per-frame path). line_start / pixel_start widen to int64,
// the Python consumer's dtype.
void trex_label_fill(void* ctx, int32_t* lines, uint8_t* pixels,
                     int64_t* line_start, int64_t* pixel_start,
                     double* stats) {
    Result* r = (Result*)ctx;
    if (!r->lines.empty())
        std::memcpy(lines, r->lines.data(),
                    r->lines.size() * sizeof(int32_t));
    if (!r->pixels.empty())
        std::memcpy(pixels, r->pixels.data(), r->pixels.size());
    for (size_t i = 0; i < r->blob_line_start.size(); i++)
        line_start[i] = (int64_t)r->blob_line_start[i];
    for (size_t i = 0; i < r->blob_pixel_start.size(); i++)
        pixel_start[i] = (int64_t)r->blob_pixel_start[i];
    if (!r->stats.empty())
        std::memcpy(stats, r->stats.data(),
                    r->stats.size() * sizeof(double));
}

// Threshold-escalation size scan (SplitBlob support): for each of the
// n_thr thresholds, run the same line-run union-find labeling over the
// (img, bg) difference and emit ONLY the component sizes —
// out[t * (2 + K) + 0] = number of components,
// out[t * (2 + K) + 1] = total foreground pixels,
// out[t * (2 + K) + 2 ..] = top-K component sizes, descending, 0-padded.
// The binarization matches trex_label_image2 exactly (including the
// img != 0 guard), so the sizes equal what a full labeling would yield.
TREX_HOT_CLONES
void trex_split_sizes(const uint8_t* img, const uint8_t* bg,
                      int32_t width, int32_t height,
                      const int32_t* thresholds, int32_t n_thr,
                      int32_t absolute, int32_t K, int64_t* out) {
    // per-pixel difference value, 0 where img is 0 (outside the mask)
    std::vector<uint8_t> diff((size_t)width * height);
    const size_t npx = (size_t)width * height;
    if (bg) {
        if (absolute) {
            for (size_t i = 0; i < npx; i++) {
                int d = (int)img[i] - (int)bg[i];
                diff[i] = (img[i] != 0) ? (uint8_t)(d < 0 ? -d : d) : 0;
            }
        } else {
            for (size_t i = 0; i < npx; i++) {
                int d = (int)bg[i] - (int)img[i];
                diff[i] = (img[i] != 0 && d > 0) ? (uint8_t)d : 0;
            }
        }
    } else {
        std::memcpy(diff.data(), img, npx);
    }

    struct SRun { int32_t x0, x1; uint32_t label; };
    std::vector<SRun> prev_runs, cur_runs;
    std::vector<uint32_t> parent;
    std::vector<int64_t> run_size;

    for (int32_t t = 0; t < n_thr; t++) {
        const int32_t thr = thresholds[t];
        parent.clear();
        run_size.clear();
        prev_runs.clear();
        int64_t total = 0;
        for (int32_t y = 0; y < height; y++) {
            const uint8_t* row = diff.data() + (size_t)y * width;
            cur_runs.clear();
            int32_t x = 0;
            while (x < width) {
                while (x < width && row[x] < thr) x++;
                if (x >= width) break;
                const int32_t start = x;
                while (x < width && row[x] >= thr) x++;
                const int32_t end = x - 1;
                uint32_t label = (uint32_t)parent.size();
                parent.push_back(label);
                run_size.push_back(end - start + 1);
                total += end - start + 1;
                cur_runs.push_back({start, end, label});
            }
            size_t j = 0;
            for (auto& r : cur_runs) {
                while (j < prev_runs.size() && prev_runs[j].x1 + 1 < r.x0) j++;
                for (size_t k = j; k < prev_runs.size()
                                   && prev_runs[k].x0 <= r.x1 + 1; k++) {
                    unite(parent, prev_runs[k].label, r.label);
                }
            }
            std::swap(prev_runs, cur_runs);
        }
        // accumulate per-root sizes
        std::vector<int64_t> comp_size;
        std::vector<uint32_t> comp_of(parent.size(), UINT32_MAX);
        for (size_t i = 0; i < parent.size(); i++) {
            uint32_t r = find_root(parent, (uint32_t)i);
            if (comp_of[r] == UINT32_MAX) {
                comp_of[r] = (uint32_t)comp_size.size();
                comp_size.push_back(0);
            }
            comp_size[comp_of[r]] += run_size[i];
        }
        std::sort(comp_size.begin(), comp_size.end(),
                  std::greater<int64_t>());
        int64_t* row_out = out + (size_t)t * (2 + K);
        row_out[0] = (int64_t)comp_size.size();
        row_out[1] = total;
        for (int32_t k = 0; k < K; k++)
            row_out[2 + k] = (size_t)k < comp_size.size() ? comp_size[k] : 0;
    }
}

// Threshold-escalation split scan with the full evaluation fused in
// (SplitBlob::evaluate_result_multiple semantics, reference
// SplitBlob.cpp:190-245,406-640): scan thresholds ascending from
// `initial`, per threshold compute component sizes (same labeling as
// trex_split_sizes) and evaluate
//   abort:  total*cm_sqr < max_shrink * first_size
//   keep:   top-`expected` pieces (after dropping pieces below the
//           global shrink limit) all fish-sized
//   remove: smallest keeper still above the largest allowed size
//           (keep raising)
// Stops at the first keep (returns that threshold) or abort/end of
// scan (returns -1). `first_size` = largest component size at the
// initial threshold (in cm^2, 0 when none). ranges = n_ranges (lo, hi)
// pairs in cm^2 (track_size_filter); n_ranges == 0 means unfiltered.
TREX_HOT_CLONES
int32_t trex_split_scan(const uint8_t* img, const uint8_t* bg,
                        int32_t width, int32_t height,
                        int32_t initial, int32_t absolute,
                        int32_t expected,
                        double cm_sqr, double max_shrink,
                        double shrink_limit,
                        const double* ranges, int32_t n_ranges,
                        double* first_size_out) {
    // per-pixel difference value, 0 where img is 0 (outside the mask)
    std::vector<uint8_t> diff((size_t)width * height);
    const size_t npx = (size_t)width * height;
    if (bg) {
        if (absolute) {
            for (size_t i = 0; i < npx; i++) {
                int d = (int)img[i] - (int)bg[i];
                diff[i] = (img[i] != 0) ? (uint8_t)(d < 0 ? -d : d) : 0;
            }
        } else {
            for (size_t i = 0; i < npx; i++) {
                int d = (int)bg[i] - (int)img[i];
                diff[i] = (img[i] != 0 && d > 0) ? (uint8_t)d : 0;
            }
        }
    } else {
        std::memcpy(diff.data(), img, npx);
    }

    // the range with the largest end (SizeFilters::max_range)
    double max_lo = 0.0, max_hi = 0.0;
    for (int32_t i = 0; i < n_ranges; i++) {
        if (i == 0 || ranges[2 * i + 1] > max_hi) {
            max_lo = ranges[2 * i];
            max_hi = ranges[2 * i + 1];
        }
    }

    struct SRun { int32_t x0, x1; uint32_t label; };
    std::vector<SRun> prev_runs, cur_runs;
    std::vector<uint32_t> parent;
    std::vector<int64_t> run_size;
    std::vector<double> comp_size;

    double first_size = 0.0;
    if (first_size_out) *first_size_out = 0.0;
    if (initial < 1) initial = 1;

    // distinct threshold states: the mask {diff >= thr} only changes
    // when thr crosses (present pixel value) + 1, and every decision
    // below depends on the mask alone, so evaluating one thr per state
    // returns exactly what the thr+=1 scan would (the first thr of the
    // winning state IS the sequential return value)
    bool present[256] = {false};
    for (size_t i = 0; i < npx; i++) present[diff[i]] = true;

    for (int32_t thr = initial; thr <= 255;) {
        parent.clear();
        run_size.clear();
        prev_runs.clear();
        int64_t total = 0;
        for (int32_t y = 0; y < height; y++) {
            const uint8_t* row = diff.data() + (size_t)y * width;
            cur_runs.clear();
            int32_t x = 0;
            while (x < width) {
                while (x < width && row[x] < thr) x++;
                if (x >= width) break;
                const int32_t start = x;
                while (x < width && row[x] >= thr) x++;
                const int32_t end = x - 1;
                uint32_t label = (uint32_t)parent.size();
                parent.push_back(label);
                run_size.push_back(end - start + 1);
                total += end - start + 1;
                cur_runs.push_back({start, end, label});
            }
            size_t j = 0;
            for (auto& r : cur_runs) {
                while (j < prev_runs.size() && prev_runs[j].x1 + 1 < r.x0) j++;
                for (size_t k = j; k < prev_runs.size()
                                   && prev_runs[k].x0 <= r.x1 + 1; k++) {
                    unite(parent, prev_runs[k].label, r.label);
                }
            }
            std::swap(prev_runs, cur_runs);
        }
        comp_size.clear();
        {
            std::vector<uint32_t> comp_of(parent.size(), UINT32_MAX);
            for (size_t i = 0; i < parent.size(); i++) {
                uint32_t r = find_root(parent, (uint32_t)i);
                if (comp_of[r] == UINT32_MAX) {
                    comp_of[r] = (uint32_t)comp_size.size();
                    comp_size.push_back(0.0);
                }
                comp_size[comp_of[r]] += (double)run_size[i];
            }
        }
        std::sort(comp_size.begin(), comp_size.end(), std::greater<double>());

        if (thr == initial) {
            first_size = comp_size.empty() ? 0.0 : comp_size[0] * cm_sqr;
            if (first_size_out) *first_size_out = first_size;
        }

        const double total_cm = (double)total * cm_sqr;
        if (total_cm < max_shrink * first_size) return -1;  // abort

        const double min_thresh = n_ranges > 0
            ? max_lo * shrink_limit : total_cm * max_shrink;
        // kept = prefix of descending sizes >= min_thresh
        int64_t kept = 0;
        for (double s : comp_size) {
            if (s * cm_sqr >= min_thresh) kept++;
            else break;
        }
        const int64_t take = std::min<int64_t>(kept, expected);
        int64_t valid = 0;
        for (int64_t i = 0; i < take; i++) {
            const double s = comp_size[(size_t)i] * cm_sqr;
            bool in = n_ranges == 0;
            for (int32_t r = 0; r < n_ranges && !in; r++)
                in = s >= ranges[2 * r] && s <= ranges[2 * r + 1];
            valid += in;
        }
        bool remove = false;
        if (n_ranges > 0 && take > 0) {
            const double min_size =
                comp_size[(size_t)(take - 1)] * cm_sqr;
            remove = min_size > max_hi;
        }
        if (!remove && valid >= expected) return thr;  // keep

        // advance to the next distinct mask state; once no pixel value
        // >= thr remains, the mask is empty for every higher thr and
        // the sequential scan would return -1 at 255
        int32_t v = thr;
        while (v < 256 && !present[v]) v++;
        if (v >= 256) return -1;
        thr = v + 1;
    }
    return -1;
}

// Per-blob statistics for externally-supplied blobs (e.g. pv-file
// frames): the same 8-double rows trex_label_image2 produces
// (n_px, track_count, sum_x, sum_y, sum_xx, sum_yy, sum_xy, 0), so
// pv-loaded blobs can feed the FastTracker engine directly.
TREX_HOT_CLONES
void trex_blob_stats(const int32_t* lines, const int64_t* line_start,
                     const uint8_t* pixels, const int64_t* pixel_start,
                     int32_t n_blobs,
                     const uint8_t* bg, int32_t width, int32_t height,
                     int32_t track_threshold, int32_t track_absolute,
                     double* stats) {
    for (int32_t b = 0; b < n_blobs; b++) {
        double* st = stats + (size_t)b * 8;
        for (int k = 0; k < 8; k++) st[k] = 0.0;
        int64_t pi = pixel_start ? pixel_start[b] : 0;
        for (int64_t i = line_start[b]; i < line_start[b + 1]; i++) {
            const double y = lines[3 * i];
            const double a = lines[3 * i + 1];
            const double e = lines[3 * i + 2];
            const double nn = e - a + 1;
            if (st[0] == 0.0) {
                st[7] = a * 65536.0 + e;
            } else {
                double bx0 = std::floor(st[7] / 65536.0);
                double bx1 = st[7] - bx0 * 65536.0;
                if (a < bx0) bx0 = a;
                if (e > bx1) bx1 = e;
                st[7] = bx0 * 65536.0 + bx1;
            }
            st[0] += nn;
            st[2] += 0.5 * (a + e) * nn;
            st[3] += y * nn;
            st[4] += (e * (e + 1) * (2 * e + 1)
                      - (a - 1) * a * (2 * a - 1)) / 6.0;
            st[5] += y * y * nn;
            st[6] += y * 0.5 * (a + e) * nn;
            if (track_threshold > 0 && bg && pixels) {
                const int32_t yy = lines[3 * i];
                const uint8_t* brow =
                    (yy >= 0 && yy < height) ? bg + (size_t)yy * width
                                             : nullptr;
                uint32_t cnt = 0;
                for (int32_t x = lines[3 * i + 1];
                     x <= lines[3 * i + 2]; x++, pi++) {
                    if (!brow || x < 0 || x >= width) continue;
                    const int v = pixels[pi];
                    // same test as pv::Blob::recount (raw_recount):
                    // no nonzero-pixel guard here
                    if (track_absolute) {
                        int d = v - (int)brow[x];
                        cnt += (d < 0 ? -d : d) >= track_threshold;
                    } else {
                        cnt += ((int)brow[x] - v) >= track_threshold;
                    }
                }
                st[1] += cnt;
            }
        }
    }
}

// One-shot blob split (SplitBlob semantics, the native composition of
// split_blob in trex_tpu/track/splitting.py): build the padded masked
// crop from the blob's RLE lines + pixels over the background, run the
// threshold-escalation scan with the evaluation fused (trex_split_scan
// logic), then materialize the winning threshold's components and
// re-evaluate them (the scan and the materialization must agree).
// Output rows (max_pieces x 7 doubles): num_pixels, x0, y0, x1, y1,
// sum_x, sum_y — pieces sorted by size descending (stable), already
// filtered by the global shrink limit, in FRAME coordinates.
// Returns the piece count (0 = no acceptable split).
TREX_HOT_CLONES
int32_t trex_split_execute(
    const int32_t* lines, int64_t n_lines, const uint8_t* pixels,
    const uint8_t* bg, int32_t bg_w, int32_t bg_h,
    int32_t initial, int32_t absolute, int32_t expected,
    double cm_sqr, double max_shrink, double shrink_limit,
    const double* ranges, int32_t n_ranges,
    int32_t max_pieces, double* out) {
    if (n_lines <= 0) return 0;
    // bbox + padded crop (to_dense(pad=1)); scan y too — unsorted
    // line arrays must not produce negative row offsets (heap writes)
    int32_t bx0 = lines[1], bx1 = lines[2];
    int32_t by0 = lines[0], by1 = lines[0];
    for (int64_t i = 0; i < n_lines; i++) {
        bx0 = std::min(bx0, lines[3 * i + 1]);
        bx1 = std::max(bx1, lines[3 * i + 2]);
        by0 = std::min(by0, lines[3 * i]);
        by1 = std::max(by1, lines[3 * i]);
    }
    const int32_t ox = bx0 - 1, oy = by0 - 1;
    const int32_t w = bx1 - bx0 + 3, h = by1 - by0 + 3;
    std::vector<uint8_t> img((size_t)w * h, 0);
    // background fill (zero outside the frame)
    for (int32_t yy = 0; yy < h; yy++) {
        const int32_t gy = yy + oy;
        if (gy < 0 || gy >= bg_h) continue;
        for (int32_t xx = 0; xx < w; xx++) {
            const int32_t gx = xx + ox;
            img[(size_t)yy * w + xx] =
                (gx >= 0 && gx < bg_w) ? bg[(size_t)gy * bg_w + gx] : 0;
        }
    }
    // blob pixels over the background
    {
        int64_t pi = 0;
        for (int64_t i = 0; i < n_lines; i++) {
            const int32_t y = lines[3 * i] - oy;
            const int32_t x0 = lines[3 * i + 1] - ox;
            const int32_t x1 = lines[3 * i + 2] - ox;
            for (int32_t x = x0; x <= x1; x++)
                img[(size_t)y * w + x] = pixels[pi++];
        }
    }
    // scan for the winning threshold
    double first_size = 0.0;
    std::vector<uint8_t> bgcrop((size_t)w * h, 0);
    for (int32_t yy = 0; yy < h; yy++) {
        const int32_t gy = yy + oy;
        if (gy < 0 || gy >= bg_h) continue;
        for (int32_t xx = 0; xx < w; xx++) {
            const int32_t gx = xx + ox;
            bgcrop[(size_t)yy * w + xx] =
                (gx >= 0 && gx < bg_w) ? bg[(size_t)gy * bg_w + gx] : 0;
        }
    }
    const int32_t best_thr = trex_split_scan(
        img.data(), bgcrop.data(), w, h, initial, absolute, expected,
        cm_sqr, max_shrink, shrink_limit, ranges, n_ranges, &first_size);
    if (best_thr < 0) return 0;

    // materialize components at best_thr: diff mask + labeling with
    // per-component count/bbox/centroid sums
    std::vector<uint8_t> diff((size_t)w * h, 0);
    const size_t npx = (size_t)w * h;
    if (absolute) {
        for (size_t i = 0; i < npx; i++) {
            int d = (int)img[i] - (int)bgcrop[i];
            diff[i] = (img[i] != 0) ? (uint8_t)(d < 0 ? -d : d) : 0;
        }
    } else {
        for (size_t i = 0; i < npx; i++) {
            int d = (int)bgcrop[i] - (int)img[i];
            diff[i] = (img[i] != 0 && d > 0) ? (uint8_t)d : 0;
        }
    }
    struct SRun { int32_t y, x0, x1; uint32_t label; };
    std::vector<SRun> prev_runs, cur_runs, all;
    std::vector<uint32_t> parent;
    for (int32_t y = 0; y < h; y++) {
        const uint8_t* row = diff.data() + (size_t)y * w;
        cur_runs.clear();
        int32_t x = 0;
        while (x < w) {
            while (x < w && row[x] < best_thr) x++;
            if (x >= w) break;
            const int32_t start = x;
            while (x < w && row[x] >= best_thr) x++;
            uint32_t label = (uint32_t)all.size();
            parent.push_back(label);
            cur_runs.push_back({y, start, x - 1, label});
            all.push_back(cur_runs.back());
        }
        size_t j = 0;
        for (auto& r : cur_runs) {
            while (j < prev_runs.size() && prev_runs[j].x1 + 1 < r.x0) j++;
            for (size_t k = j; k < prev_runs.size()
                               && prev_runs[k].x0 <= r.x1 + 1; k++)
                unite(parent, prev_runs[k].label, r.label);
        }
        std::swap(prev_runs, cur_runs);
    }
    struct Piece {
        double n = 0, x0 = 1e18, y0 = 1e18, x1 = -1e18, y1 = -1e18;
        double sx = 0, sy = 0;
    };
    std::vector<Piece> pieces;
    std::vector<uint32_t> piece_of(parent.size(), UINT32_MAX);
    for (size_t i = 0; i < all.size(); i++) {
        uint32_t r = find_root(parent, (uint32_t)i);
        if (piece_of[r] == UINT32_MAX) {
            piece_of[r] = (uint32_t)pieces.size();
            pieces.push_back({});
        }
        Piece& p = pieces[piece_of[r]];
        const auto& run = all[i];
        const double len = run.x1 - run.x0 + 1;
        p.n += len;
        p.x0 = std::min(p.x0, (double)run.x0);
        p.x1 = std::max(p.x1, (double)run.x1);
        p.y0 = std::min(p.y0, (double)run.y);
        p.y1 = std::max(p.y1, (double)run.y);
        p.sx += 0.5 * (run.x0 + run.x1) * len;
        p.sy += (double)run.y * len;
    }
    std::stable_sort(pieces.begin(), pieces.end(),
                     [](const Piece& a, const Piece& b) {
                         return a.n > b.n;
                     });
    // re-evaluate (SplitBlob::evaluate_result_multiple on materialized
    // components; must return keep or the split is rejected)
    double total = 0.0;
    for (auto& p : pieces) total += p.n;
    total *= cm_sqr;
    if (total < max_shrink * first_size) return 0;  // abort
    double max_lo = 0.0, max_hi = 0.0;
    for (int32_t i = 0; i < n_ranges; i++) {
        if (i == 0 || ranges[2 * i + 1] > max_hi) {
            max_lo = ranges[2 * i];
            max_hi = ranges[2 * i + 1];
        }
    }
    const double min_thresh = n_ranges > 0
        ? max_lo * shrink_limit : total * max_shrink;
    // drop pieces below the global shrink limit (anywhere in the list;
    // sizes are sorted so this keeps a prefix)
    size_t kept = 0;
    while (kept < pieces.size()
           && pieces[kept].n * cm_sqr >= min_thresh) kept++;
    pieces.resize(kept);
    int64_t valid = 0;
    double min_size = 1e300;
    const size_t top = std::min<size_t>(kept, (size_t)expected);
    for (size_t i = 0; i < top; i++) {
        const double s = pieces[i].n * cm_sqr;
        min_size = std::min(min_size, pieces[i].n);
        bool in = n_ranges == 0;
        for (int32_t r = 0; r < n_ranges && !in; r++)
            in = s >= ranges[2 * r] && s <= ranges[2 * r + 1];
        valid += in;
    }
    if (n_ranges > 0 && top > 0 && min_size * cm_sqr > max_hi)
        return 0;  // remove
    if (valid < expected) return 0;  // too_few
    const int32_t n_out = (int32_t)std::min<size_t>(
        pieces.size(), (size_t)max_pieces);
    for (int32_t i = 0; i < n_out; i++) {
        const Piece& p = pieces[i];
        double* o = out + (size_t)i * 7;
        o[0] = p.n;
        o[1] = p.x0 + ox;
        o[2] = p.y0 + oy;
        o[3] = p.x1 + ox;
        o[4] = p.y1 + oy;
        o[5] = p.sx + p.n * ox;
        o[6] = p.sy + p.n * oy;
    }
    return n_out;
}

// Batch wrapper over trex_split_execute: n_jobs independent splits
// against the SAME background share one FFI round trip. Per job: line
// range [line_lo, line_hi) into the shared frame `lines` array, pixel
// offset pixel_lo into the shared `pixels` array, expected piece
// count. out_counts[j] pieces land at out + j * max_pieces * 7.
int32_t trex_split_execute_batch(
    const int32_t* lines, const uint8_t* pixels,
    const int64_t* line_lo, const int64_t* line_hi,
    const int64_t* pixel_lo, const int32_t* expected, int32_t n_jobs,
    const uint8_t* bg, int32_t bg_w, int32_t bg_h,
    int32_t initial, int32_t absolute,
    double cm_sqr, double max_shrink, double shrink_limit,
    const double* ranges, int32_t n_ranges,
    int32_t max_pieces, double* out, int32_t* out_counts) {
    for (int32_t j = 0; j < n_jobs; j++) {
        out_counts[j] = trex_split_execute(
            lines + 3 * line_lo[j], line_hi[j] - line_lo[j],
            pixels + pixel_lo[j], bg, bg_w, bg_h, initial, absolute,
            expected[j], cm_sqr, max_shrink, shrink_limit,
            ranges, n_ranges, max_pieces,
            out + (size_t)j * max_pieces * 7);
    }
    return 0;
}

// History-split expectation over proximity cliques (HistorySplit.cpp:
// 170-320 + PPFrame::fill_proximity_grid sampling). Inputs: `fish`
// (nf, 2) positions of the involved fish, candidate blobs as
// concatenated RLE lines (y, x0, x1) with per-blob offsets, per-blob
// bboxes (x0, y0, x1, y1), and max_d. Output: expect counts per blob.
// Proximity (near = bbox hypot distance <= max_d) is evaluated through
// a sorted-x window — an exact superset of the dense nf x nb pass.
//
// Semantics mirror trex_tpu/track/engine.py::_split_expectation /
// _resolve_expectation exactly (differential-tested): per blob sample
// grid points (first/last line + even-y interiors when >= 4 lines;
// endpoints + midpoint + interior points every step = max(1,
// width*0.1) px when step >= 5); an edge exists when the minimum
// point distance <= max_d; per clique with more fish than blobs,
// resolve closest-first; fish without alternatives raise their best
// blob's expectation (+1 for the current owner).
TREX_HOT_CLONES
void trex_expectation(const double* fish, int32_t nf,
                      const int32_t* lines,
                      const int64_t* row_lo, const int64_t* row_hi,
                      const double* bounds, int32_t nb,
                      double max_d, int32_t* expect) {
    for (int32_t b = 0; b < nb; b++) expect[b] = 0;
    if (nb <= 0 || nf <= 0) return;
    // bbox proximity (near = hypot(dx, dy) <= max_d, matching the
    // numpy reference's np.hypot boundary semantics). Blobs are
    // visited through a sorted-x window: a blob whose x-interval is
    // more than max_d + 2 px away from the fish x provably fails the
    // d2 > hi2 test below, so the window (with a conservative margin
    // far wider than any fp wobble) is an exact superset of the dense
    // nf x nb pass it replaces.
    std::vector<int32_t> bxo(nb);
    for (int32_t b = 0; b < nb; b++) bxo[b] = b;
    std::sort(bxo.begin(), bxo.end(), [&](int32_t a, int32_t b) {
        return bounds[4 * a] < bounds[4 * b];
    });
    std::vector<double> bx0s(nb);
    double max_w = 0.0;
    for (int32_t i = 0; i < nb; i++) {
        const int32_t b = bxo[i];
        bx0s[i] = bounds[4 * b];
        max_w = std::max(max_w, bounds[4 * b + 2] - bounds[4 * b]);
    }
    const double guard = max_d * (1.0 + 1e-9) + 2.0;
    std::vector<int32_t> blob_deg(nb, 0);
    // per-fish near blob ids, ascending (the dense pass's b order)
    std::vector<std::vector<int32_t>> near_list(nf);
    // two-phase per cell: decide by squared distance except inside a
    // relative sliver around max_d^2 where hypot's <=1ulp rounding
    // could disagree — those few cells re-test with std::hypot,
    // keeping the numpy-reference np.hypot boundary semantics exact
    const double md2 = max_d * max_d;
    const double lo2 = md2 * (1.0 - 1e-9), hi2 = md2 * (1.0 + 1e-9);
    std::vector<int32_t> cand;
    for (int32_t f = 0; f < nf; f++) {
        const double fx = fish[2 * f], fy = fish[2 * f + 1];
        const auto lo_it = std::lower_bound(bx0s.begin(), bx0s.end(),
                                            fx - guard - max_w);
        const auto hi_it = std::upper_bound(bx0s.begin(), bx0s.end(),
                                            fx + guard);
        cand.clear();
        for (auto it = lo_it; it != hi_it; ++it)
            cand.push_back(bxo[it - bx0s.begin()]);
        std::sort(cand.begin(), cand.end());
        for (const int32_t b : cand) {
            const double x0 = bounds[4 * b], y0 = bounds[4 * b + 1];
            const double x1 = bounds[4 * b + 2], y1 = bounds[4 * b + 3];
            const double dx = std::max(0.0, std::max(x0 - fx, fx - x1));
            const double dy = std::max(0.0, std::max(y0 - fy, fy - y1));
            const double d2 = dx * dx + dy * dy;
            if (d2 > hi2) continue;
            bool is_near = d2 < lo2;
            if (!is_near) is_near = std::hypot(dx, dy) <= max_d;
            if (is_near) {
                near_list[f].push_back(b);
                blob_deg[b]++;
            }
        }
    }
    // involved fish: touching a contested (>= 2 fish) blob; candidate
    // blobs: near any involved fish
    std::vector<uint8_t> involved(nf, 0);
    bool any_contested = false;
    for (int32_t f = 0; f < nf; f++) {
        for (const int32_t b : near_list[f]) {
            if (blob_deg[b] >= 2) {
                involved[f] = 1;
                any_contested = true;
                break;
            }
        }
    }
    if (!any_contested) return;
    // per-blob involved fish, ascending (built in fish order)
    std::vector<std::vector<int32_t>> blob_fish(nb);
    for (int32_t f = 0; f < nf; f++) {
        if (!involved[f]) continue;
        for (const int32_t b : near_list[f]) blob_fish[b].push_back(f);
    }

    std::vector<std::vector<std::pair<double, int32_t>>> edges(nf);
    std::vector<double> px, py;
    for (int32_t b = 0; b < nb; b++) {
        if (blob_fish[b].empty()) continue;
        // sample grid points for this blob (PPFrame::insert_line)
        px.clear();
        py.clear();
        const int64_t lo = row_lo[b], hi = row_hi[b];
        const int64_t K = hi - lo;
        const double width = bounds[4 * b + 2] - bounds[4 * b] + 1;
        const int32_t step = (int32_t)std::max(1.0, width * 0.1);
        for (int64_t i = lo; i < hi; i++) {
            if (K >= 4 && i != lo && i != hi - 1 && (lines[3 * i] % 2))
                continue;
            const double y = lines[3 * i];
            const double x0 = lines[3 * i + 1];
            const double x1 = lines[3 * i + 2];
            px.push_back(x0); py.push_back(y);
            px.push_back(x1); py.push_back(y);
            px.push_back(x0 + (x1 - x0) * 0.5); py.push_back(y);
            if (step >= 5 && x1 - x0 >= 2 * step) {
                for (double x = x0 + step; x <= x1 - step + 1e-9;
                     x += step) {
                    px.push_back(x); py.push_back(y);
                }
            }
        }
        for (const int32_t f : blob_fish[b]) {
            double best = 1e300;
            const double fx = fish[2 * f], fy = fish[2 * f + 1];
            for (size_t k = 0; k < px.size(); k++) {
                const double dx = px[k] - fx, dy = py[k] - fy;
                const double d2 = dx * dx + dy * dy;
                if (d2 < best) best = d2;
            }
            const double md = std::sqrt(best);
            if (md <= max_d) edges[f].push_back({md, b});
        }
    }
    for (auto& es : edges) std::sort(es.begin(), es.end());

    // connected cliques over shared blobs (union-find; fish = [0, nf),
    // blobs = [nf, nf+nb))
    std::vector<uint32_t> parent(nf + nb);
    for (size_t i = 0; i < parent.size(); i++) parent[i] = (uint32_t)i;
    for (int32_t f = 0; f < nf; f++)
        for (auto& e : edges[f])
            unite(parent, (uint32_t)f, (uint32_t)(nf + e.second));
    // group fish by root, in fish order
    std::vector<int32_t> root_order;
    std::vector<std::vector<int32_t>> clique_fish;
    std::vector<int32_t> clique_of(nf + nb, -1);
    for (int32_t f = 0; f < nf; f++) {
        if (edges[f].empty()) continue;
        uint32_t r = find_root(parent, (uint32_t)f);
        if (clique_of[r] < 0) {
            clique_of[r] = (int32_t)clique_fish.size();
            clique_fish.push_back({});
        }
        clique_fish[clique_of[r]].push_back(f);
    }
    for (auto& fish_list : clique_fish) {
        // count distinct blobs in the clique
        std::vector<int32_t> blobs_here;
        for (int32_t f : fish_list)
            for (auto& e : edges[f]) blobs_here.push_back(e.second);
        std::sort(blobs_here.begin(), blobs_here.end());
        blobs_here.erase(std::unique(blobs_here.begin(), blobs_here.end()),
                         blobs_here.end());
        if ((int64_t)fish_list.size() <= (int64_t)blobs_here.size())
            continue;
        // combos = mutable per-fish edge lists; assign_fish = first edge
        std::vector<std::vector<std::pair<double, int32_t>>> combos;
        std::vector<int32_t> fidx(nf, -1);
        for (size_t i = 0; i < fish_list.size(); i++) {
            fidx[fish_list[i]] = (int32_t)i;
            combos.push_back(edges[fish_list[i]]);
        }
        std::vector<std::pair<double, int32_t>> assign_fish;
        for (size_t i = 0; i < fish_list.size(); i++)
            assign_fish.push_back(combos[i][0]);
        // blob -> (owner fish local idx, dist)
        std::vector<std::pair<int32_t, double>> assign_blob(
            nb, {-1, 0.0});
        std::vector<int32_t> queue(fish_list.size());
        for (size_t i = 0; i < fish_list.size(); i++)
            queue[i] = (int32_t)i;
        size_t qhead = 0;
        while (qhead < queue.size()) {
            const int32_t i = queue[qhead++];
            auto& combo = combos[i];
            if (combo.empty()) continue;
            const double d = combo[0].first;
            const int32_t b = combo[0].second;
            if (assign_blob[b].first < 0) {
                assign_blob[b] = {i, d};
                continue;
            }
            const int32_t owner = assign_blob[b].first;
            const double od = assign_blob[b].second;
            if (owner != i) {
                if (od <= d) {
                    combo.erase(combo.begin());
                    queue.push_back(i);
                } else {
                    assign_blob[b] = {i, d};
                    queue.push_back(owner);
                }
            }
        }
        for (size_t i = 0; i < fish_list.size(); i++) {
            if (!combos[i].empty()) continue;
            const int32_t b = assign_fish[i].second;
            if (assign_blob[b].first >= 0) {
                expect[b] += 1;  // current owner
                assign_blob[b].first = -1;
            }
            expect[b] += 1;
        }
    }
}

// Moore boundary trace (8-connectivity, clockwise) over a binary mask.
// Writes up to max_points (x, y) float pairs into out; returns the
// number of points written (0 when the mask is empty). Matches the
// Python reference tracer in trex_tpu/track/posture.py.
int64_t trex_trace_boundary(const uint8_t* mask, int32_t width,
                            int32_t height, float* out,
                            int64_t max_points) {
    const int32_t W = width + 2, H = height + 2;
    std::vector<uint8_t> padded((size_t)W * H, 0);
    int32_t sy = -1, sx = -1;
    for (int32_t y = 0; y < height; y++) {
        for (int32_t x = 0; x < width; x++) {
            if (mask[(size_t)y * width + x]) {
                padded[(size_t)(y + 1) * W + (x + 1)] = 1;
                if (sy < 0) { sy = y + 1; sx = x + 1; }
            }
        }
    }
    // find the topmost-leftmost pixel in scan order
    sy = -1;
    for (int32_t y = 1; y < H - 1 && sy < 0; y++) {
        for (int32_t x = 1; x < W - 1; x++) {
            if (padded[(size_t)y * W + x]) { sy = y; sx = x; break; }
        }
    }
    if (sy < 0) return 0;
    static const int32_t order[8][2] = {
        {0, -1}, {-1, -1}, {-1, 0}, {-1, 1},
        {0, 1}, {1, 1}, {1, 0}, {1, -1}};
    int32_t cy = sy, cx = sx;
    int32_t back = 0;
    int64_t n = 0;
    if (n < max_points) {
        out[2 * n] = (float)(sx - 1);
        out[2 * n + 1] = (float)(sy - 1);
        n++;
    }
    const int64_t limit = (int64_t)8 * width * height + 8;
    for (int64_t iter = 0; iter < limit; iter++) {
        bool found = false;
        for (int k = 0; k < 8; k++) {
            int d = (back + 1 + k) % 8;
            int32_t ny = cy + order[d][0];
            int32_t nx = cx + order[d][1];
            if (padded[(size_t)ny * W + nx]) {
                cy = ny; cx = nx;
                back = (d + 4) % 8;
                found = true;
                break;
            }
        }
        if (!found) break;  // isolated pixel
        if (cy == sy && cx == sx && n > 1) break;
        if (n < max_points) {
            out[2 * n] = (float)(cx - 1);
            out[2 * n + 1] = (float)(cy - 1);
            n++;
        } else {
            break;
        }
    }
    return n;
}

// pixel::threshold_blob core: rasterize the blob's RLE lines +
// pixels into a crop (background values outside the mask, like
// prefilter.threshold_components), then run the standard labeler at
// `threshold` over (crop, bg_crop). Returns a labeling ctx whose line
// coordinates are already offset back to image space. The caller
// materializes blobs from the ctx arrays exactly like label_blobs.
TREX_HOT_CLONES
void* trex_threshold_blob(const int32_t* lines, int64_t K,
                          const uint8_t* pixels,
                          const uint8_t* bg, int32_t bg_w, int32_t bg_h,
                          int32_t threshold, int32_t absolute) {
    // bounds
    int32_t y0 = INT32_MAX, y1 = INT32_MIN, x0 = INT32_MAX,
            x1 = INT32_MIN;
    for (int64_t k = 0; k < K; k++) {
        y0 = std::min(y0, lines[3 * k]);
        y1 = std::max(y1, lines[3 * k]);
        x0 = std::min(x0, lines[3 * k + 1]);
        x1 = std::max(x1, lines[3 * k + 2]);
    }
    if (K == 0) return trex_label_image2(nullptr, nullptr, 0, 0,
                                         threshold, absolute, 0, 0);
    const int32_t pad = 1;
    const int32_t W = x1 - x0 + 1 + 2 * pad, H = y1 - y0 + 1 + 2 * pad;
    const int32_t ox = x0 - pad, oy = y0 - pad;
    std::vector<uint8_t> img((size_t)W * H, 0), bgc((size_t)W * H, 0);
    for (int32_t r = 0; r < H; r++) {
        const int32_t by = oy + r;
        if (by < 0 || by >= bg_h) continue;
        const int32_t cx0 = std::max(0, -ox),
                      cx1 = std::min(W, bg_w - ox);
        if (cx1 > cx0)
            std::memcpy(bgc.data() + (size_t)r * W + cx0,
                        bg + (size_t)by * bg_w + ox + cx0, cx1 - cx0);
    }
    std::memcpy(img.data(), bgc.data(), (size_t)W * H);
    int64_t i = 0;
    for (int64_t k = 0; k < K; k++) {
        const int32_t ly = lines[3 * k], lx0 = lines[3 * k + 1],
                      lx1 = lines[3 * k + 2];
        const int32_t n = lx1 - lx0 + 1;
        std::memcpy(img.data() + (size_t)(ly - oy) * W + (lx0 - ox),
                    pixels + i, n);
        i += n;
    }
    auto* res = reinterpret_cast<Result*>(trex_label_image2(
        img.data(), bgc.data(), W, H, threshold, absolute, 0, 0));
    // offset lines back into image coordinates
    for (size_t j = 0; j + 2 < res->lines.size() + 1; j += 3) {
        res->lines[j] += oy;
        res->lines[j + 1] += ox;
        res->lines[j + 2] += ox;
    }
    // stats sums were accumulated in crop space: shift centroid sums
    for (size_t b = 0; b * 8 < res->stats.size(); b++) {
        double* st = res->stats.data() + 8 * b;
        const double n = st[0];
        st[4] += 2.0 * ox * (st[2]) + (double)ox * ox * n;   // sum x^2
        st[5] += 2.0 * oy * (st[3]) + (double)oy * oy * n;   // sum y^2
        st[6] += ox * st[3] + oy * st[2] + (double)ox * oy * n;
        st[2] += ox * n;                                      // sum x
        st[3] += oy * n;                                      // sum y
        double bx0 = std::floor(st[7] / 65536.0);
        double bx1 = st[7] - bx0 * 65536.0;
        st[7] = (bx0 + ox) * 65536.0 + (bx1 + ox);
    }
    return res;
}

// Dense rasterization of a blob's RLE lines into pre-zeroed crops
// (TrackBlob.to_dense fast path): mask gets 1s, gray gets the pixel
// values (when pixels != NULL). W/H are the padded crop dimensions.
TREX_HOT_CLONES
void trex_blob_dense(const int32_t* lines, int64_t K,
                     const uint8_t* pixels,
                     int32_t x, int32_t y, int32_t W, int32_t H,
                     int32_t pad, uint8_t* mask, uint8_t* gray) {
    int64_t i = 0;
    for (int64_t k = 0; k < K; k++) {
        const int32_t ly = lines[3 * k], x0 = lines[3 * k + 1],
                      x1 = lines[3 * k + 2];
        const int32_t n = x1 - x0 + 1;
        const int32_t r = ly - y + pad, c = x0 - x + pad;
        if (r >= 0 && r < H && c >= 0 && c + n <= W) {
            std::memset(mask + (size_t)r * W + c, 1, n);
            if (pixels)
                std::memcpy(gray + (size_t)r * W + c, pixels + i, n);
        }
        i += n;
    }
}

// Closed-polygon resampling (Outline::resample semantics, matching
// track/posture.py resample() arithmetic: float32 points, float32
// hypot widened to double for the walked-distance bookkeeping,
// interpolation factor applied in float32). Returns the number of
// points written (0 -> caller keeps the input), or -1 on overflow.
int64_t trex_outline_resample(const float* pts, int64_t n,
                              double distance, float* out,
                              int64_t cap) {
    if (distance <= 0 || n <= 1) return 0;
    int64_t m = 0;
    double walked = 0.0;
    for (int64_t i = 0; i < n; i++) {
        const float p0x = pts[2 * i], p0y = pts[2 * i + 1];
        const int64_t j = (i + 1 == n) ? 0 : i + 1;
        const float lx = pts[2 * j] - p0x, ly = pts[2 * j + 1] - p0y;
        const double seg = (double)hypotf(lx, ly);
        walked += seg;
        const double percent = seg / distance;
        double walked_percent = walked / distance;
        int64_t offset = 0;
        while (walked_percent >= 1.0) {
            const double t = percent > 0 ? (double)offset / percent : 0.0;
            if (m >= cap) return -1;
            const float tf = (float)t;
            out[2 * m] = p0x + lx * tf;
            out[2 * m + 1] = p0y + ly * tf;
            m++;
            offset++;
            walked -= distance;
            walked_percent -= 1.0;
        }
    }
    return m;
}

// Midline walk (Outline::calculate_midline pairing loop,
// Outline.cpp:795-857; arithmetic matches track/posture.py's walk:
// float32 distances via hypotf, first-minimum tie-breaks like
// np.argmin). pts: (L,2) float32 with the tail rotated to index 0.
// seg_out rows: [mid_x, mid_y, height]. Returns segment count.
int64_t trex_midline_walk(const float* pts, int64_t L,
                          int32_t max_offset, float* seg_out,
                          int64_t cap) {
    int64_t idx_r = 1, idx_l = -1;
    int64_t guard = 0, m = 0;
    while (idx_r < L + idx_l && guard < 4 * L) {
        guard++;
        int64_t li = ((L + idx_l) % L + L) % L;
        float plx = pts[2 * li], ply = pts[2 * li + 1];
        // best right candidate in [idx_r, min(L, idx_r + max_offset))
        const int64_t hi = std::min<int64_t>(L, idx_r + max_offset);
        if (hi > idx_r) {
            float best = std::numeric_limits<float>::infinity();
            int64_t best_i = idx_r;
            for (int64_t i = idx_r; i < hi; i++) {
                const float d = hypotf(pts[2 * i] - plx,
                                       pts[2 * i + 1] - ply);
                if (d < best) { best = d; best_i = i; }
            }
            idx_r = best_i;
        }
        const float prx = pts[2 * idx_r], pry = pts[2 * idx_r + 1];
        // best left candidate walking idx_l, idx_l-1, ... lo
        const int64_t lo = std::max<int64_t>(-L + 1,
                                             idx_l - max_offset + 1);
        {
            float best = std::numeric_limits<float>::infinity();
            int64_t best_k = 0, k = 0;
            for (int64_t cand = idx_l; cand >= lo; cand--, k++) {
                const int64_t ci = ((cand % L) + L) % L;
                const float d = hypotf(pts[2 * ci] - prx,
                                       pts[2 * ci + 1] - pry);
                if (d < best) { best = d; best_k = k; }
            }
            idx_l -= best_k;
        }
        li = ((L + idx_l) % L + L) % L;
        plx = pts[2 * li]; ply = pts[2 * li + 1];
        if (m >= cap) break;
        seg_out[3 * m] = (plx + prx) * 0.5f;
        seg_out[3 * m + 1] = (ply + pry) * 0.5f;
        seg_out[3 * m + 2] = hypotf(prx - plx, pry - ply);
        m++;
        idx_r++;
        idx_l--;
    }
    return m;
}

}  // extern "C"
