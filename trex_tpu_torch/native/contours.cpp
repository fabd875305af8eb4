// The sequential contour routines of tag detection (track/tag_image.py),
// as OpenCV 5.0.0 computes them on 8-bit masks and integer points:
//
// - trex_find_contours_external: findContours(RETR_EXTERNAL,
//   CHAIN_APPROX_SIMPLE), or CHAIN_APPROX_NONE with `every_point`. The
//   mask is copied into a frame one pixel wider on each side (OpenCV's
//   copyMakeBorder), thresholded to 0/1 and scanned row by row; each
//   outer border not inside another component is followed with Suzuki's
//   rule and written where the direction changes (SIMPLE) or at every
//   step (NONE). OpenCV links each new contour in front of its
//   siblings, so the list comes out in reverse order of discovery.
// - trex_contour_area: the shoelace sum in double, its absolute value.
// - trex_arc_length: float32 square roots of float32 squared edge
//   lengths, in batches of 16, added into a double in reverse order
//   within each batch.
// - trex_approx_poly_dp: approxPolyDP's start point search, its
//   Douglas-Peucker on an explicit stack (OpenCV 5 measures the distance
//   to the segment, not to its line) and its last clean-up pass.
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Pt {
    int x, y;
};

const int kCodeDx[8] = {1, 1, 0, -1, -1, -1, 0, 1};
const int kCodeDy[8] = {0, -1, -1, -1, 0, 1, 1, 1};

// icvFetchContour with CV_CHAIN_APPROX_SIMPLE (or, with `every_point`,
// CV_CHAIN_APPROX_NONE) for an outer border starting at `i0` (point `pt`
// in the padded frame).
void fetch_contour(int8_t* i0, int step, Pt pt, bool every_point,
                   std::vector<Pt>& out) {
    const int8_t nbd = 2;
    int deltas[16];
    deltas[0] = 1;
    deltas[1] = -step + 1;
    deltas[2] = -step;
    deltas[3] = -step - 1;
    deltas[4] = -1;
    deltas[5] = step - 1;
    deltas[6] = step;
    deltas[7] = step + 1;
    for (int k = 0; k < 8; ++k) deltas[k + 8] = deltas[k];

    int8_t *i1, *i3, *i4 = nullptr;
    int s, s_end, prev_s;
    s_end = s = 4;  // an outer border
    do {
        s = (s - 1) & 7;
        i1 = i0 + deltas[s];
    } while (*i1 == 0 && s != s_end);

    if (s == s_end) {  // a single pixel
        *i0 = (int8_t)(nbd | -128);
        out.push_back(pt);
        return;
    }
    i3 = i0;
    prev_s = s ^ 4;
    for (;;) {
        s_end = s;
        s = s < 15 ? s : 15;
        while (s < 15) {
            i4 = i3 + deltas[++s];
            if (*i4 != 0) break;
        }
        s &= 7;
        if ((unsigned)(s - 1) < (unsigned)s_end) {
            *i3 = (int8_t)(nbd | -128);
        } else if (*i3 == 1) {
            *i3 = nbd;
        }
        if (s != prev_s || every_point) {
            out.push_back(pt);
            prev_s = s;
        }
        pt.x += kCodeDx[s];
        pt.y += kCodeDy[s];
        if (i4 == i0 && i3 == i1) break;
        i3 = i4;
        s = (s + 4) & 7;
    }
}

}  // namespace

extern "C" {

// Outer contours of an (h, w) uint8 mask. Writes every contour's points
// (x, y), in the returned order, into `pts` (room for `cap` points) and
// the offsets into `starts` (n + 1 of them); returns n, or -1 when `pts`
// is too small.
int64_t trex_find_contours_external(const uint8_t* mask, int32_t h,
                                    int32_t w, int32_t* pts, int64_t cap,
                                    int64_t* starts, int32_t every_point) {
    const int W = w + 2, H = h + 2;
    std::vector<int8_t> img((size_t)W * H, 0);
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x)
            img[(size_t)(y + 1) * W + x + 1] = mask[(size_t)y * w + x] ? 1 : 0;

    std::vector<std::vector<Pt>> found;
    int8_t* img0 = img.data();
    // cvFindNextContour in mode 0 (RETR_EXTERNAL), from (1, 1)
    int lnbd_x = 0, lnbd_y = 1;
    for (int y = 1; y < H - 1; ++y) {
        int8_t* row = img0 + (size_t)y * W;
        int prev = row[0];
        int x = 1;
        for (; x < W - 1; ++x) {
            int p;
            for (; x < W - 1 && (p = row[x]) == prev; ++x) {
            }
            if (x >= W - 1) break;
            bool is_hole = false, skip = false;
            if (!(prev == 0 && p == 1)) {
                // not an outer border: a hole border or nothing
                if (p != 0 || prev < 1) {
                    skip = true;
                } else {
                    if (prev & -2) lnbd_x = x - 1;
                    is_hole = true;
                }
            }
            // RETR_EXTERNAL: no holes, and no outer border whose last
            // border pixel to the left belongs to an outer border
            if (!skip && (is_hole || img0[(size_t)lnbd_y * W + lnbd_x] > 0))
                skip = true;
            if (!skip) {
                std::vector<Pt> c;
                fetch_contour(row + x, W, Pt{x - 1, y - 1}, every_point != 0, c);
                found.push_back(std::move(c));
                lnbd_x = x;
                prev = row[x];
                continue;
            }
            prev = p;
            if (prev & -2) lnbd_x = x;
        }
        lnbd_x = 0;
        lnbd_y = y + 1;
    }
    int64_t total = 0;
    for (const auto& c : found) total += (int64_t)c.size();
    if (total > cap) return -1;
    int64_t k = 0, n = (int64_t)found.size();
    for (int64_t i = 0; i < n; ++i) {
        const auto& c = found[n - 1 - i];
        starts[i] = k;
        for (const Pt& q : c) {
            pts[2 * k] = q.x;
            pts[2 * k + 1] = q.y;
            ++k;
        }
    }
    starts[n] = k;
    return n;
}

double trex_contour_area(const int32_t* pts, int64_t n) {
    if (n <= 0) return 0.0;
    double a00 = 0;
    float px = (float)pts[2 * (n - 1)], py = (float)pts[2 * (n - 1) + 1];
    for (int64_t i = 0; i < n; ++i) {
        float x = (float)pts[2 * i], y = (float)pts[2 * i + 1];
        a00 += (double)px * y - (double)py * x;
        px = x;
        py = y;
    }
    a00 *= 0.5;
    return std::fabs(a00);
}

double trex_arc_length(const int32_t* pts, int64_t n, int32_t closed) {
    if (n <= 1) return 0.0;
    const int N = 16;
    float buf[N];
    double perimeter = 0;
    int64_t last = closed ? n - 1 : 0;
    float px = (float)pts[2 * last], py = (float)pts[2 * last + 1];
    int j = 0;
    for (int64_t i = 0; i < n; ++i) {
        float x = (float)pts[2 * i], y = (float)pts[2 * i + 1];
        float dx = x - px, dy = y - py;
        buf[j] = dx * dx + dy * dy;
        if (++j == N || i == n - 1) {
            for (int k = 0; k < j; ++k) buf[k] = std::sqrt(buf[k]);
            for (; j > 0; --j) perimeter += buf[j - 1];
        }
        px = x;
        py = y;
    }
    return perimeter;
}

// approxPolyDP_<int> of OpenCV (modules/imgproc/src/approx.cpp); writes
// the kept points into `dst` (room for n) and returns their count.
int64_t trex_approx_poly_dp(const int32_t* src_pts, int64_t count0,
                            double eps, int32_t is_closed0,
                            int32_t* dst_pts) {
    struct Range {
        int64_t start, end;
    };
    auto src = [&](int64_t i) { return Pt{src_pts[2 * i], src_pts[2 * i + 1]}; };
    std::vector<Pt> dst((size_t)(count0 > 0 ? count0 : 1));
    std::vector<Range> stack;
    int init_iters = 3;
    Range slice{0, 0}, right_slice{0, 0};
    Pt start_pt{-1000000, -1000000}, end_pt{0, 0}, pt{0, 0};
    int64_t i = 0, j, pos = 0, wpos, count = count0, new_count = 0;
    int is_closed = is_closed0;
    bool le_eps = false;

    if (count == 0) return 0;
    eps *= eps;

    auto read_pt = [&](Pt& p, int64_t& ps) {
        p = src(ps);
        if (++ps >= count) ps = 0;
    };

    if (!is_closed) {
        right_slice.start = count;
        end_pt = src(0);
        start_pt = src(count - 1);
        if (start_pt.x != end_pt.x || start_pt.y != end_pt.y) {
            slice.start = 0;
            slice.end = count - 1;
            stack.push_back(slice);
        } else {
            is_closed = 1;
            init_iters = 1;
        }
    }

    if (is_closed) {
        right_slice.start = 0;
        for (i = 0; i < init_iters; i++) {
            double dist, max_dist = 0;
            pos = (pos + right_slice.start) % count;
            read_pt(start_pt, pos);
            for (j = 1; j < count; j++) {
                double dx, dy;
                read_pt(pt, pos);
                dx = pt.x - start_pt.x;
                dy = pt.y - start_pt.y;
                dist = dx * dx + dy * dy;
                if (dist > max_dist) {
                    max_dist = dist;
                    right_slice.start = j;
                }
            }
            le_eps = max_dist <= eps;
        }
        if (!le_eps) {
            right_slice.end = slice.start = pos % count;
            slice.end = right_slice.start =
                (right_slice.start + slice.start) % count;
            stack.push_back(right_slice);
            stack.push_back(slice);
        } else {
            dst[new_count++] = start_pt;
        }
    }

    while (!stack.empty()) {
        slice = stack.back();
        stack.pop_back();
        end_pt = src(slice.end);
        pos = slice.start;
        read_pt(start_pt, pos);
        if (pos != slice.end) {
            // OpenCV 5 measures each point's distance to the segment
            // (not to its line): squared, the perpendicular part divided
            // by the squared length
            double dx, dy, dist, max_dist = 0, len2;
            dx = end_pt.x - start_pt.x;
            dy = end_pt.y - start_pt.y;
            len2 = dx * dx + dy * dy;
            while (pos != slice.end) {
                read_pt(pt, pos);
                double px = pt.x - start_pt.x, py = pt.y - start_pt.y;
                double dot = px * dx + py * dy;
                if (dot <= 0) {
                    dist = px * px + py * py;
                } else if (dot >= len2) {
                    double qx = pt.x - end_pt.x, qy = pt.y - end_pt.y;
                    dist = qx * qx + qy * qy;
                } else {
                    double cr = py * dx - px * dy;
                    dist = cr * cr / len2;
                }
                if (dist > max_dist) {
                    max_dist = dist;
                    right_slice.start = (pos + count - 1) % count;
                }
            }
            le_eps = max_dist <= eps;
        } else {
            le_eps = true;
            start_pt = src(slice.start);
        }
        if (le_eps) {
            dst[new_count++] = start_pt;
        } else {
            right_slice.end = slice.end;
            slice.end = right_slice.start;
            stack.push_back(right_slice);
            stack.push_back(slice);
        }
    }

    if (!is_closed) dst[new_count++] = src(count - 1);

    // the last pass: drop points on [almost] straight lines
    is_closed = is_closed0;
    count = new_count;
    auto read_dst = [&](Pt& p, int64_t& ps) {
        p = dst[ps];
        if (++ps >= count) ps = 0;
    };
    pos = is_closed ? count - 1 : 0;
    read_dst(start_pt, pos);
    wpos = pos;
    read_dst(pt, pos);

    for (i = !is_closed; i < count - !is_closed && new_count > 2; i++) {
        double dx, dy, dist, successive_inner_product;
        read_dst(end_pt, pos);
        dx = end_pt.x - start_pt.x;
        dy = end_pt.y - start_pt.y;
        dist = std::fabs((pt.x - start_pt.x) * dy - (pt.y - start_pt.y) * dx);
        successive_inner_product = (pt.x - start_pt.x) * (end_pt.x - pt.x) +
                                   (pt.y - start_pt.y) * (end_pt.y - pt.y);
        if (dist * dist <= 0.5 * eps * (dx * dx + dy * dy) && dx != 0 &&
            dy != 0 && successive_inner_product >= 0) {
            new_count--;
            dst[wpos] = start_pt = end_pt;
            if (++wpos >= count) wpos = 0;
            read_dst(pt, pos);
            i++;
            continue;
        }
        dst[wpos] = start_pt = pt;
        if (++wpos >= count) wpos = 0;
        pt = end_pt;
    }

    if (!is_closed) dst[wpos] = pt;

    for (int64_t k = 0; k < new_count; ++k) {
        dst_pts[2 * k] = dst[k].x;
        dst_pts[2 * k + 1] = dst[k].y;
    }
    return new_count;
}

}  // extern "C"
