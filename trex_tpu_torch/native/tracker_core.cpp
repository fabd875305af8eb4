// Native tracking-step phases for the FastTracker engine
// (trex_tpu/track/engine.py). State lives in numpy arrays owned by
// Python; these functions mutate/read them through raw pointers.
//
// Semantics are the engine's (which is differential-tested against the
// object Tracker, i.e. the reference's Tracker.cpp:1083-1360 paired
// probabilities, per-clique optimal matching, and the reactivation
// second pass Tracker.cpp:1900-1930). Float operation order matches
// the numpy implementation so results are bit-identical.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <functional>
#include <vector>

#include "simd_clones.h"

namespace {

constexpr int64_t KNOWN = -100000000;  // last_frame > KNOWN => has history

struct Edge { int32_t b; double p; };

}  // namespace

extern "C" {

// Phase A: per-fish matching caches (engine._caches, lam == 1).
// trk_ring: (F, ring_cap, 2) int64 closed tracklets, oldest first;
// trk_ring_n: number of valid entries. Outputs tdelta, tprob (F,).
void trex_track_caches(
    int32_t n_fish, int64_t cur_frame, double time,
    int64_t global_start_frame,
    const int64_t* last_frame, const double* last_time,
    const int64_t* trk_start, const int64_t* trk_ring,
    const int32_t* trk_ring_n, int32_t ring_cap,
    int32_t frame_rate, double t_max, double p_min,
    int32_t minimum_frames, int32_t time_prob_enabled,
    double* tdelta, double* tprob) {
    const double t_delta_frame = 1.0 / frame_rate;
    for (int32_t f = 0; f < n_fish; f++) {
        const bool has = last_frame[f] > KNOWN;
        double td = time - last_time[f];
        if (td < 1e-6) td = 1e-6;
        tdelta[f] = td;
        if (!time_prob_enabled) {
            tprob[f] = has ? 1.0 : 0.0;
            continue;
        }
        double p = 1.0 - std::min(1.0, std::max(
            0.0, (td - t_delta_frame) / t_max));
        double scale = 1.0;
        if (has && last_frame[f] >= global_start_frame + minimum_frames) {
            // recent_number_samples walk over ring + current tracklet,
            // window anchored at the CURRENT frame (Individual.cpp:1806)
            const int64_t prev = last_frame[f];
            const int64_t lower = cur_frame - frame_rate;
            const double time_limit = (double)frame_rate * t_max;
            int64_t n = 0;
            int64_t previous = cur_frame;
            // tracklets newest-last: current, then ring reversed
            int64_t cs = trk_start[f], ce = prev;
            for (int32_t k = trk_ring_n[f]; k >= 0; k--) {
                int64_t t0, t1;
                if (k == trk_ring_n[f]) { t0 = cs; t1 = ce; }
                else {
                    t0 = trk_ring[((int64_t)f * ring_cap + k) * 2];
                    t1 = trk_ring[((int64_t)f * ring_cap + k) * 2 + 1];
                }
                if (t1 < lower) break;
                if ((double)(previous - t1) > time_limit) break;
                const int64_t s = std::max(t0, lower);
                const int64_t e = std::min(t1, cur_frame);
                previous = s;
                if (e >= s) n += e - s + 1;
            }
            scale = std::min(1.0, (double)(n - 1) / minimum_frames
                                      + p_min);
        }
        double tp = td > t_max ? 0.0 : (p * scale) * 0.75 + 0.25;
        tprob[f] = has ? tp : 0.0;
    }
}

// Tree branch-and-bound matcher over one clique (matching._tree_on
// semantics with identical enumeration/tie-break order). Returns true
// when solved within the node budget.
static bool tree_clique(const std::vector<std::vector<Edge>>& options,
                        int64_t node_budget,
                        std::vector<int32_t>& out_blob_of_fish) {
    const size_t n = options.size();
    // suffix upper bounds, accumulated in numpy's cumsum-of-reversed
    // order (options are sorted desc, so best = first entry)
    std::vector<double> suffix(n + 1, 0.0);
    {
        double acc = 0.0;
        for (size_t i = n; i-- > 0;) {
            acc += options[i].empty() ? 0.0 : options[i][0].p;
            suffix[i] = acc;
        }
    }
    struct Best { double sum = -1.0; std::vector<int32_t> assign; };
    Best best;
    std::vector<int32_t> cur(n, -1);
    std::vector<uint8_t> used_blob;  // indexed by local blob slot
    int32_t max_b = -1;
    for (auto& os : options)
        for (auto& e : os) max_b = std::max(max_b, e.b);
    used_blob.assign(max_b + 1, 0);
    int64_t nodes = 0;
    bool aborted = false;

    std::function<void(size_t, double)> rec =
        [&](size_t i, double acc) {
        if (aborted) return;
        if (++nodes > node_budget) { aborted = true; return; }
        if (acc + suffix[i] <= best.sum) return;
        if (i == n) {
            if (acc > best.sum) {
                best.sum = acc;
                best.assign = cur;
            }
            return;
        }
        for (auto& e : options[i]) {
            if (used_blob[e.b]) continue;
            used_blob[e.b] = 1;
            cur[i] = e.b;
            rec(i + 1, acc + e.p);
            used_blob[e.b] = 0;
            cur[i] = -1;
        }
        rec(i + 1, acc);
    };
    rec(0, 0.0);
    if (aborted) return false;
    out_blob_of_fish = best.assign;
    return true;
}

// Phase B: probability matrix + per-clique matching (mode=automatic).
// usable fish are given by index arrays; outputs fish_of_blob (B,)
// int32 (-1 = unassigned), prob_of_blob (B,), and pending edges
// (fish-major) for cliques the caller must solve in Python
// (> max_tree_fish fish, or node budget exceeded). Returns number of
// pending edges (capped at pend_cap; if it would exceed, returns -1).
TREX_HOT_CLONES
int64_t trex_track_match(
    const int32_t* uf, int32_t n_usable,
    const double* last_x, const double* last_y,
    const double* tdelta, const double* tprob,
    const double* bcx, const double* bcy, int32_t n_blobs,
    double p_min, double cm_over_maxspeed, int32_t max_tree_fish,
    int32_t* fish_of_blob, double* prob_of_blob,
    int32_t* pend_fish, int32_t* pend_blob, double* pend_p,
    int64_t pend_cap) {
    for (int32_t b = 0; b < n_blobs; b++) {
        fish_of_blob[b] = -1;
        prob_of_blob[b] = 0.0;
    }
    // edges per usable fish (blob ascending), degrees. Blobs are
    // visited through a sorted-x window: |bcx - fx| > d_rej + 1
    // implies dx^2 alone already exceeds d_rej2 (the margin dwarfs any
    // fp wobble), so the window is an exact superset of the dense
    // n_usable x n_blobs pass it replaces.
    std::vector<std::vector<Edge>> edges(n_usable);
    std::vector<int32_t> blob_deg(n_blobs, 0);
    std::vector<int32_t> bxo((size_t)n_blobs);
    for (int32_t b = 0; b < n_blobs; b++) bxo[b] = b;
    std::sort(bxo.begin(), bxo.end(), [&](int32_t a, int32_t b) {
        return bcx[a] < bcx[b];
    });
    std::vector<double> bcx_sorted((size_t)n_blobs);
    for (int32_t i = 0; i < n_blobs; i++) bcx_sorted[i] = bcx[bxo[i]];
    std::vector<int32_t> cand;
    for (int32_t i = 0; i < n_usable; i++) {
        const int32_t f = uf[i];
        const double fx = last_x[f], fy = last_y[f];
        const double td = tdelta[f], tp = tprob[f];
        // p > p_min  <=>  d < td/cms * (sqrt(tp/p_min) - 1); reject on
        // the squared distance (with margin) before the exact test
        double d_rej = 1e300;
        if (tp <= p_min) continue;  // no distance can pass
        if (cm_over_maxspeed > 0.0) {
            d_rej = td / cm_over_maxspeed
                    * (std::sqrt(tp / p_min) - 1.0) * 1.0000001 + 1.0;
        }
        const double d_rej2 = d_rej * d_rej;
        const auto lo_it = std::lower_bound(
            bcx_sorted.begin(), bcx_sorted.end(), fx - d_rej - 1.0);
        const auto hi_it = std::upper_bound(
            bcx_sorted.begin(), bcx_sorted.end(), fx + d_rej + 1.0);
        cand.assign(bxo.begin() + (lo_it - bcx_sorted.begin()),
                    bxo.begin() + (hi_it - bcx_sorted.begin()));
        std::sort(cand.begin(), cand.end());  // blob-ascending edges
        for (const int32_t b : cand) {
            const double dx = bcx[b] - fx, dy = bcy[b] - fy;
            if (dx * dx + dy * dy > d_rej2) continue;
            const double d = std::hypot(dx, dy);
            const double speed = d / td * cm_over_maxspeed;
            const double denom = (1.0 + speed) * (1.0 + speed);
            const double p = tp / denom;
            if (p > p_min) {
                edges[i].push_back({b, p});
                blob_deg[b]++;
            }
        }
    }
    // union-find cliques over (fish, blob)
    std::vector<int32_t> parent(n_usable + n_blobs);
    for (size_t i = 0; i < parent.size(); i++) parent[i] = (int32_t)i;
    std::function<int32_t(int32_t)> find = [&](int32_t x) {
        while (parent[x] != x) {
            parent[x] = parent[parent[x]];
            x = parent[x];
        }
        return x;
    };
    for (int32_t i = 0; i < n_usable; i++)
        for (auto& e : edges[i]) {
            int32_t a = find(i), b = find(n_usable + e.b);
            if (a != b) parent[std::max(a, b)] = std::min(a, b);
        }
    // group fish by clique root (ascending fish order)
    std::vector<int32_t> clique_of(n_usable + n_blobs, -1);
    std::vector<std::vector<int32_t>> cl_fish;
    std::vector<std::vector<int32_t>> cl_blobs;
    for (int32_t i = 0; i < n_usable; i++) {
        if (edges[i].empty()) continue;
        int32_t r = find(i);
        if (clique_of[r] < 0) {
            clique_of[r] = (int32_t)cl_fish.size();
            cl_fish.push_back({});
            cl_blobs.push_back({});
        }
        cl_fish[clique_of[r]].push_back(i);
    }
    for (int32_t b = 0; b < n_blobs; b++) {
        if (!blob_deg[b]) continue;
        int32_t r = find(n_usable + b);
        if (clique_of[r] >= 0) cl_blobs[clique_of[r]].push_back(b);
    }

    int64_t n_pend = 0;
    auto emit_pending = [&](const std::vector<int32_t>& fish) -> bool {
        for (int32_t i : fish)
            for (auto& e : edges[i]) {
                if (n_pend >= pend_cap) return false;
                pend_fish[n_pend] = uf[i];
                pend_blob[n_pend] = e.b;
                pend_p[n_pend] = e.p;
                n_pend++;
            }
        return true;
    };

    for (size_t c = 0; c < cl_fish.size(); c++) {
        auto& fish = cl_fish[c];
        auto& blobs = cl_blobs[c];
        if (fish.size() == 1) {
            // best blob, first maximum in blob order
            const int32_t i = fish[0];
            double bp = -1.0;
            int32_t bb = -1;
            for (auto& e : edges[i])
                if (e.p > bp) { bp = e.p; bb = e.b; }
            if (bb >= 0) {
                fish_of_blob[bb] = uf[i];
                prob_of_blob[bb] = bp;
            }
            continue;
        }
        if (blobs.size() == 1) {
            const int32_t b = blobs[0];
            double bp = -1.0;
            int32_t bf = -1;
            for (int32_t i : fish)
                for (auto& e : edges[i])
                    if (e.b == b && e.p > bp) { bp = e.p; bf = i; }
            if (bf >= 0) {
                fish_of_blob[b] = uf[bf];
                prob_of_blob[b] = bp;
            }
            continue;
        }
        if ((int32_t)fish.size() > max_tree_fish) {
            if (!emit_pending(fish)) return -1;
            continue;
        }
        // degree-sorted (stable) options, each desc by p (stable)
        std::vector<int32_t> order(fish);
        std::stable_sort(order.begin(), order.end(),
                         [&](int32_t a, int32_t b) {
                             return edges[a].size() < edges[b].size();
                         });
        std::vector<std::vector<Edge>> options;
        for (int32_t i : order) {
            auto os = edges[i];
            std::stable_sort(os.begin(), os.end(),
                             [](const Edge& a, const Edge& b) {
                                 return a.p > b.p;
                             });
            options.push_back(std::move(os));
        }
        if (fish.size() == 2) {
            // closed form replicating the tree enumeration order
            auto o1 = options[0], o2 = options[1];
            o1.push_back({-1, 0.0});
            o2.push_back({-2, 0.0});
            double bsum = -1.0;
            int32_t b1 = -1, b2 = -1;
            for (auto& e1 : o1)
                for (auto& e2 : o2) {
                    if (e1.b == e2.b) continue;
                    const double t = e1.p + e2.p;
                    if (t > bsum) { bsum = t; b1 = e1.b; b2 = e2.b; }
                }
            if (b1 >= 0) {
                fish_of_blob[b1] = uf[order[0]];
                prob_of_blob[b1] = 0.0;  // filled below
            }
            if (b2 >= 0) {
                fish_of_blob[b2] = uf[order[1]];
            }
            // probability lookup for assigned pairs
            for (int32_t k = 0; k < 2; k++) {
                const int32_t bb = k == 0 ? b1 : b2;
                if (bb < 0) continue;
                const int32_t i = order[k];
                for (auto& e : edges[i])
                    if (e.b == bb) { prob_of_blob[bb] = e.p; break; }
            }
            continue;
        }
        std::vector<int32_t> assign;
        if (!tree_clique(options, 1000000, assign)) {
            if (!emit_pending(fish)) return -1;
            continue;
        }
        for (size_t k = 0; k < order.size(); k++) {
            const int32_t bb = assign[k];
            if (bb < 0) continue;
            fish_of_blob[bb] = uf[order[k]];
            for (auto& e : edges[order[k]])
                if (e.b == bb) { prob_of_blob[bb] = e.p; break; }
        }
    }
    return n_pend;
}

// Phase C: reactivation second pass (Tracker.cpp:1900-1930 semantics
// as implemented by engine._second_pass): free blobs in order, each
// takes the best still-free fish; p = p_min + (1/sqdist/tdelta) *
// (1 - p_min); fish without history bid p_min. cand fish are given in
// identity order. Outputs fish_of_blob (-1 = none).
void trex_track_reactivate(
    const int32_t* cand, int32_t n_cand,
    const uint8_t* has_history,
    const double* last_x, const double* last_y, const double* tdelta,
    const int32_t* free_rows, int32_t n_free,
    const double* cx, const double* cy,
    double p_min, int32_t* fish_of_blob) {
    std::vector<uint8_t> taken(n_cand, 0);
    for (int32_t j = 0; j < n_free; j++) {
        const int32_t b = free_rows[j];
        const double bx = cx[b], by = cy[b];
        double best = 0.0;
        int32_t bk = -1;
        for (int32_t k = 0; k < n_cand; k++) {
            if (taken[k]) continue;
            const int32_t f = cand[k];
            double p;
            if (!has_history[k]) {
                p = p_min;
            } else {
                const double dx = bx - last_x[f];
                const double dy = by - last_y[f];
                const double sq = dx * dx + dy * dy;
                const double td = tdelta[f];
                double raw = sq > 0.0 ? 1.0 / sq / td : 1.0 / td;
                if (td <= 0.0) raw = 1.0;
                p = p_min + raw * (1.0 - p_min);
            }
            if (p > best) { best = p; bk = k; }
        }
        if (bk < 0) continue;
        taken[bk] = 1;
        fish_of_blob[b] = cand[bk];
    }
}

}  // extern "C"
