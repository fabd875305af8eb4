"""Blob splitting by threshold escalation, and the history split.

Counterpart of ``trex_tpu/track/splitting.py`` (the reference's
SplitBlob, tracking/SplitBlob.h:33-70, and HistorySplit,
tracking/HistorySplit.h). ``split_blob`` raises the threshold step by
step until the blob falls into the requested number of fish-sized
components, never shrinking a piece below
``blob_split_global_shrink_limit`` times the size minimum nor the whole
below ``blob_split_max_shrink`` times the original size; failure returns
[] and the caller treats the blob as unsplittable. The host FastTracker
calls it for the start-frame split, the object Tracker also through
``HistorySplit``, which decides from the fish's estimated positions how
many individuals each blob holds.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..ops.labeling import split_scan, split_sizes
from .blob import TrackBlob
from .prefilter import SizeFilters, threshold_components

MAX_THRESHOLD = 255


def _split_crop(blob: TrackBlob, background: np.ndarray):
    """Masked grayscale crop + matching background crop for the
    escalation scan."""
    mask, gray, (ox, oy) = blob.to_dense(pad=1)
    bg_crop = np.zeros_like(gray)
    bh, bw = background.shape[:2]
    ys0, ys1 = max(0, oy), min(bh, oy + gray.shape[0])
    xs0, xs1 = max(0, ox), min(bw, ox + gray.shape[1])
    bg_crop[ys0 - oy:ys1 - oy, xs0 - ox:xs1 - ox] = \
        background[ys0:ys1, xs0:xs1]
    # pixel value 0 is the scan's outside-mask sentinel: clamp genuine
    # zeros inside the mask to 1
    img = np.where(mask > 0, np.maximum(gray, 1), bg_crop.astype(np.uint8))
    return img, bg_crop


def _initial_threshold(settings) -> int:
    track_thr = int(settings["track_threshold"])
    if settings["calculate_posture"]:
        initial = max(track_thr,
                      int(settings["track_posture_threshold"])) + 1
    else:
        initial = track_thr + 1
    return max(1, initial)


def _evaluate_split(expected: int, first_size: float, comps: list,
                    settings, cm_sqr: float, fish_size: SizeFilters) -> str:
    """SplitBlob::evaluate_result_multiple: 'abort' (shrunk too far),
    'remove' (pieces still too big), 'too_few' or 'keep'. Drops pieces
    below the global shrink limit from `comps`."""
    total = sum(c.num_pixels for c in comps) * cm_sqr
    if total < settings["blob_split_max_shrink"] * first_size:
        return "abort"
    if fish_size:
        min_thresh = fish_size.max_range[0] * \
            settings["blob_split_global_shrink_limit"]
    else:
        min_thresh = total * settings["blob_split_max_shrink"]
    comps[:] = [c for c in comps if c.num_pixels * cm_sqr >= min_thresh]
    valid = 0
    min_size = None
    for c in comps[:expected]:
        s = c.num_pixels
        if min_size is None or s < min_size:
            min_size = s
        if not fish_size or fish_size.in_range_of_one(s * cm_sqr):
            valid += 1
    if fish_size and min_size is not None \
            and min_size * cm_sqr > fish_size.max_range[1]:
        return "remove"
    if valid < expected:
        return "too_few"
    return "keep"


def split_blob(blob: TrackBlob, expected: int, background: np.ndarray,
               settings) -> list:
    """Split `blob` into >= `expected` components by raising the
    threshold from max(track_threshold, track_posture_threshold) + 1 to
    the smallest one whose components pass the split evaluation. Returns
    the components largest first, or [] when no split is acceptable."""
    if expected <= 1:
        return [blob]
    s = settings
    if s["blob_split_algorithm"] == "none":
        return []
    track_thr = int(s["track_threshold"])
    cm = s["cm_per_pixel"] or 1.0
    cm_sqr = cm * cm
    fish_size = SizeFilters(s["track_size_filter"])
    # the scan needs only component sizes until the threshold is chosen;
    # its components then materialize with one threshold_components call
    img, bg_crop = _split_crop(blob, background)
    best_thr, first_size = split_scan(
        img, bg_crop, _initial_threshold(s),
        bool(s["track_threshold_is_absolute"]), expected, cm_sqr,
        float(s["blob_split_max_shrink"]),
        float(s["blob_split_global_shrink_limit"]), fish_size.ranges)
    if best_thr < 0:
        return []
    comps = threshold_components(blob, best_thr, background, s)
    comps.sort(key=lambda c: -c.num_pixels)
    if _evaluate_split(expected, first_size, comps, s, cm_sqr,
                       fish_size) != "keep":
        return []  # size scan and materialization disagree: be safe
    for c in comps:
        c.split = True
        c.parent_id = blob.blob_id
        c.recount(track_thr, background, s)
    return comps


def split_scan_py(img: np.ndarray, bg_crop: np.ndarray, initial: int,
                  absolute: bool, expected: int, settings
                  ) -> tuple[int, float]:
    """Pure-numpy scan over thresholds: the pre-native reference for
    trex_split_scan (differential-tested equal). Scans EVERY threshold
    ascending until the first keep or an abort — the reference's
    segmented multi-thread sampling covers the whole band at step 1
    (SplitBlob.cpp:616-660), so narrow keep-windows must not be
    skipped. Returns (best threshold or -1, first_size cm^2)."""
    s = settings
    cm = s["cm_per_pixel"] or 1.0
    cm_sqr = cm * cm
    fish_size = SizeFilters(s["track_size_filter"])
    max_shrink = float(s["blob_split_max_shrink"])
    shrink_lim = float(s["blob_split_global_shrink_limit"])
    top_k = max(16, expected)

    def evaluate_rows(mat: np.ndarray, first_size: float):
        """Vectorized SplitBlob::evaluate_result_multiple over a
        (n, 2+K) size matrix. Sizes are sorted desc per row, so the
        shrink filter removes a suffix and top-`expected` of the
        filtered list is a row prefix. Returns (abort, keep) vectors."""
        n_comps = mat[:, 0]
        total = mat[:, 1].astype(np.float64) * cm_sqr
        abort = total < max_shrink * first_size
        if fish_size:
            min_thresh = np.full_like(total,
                                      fish_size.max_range[0] * shrink_lim)
        else:
            min_thresh = total * max_shrink
        sizes = mat[:, 2:].astype(np.float64) * cm_sqr  # (n, K) desc
        within = np.arange(sizes.shape[1])[None, :] \
            < np.minimum(n_comps, top_k)[:, None]
        kept = within & (sizes >= min_thresh[:, None])  # prefix per row
        take = np.minimum(kept.sum(axis=1), expected)
        if fish_size:
            in_rng = np.zeros(sizes.shape, bool)
            for lo, hi in fish_size.ranges:
                in_rng |= (sizes >= lo) & (sizes <= hi)
        else:
            in_rng = np.ones(sizes.shape, bool)
        prefix = np.arange(sizes.shape[1])[None, :] < take[:, None]
        valid = (in_rng & prefix).sum(axis=1)
        # min of the prefix = its last element (sizes descending)
        min_size = sizes[np.arange(len(take)), np.maximum(take, 1) - 1]
        remove = (take > 0) & (min_size > fish_size.max_range[1]) \
            if fish_size else np.zeros(len(take), bool)
        keep = ~abort & ~remove & (valid >= expected)
        return abort, keep

    thrs = np.arange(max(1, initial), MAX_THRESHOLD + 1)
    mat = split_sizes(img, bg_crop, thrs, absolute, top_k)
    first_size = (float(mat[0, 2]) * cm_sqr) if mat[0, 0] > 0 else 0.0
    abort_f, keep_f = evaluate_rows(mat, first_size)
    stop = keep_f | abort_f
    if stop.any():
        i = int(np.argmax(stop))
        if keep_f[i]:
            return int(thrs[i]), first_size
    return -1, first_size


class HistorySplit:
    """Decides which blobs must be split before matching.

    Mirrors the role of the reference's HistorySplit: for each blob,
    count how many currently-active individuals project onto it
    (expected individuals per blob); blobs with expectation > 1 are
    split via split_blob. Manual splits (`manual_splits` setting) are
    always honored.
    """

    def __init__(self, settings):
        self.settings = settings

    def split_expectation(self, blobs: list[TrackBlob],
                          fish_positions: list[tuple],
                          max_distance_px: float) -> dict[int, int]:
        """The reference's expectation algorithm (HistorySplit.cpp:
        170-320): per connected clique of fish<->blob proximity edges
        with more fish than blobs, resolve conflicts greedily closest-
        first; every fish left without an alternative raises the split
        expectation of its best blob (plus one for the current owner).

        Returns {blob_index: expected_count}; blobs absent need no split.
        """
        if not fish_positions or not blobs:
            return {}
        bounds = np.array([b.bounds for b in blobs], np.float64)
        x0 = bounds[:, 0]
        y0 = bounds[:, 1]
        x1 = bounds[:, 0] + bounds[:, 2] - 1
        y1 = bounds[:, 1] + bounds[:, 3] - 1
        pos = np.asarray(fish_positions, np.float64)
        fx = pos[:, 0][:, None]
        fy = pos[:, 1][:, None]
        dx = np.maximum(0, np.maximum(x0[None, :] - fx, fx - x1[None, :]))
        dy = np.maximum(0, np.maximum(y0[None, :] - fy, fy - y1[None, :]))
        dmat = np.hypot(dx, dy)
        near = dmat <= max_distance_px
        # early exit: only fish touching a contested blob (>= 2 mapped
        # fish) can raise expectations — typical frames have none
        contested = near.sum(axis=0) >= 2
        if not contested.any():
            return {}
        involved = near[:, contested].any(axis=1)
        fish_ids = np.flatnonzero(involved)
        cand = near[involved]  # (F_inv, B) bbox-proximity candidates
        cand_blobs = np.flatnonzero(cand.any(axis=0))

        # The reference's blob_grid holds SAMPLED mask points (PPFrame::
        # fill_proximity_grid + insert_line, PPFrame.cpp:123-135,
        # 891-932): first/last line plus even-y lines; per line the two
        # endpoints, the midpoint, and interior points every
        # max(1, bbox_width*0.1) px (only when that step >= 5). Edges
        # exist where a sampled point lies within max_d of the estimate;
        # distances are to the sampled points (NOT the exact mask), so
        # replicate the sampling bit for bit. All candidate blobs'
        # points stack into one array; one distance matrix + a
        # scatter-min gives every (fish, blob) mask distance at once.
        line_arrays = [np.asarray(blobs[bi].lines) for bi in cand_blobs]
        counts = np.fromiter((len(a) for a in line_arrays), np.int64,
                             len(line_arrays))
        L = np.concatenate(line_arrays).astype(np.float64)
        ends = np.cumsum(counts)
        starts = ends - counts
        line_owner = np.repeat(np.arange(len(counts)), counts)
        # line selection: blobs with >= 4 lines keep first/last + even-y
        # interiors; smaller blobs keep every line
        keep = L[:, 0] % 2 == 0
        keep[np.repeat(counts < 4, counts)] = True
        keep[starts] = True
        keep[ends - 1] = True
        Lk = L[keep]
        ok_owner = line_owner[keep]
        y = Lk[:, 0]
        x0 = Lk[:, 1]
        x1 = Lk[:, 2]
        pts = np.concatenate([
            np.stack([x0, y], 1), np.stack([x1, y], 1),
            np.stack([x0 + (x1 - x0) * 0.5, y], 1)])
        owner = np.concatenate([ok_owner] * 3)
        # interior samples every `step` px exist only when
        # step = max(1, bbox_width*0.1) >= 5, i.e. blobs >= ~50 px wide
        widths = np.zeros(len(counts))
        np.maximum.at(widths, line_owner, L[:, 2])
        mins = np.full(len(counts), np.inf)
        np.minimum.at(mins, line_owner, L[:, 1])
        steps = np.maximum(1.0, (widths - mins + 1) * 0.1).astype(np.int64)
        step_of = steps[ok_owner]
        wide = np.flatnonzero((step_of >= 5) & (x1 - x0 >= 2 * step_of))
        if wide.size:
            extra = []
            extra_owner = []
            for i in wide.tolist():
                st = step_of[i]
                xs = np.arange(x0[i] + st, x1[i] - st + 1e-9, st)
                extra.append(np.stack([xs, np.full(xs.size, y[i])], 1))
                extra_owner.append(np.full(xs.size, ok_owner[i], np.int64))
            pts = np.concatenate([pts] + extra)
            owner = np.concatenate([owner] + extra_owner)
        fpos = pos[fish_ids]  # (F_inv, 2)
        d2 = (pts[None, :, 0] - fpos[:, 0, None]) ** 2 \
            + (pts[None, :, 1] - fpos[:, 1, None]) ** 2
        md2 = np.full((len(fish_ids), len(cand_blobs)), np.inf)
        np.minimum.at(md2, (slice(None), owner), d2)
        md = np.sqrt(md2)
        slot_of = {int(bi): si for si, bi in enumerate(cand_blobs)}

        edges: dict[int, list] = {}
        fi_rows, bi_cols = np.nonzero(cand)
        for fr, bi in zip(fi_rows.tolist(), bi_cols.tolist()):
            dist = md[fr, slot_of[bi]]
            if dist <= max_distance_px:
                edges.setdefault(int(fish_ids[fr]), []).append(
                    (float(dist), bi))
        for es in edges.values():
            es.sort()

        # connected cliques over shared blobs
        parent: dict = {}

        def find(x):
            while parent.setdefault(x, x) != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        def union(a, b):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[rb] = ra

        for fi, es in edges.items():
            for _, bi in es:
                union(("f", fi), ("b", bi))
        cliques: dict = {}
        for fi in edges:
            cliques.setdefault(find(("f", fi)), ([], set()))[0].append(fi)
        for fi, es in edges.items():
            root = find(("f", fi))
            for _, bi in es:
                cliques[root][1].add(bi)

        expect: dict[int, int] = {}
        for fish_list, blob_set in cliques.values():
            if len(fish_list) <= len(blob_set):
                continue
            combos = {fi: list(edges[fi]) for fi in fish_list}
            assign_fish = {fi: combos[fi][0] for fi in fish_list}
            assign_blob: dict[int, tuple] = {}
            queue = list(fish_list)
            while queue:
                fi = queue.pop(0)
                combo = combos[fi]
                if not combo:
                    continue
                d, b = combo[0]
                if b not in assign_blob:
                    assign_blob[b] = (fi, d)
                    continue
                owner, od = assign_blob[b]
                if owner != fi:
                    if od <= d:
                        combo.pop(0)
                        queue.append(fi)
                    else:
                        assign_blob[b] = (fi, d)
                        queue.append(owner)
                        # owner must look for alternatives again
            for fi in fish_list:
                if combos[fi]:
                    continue  # still has alternatives
                d, b = assign_fish[fi]
                if b in assign_blob:
                    expect[b] = expect.get(b, 0) + 1  # current owner
                    del assign_blob[b]
                expect[b] = expect.get(b, 0) + 1
        return expect

    def apply(self, frame_index: int, blobs: list[TrackBlob],
              fish_positions: list[tuple], background: np.ndarray,
              noise_sink: Optional[list] = None) -> list[TrackBlob]:
        """Return the blob list with over-subscribed blobs split
        (HistorySplit tail: split_big + final size filter)."""
        s = self.settings
        fish_size = SizeFilters(s["track_size_filter"])
        cm = s["cm_per_pixel"] or 1.0
        cm_sqr = cm * cm
        if not s["track_do_history_split"]:
            return blobs
        # max_d = track_max_speed * tdelta / cm_per_pixel * 0.5
        # (PPFrame.cpp:214, tdelta = one frame)
        max_d = (s["track_max_speed"] / cm) / max(
            1.0, float(s["frame_rate"] or 25)) * 0.5
        expect = self.split_expectation(blobs, fish_positions, max_d)
        # manual splits always force a 2-way split
        manual = (s["manual_splits"] or {})
        manual_bids = set(manual.get(frame_index, [])
                          or manual.get(str(frame_index), []))
        out = []
        for bi, b in enumerate(blobs):
            want = expect.get(bi, 0)
            if b.blob_id in manual_bids:
                want = max(want, 2)
            if want < 2:
                out.append(b)
                continue
            # NO retry with fewer parts here: the reference's history
            # split demands exactly `expect.number` pieces
            # (allow_less_than=false, HistorySplit.cpp:184-200) — a
            # failed split sends the blob to noise and the involved
            # fish stay missing. (The start-frame split_big retry lives
            # in tracker.py where the count is only a size heuristic.)
            parts = split_blob(b, want, background, self.settings)
            if not parts:
                # split failed: the blob leaves the match candidates
                # (FilterReason::History) — involved fish stay missing
                if noise_sink is not None:
                    noise_sink.append(b)
                continue
            for p in parts:
                p.recount(int(s["track_threshold"]), background, s)
                out.append(p)
        # final size filter (HistorySplit.cpp:364-373): everything out of
        # track_size_filter becomes noise
        final = []
        for b in out:
            rec = b.recount(-1) if b._last_recount is not None \
                else b.num_pixels * cm_sqr
            if not fish_size or fish_size.in_range_of_one(rec):
                final.append(b)
            elif noise_sink is not None:
                noise_sink.append(b)
        return final
