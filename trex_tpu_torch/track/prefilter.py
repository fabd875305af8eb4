"""Blob prefiltering and track-threshold splitting.

Counterpart of ``trex_tpu/track/prefilter.py`` (Tracker::prefilter,
Tracker.cpp:676-964, and PrefilterBlobs, tracking/PrefilterBlobs.h):

1. recount each raw blob at track_threshold against the background;
2. if it may be fish-sized, re-threshold the blob's own pixels and split
   the survivors into connected components (``threshold_components``,
   which the host FastTracker's candidate construction and the
   start-frame split call too);
3. sort the results into filtered (fish-sized), filtered_out (noise,
   with a FilterReason) and big_blobs (over the size maximum: split
   candidates);
4. the optional second threshold (track_threshold_2 with
   threshold_ratio_range);
5. the track_ignore / track_include shape filters and track_ignore_bdx.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..ops.labeling import label_blobs, threshold_blob_native
from .blob import TrackBlob


class FilterReason(enum.Enum):
    Unknown = 0
    OutsideRange = 1
    SecondThreshold = 2
    InsideIgnore = 3
    OutsideInclude = 4
    BdxIgnored = 5
    SplitFailed = 6
    Category = 7
    Label = 8
    TrackConfidenceThreshold = 9
    DontTrackTags = 10
    OnlySegmentations = 11


@dataclass
class PrefilterResult:
    frame_index: int
    filtered: list = field(default_factory=list)
    filtered_out: list = field(default_factory=list)  # (blob, reason)
    big_blobs: list = field(default_factory=list)

    def filter_out(self, blob, reason: FilterReason):
        self.filtered_out.append((blob, reason))


class SizeFilters:
    """List of [min, max] ranges in cm^2 (commons SizeFilters)."""

    def __init__(self, ranges):
        self.ranges = [tuple(map(float, r)) for r in (ranges or [])]

    def __bool__(self):
        return bool(self.ranges)

    def in_range_of_one(self, value: float) -> bool:
        if not self.ranges:
            return True
        return any(lo <= value <= hi for lo, hi in self.ranges)

    def close_to_minimum_of_one(self, value: float, factor: float) -> bool:
        if not self.ranges:
            return True
        return any(value >= lo * factor for lo, hi in self.ranges)

    @property
    def max_range(self):
        """The range with the largest end."""
        return max(self.ranges, key=lambda r: r[1]) if self.ranges \
            else (0.0, float("inf"))


def threshold_components(blob: TrackBlob, threshold: int,
                         background: np.ndarray, settings) -> list:
    """pixel::threshold_blob: apply the track threshold to the blob's own
    pixels and split the survivors into connected components, each
    marked split with the blob as its parent."""
    cm = settings["cm_per_pixel"] or 1.0
    absolute = bool(settings["track_threshold_is_absolute"])
    if blob.pixels is not None:
        # fast path: if every mask pixel passes the threshold, the
        # component set is exactly the original (connected) blob. The
        # cached recount matches the diff-based test only under
        # background subtraction.
        cached = blob._recount_cache.get(threshold) \
            if settings["track_background_subtraction"] else None
        passed_all = passed_any = None
        if cached is not None:
            cnt = cached / (cm * cm)
            if round(cnt) >= blob.num_pixels:
                passed_all, passed_any = True, True
            elif cnt <= 0:
                passed_all, passed_any = False, False
        if passed_all is None:
            diff = blob._diff_values(background)
            passed = np.abs(diff) >= threshold if absolute \
                else diff >= threshold
            passed_all = bool(passed.all())
            passed_any = bool(passed.any())
        if passed_all:
            out = TrackBlob(blob.lines, blob.pixels, flags=blob.flags,
                            parent_id=blob.blob_id, split=True,
                            stats=blob.stats)
            out._recount_cache.update(blob._recount_cache)
            return [out]
        if not passed_any:
            return []
        comps = threshold_blob_native(blob.lines, blob.pixels, background,
                                      threshold, absolute)
        out = []
        for c in comps:
            tb = TrackBlob(c.lines, c.pixels, flags=blob.flags,
                           parent_id=blob.blob_id, split=True,
                           stats=c.stats)
            tb._recount_cache[threshold] = float(
                c.stats[0] if c.stats is not None
                else tb.num_pixels) * cm * cm
            out.append(tb)
        return out
    # no pixel data: label the dense crop (mask pixels read as 0)
    mask, gray, (ox, oy) = blob.to_dense(pad=1)
    bg_crop = np.zeros_like(gray)
    bh, bw = background.shape[:2]
    ys0, ys1 = max(0, oy), min(bh, oy + gray.shape[0])
    xs0, xs1 = max(0, ox), min(bw, ox + gray.shape[1])
    bg_crop[ys0 - oy:ys1 - oy, xs0 - ox:xs1 - ox] = \
        background[ys0:ys1, xs0:xs1]
    img = np.where(mask > 0, gray, bg_crop.astype(np.uint8))
    out = []
    for c in label_blobs(img, bg_crop, threshold=threshold,
                         absolute=absolute):
        lines = c.lines.copy()
        lines[:, 0] += oy
        lines[:, 1] += ox
        lines[:, 2] += ox
        # translate the moment sums by the crop offset
        n, tc, sx, sy, sxx, syy, sxy = c.stats[:7]
        stats = np.array([
            n, tc, sx + n * ox, sy + n * oy,
            sxx + 2 * ox * sx + n * ox * ox,
            syy + 2 * oy * sy + n * oy * oy,
            sxy + ox * sy + oy * sx + n * ox * oy, 0.0])
        tb = TrackBlob(lines, c.pixels, flags=blob.flags,
                       parent_id=blob.blob_id, split=True, stats=stats)
        # every pixel of a component passed `threshold` by construction
        tb._recount_cache[threshold] = float(stats[0]) * cm * cm
        out.append(tb)
    return out


def _shape_filters(settings):
    return settings["track_ignore"] or [], settings["track_include"] or []


def _point_in_poly(px, py, poly) -> bool:
    """Even-odd rule; rectangles given as [[x0,y0],[x1,y1]]."""
    if len(poly) == 2:
        (x0, y0), (x1, y1) = poly
        return min(x0, x1) <= px <= max(x0, x1) and min(y0, y1) <= py <= max(y0, y1)
    inside = False
    n = len(poly)
    for i in range(n):
        x0, y0 = poly[i]
        x1, y1 = poly[(i + 1) % n]
        if (y0 > py) != (y1 > py):
            xcross = (x1 - x0) * (py - y0) / (y1 - y0) + x0
            if px < xcross:
                inside = not inside
    return inside


def blob_matches_shapes(blob: TrackBlob, shapes) -> bool:
    cx, cy = blob.center
    return any(_point_in_poly(cx, cy, s) for s in shapes)


def prefilter(frame_index: int, raw_blobs: list,
              background: Optional[np.ndarray], settings) -> PrefilterResult:
    """Sort a frame's raw blobs into fish-sized candidates, noise (with
    its reason) and big blobs, each candidate recounted at
    track_threshold."""
    result = PrefilterResult(frame_index)
    threshold = int(settings["track_threshold"])
    fish_size = SizeFilters(settings["track_size_filter"])
    cm = settings["cm_per_pixel"] or 1.0
    cm_sqr = cm * cm
    ignore, include = _shape_filters(settings)
    ignore_bdx = settings["track_ignore_bdx"] or {}
    frame_ignores = set(ignore_bdx.get(str(frame_index), [])) \
        | set(ignore_bdx.get(frame_index, []) if isinstance(ignore_bdx, dict)
              else [])

    def precise_ok(b: TrackBlob) -> bool:
        if ignore and blob_matches_shapes(b, ignore):
            result.filter_out(b, FilterReason.InsideIgnore)
            return False
        if include and not blob_matches_shapes(b, include):
            result.filter_out(b, FilterReason.OutsideInclude)
            return False
        if b.blob_id in frame_ignores:
            result.filter_out(b, FilterReason.BdxIgnored)
            return False
        return True

    tags_dont_track = bool(settings["tags_dont_track"])
    for blob in raw_blobs:
        # physical-tag objects never track under tags_dont_track (the
        # default; Tracker.cpp:776)
        if tags_dont_track and (blob.flags & 0x2):
            result.filter_out(blob, FilterReason.DontTrackTags)
            continue
        if fish_size \
                and blob.num_pixels * cm_sqr > fish_size.max_range[1] * 100:
            blob.force_set_recount(threshold, settings=settings)
        else:
            blob.recount(threshold, background, settings)

        recount = blob.recount(-1)
        candidates: list = []
        found = 0
        if (not fish_size or fish_size.close_to_minimum_of_one(recount, 0.5)) \
                and threshold > 0 and background is not None \
                and blob.pixels is not None:
            comps = threshold_components(blob, threshold, background,
                                         settings)
            found = len(comps)
            for c in comps:
                c.recount(threshold, background, settings)
                if precise_ok(c):
                    candidates.append(c)
        if found == 0:
            if precise_ok(blob):
                candidates.append(blob)
            else:
                continue

        for c in candidates:
            recount = c.recount(-1)
            if fish_size.in_range_of_one(recount):
                t2 = int(settings["track_threshold_2"])
                if t2 > 0:
                    second = c.recount(t2, background, settings)
                    c.force_set_recount(threshold, recount / cm_sqr,
                                        settings=settings)
                    lo, hi = settings["threshold_ratio_range"]
                    if not (lo * recount <= second <= hi * recount):
                        result.filter_out(c, FilterReason.SecondThreshold)
                        continue
                result.filtered.append(c)
            elif fish_size and recount < fish_size.max_range[0]:
                result.filter_out(c, FilterReason.OutsideRange)
            else:
                result.big_blobs.append(c)
    return result
