"""Size filters and track-threshold splitting of a blob.

Counterpart of ``trex_tpu/track/prefilter.py`` (``SizeFilters``,
``threshold_components``): what the host FastTracker's candidate
construction and the start-frame split call.
"""
from __future__ import annotations

import numpy as np

from ..ops.labeling import label_blobs, threshold_blob_native
from .blob import TrackBlob


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
