"""Tracking-stage blob: RLE lines + pixels + threshold recount.

Counterpart of ``trex_tpu/track/blob.py`` (``TrackBlob``,
``blob_id_from_lines``): identity, geometry (bounds, centroid, bbox
centre, orientation from the image moments), the thresholded recount,
the dense crop, and the split flags and parent id that the
per-individual archives keep. Pixel counts are cached per threshold
like the reference's ``recount(threshold, background)``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np

from ..ops.labeling import _lib


def blob_id_from_lines(lines: np.ndarray) -> int:
    """Position/size hash of a blob (the reference's pv::bid):

        bid = (round_half_up((x0 + x1) / 2) << 19)   # first-line center x
            | (y0 << 6)                              # first-line y
            | (n_lines & 0x3F)                       # line count, 6 bits
    """
    if len(lines) == 0:
        return 0
    x_center = (int(lines[0, 1]) + int(lines[0, 2]) + 1) // 2  # half-up
    y0 = int(lines[0, 0])
    return ((x_center << 19) | (y0 << 6) | (len(lines) & 0x3F)) & 0xFFFFFFFF


class TrackBlob:
    """A candidate object during tracking: `lines`/`pixels` from
    detection, optional native per-blob `stats` (8 doubles: n_px,
    track_count, sum_x, sum_y, sxx, syy, sxy, packed x bounds); `split`
    and `parent_id` mark a piece of a thresholded or split parent,
    `prediction` a detector's pose or outline and `store_pixels` the
    encoded colour pixels of pv storage."""

    __slots__ = ("lines", "pixels", "parent_id", "split", "flags", "_bid",
                 "_bounds", "_recount_cache", "_last_recount",
                 "_diff_cached", "stats", "prediction", "store_pixels")

    def __init__(self, lines: np.ndarray, pixels: Optional[np.ndarray],
                 flags: int = 0, parent_id: int = -1, split: bool = False,
                 stats: Optional[np.ndarray] = None):
        self.lines = np.asarray(lines, dtype=np.int32)
        self.pixels = pixels if pixels is None \
            else np.asarray(pixels, np.uint8)
        self.flags = flags
        self.parent_id = parent_id
        self.split = split
        self._bid = None
        self._bounds = None
        self._recount_cache: dict = {}
        self._last_recount: Optional[int] = None
        self._diff_cached = None
        self.stats = stats
        self.prediction = None
        self.store_pixels = None

    @property
    def blob_id(self) -> int:
        if self._bid is None:
            self._bid = blob_id_from_lines(self.lines)
        return self._bid

    @property
    def bounds(self):
        """(x, y, w, h)"""
        if self._bounds is None:
            ls = self.lines
            x0 = int(ls[:, 1].min())
            y0 = int(ls[0, 0])
            x1 = int(ls[:, 2].max())
            y1 = int(ls[-1, 0])
            self._bounds = (x0, y0, x1 - x0 + 1, y1 - y0 + 1)
        return self._bounds

    @property
    def bbox_center(self):
        """Bounding-box centre, the matching probability's position
        (Individual.cpp:2186-2194: bounds.pos() + size * 0.5)."""
        x, y, w, h = self.bounds
        return (x + w * 0.5, y + h * 0.5)

    @property
    def center(self):
        """Mask centroid (image moments)."""
        if self.stats is not None:
            n = self.stats[0]
            return (float(self.stats[2] / n), float(self.stats[3] / n))
        ys, x0s, x1s = self.lines[:, 0], self.lines[:, 1], self.lines[:, 2]
        w = (x1s - x0s + 1).astype(np.float64)
        n = w.sum()
        cx = float((0.5 * (x0s + x1s) * w).sum() / n)
        cy = float((ys * w).sum() / n)
        return (cx, cy)

    @property
    def num_pixels(self) -> int:
        if self.stats is not None:
            return int(self.stats[0])
        return int(np.sum(self.lines[:, 2] - self.lines[:, 1] + 1))

    @property
    def orientation(self) -> float:
        """Principal-axis angle from the image moments of the mask."""
        if self.stats is not None:
            n, _, sx, sy, sx2, sy2, sxy = self.stats[:7]
            cx, cy = sx / n, sy / n
            mu20 = sx2 - cx * sx
            mu02 = sy2 - cy * sy
            mu11 = sxy - cx * sy
            if mu20 == mu02 and mu11 == 0:
                return 0.0
            return 0.5 * math.atan2(2 * mu11, mu20 - mu02)
        ys, x0s, x1s = self.lines[:, 0], self.lines[:, 1], self.lines[:, 2]
        w = (x1s - x0s + 1).astype(np.float64)
        n = w.sum()
        cx = float((0.5 * (x0s + x1s) * w).sum() / n)
        cy = float((ys * w).sum() / n)
        # second moments from exact sums over the runs:
        # sum x^2 over [a, b] = (b(b+1)(2b+1) - (a-1)a(2a-1)) / 6
        a = x0s.astype(np.float64)
        b = x1s.astype(np.float64)
        sx2 = ((b * (b + 1) * (2 * b + 1)
                - (a - 1) * a * (2 * a - 1)) / 6.0).sum()
        sx = (0.5 * (a + b) * w).sum()
        mu20 = sx2 - 2 * cx * sx + cx * cx * n
        mu02 = float(((ys - cy) ** 2 * w).sum())
        mu11 = float((((0.5 * (a + b)) - cx) * (ys - cy) * w).sum())
        if mu20 == mu02 and mu11 == 0:
            return 0.0
        return 0.5 * math.atan2(2 * mu11, mu20 - mu02)

    def raw_recount(self, threshold: int, background: Optional[np.ndarray],
                    absolute: bool, use_bgsub: bool) -> int:
        """Pixel count above `threshold` vs background (count in px)."""
        if threshold <= 0 or self.pixels is None or background is None \
                or not use_bgsub:
            if threshold <= 0 or self.pixels is None:
                return self.num_pixels
            # no background: threshold raw pixel values
            return int(np.count_nonzero(self.pixels >= threshold))
        diff = self._diff_values(background)
        if absolute:
            return int(np.count_nonzero(np.abs(diff) >= threshold))
        return int(np.count_nonzero(diff >= threshold))

    def _diff_values(self, background: np.ndarray) -> np.ndarray:
        """(bg - px) per mask pixel, int16, scan order (cached)."""
        if self._diff_cached is not None:
            return self._diff_cached
        ls = self.lines
        widths = ls[:, 2] - ls[:, 1] + 1
        w = background.shape[1]
        starts = ls[:, 0].astype(np.int64) * w + ls[:, 1]
        total = int(widths.sum())
        offs = np.arange(total) - np.repeat(
            np.concatenate([[0], np.cumsum(widths[:-1])]), widths)
        flat = np.repeat(starts, widths) + offs
        bg_vals = background.reshape(-1)[flat].astype(np.int16)
        self._diff_cached = bg_vals - self.pixels.astype(np.int16)
        return self._diff_cached

    def recount(self, threshold: int, background=None,
                settings=None) -> float:
        """Thresholded size in cm^2 (cached); ``threshold == -1`` returns
        the last one computed."""
        if threshold == -1:
            if self._last_recount is None:
                raise ValueError("no recount cached yet")
            return self._recount_cache[self._last_recount]
        if threshold not in self._recount_cache:
            if settings is not None:
                absolute = bool(settings["track_threshold_is_absolute"])
                use_bgsub = bool(settings["track_background_subtraction"])
                cm = settings["cm_per_pixel"] or 1.0
            else:
                absolute, use_bgsub, cm = True, True, 1.0
            cnt = self.raw_recount(threshold, background, absolute,
                                   use_bgsub)
            self._recount_cache[threshold] = cnt * cm * cm
        self._last_recount = threshold
        return self._recount_cache[threshold]

    def to_dense(self, pad: int = 0):
        """(mask, gray, (ox, oy)): dense uint8 crops of the blob,
        rasterized by the host labeler (``trex_blob_dense``)."""
        x, y, w, h = self.bounds
        H, W = h + 2 * pad, w + 2 * pad
        mask = np.zeros((H, W), np.uint8)
        gray = np.zeros_like(mask)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lines = np.ascontiguousarray(self.lines, np.int32)
        px = self.pixels
        if px is not None:
            px = np.ascontiguousarray(px, np.uint8)
        _lib().trex_blob_dense(
            lines.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(lines), px.ctypes.data_as(u8p) if px is not None else None,
            int(x), int(y), W, H, int(pad),
            mask.ctypes.data_as(u8p), gray.ctypes.data_as(u8p))
        return mask, gray, (x - pad, y - pad)
