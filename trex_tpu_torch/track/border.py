"""Arena border model (reference core/Border.{h,cpp}).

Border types (recognition_border setting): none / heatmap / outline /
shapes / grid / circle. Used for the BORDER_DISTANCE output field and
for gating recognition samples near walls.

- heatmap (Border::update_heatmap, Border.cpp:137-220): sample ~0.02%
  of the video's frames, re-threshold each blob at track_threshold,
  keep fish-sized pieces (min size rescaled by
  recognition_border_size_rescale), accumulate mask-pixel counts on a
  100x100 cell grid, then keep cells whose count reaches the 5th
  percentile of the nonzero counts.
- outline: the largest dark region of the background becomes the arena.
- grid (Border.cpp:509-538): `grid_points` become circle centers; the
  common radius is half the average nearest-neighbor distance times
  grid_points_scaling.
- distance(): exact distance to the arena border — a euclidean
  distance transform of the mask for mask-based types, circle edge for
  grid, polygon edges for shapes, frame edges otherwise.

The mask's image operations (the heatmap's box blur, the outline's
contour, area and polygon fill, the shrink's elliptic erode and dilate)
are the port's bit-for-bit copies of OpenCV's (``utils/imgproc.py``,
``track/tag_image.py``), so the masks and distances equal the JAX
package's.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from ..utils.imgproc import box_blur, dilate, ellipse_element, erode, \
    fill_poly


class Border:
    def __init__(self, settings, background: Optional[np.ndarray] = None):
        self.settings = settings
        self.type = settings["recognition_border"] or "none"
        self.background = background
        self._mask: Optional[np.ndarray] = None
        self._dist: Optional[np.ndarray] = None
        self._shapes = settings["recognition_shapes"] or []
        self._grid_points = np.asarray(
            settings["grid_points"] or [], np.float64).reshape(-1, 2)
        self._grid_radius = 0.0
        if self.type == "outline" and background is not None:
            self._build_outline()
        elif self.type == "grid" and len(self._grid_points) >= 2:
            self._build_grid()

    # ------------------------------------------------------------------
    def update_from_video(self, pv_file) -> None:
        """Build the mask from a pv file: heatmap sampling
        (Border::update_heatmap) or the stored binary mask for the
        circle type (Border.cpp:554-599 — cam_circle_mask recordings
        carry the arena mask in the file header)."""
        if self.type == "circle" and self._mask is None:
            m = getattr(pv_file.header, "mask", None)
            if m is not None:
                m = np.asarray(m)
                self._mask = (m[..., 0] if m.ndim == 3 else m) > 0
            return
        if self.type != "heatmap" or self._mask is not None:
            return
        from .blob import TrackBlob
        from .prefilter import SizeFilters, threshold_components

        s = self.settings
        n = len(pv_file)
        if not n or self.background is None:
            return
        h, w = self.background.shape[:2]
        grid_res = 100
        cw = w / grid_res
        ch = h / grid_res
        counts = np.zeros((grid_res + 2, grid_res + 2), np.int64)
        fish_size = SizeFilters(s["track_size_filter"])
        rescale = 1 - min(0.9, max(
            0.0, float(s["recognition_border_size_rescale"] or 0)))
        cm_sqr = (s["cm_per_pixel"] or 1.0) ** 2
        thr = int(s["track_threshold"])
        step = max(1, int(n * 0.0002))
        for i in range(0, n, step):
            fr = pv_file.read_frame(i)
            for k in range(fr.n):
                blob = TrackBlob(fr.masks[k], fr.pixels[k])
                pieces = threshold_components(blob, thr, self.background,
                                              s) if thr > 0 else [blob]
                for p in pieces:
                    size = p.num_pixels * cm_sqr
                    # commons SizeFilters::in_range_of_one(v, scale):
                    # the scale shrinks the lower and expands the upper
                    # bound (Border.cpp:161 rescale = 1 - setting)
                    ok = not fish_size or any(
                        lo * rescale <= size <= hi / rescale
                        for lo, hi in fish_size.ranges)
                    if not ok:
                        continue
                    ls = np.asarray(p.lines)
                    gy = np.round(ls[:, 0] / ch).astype(int)
                    # one count per mask pixel, accumulated into its
                    # grid cell (reference loops x0..x1 per line)
                    widths = ls[:, 2] - ls[:, 1] + 1
                    xs = np.concatenate([
                        np.arange(a, b + 1) for a, b in
                        zip(ls[:, 1], ls[:, 2])])
                    gx = np.round(xs / cw).astype(int)
                    gys = np.repeat(gy, widths)
                    np.add.at(counts, (gys, gx), 1)
        nz = counts[counts > 0]
        if not len(nz):
            self._mask = np.ones((h, w), bool)
            return
        middle = np.percentile(np.sort(nz), 5, method="lower")
        ys = np.minimum(np.round(np.arange(h) / ch).astype(int),
                        grid_res + 1)
        xs = np.minimum(np.round(np.arange(w) / cw).astype(int),
                        grid_res + 1)
        mask = counts[np.ix_(ys, xs)] >= middle
        # heatmap masks blur + re-threshold, then shrink
        # (Border.cpp:214-232)
        k = (int(w * 0.07) | 1, int(h * 0.07) | 1)
        mask = box_blur(mask.astype(np.uint8) * 255, k) > 150
        self._mask = self._shrink(mask)
        self._dist = None

    def _build_outline(self):
        """Largest dark region of the background as the arena; the
        boundary is smoothed (recognition_smooth_amount) and low-pass
        approximated with recognition_coeff elliptic-Fourier
        coefficients (Border.cpp:440-455), then shrunk by
        recognition_border_shrink_percent."""
        from ..ops.labeling import label_blobs

        bg = self.background
        thr = int(np.median(bg)) // 2
        comps = label_blobs(255 - bg, threshold=max(1, thr))
        self._mask = np.zeros(bg.shape[:2], bool)
        if comps:
            big = max(comps, key=lambda c: c.num_pixels)
            for y, x0, x1 in big.lines:
                self._mask[y, x0 : x1 + 1] = True
        else:
            self._mask[:] = True
            return
        coeff = int(self.settings["recognition_coeff"] or 0)
        if coeff > 0:
            from .posture import eft, ieft, smooth_points
            from .tag_image import contour_area, find_contours_external

            cs = find_contours_external(self._mask.astype(np.uint8),
                                        every_point=True)
            if cs:
                pts = max(cs, key=contour_area) \
                    .reshape(-1, 2).astype(np.float64)
                amount = int(
                    self.settings["recognition_smooth_amount"] or 0)
                if amount > 0 and len(pts) > 4:
                    pts = smooth_points(pts, amount, 1)
                center = pts.mean(axis=0)
                pts = ieft(eft(pts - center, coeff),
                           max(len(pts), 64), center)
                m = np.zeros(self._mask.shape, np.uint8)
                fill_poly(m, np.round(pts).astype(np.int32), 1)
                self._mask = m.astype(bool)
        self._mask = self._shrink(self._mask)

    def _shrink(self, mask):
        """recognition_border_shrink_percent (Border.cpp:220-232):
        open with a 2.5%-of-width ellipse, then erode again with
        size * (1 - shrink)."""
        w = mask.shape[1]
        morph = max(1, int(w * 0.025))
        shrink = float(
            self.settings["recognition_border_shrink_percent"] or 0.0)
        morph1 = max(1, int(morph * (1.0 - shrink)))
        e = ellipse_element((2 * morph + 1, 2 * morph + 1))
        e1 = ellipse_element((2 * morph1 + 1, 2 * morph1 + 1))
        m = mask.astype(np.uint8)
        m = erode(m, e)
        m = dilate(m, e)
        m = erode(m, e1)
        return m.astype(bool)

    def _build_grid(self):
        """Circle radius = avg nearest-neighbor distance * 0.5 *
        grid_points_scaling (Border.cpp:509-538)."""
        pts = self._grid_points
        d = np.hypot(pts[:, None, 0] - pts[None, :, 0],
                     pts[:, None, 1] - pts[None, :, 1])
        np.fill_diagonal(d, np.inf)
        nearest = d.min(axis=1)
        scaling = float(self.settings["grid_points_scaling"] or 1.0)
        self._grid_radius = float(nearest.mean()) * 0.5 * scaling

    # ------------------------------------------------------------------
    def in_recognition_bounds(self, x: float, y: float) -> bool:
        if self.type == "none":
            return True
        if self.type == "shapes" and self._shapes:
            from .prefilter import _point_in_poly

            return any(_point_in_poly(x, y, s) for s in self._shapes)
        if self.type == "grid" and len(self._grid_points) >= 2:
            d = np.hypot(self._grid_points[:, 0] - x,
                         self._grid_points[:, 1] - y)
            return bool(d.min() <= self._grid_radius)
        if self._mask is not None:
            xi, yi = int(x), int(y)
            if 0 <= yi < self._mask.shape[0] and 0 <= xi < self._mask.shape[1]:
                return bool(self._mask[yi, xi])
            return False
        return True

    def _distance_field(self) -> Optional[np.ndarray]:
        if self._dist is None and self._mask is not None:
            from scipy.ndimage import distance_transform_edt

            self._dist = distance_transform_edt(self._mask)
        return self._dist

    def distance(self, x: float, y: float) -> float:
        """Distance to the nearest border in px (BORDER_DISTANCE)."""
        if self.type == "shapes" and self._shapes:
            best = float("inf")
            for shape in self._shapes:
                pts = shape if len(shape) > 2 else [
                    (shape[0][0], shape[0][1]), (shape[1][0], shape[0][1]),
                    (shape[1][0], shape[1][1]), (shape[0][0], shape[1][1])]
                n = len(pts)
                for i in range(n):
                    x0, y0 = pts[i]
                    x1, y1 = pts[(i + 1) % n]
                    best = min(best, _point_segment_distance(
                        x, y, x0, y0, x1, y1))
            return best
        if self.type == "grid" and len(self._grid_points) >= 2:
            d = np.hypot(self._grid_points[:, 0] - x,
                         self._grid_points[:, 1] - y)
            return max(0.0, self._grid_radius - float(d.min()))
        dist = self._distance_field()
        if dist is not None:
            yi = int(np.clip(y, 0, dist.shape[0] - 1))
            xi = int(np.clip(x, 0, dist.shape[1] - 1))
            return float(dist[yi, xi])
        if self.background is None:
            return float("inf")
        h, w = self.background.shape[:2]
        return float(min(x, y, w - x, h - y))


def _point_segment_distance(px, py, x0, y0, x1, y1) -> float:
    dx, dy = x1 - x0, y1 - y0
    if dx == dy == 0:
        return math.hypot(px - x0, py - y0)
    t = max(0.0, min(1.0, ((px - x0) * dx + (py - y0) * dy)
                     / (dx * dx + dy * dy)))
    return math.hypot(px - (x0 + t * dx), py - (y0 + t * dy))
