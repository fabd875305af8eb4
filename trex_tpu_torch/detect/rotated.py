"""Rotated rectangles as OpenCV 5.0.0 computes them, without OpenCV.

- :func:`min_area_rect` is ``cv2.minAreaRect`` of float32 points: the
  convex hull (``track/visual_field.py::convex_hull``), then OpenCV's
  rotating calipers in float32, with its angle range [-90, 0) and its
  (width, height) order. Where several of the hull's edge-aligned
  rectangles tie in area up to float32 rounding (three points always
  tie), OpenCV can keep another of them.
- :func:`pair_intersection_areas` (:func:`intersection_area` for one
  pair) is ``cv2.contourArea`` of ``cv2.rotatedRectangleIntersection``'s
  region, for many pairs at once: the rectangles' corners
  as ``RotatedRect::points`` places them, one clipped against the other
  (Sutherland-Hodgman) in double, then vertices merged as OpenCV merges
  them (squared distance at most 1e-6 of the larger area). OpenCV
  intersects the edges in float32, so the two areas part by rounding
  (``tests/test_torch_detect_cv.py`` states the bound).
"""
from __future__ import annotations

import math

import numpy as np

from ..track.visual_field import convex_hull

_F = np.float32


def _right_of(v1, v2) -> bool:
    """OpenCV's ``firstVecIsRight``: (v1.y, -v1.x) . v2 < 0, in float32."""
    return _F(v1[1] * v2[0]) + _F(-v1[0] * v2[1]) < 0


def _calipers(pts: np.ndarray) -> tuple:
    """``rotatingCalipers(..., CALIPERS_MINAREARECT)`` over a hull of n >
    2 float32 points: the corner, and the two side vectors."""
    n = len(pts)
    vect = np.zeros((n, 2), np.float32)
    inv_len = np.zeros(n, np.float32)
    left = bottom = right = top = 0
    left_x = right_x = pts[0, 0]
    top_y = bottom_y = pts[0, 1]
    for i in range(n):
        p0 = pts[i]
        if p0[0] < left_x:
            left_x, left = p0[0], i
        if p0[0] > right_x:
            right_x, right = p0[0], i
        if p0[1] > top_y:
            top_y, top = p0[1], i
        if p0[1] < bottom_y:
            bottom_y, bottom = p0[1], i
        p1 = pts[(i + 1) % n]
        dx = float(p1[0]) - float(p0[0])
        dy = float(p1[1]) - float(p0[1])
        vect[i] = (dx, dy)
        inv_len[i] = 1.0 / math.sqrt(dx * dx + dy * dy)
    orientation = _F(0)
    ax, ay = float(vect[-1, 0]), float(vect[-1, 1])
    for i in range(n):
        bx, by = float(vect[i, 0]), float(vect[i, 1])
        convexity = ax * by - ay * bx
        if convexity != 0:
            orientation = _F(1) if convexity > 0 else _F(-1)
            break
        ax, ay = bx, by
    if orientation == 0:
        raise ValueError("degenerate hull")
    base_a, base_b = orientation, _F(0)
    seq = [bottom, right, top, left]
    minarea = _F(np.finfo(np.float32).max)
    best = None
    for _ in range(n):
        v = [vect[seq[0]], vect[seq[1]], vect[seq[2]], vect[seq[3]]]
        rot = [(v[0][0], v[0][1]), (v[1][1], -v[1][0]),
               (-v[2][0], -v[2][1]), (-v[3][1], v[3][0])]
        main = 0
        for i in range(1, 4):
            if _right_of(rot[i], rot[main]):
                main = i
        pi = seq[main]
        lead_x = vect[pi, 0] * inv_len[pi]
        lead_y = vect[pi, 1] * inv_len[pi]
        base_a, base_b = ((lead_x, lead_y), (lead_y, -lead_x),
                          (-lead_x, -lead_y), (-lead_y, lead_x))[main]
        seq[main] = (seq[main] + 1) % n
        dx = pts[seq[1], 0] - pts[seq[3], 0]
        dy = pts[seq[1], 1] - pts[seq[3], 1]
        width = dx * base_a + dy * base_b
        dx = pts[seq[2], 0] - pts[seq[0], 0]
        dy = pts[seq[2], 1] - pts[seq[0], 1]
        height = -dx * base_b + dy * base_a
        area = width * height
        if area <= minarea:
            minarea = area
            best = (seq[3], base_a, width, base_b, height, seq[0])
    i_left, a1, width, b1, height, i_bottom = best
    a2, b2 = -b1, a1
    c1 = a1 * pts[i_left, 0] + pts[i_left, 1] * b1
    c2 = a2 * pts[i_bottom, 0] + pts[i_bottom, 1] * b2
    idet = _F(1) / (a1 * b2 - a2 * b1)
    px = (c1 * b2 - c2 * b1) * idet
    py = (a1 * c2 - a2 * c1) * idet
    return (px, py), (a1 * width, b1 * width), (a2 * height, b2 * height)


def min_area_rect(points) -> tuple:
    """``cv2.minAreaRect`` of (N, 2) points taken as float32: ((cx, cy),
    (w, h), angle in degrees) as python floats, the angle in [-90, 0)
    as OpenCV 5 gives it (the side that makes it so is the width)."""
    with np.errstate(over="ignore", invalid="ignore"):
        hull = convex_hull(np.asarray(points, np.float32))
        n = len(hull)
        cx = cy = _F(0)
        side = (0.0, 0.0)
        other = 0.0
        if n > 2:
            (px, py), s1, s2 = _calipers(hull)
            cx = px + (s1[0] + s2[0]) * _F(0.5)
            cy = py + (s1[1] + s2[1]) * _F(0.5)
            side = (float(s1[0]), float(s1[1]))
            other = math.hypot(float(s2[0]), float(s2[1]))
        elif n == 2:
            cx = (hull[0, 0] + hull[1, 0]) * _F(0.5)
            cy = (hull[0, 1] + hull[1, 1]) * _F(0.5)
            side = (float(hull[1, 0]) - float(hull[0, 0]),
                    float(hull[1, 1]) - float(hull[0, 1]))
        elif n == 1:
            cx, cy = hull[0]
    w, h = math.hypot(*side), other
    angle = math.atan2(side[1], side[0]) * 180 / math.pi if n > 1 else 0.0
    # (w, h, a) is the rect (h, w, a - 90)
    while angle >= 0:
        w, h, angle = h, w, angle - 90.0
    while angle < -90:
        w, h, angle = h, w, angle + 90.0
    return ((float(cx), float(cy)), (float(_F(w)), float(_F(h))),
            float(_F(angle)))


def rect_points(rect) -> np.ndarray:
    """``RotatedRect::points``: the four corners, (4, 2) float64."""
    (cx, cy), (w, h), angle = rect
    t = angle * math.pi / 180.0
    b = math.cos(t) * 0.5
    a = math.sin(t) * 0.5
    p0 = (cx - a * h - b * w, cy + b * h - a * w)
    p1 = (cx + a * h - b * w, cy - b * h - a * w)
    return np.array([p0, p1, (2 * cx - p0[0], 2 * cy - p0[1]),
                     (2 * cx - p1[0], 2 * cy - p1[1])], np.float64)


def _ccw(pts: np.ndarray) -> np.ndarray:
    """(m, 4, 2) corners in counter-clockwise order (y up)."""
    x, y = pts[..., 0], pts[..., 1]
    area2 = (x * np.roll(y, -1, -1) - np.roll(x, -1, -1) * y).sum(-1)
    return np.where((area2 < 0)[:, None, None], pts[:, ::-1], pts)


def _clip(poly, count, p0, p1):
    """Clip (m, k, 2) convex polygons of `count` vertices against the
    half-plane left of the directed edge p0 -> p1 ((m, 2) each)."""
    m, k, _ = poly.shape
    idx = np.arange(k)
    nxt = np.where(idx[None] + 1 < count[:, None], idx[None] + 1, 0)
    q = np.take_along_axis(poly, nxt[..., None].repeat(2, -1), 1)
    e = (p1 - p0)[:, None]

    def side(v):
        return e[..., 0] * (v[..., 1] - p0[:, None, 1]) \
            - e[..., 1] * (v[..., 0] - p0[:, None, 0])

    sp, sq = side(poly), side(q)
    live = idx[None] < count[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = sp / (sp - sq)
    cross = poly + (q - poly) * t[..., None]
    # each edge p -> q emits the crossing where it changes side, then q
    # when q is inside
    emit_x = live & ((sp >= 0) != (sq >= 0))
    emit_q = live & (sq >= 0)
    out = np.stack([cross, q], 2).reshape(m, 2 * k, 2)
    keep = np.stack([emit_x, emit_q], 2).reshape(m, 2 * k)
    order = np.argsort(~keep, axis=1, kind="stable")
    out = np.take_along_axis(out, order[..., None].repeat(2, -1), 1)
    return out[:, :8], np.minimum(keep.sum(1), 8)


def rects_points(rects) -> np.ndarray:
    """:func:`rect_points` of each rect: (m, 4, 2) float64."""
    r = np.array([(c[0], c[1], sz[0], sz[1], a) for c, sz, a in rects],
                 np.float64).reshape(-1, 5)
    t = r[:, 4] * math.pi / 180.0
    b, a = np.cos(t) * 0.5, np.sin(t) * 0.5
    cx, cy, w, h = r[:, 0], r[:, 1], r[:, 2], r[:, 3]
    p0 = np.stack([cx - a * h - b * w, cy + b * h - a * w], -1)
    p1 = np.stack([cx + a * h - b * w, cy - b * h - a * w], -1)
    c = np.stack([cx, cy], -1)
    return np.stack([p0, p1, 2 * c - p0, 2 * c - p1], 1)


def pair_intersection_areas(ca, sa, pa, cb, sb, pb) -> np.ndarray:
    """Areas of the intersections of rotated rects a[i] and b[i]: centres
    (m, 2), sizes (m, 2) and corners (m, 4, 2) each (:func:`rects_points`);
    0.0 where either is empty or they do not meet."""
    m = len(ca)
    if m == 0:
        return np.zeros(0)
    # the average centre moves to the origin, as OpenCV shifts it
    mid = (ca + cb) / 2.0
    with np.errstate(all="ignore"):
        clip = _ccw(pa - mid[:, None])
        poly = _ccw(pb - mid[:, None])
        poly = np.concatenate([poly, np.zeros((m, 4, 2))], 1)
        count = np.full(m, 4)
        for i in range(4):
            poly, count = _clip(poly, count, clip[:, i - 1], clip[:, i])
        # OpenCV merges vertices whose squared distance is at most its
        # epsilon: 1e-6 of the larger area, at most the shortest edge
        area_a, area_b = sa.prod(1), sb.prod(1)
        eps = np.maximum(1e-16, np.minimum(
            1e-6 * np.maximum(area_a, area_b),
            np.minimum(sa.min(1), sb.min(1))))
        d2 = ((poly[:, :, None] - poly[:, None]) ** 2).sum(-1)
        kept = np.zeros(poly.shape[:2], bool)
        for j in range(poly.shape[1]):
            near = (d2[:, j] <= eps[:, None]) & kept
            kept[:, j] = (j < count) & ~near.any(1)
        order = np.argsort(~kept, axis=1, kind="stable")
        poly = np.take_along_axis(poly, order[..., None].repeat(2, -1), 1)
        n = kept.sum(1)
        idx = np.arange(poly.shape[1])
        nxt = np.where(idx[None] + 1 < n[:, None], idx[None] + 1, 0)
        q = np.take_along_axis(poly, nxt[..., None].repeat(2, -1), 1)
        terms = poly[..., 0] * q[..., 1] - q[..., 0] * poly[..., 1]
        area = np.abs(np.where(idx[None] < n[:, None], terms, 0.0).sum(1))
    empty = (area_a <= 0) | (area_b <= 0) | (n < 3)
    return np.where(empty, 0.0, area / 2)


def intersection_area(ra, rb) -> float:
    """Area of the intersection of two rotated rects ((cx, cy), (w, h),
    angle)."""
    c = np.array([ra[0], rb[0]], np.float64)
    sz = np.array([ra[1], rb[1]], np.float64)
    p = rects_points([ra, rb])
    return float(pair_intersection_areas(c[:1], sz[:1], p[:1], c[1:],
                                         sz[1:], p[1:])[0])


def circumradius(rect) -> float:
    """Half the diagonal: two rects whose centres lie further apart than
    the sum of theirs do not meet."""
    return 0.5 * math.hypot(rect[1][0], rect[1][1])
