"""TRex's YOLO post-processing in plain NumPy: tiles, per-tile threshold
and NMS, scale-back, the tile merge, and the blobs.

The benchmark's reference for what ``YOLOBackend.apply`` returns, written
from the semantics of TRex's ``core/TileImage.cpp`` and
``python/YOLO.cpp`` (SAHI tiles; per-tile NMS; keypoint and OBB tile
merge by rotated-rect NMS; ``process_boxes_only`` and ``process_obbs``
rasterisation) and ultralytics' ``scale_boxes``. It imports nothing of
the program under test. Geometry is in float64 (the minimum-area
rectangle by an edge scan of the convex hull, the rotated intersection
by Sutherland-Hodgman clipping); the program rebuilds OpenCV's float32
routines, so a rectangle edge or a scanline end can part by rounding,
which :mod:`perfbench.reference.compare` allows for (one pixel).
"""
from __future__ import annotations

import math

import numpy as np

GRAY_WEIGHTS = (3735, 19235, 9798)  # cv2 BGR2GRAY fixed point, b g r


def tile_bounds(width, height, size, target_width, tile_image, overlap):
    """SAHI tiles (x, y, w, h) of a frame for a square detector input of
    `size` (TileImage.cpp: compute_tiling_dimensions, compute_offsets)."""
    if target_width <= 0 and tile_image <= 1:
        return []
    edge = target_width if target_width > 0 else (size or 320)
    overlap = min(max(overlap, 0.0), 0.95)
    stride = max(1, int(round(edge * (1 - overlap))))

    def offsets(extent):
        if extent <= edge:
            return [0]
        out = list(range(0, extent - edge, stride))
        if out[-1] != extent - edge:
            out.append(extent - edge)
        return out

    return [(x, y, edge, edge) for y in offsets(height)
            for x in offsets(width)]


def letterbox(image, size):
    """ultralytics' letterbox for an image of `size` x `size` already
    (a tile of the model's input size): the image itself, as BGR."""
    if image.shape[:2] != (size, size):
        raise ValueError("the reference letterboxes only tiles of the "
                         "model's input size")
    if image.ndim == 2:
        image = np.repeat(image[..., None], 3, -1)
    return np.ascontiguousarray(image)


def bgr_to_gray(img):
    if img.ndim == 2:
        return img
    b, g, r = (img[..., i].astype(np.int32) for i in range(3))
    wb, wg, wr = GRAY_WEIGHTS
    return ((wb * b + wg * g + wr * r + (1 << 14)) >> 15).astype(np.uint8)


def nms(boxes, conf, clid, iou_threshold):
    """Per-class greedy NMS on xyxy boxes (IoU >= threshold suppresses),
    each class by confidence descending, then index; rows of zero area
    take no part. Returns the kept indices, ascending."""
    area = np.maximum(0, boxes[:, 2] - boxes[:, 0]) * \
        np.maximum(0, boxes[:, 3] - boxes[:, 1])
    keep = []
    for c in np.unique(clid):
        idx = np.flatnonzero((clid == c) & (area > 0))
        idx = idx[np.lexsort((idx, -conf[idx]))]
        dead = np.zeros(len(idx), bool)
        for i, ri in enumerate(idx):
            if dead[i]:
                continue
            keep.append(int(ri))
            rest = idx[i + 1:]
            w = np.maximum(0, np.minimum(boxes[ri, 2], boxes[rest, 2])
                           - np.maximum(boxes[ri, 0], boxes[rest, 0]))
            h = np.maximum(0, np.minimum(boxes[ri, 3], boxes[rest, 3])
                           - np.maximum(boxes[ri, 1], boxes[rest, 1]))
            inter = w * h
            union = area[ri] + area[rest] - inter
            with np.errstate(divide="ignore", invalid="ignore"):
                hit = (inter > 0) & (union > 0) & (inter / union
                                                   >= iou_threshold)
            dead[i + 1:] |= hit
    return sorted(keep)


# --------------------------------------------------------------------------
# rotated rectangles
# --------------------------------------------------------------------------

def hull(points):
    """Convex hull (Andrew's monotone chain), counter-clockwise."""
    pts = sorted(set(map(tuple, np.asarray(points, np.float64))))
    if len(pts) <= 2:
        return np.array(pts, np.float64)

    def half(seq):
        out = []
        for p in seq:
            while len(out) >= 2 and ((out[-1][0] - out[-2][0])
                                     * (p[1] - out[-2][1])
                                     - (out[-1][1] - out[-2][1])
                                     * (p[0] - out[-2][0])) <= 0:
                out.pop()
            out.append(p)
        return out

    lower, upper = half(pts), half(reversed(pts))
    return np.array(lower[:-1] + upper[:-1], np.float64)


def min_area_corners(points):
    """Corners (4, 2) of the smallest rectangle around `points`, one side
    on an edge of their hull; None for no points."""
    h = hull(points)
    if len(h) == 0:
        return None
    if len(h) == 1:
        return np.repeat(h, 4, 0)
    best = None
    for i in range(len(h)):
        e = h[(i + 1) % len(h)] - h[i]
        n = math.hypot(*e)
        if n == 0:
            continue
        u = e / n
        v = np.array([-u[1], u[0]])
        a, b = h @ u, h @ v
        area = (a.max() - a.min()) * (b.max() - b.min())
        if best is None or area < best[0]:
            best = (area, u, v, a.min(), a.max(), b.min(), b.max())
    _, u, v, a0, a1, b0, b1 = best
    return np.array([a0 * u + b0 * v, a1 * u + b0 * v, a1 * u + b1 * v,
                     a0 * u + b1 * v])


def rect_from_corners(corners, pad=0.0, min_side=1.0):
    """(centre, (w, h), unit side vectors) of a rectangle given by its
    corners, each side at least `min_side`, then grown by `pad`."""
    c = corners.mean(0)
    e1, e2 = corners[1] - corners[0], corners[3] - corners[0]
    w, h = math.hypot(*e1), math.hypot(*e2)
    u = e1 / w if w > 0 else np.array([1.0, 0.0])
    v = e2 / h if h > 0 else np.array([-u[1], u[0]])
    return c, (max(w, min_side) + pad, max(h, min_side) + pad), u, v


def corners_of(c, size, u, v):
    hw, hh = size[0] / 2, size[1] / 2
    return np.array([c - hw * u - hh * v, c + hw * u - hh * v,
                     c + hw * u + hh * v, c - hw * u + hh * v])


def _ccw(poly):
    x, y = poly[:, 0], poly[:, 1]
    s = (x * np.roll(y, -1) - np.roll(x, -1) * y).sum()
    return poly if s >= 0 else poly[::-1]


def polygon_area(poly):
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return abs((x * np.roll(y, -1) - np.roll(x, -1) * y).sum()) / 2


def intersection_area(pa, pb):
    """Area of the intersection of two convex polygons (Sutherland-
    Hodgman: `pb` clipped by each edge of `pa`)."""
    pa, out = _ccw(pa), list(_ccw(pb))
    for i in range(len(pa)):
        a, b = pa[i], pa[(i + 1) % len(pa)]
        if not out:
            break
        src, out = out, []

        def side(p):
            return (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0]
                                                                   - a[0])

        for j in range(len(src)):
            p, q = src[j], src[(j + 1) % len(src)]
            sp, sq = side(p), side(q)
            if sp >= 0:
                out.append(p)
            if (sp >= 0) != (sq >= 0):
                out.append(p + (q - p) * (sp / (sp - sq)))
    return polygon_area(np.array(out)) if len(out) >= 3 else 0.0


def rotated_nms(corners, area, conf, clid, iou_threshold):
    """Greedy NMS over rotated rectangles given by their corners."""
    keep = []
    centre = corners.mean(1)
    radius = np.sqrt(((corners - centre[:, None]) ** 2).sum(-1)).max(1)
    for c in np.unique(clid):
        idx = np.flatnonzero((clid == c) & (area > 0))
        idx = idx[np.lexsort((idx, -conf[idx]))]
        dead = np.zeros(len(idx), bool)
        for i, ri in enumerate(idx):
            if dead[i]:
                continue
            keep.append(int(ri))
            for j in range(i + 1, len(idx)):
                rj = idx[j]
                if dead[j] or np.hypot(*(centre[ri] - centre[rj])) > \
                        radius[ri] + radius[rj] + 1e-6:
                    continue
                inter = intersection_area(corners[ri], corners[rj])
                union = area[ri] + area[rj] - inter
                if inter > 0 and union > 0 and inter / union >= \
                        iou_threshold:
                    dead[j] = True
    return sorted(keep)


# --------------------------------------------------------------------------
# the frame
# --------------------------------------------------------------------------

def scale_back(boxes, hw, size):
    """ultralytics' ``scale_boxes`` from a `size` letterbox to `hw`."""
    h, w = hw
    gain = min(size / h, size / w)
    px = round((size - w * gain) / 2 - 0.1)
    py = round((size - h * gain) / 2 - 0.1)
    out = boxes.astype(np.float64)
    out[:, [0, 2]] = np.clip((out[:, [0, 2]] - px) / gain, 0, w)
    out[:, [1, 3]] = np.clip((out[:, [1, 3]] - py) / gain, 0, h)
    return out, gain, (px, py)


def frame_detections(rows, tiles, size, settings, task):
    """Per-tile threshold, NMS and scale-back of decoded `rows` (arrays
    (T, N, ...) in tile order), offset to frame coordinates and joined:
    a dict of boxes, conf, clid and keypoints or obb."""
    thr = float(settings.get("detect_conf_threshold") or 0.1)
    iou = float(settings.get("detect_iou_threshold") or 0.7)
    parts = {k: [] for k in ("boxes", "conf", "clid", "keypoints", "obb")}
    for k, (tx, ty, tw, th) in enumerate(tiles):
        conf = np.asarray(rows["conf"][k])
        keep = np.flatnonzero(conf >= thr)
        boxes = np.asarray(rows["boxes"][k])[keep]
        clid = np.asarray(rows["clid"][k])[keep]
        sel = nms(boxes, conf[keep], clid, iou)
        rows_k = keep[sel]
        b, gain, (px, py) = scale_back(boxes[sel], (th, tw), size)
        b[:, [0, 2]] += tx
        b[:, [1, 3]] += ty
        parts["boxes"].append(b)
        parts["conf"].append(conf[rows_k])
        parts["clid"].append(np.asarray(rows["clid"][k])[rows_k])
        if task == "pose":
            kp = np.asarray(rows["keypoints"][k])[rows_k].astype(np.float64)
            kp[..., 0] = (kp[..., 0] - px) / gain + tx
            kp[..., 1] = (kp[..., 1] - py) / gain + ty
            parts["keypoints"].append(kp)
        if task == "obb":
            o = np.asarray(rows["obb"][k])[rows_k].astype(np.float64)
            o[:, 0] = (o[:, 0] - px) / gain + tx
            o[:, 1] = (o[:, 1] - py) / gain + ty
            o[:, 2:4] /= gain
            parts["obb"].append(o)
    return {k: np.concatenate(v) for k, v in parts.items() if v}


def merge(det, settings, task):
    """The tile merge: rotated-rect NMS over the keypoints' padded
    minimum-area rectangles (pose) or the oriented boxes (OBB)."""
    iou = float(settings.get("detect_tile_merge_iou") or 0.55)
    n = len(det["conf"])
    if n == 0:
        return det
    if task == "pose":
        if str(settings.get("detect_pose_bbx") or "keypoints") != "keypoints":
            raise NotImplementedError("pose merge by keypoints only")
        corners, ok = [], []
        for i in range(n):
            pts = det["keypoints"][i][..., :2]
            pts = pts[np.isfinite(pts).all(1)]
            if len(pts) == 0:
                continue
            cr = min_area_corners(pts)
            c, size, u, v = rect_from_corners(cr, pad=4.0)
            corners.append(corners_of(c, size, u, v))
            ok.append(i)
        ok = np.asarray(ok, int)
        corners = np.asarray(corners).reshape(-1, 4, 2)
    elif task == "obb":
        o = det["obb"]
        u = np.stack([np.cos(o[:, 4]), np.sin(o[:, 4])], -1)
        v = np.stack([-u[:, 1], u[:, 0]], -1)
        sizes = np.maximum(o[:, 2:4], 1.0)
        corners = np.stack([corners_of(o[i, :2], sizes[i], u[i], v[i])
                            for i in range(n)])
        ok = np.arange(n)
    else:
        raise NotImplementedError(task)
    area = np.array([polygon_area(c) for c in corners])
    sel = ok[rotated_nms(corners, area, det["conf"][ok], det["clid"][ok],
                         iou)]
    return {k: v[sel] for k, v in det.items()}


def box_blobs(det, gray):
    """``process_boxes_only``: each box a blob of whole rows (xyxy edges
    exclusive)."""
    h, w = gray.shape
    out = []
    for i in range(len(det["conf"])):
        x0, y0, x1, y1 = det["boxes"][i]
        x0, x1 = int(max(0, min(w - 1, x0))), int(max(0, min(w, x1)))
        y0, y1 = int(max(0, min(h - 1, y0))), int(max(0, min(h, y1)))
        if x1 <= x0 or y1 <= y0:
            continue
        lines = np.stack([np.arange(y0, y1), np.full(y1 - y0, x0),
                          np.full(y1 - y0, x1 - 1)], 1)
        out.append(_blob(det, i, lines, gray))
    return out


def obb_blobs(det, gray):
    """``process_obbs``: each oriented box rasterised a scanline at a
    time: the first two crossings of the row with its edges, inner
    pixels (ceil, floor), columns clamped to the frame."""
    h, w = gray.shape
    out = []
    for i in range(len(det["conf"])):
        cx, cy, bw, bh, a = (float(x) for x in det["obb"][i])
        u = np.array([math.cos(a), math.sin(a)])
        v = np.array([-u[1], u[0]])
        cr = corners_of(np.array([cx, cy]), (bw, bh), u, v)
        cr = cr[[2, 1, 0, 3]]  # (+w,+h), (+w,-h), (-w,-h), (-w,+h)
        lines = []
        for y in range(max(0, math.floor(cr[:, 1].min())),
                       min(math.ceil(cr[:, 1].max()) + 1, h)):
            xs = []
            for e in range(4):
                p, q = cr[e], cr[(e + 1) % 4]
                dy = q[1] - p[1]
                if dy == 0:
                    if y == p[1]:
                        xs += [min(p[0], q[0]), max(p[0], q[0])]
                    continue
                t = (y - p[1]) / dy
                if 0 <= t < 1:
                    xs.append(p[0] + (q[0] - p[0]) * t)
            if len(xs) < 2:
                continue
            lo, hi = min(xs[:2]), max(xs[:2])
            lines.append((y, min(max(math.ceil(lo), 0), w - 1),
                          min(max(math.floor(hi), 0), w - 1)))
        if lines:
            out.append(_blob(det, i, np.asarray(lines), gray))
    return out


def _blob(det, i, lines, gray):
    px = np.concatenate([gray[y, a:b + 1] for y, a, b in lines])
    return {"clid": int(det["clid"][i]), "p": float(det["conf"][i]),
            "lines": np.asarray(lines, np.int64), "pixels": px}


def frame_blobs(rows, frame, size, settings, task):
    """What ``apply`` should return for `frame` given the decoded `rows`
    of its tiles."""
    h, w = frame.shape[:2]
    tiles = tile_bounds(w, h, size,
                        int(settings.get("detect_tile_target_width") or 0),
                        int(settings.get("detect_tile_image") or 0),
                        float(settings.get("detect_tile_overlap") or 0.0))
    det = merge(frame_detections(rows, tiles, size, settings, task),
                settings, task)
    gray = bgr_to_gray(frame)
    return obb_blobs(det, gray) if task == "obb" else box_blobs(det, gray)
