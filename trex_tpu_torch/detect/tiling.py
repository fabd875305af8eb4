"""SAHI-style tiling + tile-merge postprocessing.

The port of ``trex_tpu/detect/tiling.py``: the reference's tiling math
(core/TileImage.cpp: compute_tiling_dimensions, compute_offsets,
compute_tile_bounds) and the YOLO tile-merge postprocess (python/YOLO.cpp:
GreedyNMM IOS groups, per-class NMS, rotated-rect pose NMS,
compute_pose_tile_rect).

The greedy loops compare the kept row with every later candidate at once
(numpy, in the boxes' own dtype, the same operations in the same order
as the JAX package's pair loop), so the groups and the keeps are the
JAX package's. The rotated-rect NMS and ``compute_pose_tile_rect`` use
``rotated.py``'s rebuilds of OpenCV's ``rotatedRectangleIntersection``
and ``minAreaRect`` in place of ``cv2``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .rotated import (circumradius, min_area_rect, pair_intersection_areas,
                      rects_points)


def compute_tiling_dimensions(frame_size, detector_size,
                              detect_tile_target_width: int,
                              detect_tile_image: int):
    """Returns ((new_w, new_h), (tile_w, tile_h))."""
    fw, fh = frame_size
    dw, dh = detector_size
    new_size = (dw, dh)
    tile_size = (dw, dh)
    if detect_tile_target_width <= 0 and detect_tile_image <= 1:
        return new_size, tile_size
    base_edge = max(int(dw), int(dh))
    tile_edge = 320 if base_edge == 0 else base_edge
    if detect_tile_target_width > 0:
        tile_edge = detect_tile_target_width
    if tile_edge == 0:
        tile_edge = 320
    tiles_x = detect_tile_image if detect_tile_image > 1 else 1
    if detect_tile_target_width > 0:
        if fw == 0:
            fw = tile_edge
        tiles_x = max(tiles_x, math.ceil(fw / tile_edge))
    tiles_x = max(tiles_x, 1)
    tiles_y = 1
    if detect_tile_image > 1:
        ratio = (fh / fw) if fw > 0 and fh > 0 else 1.0
        tiles_y = max(tiles_y, math.ceil(ratio * tiles_x))
    if detect_tile_target_width > 0:
        if fh == 0:
            fh = tile_edge
        tiles_y = max(tiles_y, math.ceil(fh / tile_edge))
    tiles_y = max(tiles_y, 1)
    return ((tile_edge * tiles_x, tile_edge * tiles_y),
            (tile_edge, tile_edge))


def compute_offsets(extent: int, tile_extent: int, stride: int) -> list[int]:
    if tile_extent <= 0 or extent <= tile_extent:
        return [0]
    offsets = [0]
    current = 0
    while current + tile_extent < extent:
        nxt = current + stride
        if nxt + tile_extent > extent:
            nxt = extent - tile_extent
        if nxt <= current:
            break
        offsets.append(nxt)
        current = nxt
    last = extent - tile_extent
    if last > 0 and offsets[-1] != last:
        offsets.append(last)
    out = []
    for o in offsets:  # std::unique removes consecutive duplicates
        if not out or out[-1] != o:
            out.append(o)
    return out


def compute_tile_bounds(video_size, detector_size,
                        detect_tile_target_width: int,
                        detect_tile_image: int,
                        detect_tile_overlap: float) -> list[tuple]:
    """Tile rectangles (x, y, w, h) in original video coordinates."""
    vw, vh = video_size
    dw, dh = detector_size
    if vw == 0 or vh == 0 or dw == 0 or dh == 0:
        return []
    if detect_tile_target_width == 0 and detect_tile_image <= 1:
        return []
    _, (tw, th) = compute_tiling_dimensions(
        video_size, detector_size, detect_tile_target_width,
        detect_tile_image)
    overlap = min(max(detect_tile_overlap, 0.0), 0.95)
    stride_x = max(1, int(round(tw * (1 - overlap))))
    stride_y = max(1, int(round(th * (1 - overlap))))
    xs = compute_offsets(int(vw), int(tw), stride_x)
    ys = compute_offsets(int(vh), int(th), stride_y)
    return [(x, y, tw, th) for y in ys for x in xs]


# ---------------------------------------------------------------------------
# tile-merge postprocess over detection rows
# ---------------------------------------------------------------------------

def _areas(boxes: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, boxes[:, 2] - boxes[:, 0]) * \
        np.maximum(0.0, boxes[:, 3] - boxes[:, 1])


def _intersections(ref: np.ndarray, others: np.ndarray) -> np.ndarray:
    x0 = np.maximum(ref[0], others[:, 0])
    y0 = np.maximum(ref[1], others[:, 1])
    x1 = np.minimum(ref[2], others[:, 2])
    y1 = np.minimum(ref[3], others[:, 3])
    return np.maximum(0.0, x1 - x0) * np.maximum(0.0, y1 - y0)


@dataclass
class TileMergeGroup:
    representative_index: int
    source_indices: list[int] = field(default_factory=list)


def _class_orders(clid: np.ndarray, conf: np.ndarray, areas: np.ndarray):
    """Per class of a row with area: its rows by confidence descending,
    index ascending (the JAX package's ``(-conf, i)`` sort key)."""
    rows = np.flatnonzero(areas > 0)
    for c in np.unique(clid[rows]):
        idx = rows[clid[rows] == c]
        yield idx[np.lexsort((idx, -conf[idx]))]


def _greedy(boxes, conf, clid, suppress):
    """The greedy pass shared by NMM and NMS: each row not yet
    suppressed is kept and suppresses the later rows of its class that
    `suppress(ref_row, later_rows, inter)` marks (among those with a
    positive intersection). Yields (kept row, rows it suppressed)."""
    areas = _areas(boxes)
    for idx in _class_orders(clid, conf, areas):
        alive = np.ones(len(idx), bool)
        for i, ri in enumerate(idx):
            if not alive[i]:
                continue
            later = np.flatnonzero(alive[i + 1:]) + i + 1
            cj = idx[later]
            inter = _intersections(boxes[ri], boxes[cj])
            hit = np.zeros(len(cj), bool)
            pos = inter > 0
            hit[pos] = suppress(areas[ri], areas[cj[pos]], inter[pos])
            alive[later[hit]] = False
            yield int(ri), cj[hit]


def compute_tile_merge_groups(boxes: np.ndarray, conf: np.ndarray,
                              clid: np.ndarray,
                              ios_threshold: float) -> list[TileMergeGroup]:
    """GreedyNMM: per-class confidence-sorted grouping by
    intersection-over-smaller-area (YOLO.cpp:80-163)."""
    if len(boxes) == 0:
        return []
    ios_threshold = min(max(ios_threshold, 0.0), 1.0)

    def suppress(a_ref, a_other, inter):
        return inter / np.minimum(a_ref, a_other) >= ios_threshold

    groups = [TileMergeGroup(ri, sorted([ri] + [int(j) for j in hit]))
              for ri, hit in _greedy(boxes, conf, clid, suppress)]
    groups.sort(key=lambda g: g.representative_index)
    return groups


def compute_tile_nms_indices(boxes: np.ndarray, conf: np.ndarray,
                             clid: np.ndarray,
                             iou_threshold: float) -> list[int]:
    """Per-class IoU NMS (YOLO.cpp:164-224)."""
    if len(boxes) == 0:
        return []
    iou_threshold = min(max(iou_threshold, 0.0), 1.0)

    def suppress(a_ref, a_other, inter):
        union = a_ref + a_other - inter
        ok = union > 0
        iou = np.zeros(len(inter), np.result_type(inter, union))
        iou[ok] = inter[ok] / union[ok]
        return ok & (iou >= iou_threshold)

    return sorted(ri for ri, _ in _greedy(boxes, conf, clid, suppress))


def compute_pose_tile_rect(keypoints: np.ndarray) -> Optional[tuple]:
    """Min-area rotated rect over finite keypoints
    (YOLO.cpp compute_pose_tile_rect :286). Returns
    ((cx, cy), (w, h), angle_deg) or None."""
    pts = keypoints[np.isfinite(keypoints).all(axis=1)]
    if len(pts) == 0:
        return None
    if len(pts) == 1:
        return ((float(pts[0, 0]), float(pts[0, 1])), (1.0, 1.0), 0.0)
    (cx, cy), (w, h), a = min_area_rect(pts.astype(np.float32))
    return ((cx, cy), (max(w, 1.0), max(h, 1.0)), a)


def compute_tile_nms_indices_for_rotated_rects(
        rects: list, confidences: np.ndarray, classes: np.ndarray,
        iou_threshold: float) -> list[int]:
    """Rotated-rect NMS for pose detections (YOLO.cpp:225-285). The IoU
    of every pair of a class whose circumcircles meet is computed at
    once (rects further apart do not meet); the greedy pass then reads
    it."""
    n = len(rects)
    if n == 0:
        return []
    iou_threshold = min(max(iou_threshold, 0.0), 1.0)
    size = np.array([r[1] for r in rects], np.float64).reshape(-1, 2)
    area = size[:, 0] * size[:, 1]
    centre = np.array([r[0] for r in rects], np.float64).reshape(-1, 2)
    radius = np.array([circumradius(r) for r in rects], np.float64)
    corners = rects_points(rects)
    classes = np.asarray([int(x) for x in classes])
    conf = np.asarray(confidences)
    keep = []
    for c in np.unique(classes):
        idx = np.flatnonzero((classes == c) & (area > 0))
        idx = idx[np.lexsort((idx, -conf[idx]))]
        d = np.hypot(centre[idx, None, 0] - centre[None, idx, 0],
                     centre[idx, None, 1] - centre[None, idx, 1])
        meet = np.triu(d <= radius[idx, None] + radius[None, idx] + 1e-6,
                       1)
        pi, pj = np.nonzero(meet)
        a, b = idx[pi], idx[pj]
        inter = pair_intersection_areas(centre[a], size[a], corners[a],
                                        centre[b], size[b], corners[b])
        union = area[a] + area[b] - inter
        with np.errstate(divide="ignore", invalid="ignore"):
            hit = (inter > 0) & (union > 0) \
                & (inter / union >= iou_threshold)
        suppress = [[] for _ in idx]
        for i, j in zip(pi[hit], pj[hit]):
            suppress[i].append(j)
        alive = np.ones(len(idx), bool)
        for i, ri in enumerate(idx):
            if alive[i]:
                keep.append(int(ri))
                alive[suppress[i]] = False
    return sorted(set(keep))
