"""Two-stage region-proposal detection.

The port of ``trex_tpu/detect/region.py``, unchanged. It re-creates the
reference's region-proposal flow (trex_detection_model.py
perform_region_proposal :547-650 with the
region_model/region_resolution settings): a cheap region detector runs
on the downscaled full frame; its boxes are padded, merged, and snapped
to square crops; the main detector runs on each crop; detections map
back to video coordinates and deduplicate via the SAHI tile merge.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from .yolo import Detections, merge_tile_detections


def _merge_overlapping(boxes: np.ndarray, pad: float) -> np.ndarray:
    """Pad boxes and merge transitively-overlapping ones."""
    if len(boxes) == 0:
        return boxes
    b = boxes.astype(np.float64).copy()
    b[:, 0] -= pad
    b[:, 1] -= pad
    b[:, 2] += pad
    b[:, 3] += pad
    merged = []
    used = np.zeros(len(b), bool)
    for i in range(len(b)):
        if used[i]:
            continue
        cur = b[i].copy()
        used[i] = True
        changed = True
        while changed:
            changed = False
            for j in range(len(b)):
                if used[j]:
                    continue
                if not (b[j, 0] > cur[2] or b[j, 2] < cur[0]
                        or b[j, 1] > cur[3] or b[j, 3] < cur[1]):
                    cur[0] = min(cur[0], b[j, 0])
                    cur[1] = min(cur[1], b[j, 1])
                    cur[2] = max(cur[2], b[j, 2])
                    cur[3] = max(cur[3], b[j, 3])
                    used[j] = True
                    changed = True
        merged.append(cur)
    return np.asarray(merged)


def region_proposal_detect(image: np.ndarray,
                           region_fn: Callable[[np.ndarray], Detections],
                           detect_fn: Callable[[np.ndarray], Detections],
                           settings,
                           crop_size: int = 320,
                           pad: float = 20.0) -> Detections:
    """Run region_fn on the full frame, detect_fn on merged region crops."""
    h, w = image.shape[:2]
    regions = region_fn(image)
    if len(regions) == 0:
        return Detections(np.zeros((0, 4)), np.zeros(0),
                          np.zeros(0, int))
    merged = _merge_overlapping(regions.boxes, pad)
    all_boxes, all_conf, all_clid, all_kp = [], [], [], []
    for (x0, y0, x1, y1) in merged:
        # snap to at least crop_size, clamped to the frame
        cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
        side = max(crop_size, x1 - x0, y1 - y0)
        sx0 = int(max(0, min(w - side, cx - side / 2)))
        sy0 = int(max(0, min(h - side, cy - side / 2)))
        sx1 = int(min(w, sx0 + side))
        sy1 = int(min(h, sy0 + side))
        crop = image[sy0:sy1, sx0:sx1]
        det = detect_fn(crop)
        if len(det) == 0:
            continue
        boxes = det.boxes.copy()
        boxes[:, [0, 2]] += sx0
        boxes[:, [1, 3]] += sy0
        all_boxes.append(boxes)
        all_conf.append(det.conf)
        all_clid.append(det.clid)
        if det.keypoints is not None:
            kp = det.keypoints.copy()
            kp[..., 0] += sx0
            kp[..., 1] += sy0
            all_kp.append(kp)
    if not all_boxes:
        return Detections(np.zeros((0, 4)), np.zeros(0), np.zeros(0, int))
    boxes_cat = np.concatenate(all_boxes)
    # keypoints stay aligned with boxes only when EVERY crop reported
    # them — a mixed set would silently pair keypoints with the wrong
    # boxes downstream
    kp_cat = np.concatenate(all_kp) \
        if all_kp and sum(len(k) for k in all_kp) == len(boxes_cat) \
        else None
    det = Detections(boxes_cat, np.concatenate(all_conf),
                     np.concatenate(all_clid).astype(int),
                     keypoints=kp_cat)
    return merge_tile_detections(det, settings)
