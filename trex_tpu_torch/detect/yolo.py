"""YOLO detection backend: tiling -> the torch model -> merge -> blobs.

The port of ``trex_tpu/detect/yolo.py`` (the reference's python/YOLO.cpp
+ trex_yolo.py):

- letterbox / SAHI tiles feed ``models/yolo.py``'s YOLOv8 on the card
  (the CPU when the caller names it); ``decode_predictions`` runs there
  and its rows come to the host once a batch;
- thresholding, NMS, the tile merge (``tiling.py``) and the blob
  converters run on the host, as in the JAX package;
- boxes scale back to video coordinates (scale_boxes semantics), boxes
  become full-rectangle blobs with the image pixels, instance masks
  become RLE lines, keypoints attach as poses.

The OpenCV calls of the JAX package's path are the port's own
(``track/tag_image.py``): the letterbox's ``resize`` (``INTER_LINEAR``),
``cvtColor`` ``GRAY2BGR`` and the masks' ``INTER_NEAREST`` resize.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.labeling import label_blobs
from ..track.blob import TrackBlob
from ..track.tag_image import gray_to_bgr, resize_linear, resize_nearest
from .prediction_filter import filter_from_settings
from .tiling import (
    compute_pose_tile_rect,
    compute_tile_bounds,
    compute_tile_merge_groups,
    compute_tile_nms_indices,
    compute_tile_nms_indices_for_rotated_rects,
)

# the decoded rows _postprocess reads, brought to the host once a batch
_HOST_KEYS = ("boxes", "conf", "clid", "keypoints", "mask_coeffs",
              "proto", "obb")


@dataclass
class Detections:
    """Flat per-frame detection rows in video coordinates."""
    boxes: np.ndarray  # (N, 4) xyxy
    conf: np.ndarray  # (N,)
    clid: np.ndarray  # (N,) int
    keypoints: Optional[np.ndarray] = None  # (N, K, 3)
    masks: Optional[np.ndarray] = None  # (N, h, w) bool, video coords
    obb: Optional[np.ndarray] = None  # (N, 5) cx, cy, w, h, angle(rad)
    points: Optional[np.ndarray] = None  # (N, 2) cx, cy + radii below
    radii: Optional[np.ndarray] = None  # (N,) point radius per row

    def __len__(self):
        return len(self.boxes)


def obb_corners(obb: np.ndarray) -> np.ndarray:
    """(N, 5) cx,cy,w,h,angle -> (N, 4, 2) corner points (the
    detect::ICXYWHR::corners() geometry YOLO.cpp:862 rasterizes)."""
    cx, cy, w, h, a = (obb[:, i] for i in range(5))
    cos, sin = np.cos(a), np.sin(a)
    dx = np.stack([w / 2, w / 2, -w / 2, -w / 2], -1)
    dy = np.stack([h / 2, -h / 2, -h / 2, h / 2], -1)
    x = cx[:, None] + dx * cos[:, None] - dy * sin[:, None]
    y = cy[:, None] + dx * sin[:, None] + dy * cos[:, None]
    return np.stack([x, y], -1)


def letterbox_params(src_hw, dst_hw):
    """gain + (pad_x, pad_y) as in scale_boxes (trex_yolo.py:46-52)."""
    gain = min(dst_hw[0] / src_hw[0], dst_hw[1] / src_hw[1])
    pad = (round((dst_hw[1] - src_hw[1] * gain) / 2 - 0.1),
           round((dst_hw[0] - src_hw[0] * gain) / 2 - 0.1))
    return gain, pad


def letterbox(image: np.ndarray, size: int) -> np.ndarray:
    """`image` (gray or BGR) resized by its longer side to `size` and
    centred on a (size, size, 3) canvas of 114 (ultralytics' letterbox;
    ``cv2.resize`` ``INTER_LINEAR`` as the port rebuilds it)."""
    h, w = image.shape[:2]
    gain = min(size / h, size / w)
    nw, nh = int(round(w * gain)), int(round(h * gain))
    resized = resize_linear(image, (nw, nh))
    canvas = np.full((size, size, 3), 114, np.uint8)
    px = (size - nw) // 2
    py = (size - nh) // 2
    if resized.ndim == 2:
        resized = gray_to_bgr(resized)
    canvas[py: py + nh, px: px + nw] = resized
    return canvas


def scale_boxes_back(boxes: np.ndarray, src_hw, dst_hw) -> np.ndarray:
    """Undo letterboxing: model-input xyxy -> original-image xyxy."""
    gain, pad = letterbox_params(dst_hw, src_hw)
    out = boxes.astype(np.float64).copy()
    out[:, [0, 2]] -= pad[0]
    out[:, [1, 3]] -= pad[1]
    out /= gain
    out[:, [0, 2]] = np.clip(out[:, [0, 2]], 0, dst_hw[1])
    out[:, [1, 3]] = np.clip(out[:, [1, 3]], 0, dst_hw[0])
    return out


def process_mask(proto: np.ndarray, coeffs: np.ndarray,
                 boxes: np.ndarray, input_hw) -> np.ndarray:
    """(n, mh, mw) binary masks cropped to their boxes
    (trex_yolo.py:71-101)."""
    mh, mw, c = proto.shape
    masks = coeffs.astype(np.float32) @ proto.reshape(mh * mw, c).T
    masks = 1.0 / (1.0 + np.exp(-masks))
    masks = masks.reshape(-1, mh, mw)
    ih, iw = input_hw
    sx, sy = mw / iw, mh / ih
    for i, (x0, y0, x1, y1) in enumerate(boxes):
        bx0, by0 = int(max(0, x0 * sx)), int(max(0, y0 * sy))
        bx1 = int(min(mw, math.ceil(x1 * sx)))
        by1 = int(min(mh, math.ceil(y1 * sy)))
        crop = np.zeros((mh, mw), np.float32)
        crop[by0:by1, bx0:bx1] = masks[i, by0:by1, bx0:bx1]
        masks[i] = crop
    return masks > 0.5


def unpad_masks(masks: np.ndarray, pad, gain, hw,
                input_size: int) -> np.ndarray:
    """Crop letterbox padding off proto-grid masks so that a direct
    resize to the video frame maps content correctly (ultralytics
    scale_masks)."""
    h, w = hw
    n, mh, mw = masks.shape
    sx, sy = mw / input_size, mh / input_size
    px0 = int(round(pad[0] * sx))
    py0 = int(round(pad[1] * sy))
    px1 = int(round((pad[0] + w * gain) * sx))
    py1 = int(round((pad[1] + h * gain) * sy))
    return masks[:, py0:max(py0 + 1, py1), px0:max(px0 + 1, px1)]


class YOLODetector:
    """Runs the YOLOv8 model over letterboxed frames or SAHI tiles on
    `device` (the card unless the caller names the CPU)."""

    def __init__(self, settings, state=None, scale: str = "n",
                 task: str = "detect", num_classes: int = 80,
                 input_size: int = 640, num_keypoints: int = 17,
                 kpt_dims: int = 3, device=None, dtype=None):
        from ..models.yolo import build, decode_predictions

        self.device = resolve_device(device)
        self.settings = settings
        self.task = task
        self.scale = scale
        self.num_classes = num_classes
        # detect_resolution overrides the DEFAULT model input size;
        # explicit sizes (e.g. region_resolution) win
        res = settings["detect_resolution"]
        if res and input_size == 640:
            input_size = int(res[0] if isinstance(res, (list, tuple))
                             else res)
        self.input_size = input_size
        self.model = build(num_classes, scale, task,
                           num_keypoints=num_keypoints, kpt_dims=kpt_dims,
                           dtype=dtype, state=state, device=self.device)
        self._decode = decode_predictions
        conf_t = settings["detect_conf_threshold"]
        self._conf_threshold = float(conf_t if conf_t else 0.1)
        self.batch_size = self._auto_batch_size()
        # detect_format=points: POLO-style point localization
        self.points_mode = str(settings["detect_format"] or "") == "points"

    def _auto_batch_size(self, target_fraction: float = 0.5) -> int:
        """Memory-aware batch sizing (trex_detection_model.py's
        calculate_memory/get_free_memory:656-691): per-image activation
        bytes from the model scale and input size, the batch sized to
        `target_fraction` of the card's free memory, clamped to [1,
        detect_batch_size]; on the CPU the cap."""
        from ..models.yolo import SCALES

        cap = int(self.settings.get("detect_batch_size") or 8)
        free = torch.cuda.mem_get_info(self.device)[0] \
            if self.device.type == "cuda" else 0
        if free <= 0:
            return max(1, cap)
        _, width, _ = SCALES[self.scale]
        # dominant activations: stride-4/8 feature maps, bf16
        per_image = int(self.input_size * self.input_size
                        * (16 + 32) * width * 2 * 2.5)
        batch = int(max(1, (free * target_fraction) // max(1, per_image)))
        return max(1, min(cap, batch))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def infer_device(self, canvas: np.ndarray) -> dict:
        """Forward + decode of (B, S, S, 3) uint8 letterboxed images;
        the decoded tensors stay on the device."""
        x = torch.from_numpy(np.ascontiguousarray(canvas)).to(
            self.device).permute(0, 3, 1, 2)
        return self._decode(self.model(x), self.num_classes)

    def _infer(self, canvas: np.ndarray) -> dict:
        """:meth:`infer_device`, with the rows ``_postprocess`` reads
        copied to the host."""
        dec = self.infer_device(canvas)
        return {k: dec[k].cpu().numpy() for k in _HOST_KEYS if k in dec}

    def _prepare(self, image: np.ndarray, size: int):
        return letterbox(image, size)

    def detect(self, image: np.ndarray) -> Detections:
        """Full-frame (letterboxed) or tiled detection in video coords."""
        s = self.settings
        h, w = image.shape[:2]
        tiles = compute_tile_bounds(
            (w, h), (self.input_size, self.input_size),
            int(s["detect_tile_target_width"] or 0),
            int(s["detect_tile_image"] or 0),
            float(s["detect_tile_overlap"] or 0.0))
        if not tiles:
            return self._detect_single(image)
        all_boxes, all_conf, all_clid, all_kp, all_obb = [], [], [], [], []
        crops = [image[int(ty): int(ty + th), int(tx): int(tx + tw)]
                 for (tx, ty, tw, th) in tiles]
        dets = self._detect_many(crops)
        for (tx, ty, tw, th), det in zip(tiles, dets):
            det.boxes[:, [0, 2]] += tx
            det.boxes[:, [1, 3]] += ty
            if det.keypoints is not None:
                det.keypoints[..., 0] += tx
                det.keypoints[..., 1] += ty
                all_kp.append(det.keypoints)
            if det.obb is not None:
                det.obb[:, 0] += tx
                det.obb[:, 1] += ty
                all_obb.append(det.obb)
            all_boxes.append(det.boxes)
            all_conf.append(det.conf)
            all_clid.append(det.clid)
        boxes = np.concatenate(all_boxes) if all_boxes else np.zeros((0, 4))
        conf = np.concatenate(all_conf) if all_conf else np.zeros(0)
        clid = np.concatenate(all_clid) if all_clid else np.zeros(0, int)
        kp = np.concatenate(all_kp) if all_kp else None
        obb = np.concatenate(all_obb) if all_obb else None
        det = Detections(boxes, conf, clid, keypoints=kp, obb=obb)
        det = merge_tile_detections(det, self.settings)
        if self.points_mode:
            attach_points(det, self.settings)
        return det

    def _detect_many(self, images: list) -> list:
        """Batched inference over several crops: letterbox all, forward
        them in batches of at most ``batch_size``, then post-process
        each."""
        B = max(1, int(self.batch_size))
        out_dets = []
        for i0 in range(0, len(images), B):
            chunk = images[i0:i0 + B]
            canv = np.stack([self._prepare(im, self.input_size)
                             for im in chunk])
            out = self._infer(canv)
            for k, im in enumerate(chunk):
                out_dets.append(self._postprocess(out, k, im.shape[:2]))
        return out_dets

    def _detect_single(self, image: np.ndarray) -> Detections:
        canvas = self._prepare(image, self.input_size)
        out = self._infer(canvas[None])
        return self._postprocess(out, 0, image.shape[:2])

    def _postprocess(self, out, k: int, hw) -> Detections:
        h, w = hw
        boxes = np.asarray(out["boxes"][k])
        conf = np.asarray(out["conf"][k])
        clid = np.asarray(out["clid"][k])
        keep = conf >= self._conf_threshold
        boxes, conf, clid = boxes[keep], conf[keep], clid[keep]
        # intra-frame NMS (ultralytics default iou 0.7)
        iou = self.settings["detect_iou_threshold"]
        sel = compute_tile_nms_indices(boxes, conf, clid,
                                       float(iou) if iou else 0.7)
        boxes, conf, clid = boxes[sel], conf[sel], clid[sel]
        boxes = scale_boxes_back(boxes, (self.input_size, self.input_size),
                                 (h, w))
        gain, pad = letterbox_params((h, w),
                                     (self.input_size, self.input_size))
        kp = None
        if "keypoints" in out:
            kp = np.asarray(out["keypoints"][k])[keep][sel]
            kp[..., 0] = (kp[..., 0] - pad[0]) / gain
            kp[..., 1] = (kp[..., 1] - pad[1]) / gain
        masks = None
        if "mask_coeffs" in out:
            coeffs = np.asarray(out["mask_coeffs"][k])[keep][sel]
            proto = np.asarray(out["proto"][k])
            # boxes are in video coords; map back to model-input coords
            input_boxes = boxes * gain
            input_boxes[:, [0, 2]] += pad[0]
            input_boxes[:, [1, 3]] += pad[1]
            masks = process_mask(proto, coeffs, input_boxes,
                                 (self.input_size, self.input_size))
            masks = unpad_masks(masks, pad, gain, (h, w),
                                self.input_size)
        obb = None
        if "obb" in out:
            obb = np.asarray(out["obb"][k])[keep][sel]
            obb[:, 0] = (obb[:, 0] - pad[0]) / gain
            obb[:, 1] = (obb[:, 1] - pad[1]) / gain
            obb[:, 2:4] /= gain  # letterbox scale is uniform: angle keeps
        det = Detections(boxes, conf, clid, keypoints=kp, masks=masks,
                         obb=obb)
        if self.points_mode:
            attach_points(det, self.settings)
        return det


def attach_points(det: Detections, settings) -> Detections:
    """detect_format=points: each detection collapses to its center
    with a per-class radius from `detect_point_radii` (default 20 -
    trex_yolo.py:328-344 row construction for POLO results)."""
    radii_map = settings["detect_point_radii"] or {}
    cx = (det.boxes[:, 0] + det.boxes[:, 2]) / 2
    cy = (det.boxes[:, 1] + det.boxes[:, 3]) / 2
    det.points = np.stack([cx, cy], -1)
    det.radii = np.array(
        [float(radii_map.get(int(c), radii_map.get(str(int(c)), 20.0)))
         for c in det.clid], np.float64)
    return det


def merge_tile_detections(det: Detections, settings) -> Detections:
    """SAHI postprocess across tiles (YOLO.cpp tile merge path)."""
    if len(det) == 0:
        return det
    if det.obb is not None:
        # rotated-rect NMS across tiles over the OBB rects themselves
        rects = [((float(o[0]), float(o[1])),
                  (max(float(o[2]), 1.0), max(float(o[3]), 1.0)),
                  math.degrees(float(o[4]))) for o in det.obb]
        sel = compute_tile_nms_indices_for_rotated_rects(
            rects, det.conf, det.clid,
            float(settings["detect_tile_merge_iou"] or 0.55))
        return Detections(det.boxes[sel], det.conf[sel], det.clid[sel],
                          keypoints=det.keypoints[sel]
                          if det.keypoints is not None else None,
                          obb=det.obb[sel])
    if det.keypoints is not None \
            and str(settings["detect_pose_bbx"] or "keypoints") \
            == "keypoints":
        # pose duplicates matched over padded min-area keypoint rects
        # (detect_pose_bbx=keypoints; YOLO.cpp:225-353)
        rects = []
        ok = []
        for i in range(len(det)):
            r = compute_pose_tile_rect(det.keypoints[i][..., :2])
            if r is not None:
                (cx, cy), (w_, h_), a = r
                rects.append(((cx, cy), (w_ + 4.0, h_ + 4.0), a))
                ok.append(i)
        if rects:
            oki = np.asarray(ok)
            sel = compute_tile_nms_indices_for_rotated_rects(
                rects, det.conf[oki], det.clid[oki],
                float(settings["detect_tile_merge_iou"] or 0.55))
            keep = oki[sel]
            return Detections(det.boxes[keep], det.conf[keep],
                              det.clid[keep],
                              keypoints=det.keypoints[keep])
    method = settings["detect_tile_merge_method"] \
        if "detect_tile_merge_method" in settings else "nmm"
    if method in ("nmm", "greedy_nmm", None, True):
        groups = compute_tile_merge_groups(
            det.boxes, det.conf, det.clid,
            float(settings["detect_tile_merge_containment"] or 0.5))
        boxes, conf, clid, kps = [], [], [], []
        for g in groups:
            src = det.boxes[g.source_indices]
            boxes.append([src[:, 0].min(), src[:, 1].min(),
                          src[:, 2].max(), src[:, 3].max()])
            conf.append(det.conf[g.representative_index])
            clid.append(det.clid[g.representative_index])
            if det.keypoints is not None:
                kps.append(det.keypoints[g.representative_index])
        return Detections(np.asarray(boxes, np.float64),
                          np.asarray(conf), np.asarray(clid, int),
                          keypoints=np.asarray(kps) if kps else None)
    sel = compute_tile_nms_indices(
        det.boxes, det.conf, det.clid,
        float(settings["detect_tile_merge_iou"] or 0.55))
    return Detections(det.boxes[sel], det.conf[sel], det.clid[sel],
                      keypoints=det.keypoints[sel]
                      if det.keypoints is not None else None)


# ---------------------------------------------------------------------------
# detections -> blobs (pv objects)
# ---------------------------------------------------------------------------

def boxes_to_blobs(det: Detections, image: np.ndarray,
                   settings) -> list[TrackBlob]:
    """process_boxes_only (YOLO.cpp:980-1090): each box becomes a blob of
    full horizontal lines carrying the image pixels + class prediction."""
    h, w = image.shape[:2]
    out = []
    only = filter_from_settings(settings)
    for i in range(len(det)):
        if only is not None and not only.allowed(int(det.clid[i])):
            continue
        x0, y0, x1, y1 = det.boxes[i]
        # xyxy edges are exclusive on both axes; RLE line x1 is
        # inclusive, so the last column is x1 - 1
        x0 = int(max(0, min(w - 1, x0)))
        x1 = int(max(0, min(w, x1)))
        y0 = int(max(0, min(h - 1, y0)))
        y1 = int(max(0, min(h, y1)))
        if x1 <= x0 or y1 <= y0:
            continue
        lines = np.array([[y, x0, x1 - 1] for y in range(y0, y1)],
                         np.int32)
        px = image[y0:y1, x0:x1].reshape(-1)
        blob = TrackBlob(lines, px)
        blob.prediction = {"clid": int(det.clid[i]),
                           "p": float(det.conf[i]),
                           "keypoints": None if det.keypoints is None
                           else det.keypoints[i]}
        out.append(blob)
    return out


def masks_to_blobs(det: Detections, image: np.ndarray, masks: np.ndarray,
                   settings) -> list[TrackBlob]:
    """process_instance_segmentation: binary masks -> RLE-line blobs."""
    h, w = image.shape[:2]
    out = []
    for i in range(len(det)):
        m = masks[i]
        if m.shape != (h, w):
            m = resize_nearest(m.astype(np.uint8), (w, h))
        comps = label_blobs((m > 0).astype(np.uint8) * 255)
        if not comps:
            continue
        big = max(comps, key=lambda c: c.num_pixels)
        px = np.concatenate([image[y, a: b + 1]
                             for y, a, b in big.lines])
        blob = TrackBlob(big.lines, px,
                         flags=0x4)  # is_instance_segmentation
        blob.prediction = {"clid": int(det.clid[i]),
                           "p": float(det.conf[i]), "keypoints": None}
        out.append(blob)
    return out


def _lines_blob(lines: list, image: np.ndarray, det: Detections,
                i: int) -> Optional[TrackBlob]:
    if not lines:
        return None
    lines = np.asarray(lines, np.int32)
    px = np.concatenate([image[y, a: b + 1] for y, a, b in lines])
    blob = TrackBlob(lines, px)
    blob.prediction = {"clid": int(det.clid[i]),
                       "p": float(det.conf[i]),
                       "keypoints": None if det.keypoints is None
                       else det.keypoints[i]}
    return blob


def obbs_to_blobs(det: Detections, image: np.ndarray,
                  settings) -> list[TrackBlob]:
    """process_obbs (YOLO.cpp:840-975): each oriented box rasterizes to
    RLE lines by intersecting every scanline with the rect's four
    edges (ceil/floor inner-pixel rounding, columns clamped to
    [0, w-1]), pixels copied from the frame, class/pose prediction
    attached."""
    h, w = image.shape[:2]
    out = []
    only = filter_from_settings(settings)
    corners_all = obb_corners(det.obb)
    for i in range(len(det)):
        if only is not None and not only.allowed(int(det.clid[i])):
            continue
        corners = corners_all[i]
        ymin = int(max(0, math.floor(corners[:, 1].min())))
        ymax = int(math.ceil(corners[:, 1].max()))
        lines = []
        for y in range(ymin, min(ymax + 1, h)):
            xs = []
            for e in range(4):
                v0, v1 = corners[e], corners[(e + 1) % 4]
                dy = v1[1] - v0[1]
                if dy == 0:
                    if y == v0[1]:
                        xs += [min(v0[0], v1[0]), max(v0[0], v1[0])]
                else:
                    t = (y - v0[1]) / dy
                    if 0 <= t < 1:
                        xs.append((v1[0] - v0[0]) * t + v0[0])
            if len(xs) < 2:
                continue
            x0 = int(np.clip(math.ceil(min(xs[0], xs[1])), 0, w - 1))
            x1 = int(np.clip(math.floor(max(xs[0], xs[1])), 0, w - 1))
            lines.append((y, x0, x1))
        blob = _lines_blob(lines, image, det, i)
        if blob is not None:
            out.append(blob)
    return out


def points_to_blobs(det: Detections, image: np.ndarray,
                    settings) -> list[TrackBlob]:
    """process_points (YOLO.cpp:754-840): a POLO point becomes a filled
    circle blob of radius det.radii[i] (the scanline half-width is
    max(1, sqrt(r^2 - dy^2)), rounded ceil/floor and clamped like the
    OBB path)."""
    h, w = image.shape[:2]
    out = []
    only = filter_from_settings(settings)
    for i in range(len(det)):
        if only is not None and not only.allowed(int(det.clid[i])):
            continue
        xmid, ymid = det.points[i]
        halfh = float(det.radii[i])
        ymin = int(max(0, math.floor(ymid - halfh)))
        ymax = int(math.ceil(ymid + halfh))
        lines = []
        for y in range(ymin, min(ymax + 1, h)):
            radicand = max(0.0, halfh * halfh - (y - ymid) ** 2)
            r = max(1.0, math.sqrt(radicand))
            x0 = int(np.clip(math.ceil(xmid - r), 0, w - 1))
            x1 = int(np.clip(math.floor(xmid + r), 0, w - 1))
            lines.append((y, x0, x1))
        blob = _lines_blob(lines, image, det, i)
        if blob is not None:
            out.append(blob)
    return out
