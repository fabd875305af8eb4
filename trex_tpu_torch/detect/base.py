"""Detection facade + backend registry.

The port of ``trex_tpu/detect/base.py`` (the reference's
python/Detection.cpp:16-189 dispatch and its BackendRegistry): one
backend per ``detect_type`` in {background_subtraction, yolo, sam3,
precomputed, none} with init/apply/deinit. ``create_detection`` runs
its backend on the card unless the caller names the CPU; without CUDA
and without ``device="cpu"`` it raises. The SAM backend is not ported
yet: it raises, naming its ROADMAP item.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable

import numpy as np

from ..device import resolve_device
from ..track.blob import TrackBlob
from ..track.tag_image import bgr_to_gray


class DetectionBackend:
    def init(self, settings, background=None, device=None):
        return self

    def apply(self, frame_index: int, image: np.ndarray) -> list[TrackBlob]:
        raise NotImplementedError

    def deinit(self):
        pass


class BackgroundSubtractionBackend(DetectionBackend):
    """Classic path (BackgroundSubtraction.cpp:126-347), the host's
    ``pipeline.detect_frame``."""

    def init(self, settings, background=None, device=None):
        self.settings = settings
        self.background = background
        return self

    def set_background(self, background):
        self.background = background

    def apply(self, frame_index, image):
        from ..pipeline import detect_frame

        return detect_frame(image, self.background, self.settings)


class YOLOBackend(DetectionBackend):
    def init(self, settings, background=None, device=None):
        from ..models.yolo_convert import load_ultralytics_checkpoint
        from .yolo import YOLODetector

        self.settings = settings
        model_path = settings["detect_model"]
        loaded = {}
        if model_path:
            loaded = load_ultralytics_checkpoint(model_path, device=device)
        self.detector = YOLODetector(
            settings, state=loaded.get("state"),
            num_classes=loaded.get("num_classes", 80),
            task=loaded.get("task", "detect"),
            scale=loaded.get("scale", "n"),
            num_keypoints=loaded.get("num_keypoints", 17),
            kpt_dims=loaded.get("kpt_dims", 3), device=device)
        # region_model/region_resolution: a cheap region detector runs
        # on the downscaled full frame and the main model only on the
        # proposed crops (trex_detection_model.py:547
        # perform_region_proposal)
        self.region = None
        region_path = str(settings["region_model"] or "").strip()
        if region_path:
            rl = load_ultralytics_checkpoint(region_path, device=device)
            self.region = YOLODetector(
                settings, state=rl.get("state"),
                num_classes=rl.get("num_classes", 1),
                task=rl.get("task", "detect"),
                scale=rl.get("scale", "n"),
                num_keypoints=rl.get("num_keypoints", 17),
                kpt_dims=rl.get("kpt_dims", 3),
                input_size=int(settings["region_resolution"] or 320),
                device=device)
        return self

    def apply(self, frame_index, image):
        # dispatch order mirrors YOLO.cpp:740-752: instance masks win,
        # then oriented boxes, then POLO points, then plain boxes
        from .yolo import (
            boxes_to_blobs,
            masks_to_blobs,
            obbs_to_blobs,
            points_to_blobs,
        )

        if self.region is not None:
            from .region import region_proposal_detect

            det = region_proposal_detect(
                image, self.region.detect, self.detector.detect,
                self.settings,
                crop_size=int(self.settings["region_resolution"] or 320))
        else:
            det = self.detector.detect(image)
        gray = bgr_to_gray(image) if image.ndim == 3 else image
        if det.masks is not None:
            return masks_to_blobs(det, gray, det.masks, self.settings)
        if det.obb is not None:
            return obbs_to_blobs(det, gray, self.settings)
        if det.points is not None:
            return points_to_blobs(det, gray, self.settings)
        return boxes_to_blobs(det, gray, self.settings)


class PrecomputedBackend(DetectionBackend):
    """External CSV/NPZ detections (python/PrecomuptedDetection.cpp:
    buildCache): rows of (x, y, w, h, frame) become rectangle blobs."""

    def init(self, settings, background=None, device=None):
        self.settings = settings
        self.cache: dict[int, list] = {}
        path = settings["detect_precomputed_file"]
        if path:
            self.load(path)
        return self

    def load(self, path):
        path = Path(str(path))
        if not path.exists():
            raise FileNotFoundError(path)
        if path.suffix == ".npz":
            with np.load(path) as data:
                rows = np.stack([data[k] for k in
                                 ("x", "y", "w", "h", "frame")], 1)
        else:
            import csv

            with open(path) as f:
                r = csv.DictReader(f)
                rows = np.array([[float(row["x"]), float(row["y"]),
                                  float(row["w"]), float(row["h"]),
                                  float(row["frame"])] for row in r])
        for x, y, w, h, frame in rows:
            self.cache.setdefault(int(frame), []).append((x, y, w, h))

    def apply(self, frame_index, image):
        if image.ndim == 3:  # blob pixels are grayscale
            image = bgr_to_gray(image)
        blobs = []
        ih, iw = image.shape[:2]
        for (x, y, w, h) in self.cache.get(frame_index, []):
            # symmetric clamp: boxes fully off ANY edge drop out
            x0 = int(max(0, min(iw, x)))
            y0 = int(max(0, min(ih, y)))
            x1 = int(max(0, min(iw, x + w)))
            y1 = int(max(0, min(ih, y + h)))
            if x1 <= x0 or y1 <= y0:
                continue
            # exclusive box edges -> inclusive RLE x1
            lines = np.array([[yy, x0, x1 - 1] for yy in range(y0, y1)],
                             np.int32)
            px = image[y0:y1, x0:x1].reshape(-1)
            blobs.append(TrackBlob(lines, px))
        return blobs


class NoDetection(DetectionBackend):
    """Whole frame = one object (python/NoDetection.{h,cpp})."""

    def apply(self, frame_index, image):
        if image.ndim == 3:  # blob pixels are grayscale
            image = bgr_to_gray(image)
        h, w = image.shape[:2]
        lines = np.stack([np.arange(h), np.zeros(h, int),
                          np.full(h, w - 1)], 1).astype(np.int32)
        return [TrackBlob(lines, image.reshape(-1))]


class Sam3Backend(DetectionBackend):
    """Prompted segmentation (python/SAM3.{h,cpp}): not ported yet."""

    def init(self, settings, background=None, device=None):
        from ..track.engine import EngineUnsupported

        raise EngineUnsupported(
            "detect_type sam3 (the SAM models, ported with ROADMAP.md A "
            "item 3f)")


REGISTRY: dict[str, Callable[[], DetectionBackend]] = {
    "background_subtraction": BackgroundSubtractionBackend,
    "yolo": YOLOBackend,
    "sam3": Sam3Backend,
    "precomputed": PrecomputedBackend,
    "none": NoDetection,
}


def create_detection(settings, background=None,
                     device=None) -> DetectionBackend:
    """The backend of ``detect_type``, initialised on `device` (the card
    unless the CPU is named)."""
    dev = resolve_device(device)
    dtype = settings["detect_type"] or "none"
    if dtype not in REGISTRY:
        raise ValueError(f"unknown detect_type {dtype!r}; "
                         f"available: {sorted(REGISTRY)}")
    return REGISTRY[dtype]().init(settings, background, device=dev)
