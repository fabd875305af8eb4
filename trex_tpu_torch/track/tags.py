"""Physical tag (QR-ish) detection inside blobs.

Counterpart of ``trex_tpu/track/tags.py`` (reference
tracking/DetectTag.{h,cpp}):

- :func:`prettify_blobs`: square, upright grey and mask crops of the
  candidate blobs;
- :func:`is_good_image`: the variance-of-Laplacian quality score over
  the mask's interior;
- :func:`_tag_shape_ok`: the adaptive-threshold polygon test;
- :func:`detect_tags`: the size gate, the variance gate, the shape test
  and the decoder; a decoder with a ``batch`` form decodes a frame's
  surviving tags in one call (one forward on the card);
- :func:`match_tags_to_fish` (Hungarian, Tracker.cpp:2056-2108) and
  :func:`save_tags` (the ``tags_path`` NPZ).

The image routines are the port's own bit-for-bit copies of OpenCV's
(``track/tag_image.py``); the JAX package's fallback for a missing
OpenCV has no counterpart here.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from . import tag_image as ti
from .blob import TrackBlob

# detect_tags' per-frame counters (the `stats` argument)
STAT_KEYS = ("frames", "candidates", "variance", "shape", "decoded",
             "host_s", "decode_s")


@dataclass
class Tag:
    variance: float
    blob_id: int
    image: np.ndarray  # (S, S) grey crop
    mask: np.ndarray
    frame: int = -1
    tag_id: int = -1
    p: float = 1.0  # decode confidence (blob::Prediction-style tag.p)
    center: tuple = (0.0, 0.0)


def prettify_blobs(blobs: list[TrackBlob], background: np.ndarray,
                   crop_size: int = 32, max_size=None) -> list[Tag]:
    """Square grey/mask crops around each blob candidate; crops wider
    than `max_size` (tags_maximum_image_size) are center-cropped."""
    out = []
    for b in blobs:
        mask, grey, (ox, oy) = b.to_dense(pad=2)
        if max_size is not None:
            mw, mh = int(max_size[0]), int(max_size[1])
            if grey.shape[0] > mh or grey.shape[1] > mw:
                cy0 = max(0, (grey.shape[0] - mh) // 2)
                cx0 = max(0, (grey.shape[1] - mw) // 2)
                grey = grey[cy0:cy0 + mh, cx0:cx0 + mw]
                mask = mask[cy0:cy0 + mh, cx0:cx0 + mw]
        h, w = grey.shape
        side = max(h, w)
        sq_g = np.zeros((side, side), np.uint8)
        sq_m = np.zeros((side, side), np.uint8)
        y0 = (side - h) // 2
        x0 = (side - w) // 2
        sq_g[y0:y0 + h, x0:x0 + w] = grey
        sq_m[y0:y0 + h, x0:x0 + w] = mask
        sq_g = ti.resize_area(sq_g, (crop_size, crop_size))
        sq_m = ti.resize_nearest(sq_m, (crop_size, crop_size))
        tag = is_good_image(sq_g, sq_m)
        tag.blob_id = b.blob_id
        tag.center = b.center
        out.append(tag)
    return out


def is_good_image(grey: np.ndarray, mask: np.ndarray) -> Tag:
    """Variance-of-Laplacian sharpness score over the mask interior
    (DetectTag is_good_image: high interior contrast = tag-like)."""
    lap = ti.laplacian(grey)
    interior = ti.erode3((mask > 0).astype(np.uint8)) > 0
    vals = lap[interior]
    variance = float(vals.var()) if vals.size else 0.0
    return Tag(variance=variance, blob_id=-1, image=grey, mask=mask)


def _tag_shape_ok(tag: Tag, settings) -> bool:
    """tags_threshold / tags_equalize_hist / tags_num_sides: adaptively
    threshold the crop, approximate the largest contour as a polygon,
    accept side counts inside tags_num_sides."""
    img = tag.image
    if settings["tags_equalize_hist"]:
        img = ti.equalize_hist(img)
    c = int(settings["tags_threshold"])
    # the JAX package passes -|c| with either threshold type
    m = ti.adaptive_threshold_mean(img, 255, c < 0, 11, -abs(c))
    m = m & (tag.mask > 0).astype(np.uint8) * 255
    contours = ti.find_contours_external(m)
    if not contours:
        return False
    big = max(contours, key=ti.contour_area)
    eps = float(settings["tags_approximation"] or 0.025)
    approx = ti.approx_poly_dp(big, eps * ti.arc_length(big, True), True)
    lo, hi = settings["tags_num_sides"]
    return lo <= len(approx) <= hi


def detect_tags(noise_blobs: list[TrackBlob], background: np.ndarray,
                frame: int, min_variance: float = 100.0,
                decode_fn: Optional[Callable] = None,
                settings=None, stats: Optional[dict] = None) -> list[Tag]:
    """Candidate tags among the noise blobs of a frame. With settings,
    the tags_size_range area gate and the tags_threshold/
    tags_num_sides polygon test apply (DetectTag.cpp candidates).
    `stats`, when given, accumulates :data:`STAT_KEYS`: the frame, its
    candidates, the tags past each gate and decoded, the host seconds of
    the crops and gates, and the host seconds of the decode (the
    decoder's call, its copies and forward included)."""
    t0 = time.perf_counter()
    blobs = noise_blobs
    if settings is not None:
        cm = settings["cm_per_pixel"] or 1.0
        lo, hi = settings["tags_size_range"]
        blobs = [b for b in blobs
                 if lo <= b.num_pixels * cm * cm <= hi]
    max_size = settings["tags_maximum_image_size"] \
        if settings is not None else None
    tags = [t for t in prettify_blobs(blobs, background,
                                      max_size=max_size)
            if t.variance >= min_variance]
    n_var = len(tags)
    if settings is not None and settings["tags_debug"]:
        print(f"[tags] frame {frame}: {len(blobs)} candidates, "
              f"{len(tags)} past variance gate")
    if settings is not None:
        tags = [t for t in tags if _tag_shape_ok(t, settings)]
    host_s = time.perf_counter() - t0
    for t in tags:
        t.frame = frame
    t0 = time.perf_counter()
    batch = getattr(decode_fn, "batch", None)
    if tags and batch is not None:
        ids, ps = batch([t.image for t in tags])
        for t, i, p in zip(tags, ids, ps):
            t.tag_id, t.p = int(i), float(p)
    elif decode_fn is not None:
        for t in tags:
            got = decode_fn(t.image)
            # ML decoders return (id, confidence); a plain decoder
            # returns a bare id (p stays 1.0)
            if isinstance(got, tuple):
                t.tag_id, t.p = int(got[0]), float(got[1])
            else:
                t.tag_id = int(got)
    decode_s = time.perf_counter() - t0
    if stats is not None:
        for k, v in zip(STAT_KEYS, (1, len(blobs), n_var, len(tags),
                                    len(tags) if decode_fn else 0,
                                    host_s, decode_s)):
            stats[k] = stats.get(k, 0) + v
    return tags


def match_tags_to_fish(tags: list[Tag], tracker, frame: int,
                       max_distance: float = 80.0) -> dict[int, Tag]:
    """Hungarian tag<->fish matching by distance (Tracker.cpp:2056-2108).
    Returns {identity: tag}."""
    from scipy.optimize import linear_sum_assignment

    fish = [(fid, ind.basic_stuff(frame))
            for fid, ind in sorted(tracker.individuals.items())]
    fish = [(fid, b) for fid, b in fish if b is not None]
    if not fish or not tags:
        return {}
    cost = np.full((len(fish), len(tags)), 1e6)
    for i, (fid, b) in enumerate(fish):
        fx, fy = b.centroid.pos
        for j, t in enumerate(tags):
            d = np.hypot(fx - t.center[0], fy - t.center[1])
            if d <= max_distance:
                cost[i, j] = d
    rows, cols = linear_sum_assignment(cost)
    return {fish[r][0]: tags[c] for r, c in zip(rows, cols)
            if cost[r, c] < 1e6}


def save_tags(path, tags_by_fish: dict[int, list[Tag]]):
    """NPZ layout per reference tags_path exports."""
    arrays = {}
    for fid, tags in tags_by_fish.items():
        if not tags:
            continue
        arrays[f"fish{fid}_frames"] = np.array([t.frame for t in tags])
        arrays[f"fish{fid}_ids"] = np.array([t.tag_id for t in tags])
        arrays[f"fish{fid}_variances"] = np.array(
            [t.variance for t in tags])
        arrays[f"fish{fid}_images"] = np.stack([t.image for t in tags])
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)
    return path
