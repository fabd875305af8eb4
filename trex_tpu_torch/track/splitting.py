"""Blob splitting by threshold escalation.

Counterpart of ``split_blob`` and ``_initial_threshold`` in
``trex_tpu/track/splitting.py``: the start-frame split of oversized
blobs in the host FastTracker. Raise the threshold step by step until
the blob falls into the requested number of fish-sized components,
never shrinking a piece below ``blob_split_global_shrink_limit`` times
the size minimum nor the whole below ``blob_split_max_shrink`` times the
original size; failure returns [] and the caller treats the blob as
unsplittable.
"""
from __future__ import annotations

import numpy as np

from ..ops.labeling import split_scan
from .blob import TrackBlob
from .prefilter import SizeFilters, threshold_components


def _split_crop(blob: TrackBlob, background: np.ndarray):
    """Masked grayscale crop + matching background crop for the
    escalation scan."""
    mask, gray, (ox, oy) = blob.to_dense(pad=1)
    bg_crop = np.zeros_like(gray)
    bh, bw = background.shape[:2]
    ys0, ys1 = max(0, oy), min(bh, oy + gray.shape[0])
    xs0, xs1 = max(0, ox), min(bw, ox + gray.shape[1])
    bg_crop[ys0 - oy:ys1 - oy, xs0 - ox:xs1 - ox] = \
        background[ys0:ys1, xs0:xs1]
    # pixel value 0 is the scan's outside-mask sentinel: clamp genuine
    # zeros inside the mask to 1
    img = np.where(mask > 0, np.maximum(gray, 1), bg_crop.astype(np.uint8))
    return img, bg_crop


def _initial_threshold(settings) -> int:
    track_thr = int(settings["track_threshold"])
    if settings["calculate_posture"]:
        initial = max(track_thr,
                      int(settings["track_posture_threshold"])) + 1
    else:
        initial = track_thr + 1
    return max(1, initial)


def _evaluate_split(expected: int, first_size: float, comps: list,
                    settings, cm_sqr: float, fish_size: SizeFilters) -> str:
    """SplitBlob::evaluate_result_multiple: 'abort' (shrunk too far),
    'remove' (pieces still too big), 'too_few' or 'keep'. Drops pieces
    below the global shrink limit from `comps`."""
    total = sum(c.num_pixels for c in comps) * cm_sqr
    if total < settings["blob_split_max_shrink"] * first_size:
        return "abort"
    if fish_size:
        min_thresh = fish_size.max_range[0] * \
            settings["blob_split_global_shrink_limit"]
    else:
        min_thresh = total * settings["blob_split_max_shrink"]
    comps[:] = [c for c in comps if c.num_pixels * cm_sqr >= min_thresh]
    valid = 0
    min_size = None
    for c in comps[:expected]:
        s = c.num_pixels
        if min_size is None or s < min_size:
            min_size = s
        if not fish_size or fish_size.in_range_of_one(s * cm_sqr):
            valid += 1
    if fish_size and min_size is not None \
            and min_size * cm_sqr > fish_size.max_range[1]:
        return "remove"
    if valid < expected:
        return "too_few"
    return "keep"


def split_blob(blob: TrackBlob, expected: int, background: np.ndarray,
               settings) -> list:
    """Split `blob` into >= `expected` components by raising the
    threshold from max(track_threshold, track_posture_threshold) + 1 to
    the smallest one whose components pass the split evaluation. Returns
    the components largest first, or [] when no split is acceptable."""
    if expected <= 1:
        return [blob]
    s = settings
    if s["blob_split_algorithm"] == "none":
        return []
    track_thr = int(s["track_threshold"])
    cm = s["cm_per_pixel"] or 1.0
    cm_sqr = cm * cm
    fish_size = SizeFilters(s["track_size_filter"])
    # the scan needs only component sizes until the threshold is chosen;
    # its components then materialize with one threshold_components call
    img, bg_crop = _split_crop(blob, background)
    best_thr, first_size = split_scan(
        img, bg_crop, _initial_threshold(s),
        bool(s["track_threshold_is_absolute"]), expected, cm_sqr,
        float(s["blob_split_max_shrink"]),
        float(s["blob_split_global_shrink_limit"]), fish_size.ranges)
    if best_thr < 0:
        return []
    comps = threshold_components(blob, best_thr, background, s)
    comps.sort(key=lambda c: -c.num_pixels)
    if _evaluate_split(expected, first_size, comps, s, cm_sqr,
                       fish_size) != "keep":
        return []  # size scan and materialization disagree: be safe
    for c in comps:
        c.split = True
        c.parent_id = blob.blob_id
        c.recount(track_thr, background, s)
    return comps
