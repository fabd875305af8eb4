"""Occupancy/value heatmaps over the arena grid.

Counterpart of ``trex_tpu/track/heatmap.py`` (the compute half of the
reference's Heatmap view, docs/formats.rst:284-299): the arena is
divided into `heatmap_resolution`-sized cells; per frame (optionally
over a sliding `heatmap_frames` context window) the grid accumulates
individual presence or a `heatmap_source` output value of
``export/library.py``, normalized per `heatmap_normalization`. Exported
as data/<video>_heatmap_p0_<cell>_<w>x<h>.npz with heatmap/frames/meta.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

NORMALIZATION = {"none": 0.0, "value": 1.0, "cell": 2.0, "variance": 3.0}


def compute_heatmaps(tracker, settings, frames=None,
                     source: Optional[str] = None):
    """(heatmap[N, 2, gh, gw], frame_indexes). Layer 0 = counts, layer 1
    = mean source value (or speed when no source set)."""
    s = settings
    bg = tracker.background
    if bg is None:
        raise ValueError("heatmaps need a background/arena size")
    h, w = bg.shape[:2]
    res = int(s["heatmap_resolution"]) or 64
    gw = max(1, int(np.ceil(w / res)))
    gh = max(1, int(np.ceil(h / res)))
    if frames is None:
        frames = range(tracker.start_frame, tracker.end_frame + 1)
    frames = list(frames)
    context = int(s["heatmap_frames"]) or 0
    source = source or (s["heatmap_source"] or "")

    # value sources resolve through the output library, so any
    # exported field name works (the reference's heatmap_source uses
    # the same registry); '' defaults to SPEED
    from ..export.library import EvalContext, evaluate

    ctx = EvalContext(tracker, s)
    field_name = source or "SPEED"

    def source_value(ind, b, f):
        if field_name == "SPEED":
            return b.centroid.speed(s["cm_per_pixel"] or 1.0)
        v = evaluate(ctx, ind, f, field_name, [])
        return v if np.isfinite(v) else None

    per_frame = np.zeros((len(frames), 2, gh, gw), np.float32)
    variance_mode = (s["heatmap_normalization"] or "") == "variance"
    for i, f in enumerate(frames):
        counts = per_frame[i, 0]
        values = per_frame[i, 1]
        sq = np.zeros((gh, gw), np.float32) if variance_mode else None
        for ind in tracker.individuals.values():
            b = ind.basic_stuff(f)
            if b is None:
                continue
            cx, cy = b.centroid.pos
            gx = min(gw - 1, max(0, int(cx // res)))
            gy = min(gh - 1, max(0, int(cy // res)))
            counts[gy, gx] += 1
            v = source_value(ind, b, f)
            if v is not None:
                values[gy, gx] += v
                if sq is not None:
                    sq[gy, gx] += v * v
        nz = counts > 0
        if sq is not None:
            # per-cell sample variance E[x^2] - E[x]^2 as the value
            mean = np.where(nz, values / np.maximum(counts, 1), 0.0)
            values[nz] = (sq[nz] / counts[nz]) - mean[nz] ** 2
        else:
            values[nz] /= counts[nz]
    if context > 1:
        # sliding-window accumulation over `heatmap_frames`
        csum = np.cumsum(per_frame, axis=0)
        out = np.empty_like(per_frame)
        for i in range(len(frames)):
            lo = max(0, i - context + 1)
            out[i] = (csum[i] - (csum[lo - 1] if lo > 0 else 0)) \
                / (i - lo + 1)
        per_frame = out
    norm = s["heatmap_normalization"] or "cell"
    if norm == "cell":
        m = per_frame[:, 0].max()
        if m > 0:
            per_frame[:, 0] /= m
    elif norm == "value":
        m = per_frame[:, 1].max()
        if m > 0:
            per_frame[:, 1] /= m
    return per_frame, np.asarray(frames, np.int64)


def export_heatmaps(tracker, settings, output_dir, video_name: str):
    s = settings
    heat, frames = compute_heatmaps(tracker, settings)
    res = int(s["heatmap_resolution"]) or 64
    gh, gw = heat.shape[2:]
    norm = s["heatmap_normalization"] or "cell"
    path = Path(output_dir) / \
        f"{video_name}_heatmap_p0_{res}_{gw}x{gh}.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    meta = np.array([0.0, float(res), NORMALIZATION.get(norm, 2.0),
                     float(int(s["heatmap_frames"]) or len(frames))])
    with open(path, "wb") as f:
        np.savez_compressed(f, heatmap=heat, frames=frames, meta=meta)
    return path
