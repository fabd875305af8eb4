"""DatasetQuality: score global consecutive tracklet ranges to pick
training data (reference tracking/DatasetQuality.{h,cpp}).

A "global tracklet range" is a frame interval where a stable set of
individuals is continuously tracked. Quality per range combines the
number of individuals covered, range length, and (when available)
midline-length consistency — the accumulation curriculum consumes the
ranking (best range first). Counterpart of
``trex_tpu/track/dataset_quality.py``, over the port's object Tracker."""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass
class RangeQuality:
    start: int
    end: int
    individuals: int
    min_cells: int  # min per-fish sample count in the range
    score: float

    @property
    def length(self):
        return self.end - self.start + 1


def global_tracklet_ranges(tracker, min_length: int = 2) -> list[tuple]:
    """Maximal frame intervals where every currently-known individual is
    continuously present (the reference's global tracklet order)."""
    if not tracker.individuals:
        return []
    start = tracker.start_frame
    end = tracker.end_frame
    n = len(tracker.individuals)
    present = np.zeros((end - start + 1, n), bool)
    for i, (fid, ind) in enumerate(sorted(tracker.individuals.items())):
        for t0, t1 in ind.tracklets:
            present[max(0, t0 - start) : t1 - start + 1, i] = True
    all_present = present.all(axis=1)
    ranges = []
    i = 0
    m = len(all_present)
    while i < m:
        if all_present[i]:
            j = i
            while j + 1 < m and all_present[j + 1]:
                j += 1
            if j - i + 1 >= min_length:
                ranges.append((start + i, start + j))
            i = j + 1
        else:
            i += 1
    return ranges


def evaluate_single(tracker, ind, t0: int, t1: int,
                    grid_res: int = 100) -> dict:
    """Per-fish range statistics (DatasetQuality::evaluate_single,
    DatasetQuality.cpp:281-441): distinct 100x100-grid cells visited,
    distance travelled, frames present, midline length mean/std."""
    bg = tracker.background
    h, w = (bg.shape[:2] if bg is not None else (1024, 1024))
    cw = w / grid_res
    ch = h / grid_res
    cells = set()
    prev = None
    travelled = 0.0
    frames = 0
    lengths = []
    for b in ind.basic:
        if not (t0 <= b.frame <= t1):
            continue
        frames += 1
        x, y = b.centroid.x, b.centroid.y
        cells.add((int(round(x / cw)), int(round(y / ch))))
        if prev is not None:
            travelled += math.hypot(x - prev[0], y - prev[1])
        prev = (x, y)
    for p in ind.posture:
        if t0 <= p.frame <= t1 and not math.isnan(p.midline_length):
            lengths.append(p.midline_length)
    lengths = np.asarray(lengths) if lengths else np.zeros(0)
    return {
        "grid_cells_visited": len(cells),
        "distance_travelled": travelled,
        "number_frames": frames,
        "midline_len": float(lengths.mean()) if len(lengths) else 0.0,
        "midline_std": float(lengths.std()) if len(lengths) else 0.0,
    }


def evaluate_range(tracker, frame_range: tuple) -> RangeQuality:
    """Quality over a range (DatasetQuality.cpp:90-165): per-fish
    grid-cell coverage aggregated as (min_cells, average_samples) —
    the reference's Quality ordering (DatasetQuality.cpp:39-44)."""
    t0, t1 = frame_range
    individuals = 0
    min_cells = 10 ** 9
    sum_cells = 0
    avg_samples = 0.0
    for fid, ind in tracker.individuals.items():
        single = evaluate_single(tracker, ind, t0, t1)
        if single["number_frames"] > 0:
            individuals += 1
            min_cells = min(min_cells, single["grid_cells_visited"])
            sum_cells += single["grid_cells_visited"]
            avg_samples += single["number_frames"]
    if min_cells == 10 ** 9:
        min_cells = 0
    if individuals:
        avg_samples /= individuals
    # ordering key: (min_cells, average_samples); score collapses that
    # lexicographic order into one float for callers that rank by score
    score = individuals * 1e9 + min_cells * 1e4 + avg_samples
    return RangeQuality(t0, t1, individuals, min_cells, score)


def best_ranges(tracker, min_length: int = 2) -> list[RangeQuality]:
    """All global ranges sorted best-first (DatasetQuality ordering)."""
    out = [evaluate_range(tracker, r)
           for r in global_tracklet_ranges(tracker, min_length)]
    out.sort(key=lambda q: (-q.score, q.start))
    return out
