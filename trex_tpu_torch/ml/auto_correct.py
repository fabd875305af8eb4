"""Identity auto-correction from VI predictions (counterpart of
``trex_tpu/ml/auto_correct.py``; the network runs on the card, the rest
on the host).

Re-creates the apply path of the reference:
- RecTask (tracking/RecTask.{h,cpp}): streaming per-tracklet crop batches
  through the network, storing per-blob probability rows on the tracker
  (Tracker::predicted, Tracker.h:56-87)
- Tracker::check_tracklets_identities (Tracker.cpp:3026-3500): average
  predictions per (individual, tracklet), build "virtual fish", assign
  identities greedily by confidence without temporal conflicts, emit
  automatic match ranges, then re-track.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from ..ops.crops import crops_for_individual


@dataclass
class TrackletPrediction:
    fid: int
    range: tuple  # (start, end)
    probs: np.ndarray  # (num_classes,) averaged
    samples: int

    @property
    def best_id(self) -> int:
        return int(self.probs.argmax())

    @property
    def confidence(self) -> float:
        return float(self.probs.max())


def predict_tracklets(tracker, settings, network,
                      min_samples: int = 1) -> list[TrackletPrediction]:
    """RecTask: per-tracklet averaged identity predictions. The crops of
    every tracklet go through the network in one call (which batches
    them), where the JAX package calls it once per tracklet: under the
    registry's defaults every tracklet is one frame long, and a call per
    frame and individual would leave the card idle."""
    jobs = []
    for fid, ind in sorted(tracker.individuals.items()):
        lengths = [p.midline_length for p in ind.posture
                   if not math.isnan(p.midline_length)]
        med = float(np.median(lengths)) if lengths else None
        for t0, t1 in ind.tracklets:
            frames = set(range(t0, t1 + 1))
            crops, got = crops_for_individual(
                ind, tracker, settings, frames=frames,
                median_midline_length=med)
            if len(crops) < min_samples:
                continue
            jobs.append((fid, ind, (t0, t1), crops, got))
    if not jobs:
        return []
    rows = network.probabilities(np.concatenate([j[3] for j in jobs]))
    out, at = [], 0
    for fid, ind, rng, crops, got in jobs:
        probs = rows[at : at + len(crops)]
        at += len(crops)
        # store per-frame rows on the tracker (Tracker::predicted)
        for i, f in enumerate(got):
            b = ind.basic_stuff(int(f))
            if b is not None:
                tracker.predicted.setdefault(int(f), {})[
                    b.blob.blob_id] = probs[i]
        out.append(TrackletPrediction(
            fid=fid, range=rng, probs=probs.mean(axis=0),
            samples=len(crops)))
    return out


@dataclass
class Corrections:
    # identity -> list of (start, end, source_fid)
    ranges: dict = field(default_factory=dict)
    reassigned: int = 0
    skipped: int = 0


def assign_identities(predictions: list[TrackletPrediction],
                      num_classes: int,
                      min_probability: float = 0.5) -> Corrections:
    """Greedy conflict-free assignment: tracklets sorted by confidence,
    each claims its best class unless that class already owns an
    overlapping frame range (check_tracklets_identities semantics)."""
    out = Corrections()
    claimed: dict[int, list[tuple]] = {c: [] for c in range(num_classes)}
    for tp in sorted(predictions, key=lambda t: -t.confidence):
        if tp.confidence < min_probability:
            out.skipped += 1
            continue
        cid = tp.best_id
        t0, t1 = tp.range
        conflict = any(not (t1 < a or t0 > b) for a, b in claimed[cid])
        if conflict:
            out.skipped += 1
            continue
        claimed[cid].append((t0, t1))
        out.ranges.setdefault(cid, []).append((t0, t1, tp.fid))
        if cid != tp.fid:
            out.reassigned += 1
    return out


def corrections_to_manual_matches(tracker, corrections: Corrections) -> dict:
    """Translate identity ranges into frame -> {identity: blob_id} manual
    matches (AutomaticMatches / AutoAssign::RangesForID role)."""
    matches: dict[int, dict[int, int]] = {}
    for cid, ranges in corrections.ranges.items():
        for (t0, t1, src_fid) in ranges:
            src = tracker.individuals.get(src_fid)
            if src is None:
                continue
            for f in range(t0, t1 + 1):
                b = src.basic_stuff(f)
                if b is not None:
                    matches.setdefault(f, {})[cid] = b.blob.blob_id
    return matches


def check_tracklets_identities(tracker, settings, network,
                               retrack_fn: Optional[Callable] = None):
    """Full auto-correct: predict -> assign -> manual matches -> retrack.

    retrack_fn(manual_matches) re-runs tracking with the corrections (the
    reference re-tracks in place, Tracker.cpp:3026+); when omitted the
    matches are returned for the caller to apply."""
    preds = predict_tracklets(tracker, settings, network)
    num_classes = network.num_classes
    corrections = assign_identities(
        preds, num_classes,
        min_probability=settings["match_min_probability"])
    matches = corrections_to_manual_matches(tracker, corrections)
    if retrack_fn is not None:
        return retrack_fn(matches), corrections
    return matches, corrections
