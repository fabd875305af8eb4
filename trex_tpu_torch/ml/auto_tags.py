"""Identity auto-correction from physical-tag detections (`auto_tags`).

Counterpart of ``trex_tpu/ml/auto_tags.py``, on the port's
``ml/auto_correct.py``; host code.

The reference's auto_tags flow (TrackingState.cpp:899, gated on -load
at TrackingState.cpp:112-120 because the tag detections live in the
results file written during conversion) applies stored tag information
as identity ground truth and corrects tracking mistakes from it — the
tag analog of check_tracklets_identities.

This module reuses the auto-correct machinery: every (individual,
tracklet) accumulates weighted votes from tag detections whose blob id
matches the individual's blob in that frame; the vote matrix feeds the
same greedy conflict-free assignment and manual-match materialization.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from .auto_correct import (TrackletPrediction,
                           assign_identities,
                           corrections_to_manual_matches)


def tag_tracklet_predictions(tracker, tags: dict,
                             num_tags: Optional[int] = None
                             ) -> list[TrackletPrediction]:
    """Build per-tracklet tag-vote predictions.

    tags: {tag_id: {frame: (blob_id, p)}} — the .results tags block
    (export/results_binary.ResultsFile.tags) or
    Tracker.tag_assignments re-keyed.
    """
    if num_tags is None:
        num_tags = (max(tags) + 1) if tags else 0
    if not num_tags:
        return []
    # frame -> blob_id -> (tag_id, p)
    by_frame: dict[int, dict[int, tuple]] = {}
    for tid, dets in tags.items():
        for f, (bid, p) in dets.items():
            per = by_frame.setdefault(int(f), {})
            prev = per.get(int(bid))
            # several tags claiming one blob: the most confident wins
            if prev is None or float(p) > prev[1]:
                per[int(bid)] = (int(tid), float(p))
    out = []
    for fid, ind in sorted(tracker.individuals.items()):
        for (t0, t1) in ind.tracklets:
            votes = np.zeros(num_tags)
            n = 0
            for f in range(t0, t1 + 1):
                per = by_frame.get(f)
                if not per:
                    continue
                b = ind.basic_stuff(f)
                if b is None:
                    continue
                hit = per.get(int(b.blob.blob_id))
                if hit is None:
                    # detections may reference the parent blob
                    parent = getattr(b.blob, "parent_id", None)
                    if parent is not None:
                        hit = per.get(int(parent))
                if hit is not None:
                    votes[hit[0]] += hit[1]
                    n += 1
            if n and votes.sum() > 0:
                out.append(TrackletPrediction(
                    fid=fid, range=(t0, t1),
                    probs=votes / votes.sum(), samples=n))
    return out


def apply_tags(tracker, settings, tags: dict,
               retrack_fn: Optional[Callable] = None):
    """auto_tags: tag votes -> conflict-free identity ranges -> manual
    matches (-> retrack when a retrack_fn is given)."""
    preds = tag_tracklet_predictions(tracker, tags)
    num_tags = (max(tags) + 1) if tags else 0
    corrections = assign_identities(
        preds, num_tags,
        min_probability=settings["match_min_probability"])
    matches = corrections_to_manual_matches(tracker, corrections)
    if retrack_fn is not None:
        return retrack_fn(matches), corrections
    return matches, corrections
