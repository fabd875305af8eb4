"""Per-individual archives of the history engines (archive mode).

Counterpart of ``trex_tpu/track/archive.py``. The struct-of-arrays
engines (``track/engine.FastTracker``, ``track/device_engine.
DeviceTracker``) keep only flat per-frame history on the hot path. With
``keep_individuals=True`` they also record each frame's (fish -> blob)
assignments as lean TrackBlobs and the full posture geometry
(``posture_batch_full``), and ``build_individuals`` replays those records
through ``Individual.add``/``add_posture``, the construction the object
Tracker performs inline (Tracker.cpp Individual::add;
TrackingHelper::process_postures), so that the export surfaces see the
same per-individual data whichever engine tracked.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..config import SettingsView
from .blob import TrackBlob
from .individual import Individual, PostureStuff
from .motion import MotionRecord
from .posture import (Midline, calculate_posture,
                      calculate_posture_from_outline,
                      calculate_posture_from_pose, posture_batch,
                      posture_batch_full)


@dataclass
class PostureRec:
    """One (fish, frame) posture record in PostureResult conventions:
    outline crop-local, `off` blob-relative (consumers add blob
    bounds + off)."""
    outline: Optional[np.ndarray]      # (m, 2) float32, crop-local
    seg: Optional[np.ndarray]          # (k, 2) float64 midline points
    heights: Optional[np.ndarray]      # (k,)
    tail: int = 0
    head: int = -1
    inverted: bool = False
    off: tuple = (0.0, 0.0)            # blob-relative crop origin
    len_px: float = 0.0                # midline length in px
    angle: float = 0.0


def build_individuals(tracker) -> dict:
    """Replay an engine's frame/posture archives into Individual
    objects (the object Tracker's per-identity store). Assignments
    replay in frame order through Individual.add (motion-record
    chains, tracklet rules — Individual.cpp:1900-2030), posture
    through the PostureStuff construction of pipeline.run_postures
    (head / posture-centroid motion records, Individual.cpp:1459-1503
    real_point indices)."""
    s = tracker.settings
    cm = s["cm_per_pixel"] or 1.0
    hp = s["posture_head_percentage"]
    inds: dict[int, Individual] = {}
    for frame in sorted(tracker.frame_archive):
        t = tracker.frame_times[frame]
        fids, blobs = tracker.frame_archive[frame]
        # first-pass assignment probabilities feed the archive's
        # track_trusted_probability tracklet break (-1 = unknown:
        # reactivations/creations, like the object Tracker)
        h = tracker.history.get(frame)
        probs = {}
        if h is not None:
            probs = {int(fi): float(p)
                     for fi, p in zip(h["fish"], h["prob"])}
        for fid, blob in zip(fids, blobs):
            ind = inds.get(fid)
            if ind is None:
                ind = inds[fid] = Individual(int(fid), s)
            ind.add(frame, t, blob, prob=probs.get(int(fid), -1.0))
        parch = tracker.posture_archive.get(frame)
        if not parch:
            continue
        for fid, rec in parch:
            ind = inds.get(fid)
            if ind is None:
                continue
            basic = ind.basic_stuff(frame)
            if basic is None:
                continue
            stuff = PostureStuff(frame=frame)
            ox, oy = rec.off
            bx, by = basic.blob.bounds[:2]
            if rec.outline is not None and len(rec.outline):
                stuff.outline = rec.outline + np.array(
                    [bx + ox, by + oy], np.float32)
                stuff.outline_size = len(rec.outline)
            if rec.seg is not None and len(rec.seg):
                ml = Midline(
                    segments=np.asarray(rec.seg, np.float64),
                    heights=np.asarray(rec.heights, np.float64),
                    tail_index=int(rec.tail),
                    head_index=int(rec.head),
                    len=float(rec.len_px), angle=float(rec.angle),
                    inverted_because_previous=bool(rec.inverted),
                    offset=(float(ox), float(oy)))
                stuff.midline = ml
                stuff.midline_length = ml.len * cm
                stuff.midline_angle = ml.angle
                segs = ml.segments
                # head / posture centroid (pipeline.run_postures)
                hi = min(len(segs) - 1, int(round(len(segs) * hp)))
                ci = min(len(segs) // 2, len(segs) - 1)
                off = np.array([bx + ox, by + oy])
                head_pt = segs[hi] + off
                cen_pt = segs[ci] + off
                prev_post = ind.posture[-1] if ind.posture else None
                stuff.head = MotionRecord.create(
                    prev_post.head if prev_post else None,
                    basic.centroid.time, float(head_pt[0]),
                    float(head_pt[1]), ml.angle)
                stuff.centroid_posture = MotionRecord.create(
                    prev_post.centroid_posture if prev_post else None,
                    basic.centroid.time, float(cen_pt[0]),
                    float(cen_pt[1]), ml.angle)
            ind.add_posture(stuff)
    return inds


def posture_recs_from_full(full: dict, order, bounds) -> list:
    """Trimmed PostureRecs from a posture_batch_full output dict for
    the rows listed in `order` (indices into the batch); `bounds` is a
    parallel list of blob (bx, by) origins — the native `off` is the
    GLOBAL crop origin and PostureRec stores it blob-relative. Rows
    with ok=False or trunc=True must be handled by the caller
    (python-chain fallback)."""
    recs = []
    for i, (bx, by) in zip(order, bounds):
        m = int(full["n_outline"][i])
        k = int(full["nseg"][i])
        recs.append(PostureRec(
            outline=np.array(full["outline"][i, :m], np.float32),
            seg=np.array(full["seg"][i, :k]),
            heights=np.array(full["heights"][i, :k]),
            tail=int(full["tail"][i]), head=int(full["head"][i]),
            inverted=bool(full["inverted"][i]),
            off=(float(full["off"][i, 0]) - bx,
                 float(full["off"][i, 1]) - by),
            len_px=float(full["len"][i]),
            angle=float(full["angle"][i])))
    return recs


def posture_python_row(settings, background, lines, pixels, pred,
                       direction):
    """Per-blob python posture with the reference's source precedence
    (pipeline.run_postures: pose keypoints > detection outline >
    pixels)."""
    blob = TrackBlob(np.asarray(lines, np.int32), pixels)
    kp = pred.get("keypoints") if pred else None
    orig = pred.get("original_outline") if pred else None
    if kp is not None and len(np.asarray(kp).reshape(-1, 2)):
        return calculate_posture_from_pose(
            blob, np.asarray(kp, np.float64).reshape(-1, 2)[:, :2],
            settings, movement_direction=direction)
    if orig is not None and len(orig):
        return calculate_posture_from_outline(
            blob, orig, settings, movement_direction=direction)
    return calculate_posture(blob, settings, background,
                             movement_direction=direction)


def compute_posture_rows(settings, background, line_arrays,
                         pixel_arrays, preds, md,
                         want_recs: bool = False):
    """Posture for one frame's assigned rows — the shared core of
    FastTracker._run_posture_batch and DeviceTracker's host posture
    span. Runs the native batch chain (full outputs when want_recs);
    rows with a pose/outline prediction, truncated geometry or native
    failure go through the python per-blob path.

    Returns (ok, lens, angles, out_dirs, recs, dir_reset): summary
    arrays in the native convention (len in raw px), recs a list of
    PostureRec-or-None per row (None when want_recs is False or no
    result), and dir_reset marking outline-only rows whose fish must
    reset the stored movement direction (run_postures reads
    prev.midline, which is None for those)."""
    settings = SettingsView(settings)
    n = len(line_arrays)
    dir_reset = np.zeros(n, bool)
    if want_recs:
        full = posture_batch_full(line_arrays, pixel_arrays,
                                  background, settings,
                                  movement_dirs=md)
        ok = full["ok"].copy()
        lens = full["len"].copy()
        angles = full["angle"].copy()
        out_dirs = full["dir"].copy()
    else:
        full = None
        ok, lens, angles, out_dirs = posture_batch(
            line_arrays, pixel_arrays, background, settings,
            movement_dirs=md)
        ok = np.asarray(ok, bool).copy()
    recs: list = [None] * n
    redo = [i for i in range(n)
            if (preds is not None and preds[i] is not None)]
    if full is not None:
        redo += [i for i in range(n) if i not in redo
                 and (full["trunc"][i] or not full["ok"][i])]
    for i in redo:
        res = posture_python_row(
            settings, background, line_arrays[i], pixel_arrays[i],
            preds[i] if preds is not None else None,
            md[i] if np.any(md[i]) else None)
        if res is None:
            ok[i] = False
            continue
        if res.midline is not None:
            ok[i] = True
            lens[i] = res.midline.len  # raw px, native convention
            angles[i] = res.midline.angle
            out_dirs[i] = res.midline.midline_direction(
                settings["midline_stiff_percentage"])
        else:
            ok[i] = False
            out_dirs[i] = 0.0
            dir_reset[i] = True
        if full is not None:
            recs[i] = rec_from_posture_result(res)
    if full is not None:
        native_rows = [i for i in range(n)
                       if recs[i] is None and i not in redo
                       and full["ok"][i] and not full["trunc"][i]]
        bounds = []
        for i in native_rows:
            L = np.asarray(line_arrays[i])
            bounds.append((int(L[:, 1].min()), int(L[0, 0])))
        for i, rec in zip(native_rows, posture_recs_from_full(
                full, native_rows, bounds)):
            recs[i] = rec
    return ok, lens, angles, out_dirs, recs, dir_reset


def rec_from_posture_result(res) -> Optional[PostureRec]:
    """PostureRec from a python-chain PostureResult (the fallback for
    truncated/failed native rows and prediction-driven posture)."""
    if res is None:
        return None
    ml = res.midline
    return PostureRec(
        outline=None if res.outline is None
        else np.asarray(res.outline, np.float32),
        seg=None if ml is None else np.asarray(ml.segments),
        heights=None if ml is None else np.asarray(ml.heights),
        tail=0 if ml is None else int(ml.tail_index),
        head=-1 if ml is None else int(ml.head_index),
        inverted=False if ml is None
        else bool(ml.inverted_because_previous),
        off=(float(res.offset[0]), float(res.offset[1])),
        len_px=0.0 if ml is None else float(ml.len),
        angle=0.0 if ml is None else float(ml.angle))
