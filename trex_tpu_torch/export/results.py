"""`.results` checkpoint: full tracker state save/restore.

Role of the reference's Output::TrackingResults (tracking/Output.h:85-228,
versioned binary V_1..V_39). Two on-disk formats:

- the reference's binary format (results_binary.py, default for writes;
  reads V_18+) — files are interchangeable with the reference app,
- an NPZ container (magic "TREXTPU_RESULTS") kept as a fallback reader
  for checkpoints written by earlier trex_tpu versions.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from . import results_binary as rb

FORMAT_VERSION = 1


def save_results(tracker, settings, path, format: str = "binary") -> Path:
    if format == "binary":
        return save_results_binary(tracker, settings, path)
    return _save_results_npz(tracker, settings, path)


def save_results_binary(tracker, settings, path) -> Path:
    """Write the reference's V_39 binary layout (results_binary.py)."""
    from ..config.settings_io import settings_to_text

    path = Path(path)
    res = rb.ResultsFile()
    bg = getattr(tracker, "background", None)
    if bg is not None:
        res.average = np.ascontiguousarray(bg, np.uint8)
        res.video_resolution = (bg.shape[1], bg.shape[0])
    res.video_length = (tracker.end_frame + 1) if tracker.end_frame >= 0 \
        else 0
    res.settings = settings_to_text(settings)
    # one pass over each individual's frames buckets the active ids;
    # per-frame ind.has() scans are O(frames x individuals) twice over
    active: dict[int, list] = {}
    for ind in tracker.individuals.values():
        for f in ind._frames:
            active.setdefault(int(f), []).append(ind.identity)
    res.frame_properties = [
        (int(f), int(round(t * 1e6)), len(active.get(int(f), ())))
        for f, t in sorted(tracker.frame_times.items())
    ]
    for f, _, _ in res.frame_properties:
        res.active[f] = active.get(f, [])
    for fid in sorted(tracker.individuals):
        ind = tracker.individuals[fid]
        r = rb.ResultsIndividual(id=fid, name=f"fish{fid}")
        n = len(ind.basic)
        r.frames = np.array([b.frame for b in ind.basic], np.int64)
        r.positions = np.array(
            [[b.centroid.x, b.centroid.y] for b in ind.basic],
            np.float32).reshape(n, 2)
        r.angles = np.array([b.centroid.angle for b in ind.basic],
                            np.float32)
        for b in ind.basic:
            blob = b.blob
            flags = 0x1 if getattr(blob, "split", False) else 0
            parent = getattr(blob, "parent_id", None)
            r.blobs.append(rb.ResultsBlob(
                lines=np.asarray(blob.lines, np.int32), flags=flags,
                parent_id=int(parent) if parent is not None else -1))
            r.thresholded_size[b.frame] = int(b.thresholded_size or 0)
        for p in ind.posture:
            ml = getattr(p, "midline", None)
            if ml is not None and not ml.empty:
                seg = np.asarray(ml.segments, np.float64)
                hts = np.asarray(ml.heights, np.float64)
                if hts.size != len(seg):
                    hts = np.zeros(len(seg))
                r.midlines[p.frame] = rb.ResultsMidline(
                    len=float(ml.len), angle=float(ml.angle),
                    offset=tuple(map(float, ml.offset)),
                    tail_index=int(ml.tail_index),
                    head_index=int(ml.head_index),
                    segments=np.column_stack(
                        [hts, hts * 0.5, seg[:, 0], seg[:, 1]]
                    ).astype(np.float32))
            if p.outline is not None and len(p.outline):
                pts = np.asarray(p.outline, np.float64)
                first = pts[0]
                # MinimalOutline: deltas packed (int8 dx, int8 dy) per
                # point at unit scale (Output.cpp read_outline V_38)
                deltas = np.diff(pts, axis=0)
                scale = max(1.0, float(np.abs(deltas).max() / 127.0)) \
                    if len(deltas) else 1.0
                q = np.clip(np.round(deltas / scale), -128, 127) \
                    .astype(np.int8)
                packed = ((q[:, 0].astype(np.uint16) << 8)
                          | (q[:, 1].astype(np.uint16) & 0xFF))
                r.outlines[p.frame] = rb.ResultsOutline(
                    first=tuple(map(float, first)), points=packed,
                    scale=float(scale))
        res.individuals.append(r)
    store = getattr(tracker, "category_store", None)
    if store is not None and store.labeled_ranges():
        from ..track.blob import blob_id_from_lines

        ranged = []
        for rl in store.labeled_ranges():
            ind = tracker.individuals.get(rl.fid)
            bids = []
            if ind is not None:
                for f in range(rl.start, rl.end + 1):
                    b = ind.basic_stuff(f)
                    bids.append(int(blob_id_from_lines(np.asarray(
                        b.blob.lines, np.int32))) if b else 0)
            else:
                bids = [0] * (rl.end - rl.start + 1)
            ranged.append((rl.start, rl.end, rl.label, bids))
        res.categorize = {"labels": list(store.categories),
                          "probs": {}, "ranged": ranged}
    # physical-tag detections (reference: TGrabs stores these so TRex's
    # auto_tags can replay them after -load, TrackingState.cpp:112-120):
    # tag_id -> {frame: (blob id of the matched fish's blob, p)}
    for f, per in sorted(getattr(tracker, "tag_assignments", {}).items()):
        for fid, tag_id in per.items():
            ind = tracker.individuals.get(fid)
            b = ind.basic_stuff(f) if ind is not None else None
            if b is None:
                continue
            res.tags.setdefault(int(tag_id), {})[int(f)] = (
                int(b.blob.blob_id), 1.0)
    rb.write_results(path, res)
    return path


def load_results_binary(tracker, path):
    """Restore tracker state from a reference-binary .results file.

    Positions/angles/masks come from the file; velocities, tracklets
    and frame caches are rebuilt through the normal Individual.add path
    (the reference also recomputes derivatives on load,
    Output.cpp:1058 'Derivates etc. can be calculated after loading')."""
    from ..track.blob import TrackBlob
    from ..track.individual import BasicStuff, Individual, PostureStuff
    from ..track.motion import MotionRecord

    res = rb.read_results(path)
    tracker.frame_times = {
        f: ts * 1e-6 for f, ts, _ in res.frame_properties}
    frames_sorted = sorted(tracker.frame_times)
    tracker.start_frame = frames_sorted[0] if frames_sorted else -1
    tracker.end_frame = frames_sorted[-1] if frames_sorted else -1
    for r in res.individuals:
        ind = Individual(r.id, tracker.settings)
        for i, f in enumerate(r.frames):
            f = int(f)
            blob = TrackBlob(np.asarray(r.blobs[i].lines, np.int32), None,
                             split=bool(r.blobs[i].flags & 0x1))
            if r.blobs[i].parent_id >= 0:
                blob.parent_id = r.blobs[i].parent_id
            t = tracker.frame_times.get(f, f / 25.0)
            x = float(r.positions[i, 0])
            y = float(r.positions[i, 1])
            prev = ind.basic[-1].centroid if ind.basic else None
            rec = MotionRecord.create(prev, t, x, y, float(r.angles[i]))
            stuff = BasicStuff(frame=f, blob=blob, centroid=rec,
                               thresholded_size=int(
                                   r.thresholded_size.get(f, 0)))
            ind._frames[f] = len(ind.basic)
            ind.basic.append(stuff)
            ind._win[:-1] = ind._win[1:]
            ind._win[-1] = (f, x, y, t)
            ind._update_tracklets(f, t)
        # posture: midlines and packed outlines round-trip
        # (Output.cpp read_midline/read_outline; export columns and
        # Accumulation's median midline length need these after -load)
        from ..track.posture import Midline

        for f, rm in r.midlines.items():
            seg = np.asarray(rm.segments, np.float64)
            ml = Midline(
                segments=seg[:, 2:4] if seg.ndim == 2 and
                seg.shape[1] >= 4 else np.zeros((0, 2)),
                heights=seg[:, 0] if seg.ndim == 2 and seg.size
                else np.zeros(0),
                tail_index=int(rm.tail_index),
                head_index=int(rm.head_index),
                len=float(rm.len), angle=float(rm.angle),
                offset=tuple(rm.offset))
            outline = None
            ro = r.outlines.get(f)
            if ro is not None and len(ro.points):
                q = np.asarray(ro.points, np.uint16)
                dx = (q >> 8).astype(np.int8).astype(np.float64)
                dy = (q & 0xFF).astype(np.int8).astype(np.float64)
                deltas = np.column_stack([dx, dy]) * float(ro.scale)
                outline = np.concatenate(
                    [[ro.first], np.asarray(ro.first)
                     + np.cumsum(deltas, axis=0)]).astype(np.float32)
            ind.add_posture(PostureStuff(
                frame=int(f), outline=outline, midline=ml,
                midline_length=float(rm.len),
                midline_angle=float(rm.angle),
                outline_size=0 if outline is None else len(outline)))
        tracker.individuals[r.id] = ind
        tracker.active.add(r.id)
        tracker._next_id = max(tracker._next_id, r.id + 1)
    if res.categorize:
        # rebuild the Categorize DataStore so `category` export fields
        # resolve after -load (TrackingState::load_state reads the
        # DataStore block alongside the individuals)
        from ..ml.categorize import DataStore
        from ..track.blob import blob_id_from_lines

        store = DataStore(res.categorize["labels"])
        # ranged labels key on per-frame blob ids; the export lookup
        # keys on (frame, individual) — resolve each range to the
        # individual that owns its first blob id
        bid_owner: dict[tuple, int] = {}
        for r2 in res.individuals:
            for i, f in enumerate(r2.frames):
                bid_owner[(int(f), int(blob_id_from_lines(
                    np.asarray(r2.blobs[i].lines, np.int32))))] = r2.id
        for s_, e_, lbl, bids in res.categorize["ranged"]:
            # the save side stores 0 for frames where the individual
            # had no blob — resolve via the first frame that has one
            owner = None
            for k, bid in enumerate(bids or ()):
                if bid:
                    if owner is None:
                        owner = bid_owner.get((s_ + k, int(bid)))
                    # blob-level index: the matching veto
                    # (track_consistent_categories) queries labels by
                    # (frame, blob id), exactly what the file stores
                    store.set_blob_label(s_ + k, int(bid), int(lbl))
            if owner is not None:
                store.set_ranged_label(owner, s_, e_, int(lbl))
        tracker.category_store = store
    # loaded tag detections feed ml.auto_tags.apply_tags (the reference
    # only allows auto_tags after -load for the same reason,
    # TrackingState.cpp:112-120)
    tracker.loaded_tags = res.tags
    return tracker


def _save_results_npz(tracker, settings, path) -> Path:
    path = Path(path)
    arrays = {
        "__magic__": np.array(["TREXTPU_RESULTS"]),
        "__version__": np.array([FORMAT_VERSION]),
        "start_frame": np.array([tracker.start_frame]),
        "end_frame": np.array([tracker.end_frame]),
        "frame_times_keys": np.array(sorted(tracker.frame_times.keys()),
                                     np.int64),
        "frame_times_vals": np.array(
            [tracker.frame_times[k] for k in sorted(tracker.frame_times)],
            np.float64),
        "settings_json": np.array([json.dumps(
            settings.to_dict(only_non_default=True), default=str)]),
        "ids": np.array(sorted(tracker.individuals.keys()), np.int64),
    }
    for fid, ind in tracker.individuals.items():
        frames = np.array([b.frame for b in ind.basic], np.int64)
        pos = np.array([[b.centroid.x, b.centroid.y] for b in ind.basic],
                       np.float64).reshape(-1, 2)
        vel = np.array([[b.centroid.vx, b.centroid.vy] for b in ind.basic],
                       np.float64).reshape(-1, 2)
        angles = np.array([b.centroid.angle for b in ind.basic], np.float64)
        times = np.array([b.centroid.time for b in ind.basic], np.float64)
        npx = np.array([b.blob.num_pixels for b in ind.basic], np.int64)
        bids = np.array([b.blob.blob_id for b in ind.basic], np.int64)
        # blob masks: concatenated lines with per-frame offsets
        line_counts = np.array([len(b.blob.lines) for b in ind.basic],
                               np.int64)
        all_lines = (np.concatenate([b.blob.lines for b in ind.basic])
                     if ind.basic else np.zeros((0, 3), np.int32))
        pre = f"ind{fid}_"
        arrays[pre + "frames"] = frames
        arrays[pre + "pos"] = pos
        arrays[pre + "vel"] = vel
        arrays[pre + "angles"] = angles
        arrays[pre + "times"] = times
        arrays[pre + "num_pixels"] = npx
        arrays[pre + "blob_ids"] = bids
        arrays[pre + "line_counts"] = line_counts
        arrays[pre + "lines"] = all_lines
        arrays[pre + "tracklets"] = np.array(ind.tracklets, np.int64) \
            .reshape(-1, 2)
        pf = np.array([p.frame for p in ind.posture], np.int64)
        arrays[pre + "posture_frames"] = pf
        arrays[pre + "midline_lengths"] = np.array(
            [p.midline_length for p in ind.posture], np.float64)
        arrays[pre + "midline_angles"] = np.array(
            [p.midline_angle for p in ind.posture], np.float64)
    # savez appends ".npz" to bare names; write via a file object so the
    # checkpoint keeps the .results extension
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)
    return path


def load_results(tracker, path):
    """Restore tracker state; auto-detects the reference binary format
    (u32-length-prefixed "TRACK<v>" magic) vs the NPZ container (zip)."""
    with open(path, "rb") as f:
        head = f.read(16)
    if len(head) >= 9 and head[4:9] == b"TRACK":
        return load_results_binary(tracker, path)
    return _load_results_npz(tracker, path)


def _load_results_npz(tracker, path):
    """Restore individuals into `tracker` (positions/tracklets/posture
    summaries; pixel masks are restored as line-only blobs)."""
    from ..track.blob import TrackBlob
    from ..track.individual import BasicStuff, Individual, PostureStuff
    from ..track.motion import MotionRecord

    path = Path(path)
    with np.load(path, allow_pickle=False) as data:
        magic = str(data["__magic__"][0])
        if magic != "TREXTPU_RESULTS":
            raise ValueError(f"{path}: not a trex_tpu results file")
        version = int(data["__version__"][0])
        if version > FORMAT_VERSION:
            raise ValueError(f"{path}: unknown results version {version}")
        tracker.start_frame = int(data["start_frame"][0])
        tracker.end_frame = int(data["end_frame"][0])
        keys = data["frame_times_keys"]
        vals = data["frame_times_vals"]
        tracker.frame_times = {int(k): float(v) for k, v in zip(keys, vals)}
        for fid in data["ids"]:
            fid = int(fid)
            pre = f"ind{fid}_"
            ind = Individual(fid, tracker.settings)
            frames = data[pre + "frames"]
            pos = data[pre + "pos"]
            vel = data[pre + "vel"]
            angles = data[pre + "angles"]
            times = data[pre + "times"]
            npx = data[pre + "num_pixels"]
            line_counts = data[pre + "line_counts"]
            lines = data[pre + "lines"]
            off = 0
            for i, f in enumerate(frames):
                n = int(line_counts[i])
                blob = TrackBlob(lines[off : off + n], None)
                off += n
                rec = MotionRecord(time=float(times[i]), x=float(pos[i, 0]),
                                   y=float(pos[i, 1]),
                                   angle=float(angles[i]),
                                   vx=float(vel[i, 0]), vy=float(vel[i, 1]))
                stuff = BasicStuff(frame=int(f), blob=blob, centroid=rec,
                                   thresholded_size=int(npx[i]))
                ind._frames[int(f)] = len(ind.basic)
                ind.basic.append(stuff)
            ind.tracklets = [list(t) for t in data[pre + "tracklets"]]
            for i, f in enumerate(data[pre + "posture_frames"]):
                p = PostureStuff(
                    frame=int(f),
                    midline_length=float(data[pre + "midline_lengths"][i]),
                    midline_angle=float(data[pre + "midline_angles"][i]))
                ind.add_posture(p)
            tracker.individuals[fid] = ind
            tracker.active.add(fid)
            tracker._next_id = max(tracker._next_id, fid + 1)
    return tracker
