"""Per-individual CSV/NPZ export (counterpart of
``trex_tpu/export/export.py``).

Re-creates ui/Export.cpp:156-700: one file per individual named
`<video>_<prefix><id>.csv/npz` in the data directory, rows over the full
tracked frame range, columns from `output_fields`, values rounded to
`output_csv_decimals`, missing frames rendered as infinity. NPZ output
additionally stores posture arrays and metadata keys
(cm_per_pixel, frame_rate, detect_type, ...).
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from .library import EvalContext, column_title, evaluate


def _fmt(value: float, decimals: int) -> str:
    if math.isinf(value):
        return "inf" if value > 0 else "-inf"
    if math.isnan(value):
        return "nan"
    if decimals <= 0:
        # reference rounds half away from zero (C++ round())
        return str(int(math.floor(value + 0.5)) if value >= 0
                   else -int(math.floor(-value + 0.5)))
    return f"{value:.{decimals}f}"


def _interpolate_positions(rows: np.ndarray, titles: list[str]):
    """output_interpolate_positions: linearly fill missing X/Y and
    SPEED columns between tracked frames (default_config.cpp:1048
    'interpolate X/Y, and SPEED values'; other fields stay invalid)."""
    for c, t in enumerate(titles):
        if not (t.startswith("X") or t.startswith("Y")
                or t.startswith("SPEED")):
            continue
        col = rows[:, c]
        good = np.isfinite(col)
        if good.sum() < 2:
            continue
        idx = np.arange(len(col))
        inner = (idx >= idx[good][0]) & (idx <= idx[good][-1])
        fill = inner & ~good
        col[fill] = np.interp(idx[fill], idx[good], col[good])


def export_data(tracker, settings, output_dir, video_name: str,
                frame_range=None, write_npz: bool = None,
                write_csv: bool = None, pv_file=None) -> list[Path]:
    """Write per-fish data files; returns the list of paths written."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    fields = list(settings["output_fields"] or [])
    # ML-derived columns auto-append when a detection model produced
    # classes (Export.cpp:225-258): detection_p
    # (output_auto_detection_fields) and the keypoint columns
    # (output_auto_pose; named via detect_keypoint_names, else
    # poseX<i>/poseY<i> — default_config.cpp:455-478)
    if settings["detect_classes"]:
        have = {f[0] for f in fields}
        if settings["output_auto_detection_fields"] \
                and "detection_p" not in have:
            fields.append(["detection_p", []])
        kf = settings["detect_keypoint_format"]
        if settings["output_auto_pose"] and kf:
            n_points = int(kf[0] if isinstance(kf, (list, tuple))
                           else kf)
            names = settings["detect_keypoint_names"] or []
            for i in range(n_points):
                nm = names[i] if i < len(names) else None
                xf = f"{nm}_X" if nm else f"poseX{i}"
                yf = f"{nm}_Y" if nm else f"poseY{i}"
                for f_ in (xf, yf):
                    if f_ not in have:
                        fields.append([f_, ["RAW"]])
    annotations = settings["output_annotations"] or {}
    decimals = int(settings["output_csv_decimals"])
    prefix = settings["individual_prefix"] or "fish"
    fmt = settings["output_format"]
    if write_csv is None:
        write_csv = fmt == "csv"
    if write_npz is None:
        write_npz = fmt == "npz"

    if frame_range is None:
        start = tracker.start_frame
        end = tracker.end_frame
    else:
        start, end = frame_range
    ctx = EvalContext(tracker, settings, pv_file=pv_file)
    # the reference emits "frame" first, then fields ASCII-sorted by name
    # (golden CSVs: SPEED,X,blobid,midline_length,num_pixels)
    fields = sorted((list(f) for f in fields if f[0] != "frame"),
                    key=lambda f: (f[0], f[1]))
    titles = ["frame"] + [
        column_title(f, mods, annotations) for f, mods in fields
    ]
    paths = []
    for fid in sorted(tracker.individuals.keys()):
        ind = tracker.individuals[fid]
        rows = np.empty((end - start + 1, len(titles)), np.float64)
        for i, frame in enumerate(range(start, end + 1)):
            rows[i, 0] = frame
            col = 1
            missing = not ind.has(frame)
            for field, mods in fields:
                # (frame entries were filtered out of `fields` above)
                if missing and field not in ("missing",):
                    rows[i, col] = float("inf")
                else:
                    rows[i, col] = evaluate(ctx, ind, frame, field, mods)
                col += 1
        if settings["output_interpolate_positions"]:
            _interpolate_positions(rows, titles)
        if str(settings.get("output_invalid_value", "inf")) == "nan":
            # output_invalid_value: untracked cells print as nan
            rows[np.isinf(rows)] = float("nan")
        name = f"{video_name}_{prefix}{fid}"
        if write_csv:
            path = output_dir / f"{name}.csv"
            with open(path, "w") as f:
                f.write(",".join(titles) + "\n")
                for i, frame in enumerate(range(start, end + 1)):
                    cells = [str(frame)] + [
                        _fmt(rows[i, c], decimals)
                        for c in range(1, len(titles))
                    ]
                    f.write(",".join(cells) + "\n")
            paths.append(path)
        if write_npz:
            path = output_dir / f"{name}.npz"
            arrays = {
                t: rows[:, c] for c, t in enumerate(titles)
            }
            arrays["meta"] = np.array([
                f"cm_per_pixel={settings['cm_per_pixel']}",
                f"frame_rate={settings['frame_rate']}",
                f"detect_type={settings['detect_type']}",
            ])
            np.savez(path, **arrays)
            paths.append(path)
    return paths


def export_posture(tracker, settings, output_dir, video_name: str) -> list[Path]:
    """Posture NPZ per fish (ui/Export.cpp:563-640 layout):
    frames, offsets, midline lengths/offsets/angles, outline points."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    prefix = settings["individual_prefix"] or "fish"
    # output_normalize_midline_data: export the canonical-pose,
    # fixed-scale midline (Individual::fixed_midline) instead of the
    # raw blob-local segments, so points align across frames
    do_normalize = bool(settings["output_normalize_midline_data"])
    resolution = int(settings["midline_resolution"] or 25)
    paths = []
    for fid, ind in sorted(tracker.individuals.items()):
        fix_len = 0.0
        if do_normalize:
            ls = [p.midline_length for p in ind.posture
                  if np.isfinite(p.midline_length)]
            fix_len = float(np.median(ls)) if ls else 0.0
        frames, lengths, angles = [], [], []
        outline_points, outline_lengths = [], []
        midline_points, midline_lengths = [], []
        offsets = []
        for p in ind.posture:
            frames.append(p.frame)
            lengths.append(p.midline_length)
            angles.append(p.midline_angle)
            pts = p.outline if p.outline is not None else np.zeros((0, 2))
            outline_points.append(np.asarray(pts, np.float32))
            outline_lengths.append(len(pts))
            mseg = np.zeros((0, 2), np.float32)
            if p.midline is not None:
                if do_normalize:
                    from ..track.posture import fixed_midline_points

                    fixed = fixed_midline_points(p.midline, fix_len,
                                                 resolution)
                    if fixed is not None:
                        mseg = fixed
                else:
                    mseg = np.asarray(p.midline.segments, np.float32)
            midline_points.append(mseg)
            midline_lengths.append(len(mseg))
            b = ind.basic_stuff(p.frame)
            offsets.append(b.blob.bounds[:2] if b else (0, 0))
        if not frames:
            continue
        path = output_dir / f"{video_name}_posture_{prefix}{fid}.npz"
        np.savez(
            path,
            frames=np.asarray(frames, np.int64),
            midline_lengths=np.asarray(lengths, np.float32),
            midline_angles=np.asarray(angles, np.float32),
            offset=np.asarray(offsets, np.float32),
            outline_lengths=np.asarray(outline_lengths, np.int64),
            outline_points=(np.concatenate(outline_points)
                            if outline_points else np.zeros((0, 2), np.float32)),
            midline_lengths_points=np.asarray(midline_lengths, np.int64),
            midline_points=(np.concatenate(midline_points)
                            if midline_points else np.zeros((0, 2), np.float32)),
        )
        paths.append(path)
    return paths


def export_recognition(tracker, settings, output_dir,
                       video_name: str) -> list[Path]:
    """Per-fish recognition NPZ (`output_recognition_data`,
    ui/Export.cpp:561-588): for every frame where the fish's assigned
    blob has a stored prediction (tracker.predicted: frame ->
    {blob_id: class probabilities}), one probs row — arrays `frames`
    (n,) and `probs` (n, n_classes)."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    prefix = settings["individual_prefix"] or "fish"
    predicted = getattr(tracker, "predicted", {}) or {}
    paths = []
    for fid, ind in sorted(tracker.individuals.items()):
        frames, probs = [], []
        for b in ind.basic:
            preds = predicted.get(b.frame)
            if not preds:
                continue
            p = preds.get(b.blob.blob_id)
            if p is None:
                continue
            frames.append(b.frame)
            probs.append(np.asarray(p, np.float32))
        if not frames:
            continue
        path = output_dir / f"{video_name}_recognition_{prefix}{fid}.npz"
        np.savez(path, frames=np.asarray(frames, np.int64),
                 probs=np.stack(probs))
        paths.append(path)
    return paths


# the reference's track::Statistics POD: 16 floats per frame, unset
# entries infinity (core/TrackingSettings.h:270-291)
_STAT_FIELDS = (
    "adding_seconds", "combined_posture_seconds", "number_fish",
    "loading_seconds", "posture_seconds", "match_number_fish",
    "match_number_blob", "match_number_edges", "match_stack_objects",
    "match_max_edges_per_blob", "match_max_edges_per_fish",
    "match_mean_edges_per_blob", "match_mean_edges_per_fish",
    "match_improvements_made", "match_leafs_visited", "method_used")


def export_statistics(tracker, settings, output_dir,
                      video_name: str) -> list[Path]:
    """`output_statistics` (ui/Export.cpp:819-900): per-frame tracking
    statistics in the reference's 16-float track::Statistics layout
    (`stats` (n, 16) + `frames`), plus `<name>_memory.npz` with the
    per-individual memory breakdown unless auto_no_memory_stats."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    frames = sorted(tracker.statistics)
    stats = np.full((len(frames), len(_STAT_FIELDS)), np.inf,
                    np.float32)
    col = {n: i for i, n in enumerate(_STAT_FIELDS)}
    for i, f in enumerate(frames):
        st = tracker.statistics[f]
        stats[i, col["adding_seconds"]] = st.adding_seconds
        stats[i, col["number_fish"]] = st.number_fish
        stats[i, col["loading_seconds"]] = st.loading_seconds
        stats[i, col["posture_seconds"]] = st.posture_seconds
        stats[i, col["match_improvements_made"]] = \
            st.match_improvements
    path = output_dir / f"{video_name}_statistics.npz"
    np.savez(path, stats=stats, frames=np.asarray(frames, np.int64))
    paths = [path]
    if not settings["auto_no_memory_stats"]:
        from ..utils.memstats import (individual_memory_stats,
                                      tracker_memory_stats)

        overall = tracker_memory_stats(tracker)
        ids = [-1]
        sizes: dict[str, list] = {k: [v] for k, v in
                                  sorted(overall.sizes.items())}
        for fid, ind in sorted(tracker.individuals.items()):
            st = individual_memory_stats(ind)
            ids.append(fid)
            for k in sizes:
                sizes[k].append(st.sizes.get(k, 0))
        mpath = output_dir / f"{video_name}_memory.npz"
        np.savez(mpath, id=np.asarray(ids, np.int64),
                 **{k: np.asarray(v, np.uint64)
                    for k, v in sizes.items()})
        paths.append(mpath)
    return paths


def export_tracklet_images(tracker, settings, output_dir,
                           video_name: str) -> list[Path]:
    """`output_tracklet_images` (ui/Export.cpp:479-530, 1240-1380):
    one median normalized image per sufficiently long tracklet, all in
    `<name>_tracklet_images.npz` (`images` (N, h, w) + `meta` (N, 3) =
    [id, start, end]); with tracklet_max_images == 0 additionally
    every sampled frame image in
    `<name>_tracklet_images_single_part0.npz`
    (`images`/`frames`/`ids`)."""
    import math as _math

    from ..ops.crops import normalized_crop

    s = settings
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    size = s["individual_image_size"]
    tw, th = int(size[0]), int(size[1])
    min_frames = int(s["output_min_frames"])
    max_images = int(s["tracklet_max_images"])
    medians, meta = [], []
    singles, single_frames, single_ids = [], [], []
    for fid, ind in sorted(tracker.individuals.items()):
        lengths = [p.midline_length for p in ind.posture
                   if not _math.isnan(p.midline_length)]
        med_len = float(np.median(lengths)) if lengths else None
        for t0, t1 in ind.tracklets:
            if t1 - t0 + 1 < min_frames:
                continue
            frames = list(range(t0, t1 + 1))
            if max_images and len(frames) > max_images:
                step = len(frames) // max_images
                frames = frames[::step][:max_images]
            imgs = []
            for f in frames:
                b = ind.basic_stuff(f)
                if b is None or b.blob.pixels is None:
                    continue
                post = ind.posture_stuff(f)
                # tracklet_normalize=false: plain un-rotated crops
                # (Export.cpp do_normalize_tracklets gate)
                img = normalized_crop(
                    b.blob, tracker.background, s,
                    midline=post.midline if post else None,
                    median_midline_length=med_len,
                    mode=None if s["tracklet_normalize"] else "none",
                    # tracklet_force_normal_color (default): crops
                    # keep the original-video grey appearance instead
                    # of the background-difference image
                    raw=bool(s["tracklet_force_normal_color"]))
                imgs.append(img)
                if max_images == 0:
                    singles.append(img)
                    single_frames.append(f)
                    single_ids.append(fid)
            if len(imgs) > 1:
                medians.append(np.median(np.stack(imgs), axis=0)
                               .astype(np.uint8))
                meta.append((fid, t0, t1))
    paths = []
    path = output_dir / f"{video_name}_tracklet_images.npz"
    np.savez(path,
             images=(np.stack(medians) if medians
                     else np.zeros((0, th, tw), np.uint8)),
             meta=np.asarray(meta, np.int64).reshape(-1, 3))
    paths.append(path)
    if max_images == 0 and singles:
        spath = output_dir / \
            f"{video_name}_tracklet_images_single_part0.npz"
        np.savez(spath, images=np.stack(singles),
                 frames=np.asarray(single_frames, np.int64),
                 ids=np.asarray(single_ids, np.int64))
        paths.append(spath)
    return paths
