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
    """`output_recognition_data`: the per-fish class probabilities of
    the visual identification, which the port does not have yet."""
    raise NotImplementedError(
        "output_recognition_data: export_recognition comes with the "
        "visual-identification slice (ROADMAP.md A item 3)")


def export_statistics(tracker, settings, output_dir,
                      video_name: str) -> list[Path]:
    """`output_statistics`: per-frame statistics and the memory
    breakdown of `utils/memstats.py`, which the port does not have
    yet."""
    raise NotImplementedError(
        "output_statistics: export_statistics and utils/memstats.py are "
        "not ported yet (ROADMAP.md A item 1)")


def export_tracklet_images(tracker, settings, output_dir,
                           video_name: str) -> list[Path]:
    """`output_tracklet_images`: normalized crops per tracklet, which
    need `ops/crops.py`."""
    raise NotImplementedError(
        "output_tracklet_images: export_tracklet_images needs "
        "ops/crops.py (ROADMAP.md A item 3)")
