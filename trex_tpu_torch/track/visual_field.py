"""Visual fields: eye placement, outline tesselation and the projection.

Counterpart of ``trex_tpu/track/visual_field.py`` (the reference's
VisualField::generate_eyes and calculate, tracking/VisualField.cpp:
203-330): eyes sit at the midline segment that
`visual_field_eye_offset` selects, displaced perpendicular to the
midline out to the outline; their view directions are the midline
direction rotated by +/- `visual_field_eye_separation` / 2. Outlines are
tesselated to <= 5 px spacing and projected in one batch on the card
(``ops/raycast.py``); `visual_field_shapes` enter as view-blocking
convex hulls, the port's own :func:`convex_hull` in place of OpenCV's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops.raycast import FIELD_RESOLUTION, visual_field


def tesselate_outline(points: np.ndarray,
                      max_distance: float = 5.0) -> np.ndarray:
    """Insert points so adjacent outline points are <= max_distance apart
    (VisualField::tesselate_outline). Edge i runs from point i to point
    i+1 (closing back to 0); an edge of length d > max_distance gets the
    k-1 points p0 + (p1 - p0) * (j / k), k = ceil(d / max_distance), in
    the points' own arithmetic (float32 for float32 outlines)."""
    if len(points) < 2:
        return points
    p0 = np.asarray(points)
    diff = np.roll(p0, -1, axis=0) - p0
    d = np.hypot(diff[:, 0], diff[:, 1]).astype(np.float64)
    k = np.where(d > max_distance,
                 np.ceil(d / max_distance), 1).astype(np.int64)
    # per inserted point: its edge and its fraction j / k, a float64
    # division rounded to the arithmetic's type as a python float is
    edge = np.repeat(np.arange(len(p0)), k)
    start = np.cumsum(k) - k
    j = np.arange(len(edge)) - start[edge]
    wt = (diff[:1] * 1.0).dtype
    frac = (j / k[edge]).astype(wt)
    out = p0[edge] + diff[edge] * frac[:, None]
    out[j == 0] = p0[edge[j == 0]]
    return out.astype(np.float32)


def _unit(x: np.float32, y: np.float32) -> tuple:
    """(x, y) / |(x, y)| as OpenCV 5's hull normalises an edge: the norm
    in double, each component times its reciprocal rounded to float32
    (0 for a zero edge)."""
    xd, yd = float(x), float(y)
    n = math.sqrt(xd * xd + yd * yd)
    inv = 1.0 / n if n != 0 else 0.0
    return np.float32(xd * inv), np.float32(yd * inv)


def _sklansky(pts: np.ndarray, start: int, end: int, nsign: int,
              sign2: int) -> list[int]:
    """One quarter of the hull over the x-sorted float32 points, as
    OpenCV 5's Sklansky_ walks it (modules/geometry/src/convhull.cpp):
    indexes into `pts`, from `start` toward `end` (inclusive). A turn's
    convexity is the cross product, in double, of the two edges
    normalised to float32 unit vectors."""
    incr = 1 if end > start else -1
    if start == end or (pts[start, 0] == pts[end, 0]
                        and pts[start, 1] == pts[end, 1]):
        return [start]
    pprev, pcur, pnext = start, start + incr, start + 2 * incr
    stack = [pprev, pcur, pnext]
    end += incr
    while pnext != end:
        cury = pts[pcur, 1]
        by = pts[pnext, 1] - cury
        if int(np.sign(by)) != nsign:
            ax, ay = _unit(pts[pcur, 0] - pts[pprev, 0],
                           cury - pts[pprev, 1])
            bx, by = _unit(pts[pnext, 0] - pts[pcur, 0], by)
            convexity = float(ay) * float(bx) - float(ax) * float(by)
            if int(np.sign(convexity)) == sign2 and (ax != 0 or ay != 0):
                pprev, pcur = pcur, pnext
                pnext += incr
                stack.append(pnext)
            elif pprev == start:
                pcur = pnext
                stack[1] = pcur
                pnext += incr
                stack[2] = pnext
            else:
                stack[-2] = pnext
                pcur = pprev
                pprev = stack[-4]
                stack.pop()
        else:
            pnext += incr
            stack[-1] = pnext
    return stack[:-1]


def convex_hull(points) -> np.ndarray:
    """The convex hull of (N, 2) float32 points as ``cv2.convexHull``
    returns it (counter-clockwise in image coordinates, returnPoints):
    the same vertices in the same order from the same first vertex,
    collinear, duplicate and degenerate inputs included. Sklansky's scan
    over the points sorted by (x, y, input index), upper and lower
    halves, then OpenCV's cyclic shift that makes the input indexes
    ascend or descend where it can. Returns (M, 2) float32, empty where
    OpenCV returns no hull (two points equal but for a zero's sign)."""
    data = np.ascontiguousarray(points, np.float32).reshape(-1, 2)
    total = len(data)
    if total == 0:
        return data.copy()
    order = np.lexsort((np.arange(total), data[:, 1], data[:, 0]))
    pts = data[order]
    # OpenCV compares two points for equality through integer pointers
    # here and below, so on float input by their bits (0.0 != -0.0)
    bits = pts.view(np.int32)
    ys = pts[:, 1]
    miny = maxy = 0
    for i in range(1, total):
        if ys[miny] > ys[i]:
            miny = i
        if ys[maxy] < ys[i]:
            maxy = i
    if (bits[0] == bits[-1]).all():
        hull = [int(order[0])]
    else:
        # upper half; counter-clockwise swaps the two walks
        tl = _sklansky(pts, 0, maxy, -1, 1)
        tr = _sklansky(pts, total - 1, maxy, -1, -1)
        tl, tr = tr, tl
        hull = [int(order[i]) for i in tl[:-1]] \
            + [int(order[tr[i]]) for i in range(len(tr) - 1, 0, -1)]
        stop = tr[1] if len(tr) > 2 else tl[-2] if len(tl) > 2 else -1
        # lower half
        bl = _sklansky(pts, 0, miny, 1, -1)
        br = _sklansky(pts, total - 1, miny, 1, 1)
        if stop >= 0:
            nb = len(bl)
            check = bl[1] if nb > 2 else \
                br[2 - nb] if nb + len(br) > 2 else -1
            if check == stop or (check >= 0
                                 and (bits[check] == bits[stop]).all()):
                # all points on one line: the lower half mirrors the
                # upper (but for the extreme points)
                bl, br = bl[:2], br[:2]
        hull += [int(order[i]) for i in bl[:-1]] \
            + [int(order[br[i]]) for i in range(len(br) - 1, 0, -1)]
        hull = _ascending_shift(hull)
    return data[np.asarray(hull, np.int64)].copy()


def _ascending_shift(h: list[int]) -> list[int]:
    """OpenCV's cyclic shift of the hull's input indexes into an
    ascending or descending run where one exists."""
    n = len(h)
    if n < 3:
        return h
    min_i = max_i = lt = 0
    for i in range(1, n):
        lt += h[i - 1] < h[i]
        if 1 < lt <= i - 2:
            break
        if h[i] < h[min_i]:
            min_i = i
        if h[i] > h[max_i]:
            max_i = i
    mm = abs(max_i - min_i)
    if not ((mm == 1 or mm == n - 1) and (lt <= 1 or lt >= n - 2)):
        return h
    ascending = (max_i + 1) % n == min_i
    i0 = min_i if ascending else max_i
    if i0 == 0:
        return h
    out = []
    j = i0
    for i in range(n):
        cur = h[j]
        out.append(cur)
        nj = j + 1 if j + 1 < n else 0
        if i < n - 1 and ascending != (cur < h[nj]):
            return h
        j = nj
    return out


@dataclass
class EyeSet:
    pos: np.ndarray  # (2, 2)
    angle: np.ndarray  # (2,)


def generate_eyes(ind, frame: int, settings) -> Optional[EyeSet]:
    post = ind.posture_stuff(frame)
    basic = ind.basic_stuff(frame)
    if post is None or basic is None or post.midline is None \
            or len(post.midline.segments) < 3:
        return None
    mid = post.midline
    s = settings
    offset_frac = max(0.0, float(s["visual_field_eye_offset"]))
    sep = math.radians(float(s["visual_field_eye_separation"]))
    idx = min(len(mid.segments) - 1, int(len(mid.segments) * offset_frac))
    seg = mid.segments[idx]
    height = mid.heights[idx] if idx < len(mid.heights) else 4.0
    bx, by = basic.blob.bounds[:2]
    ox, oy = (mid.offset if mid.offset else (0.0, 0.0))
    # midline points are posture-crop-local (blob bounds + the posture
    # threshold-escalation crop offset); angle points tail->head; view
    # direction is the reversed midline direction (angle + pi)
    base_angle = mid.angle
    n_smooth = int(s["visual_field_history_smoothing"] or 0)
    if n_smooth > 0:
        # orientation smoothing over the last N posture frames
        # (VisualField.cpp visual_field_history_smoothing): mean unit
        # vector of the midline angles, current frame included
        vs = []
        for p in reversed(ind.posture):
            if p.frame > frame or p.frame < frame - n_smooth:
                continue
            a = p.midline_angle
            if math.isfinite(a):
                vs.append((math.cos(a), math.sin(a)))
        if vs:
            mx = sum(v[0] for v in vs) / len(vs)
            my = sum(v[1] for v in vs) / len(vs)
            if mx or my:
                base_angle = math.atan2(my, mx)
    angle = base_angle + math.pi
    nx, ny = -math.sin(angle), math.cos(angle)  # left normal
    half = height * 0.5 + 1.0
    p = np.array([seg[0] + bx + ox, seg[1] + by + oy])
    pos = np.stack([p + np.array([nx, ny]) * half,
                    p - np.array([nx, ny]) * half]).astype(np.float32)
    angles = np.array([angle - sep / 2, angle + sep / 2], np.float32)
    return EyeSet(pos=pos, angle=angles)


def visual_field_inputs(tracker, frame: int, settings,
                        max_points_per_fish: int = 256):
    """The projection's inputs for every posture-bearing individual at
    `frame`: (ids, (points, point_ids, point_valid, eye_pos, eye_angle,
    max_d)) as ``ops/raycast.py::visual_field`` takes them, with
    positional point ids (fish i of `ids` is i, shape j is len(ids) + j),
    or None if no fish is eligible."""
    eyes = []
    ids = []
    outlines = []
    for fid, ind in sorted(tracker.individuals.items()):
        post = ind.posture_stuff(frame)
        if post is None or post.outline is None:
            continue
        e = generate_eyes(ind, frame, settings)
        if e is None:
            continue
        ids.append(fid)
        eyes.append(e)
        outlines.append(tesselate_outline(post.outline, 5.0))
    if not ids:
        return None
    F = len(ids)
    P = max_points_per_fish
    pts = np.zeros((F * P, 2), np.float32)
    pids = np.full(F * P, -1, np.int32)
    valid = np.zeros(F * P, bool)
    for i, ol in enumerate(outlines):
        n = min(len(ol), P)
        if len(ol) > P:
            ol = ol[np.linspace(0, len(ol) - 1, P).astype(int)]
        pts[i * P : i * P + n] = ol[:n]
        # positional index: the projection's self/winner exclusion
        # compares point ids against arange(F) eye indexes
        pids[i * P : i * P + n] = i
        valid[i * P : i * P + n] = True
    eye_pos = np.stack([e.pos for e in eyes])
    eye_angle = np.stack([e.angle for e in eyes])

    # visual_field_shapes (VisualField.cpp:499-523): user polygons are
    # view-blocking objects; their convex hulls enter the projection as
    # extra point groups with pseudo-ids F, F+1, ... (map_ids maps them
    # to the reference's uint32_max-42-j object ids). The projection is
    # point-sampled, so each shape is tesselated finely enough that the
    # angular gap at the nearest eye stays under one bin; shapes append
    # to the flat arrays without the per-fish point cap.
    bin_angle = math.radians(130.0) / FIELD_RESOLUTION
    extra_pts = []
    for poly in (settings["visual_field_shapes"] or []):
        poly = np.asarray(poly, np.float32).reshape(-1, 2)
        if len(poly) < 3:
            continue
        hull = convex_hull(poly)
        cx, cy = hull.mean(axis=0)
        half_diag = float(np.hypot(*(hull - (cx, cy)).T).max())
        d_eyes = np.hypot(eye_pos[..., 0] - cx, eye_pos[..., 1] - cy)
        min_d = max(1.0, float(d_eyes.min()) - half_diag)
        spacing = float(np.clip(min_d * bin_angle * 0.9, 0.05, 5.0))
        tess = tesselate_outline(hull, spacing)
        if len(tess) > 20000:  # runaway guard for huge close shapes
            tess = tess[np.linspace(0, len(tess) - 1, 20000).astype(int)]
        extra_pts.append(tess)
    if F + len(extra_pts) > 511:
        # the projection packs (depth, id) into (13 + 9)-bit keys
        raise ValueError(
            f"visual fields support at most 511 concurrent individuals "
            f"+ shapes (got {F + len(extra_pts)}): the scatter-min key "
            "packs ids into 9 bits")
    if extra_pts:
        pts = np.concatenate([pts] + extra_pts)
        pids = np.concatenate(
            [pids] + [np.full(len(t), F + j, np.int32)
                      for j, t in enumerate(extra_pts)])
        valid = np.concatenate(
            [valid] + [np.ones(len(t), bool) for t in extra_pts])
    bg = tracker.background
    max_d = float(np.hypot(*bg.shape[:2])) if bg is not None else 1000.0
    return ids, (pts, pids, valid, eye_pos, eye_angle, np.float32(max_d))


def map_ids(planes: dict, ids) -> dict:
    """The projection's planes (numpy) with the positional ids of the id
    planes mapped to the tracker's: fish to their identities, shapes to
    the reference's object ids (uint32_max - 42 - j), no hit to -1."""
    F = len(ids)
    out = dict(planes)
    ids_arr = np.asarray(ids, np.int64)
    shape_base = np.int64(4294967295 - 42)
    for k in out:
        if k.startswith("id"):
            plane = out[k].astype(np.int64)
            fish_hit = (plane >= 0) & (plane < F)
            mapped = np.where(fish_hit,
                              ids_arr[np.clip(plane, 0, F - 1)], -1)
            out[k] = np.where(plane >= F, shape_base - (plane - F), mapped)
    return out


def compute_visual_fields(tracker, frame: int, settings,
                          max_points_per_fish: int = 256, device=None):
    """Visual fields for every posture-bearing individual at `frame`,
    projected on `device` (the card when None).

    Returns (ids, dict of (F, 2, 512) numpy arrays) or None if no fish
    is eligible."""
    res = visual_field_inputs(tracker, frame, settings, max_points_per_fish)
    if res is None:
        return None
    ids, inputs = res
    out = visual_field(*inputs, device=device)
    return ids, map_ids({k: v.cpu().numpy() for k, v in out.items()}, ids)


def export_visual_fields(tracker, settings, output_dir, video_name: str,
                         device=None):
    """Per-fish visual-field npz over all posture frames (ui/Export.cpp
    visual-fields section), projected on `device` (the card when None).
    Returns the paths written."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    prefix = settings["individual_prefix"] or "fish"
    frames_by_fish: dict[int, list] = {}
    fields_by_fish: dict[int, dict[str, list]] = {}
    for frame in range(tracker.start_frame, tracker.end_frame + 1):
        res = compute_visual_fields(tracker, frame, settings, device=device)
        if res is None:
            continue
        ids, fields = res
        for i, fid in enumerate(ids):
            frames_by_fish.setdefault(fid, []).append(frame)
            store = fields_by_fish.setdefault(
                fid, {k: [] for k in fields})
            for k in fields:
                store[k].append(fields[k][i])
    paths = []
    for fid, frames in frames_by_fish.items():
        path = output_dir / f"{video_name}_visual_field_{prefix}{fid}.npz"
        arrays = {k: np.stack(v) for k, v in fields_by_fish[fid].items()}
        arrays["frames"] = np.asarray(frames, np.int64)
        np.savez_compressed(path, **arrays)
        paths.append(path)
    return paths
