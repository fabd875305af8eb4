"""Output field library — named per-frame functions over individuals.

Re-creates Output::Library (reference tracking/OutputLibrary.{h,cpp},
field table docs/formats.rst:18-78): ~40 named functions, each evaluated
per (individual, frame) with a source modifier:

    #wcentroid  — weighted centroid (the stored centroid record)
    #centroid   — same record in the current reference
    #pcentroid  — posture centroid
    #head       — posture head point
    RAW/SMOOTH  — raw or smoothed series

Positions/speeds are exported in cm via cm_per_pixel; angles in radians.
Invalid values render as infinity (golden CSVs use "inf").
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np

INVALID = float("inf")

# fields that ignore the source modifier entirely — the union of the
# reference's FN_IS_CENTROID_ONLY_PROPERTY and FN_IS_POSTURE_ONLY_PROPERTY
# registrations (OutputLibrary.cpp; neither family gets a #source column
# suffix in the exports)
CENTROID_ONLY = {
    "blobid", "frame", "time", "timestamp", "missing", "num_pixels",
    "midline_length", "midline_x", "midline_y", "midline_segment_length",
    "normalized_midline", "MIDLINE_OFFSET", "visual_identification_p",
    "qr_id", "qr_p", "tracklet_id", "tracklet_length", "consecutive",
    "events", "event_energy", "event_acceleration",
    "event_direction_change", "tailbeat_threshold", "tailbeat_peak",
    "threshold_reached", "sqrt_a", "amplitude", "variance",
    "outline_size", "outline_std", "v_direction",
    "blob_x", "blob_y", "blob_width", "blob_height", "pixels_squared",
    "detection_class", "detection_p", "category", "average_category",
}


class EvalContext:
    def __init__(self, tracker, settings, pv_file=None):
        self.tracker = tracker
        self.settings = settings
        self.cm = settings["cm_per_pixel"] or 1.0
        self._border = None
        self._pv = pv_file
        # output_centered / output_origin (OutputLibrary.cpp:230-239):
        # X/Y export relative to the video center or a user origin, in
        # cm. Default origin (0,0) keeps absolute coordinates.
        if settings["output_centered"]:
            size = settings["meta_video_size"] or None
            if size and float(size[0]) > 0 and float(size[1]) > 0:
                w, h = float(size[0]), float(size[1])
            elif getattr(tracker, "background", None) is not None:
                h, w = tracker.background.shape[:2]
            else:
                w = h = 0.0
            self.center = (w * 0.5 * self.cm, h * 0.5 * self.cm)
        else:
            origin = settings["output_origin"] or (0.0, 0.0)
            self.center = (float(origin[0]) * self.cm,
                           float(origin[1]) * self.cm)
        # category fields resolve through THIS context's tracker store
        # (no module-global rebinding: a store from one export must not
        # leak into the next tracker's context)
        self.category_store = getattr(tracker, "category_store", None)

    @property
    def border(self):
        """Arena Border model, built lazily (heatmap types sample the
        pv file when one was provided)."""
        if self._border is None:
            from ..track.border import Border

            self._border = Border(self.settings,
                                  self.tracker.background)
            if self._pv is not None:
                self._border.update_from_video(self._pv)
        return self._border


def _record(ind, frame: int, source: str):
    source = (source or "wcentroid").lower()
    if source in ("wcentroid", "centroid"):
        b = ind.basic_stuff(frame)
        return b.centroid if b else None
    post = ind.posture_stuff(frame)
    if post is None:
        return None
    if source == "head":
        return post.head
    if source == "pcentroid":
        return post.centroid_posture
    return None


def _smooth_window(ind, frame, source, attr, ctx, half=None):
    """SMOOTH modifier: mean over frame +- smooth_window
    (OutputLibrary.cpp:301,338 FAST_SETTING(smooth_window))."""
    if half is None:
        half = int(ctx.settings["smooth_window"] or 2)
    vals = []
    for f in range(frame - half, frame + half + 1):
        r = _record(ind, f, source)
        if r is not None:
            vals.append(getattr(r, attr))
    return float(np.mean(vals)) if vals else None


def _pos_attr(attr, center_idx=None):
    """center_idx: X/Y subtract the context center (output_centered /
    output_origin, OutputLibrary.cpp X/Y LIBGLFNC :248-285); velocity
    and acceleration components are translation-invariant."""
    def fn(ind, frame, source, smooth, ctx):
        r = _record(ind, frame, source)
        if r is None:
            return INVALID
        off = ctx.center[center_idx] if center_idx is not None else 0.0
        if smooth:
            v = _smooth_window(ind, frame, source, attr, ctx)
            return v * ctx.cm - off if v is not None else INVALID
        return getattr(r, attr) * ctx.cm - off
    return fn


def _speed(ind, frame, source, smooth, ctx):
    r = _record(ind, frame, source)
    if r is None:
        return INVALID
    if smooth:
        vx = _smooth_window(ind, frame, source, "vx", ctx)
        vy = _smooth_window(ind, frame, source, "vy", ctx)
        if vx is None:
            return INVALID
        return math.hypot(vx, vy) * ctx.cm
    return r.speed(ctx.cm)


def _acceleration(ind, frame, source, smooth, ctx):
    r = _record(ind, frame, source)
    if r is None:
        return INVALID
    if smooth:
        ax = _smooth_window(ind, frame, source, "ax", ctx)
        ay = _smooth_window(ind, frame, source, "ay", ctx)
        if ax is None:
            return INVALID
        return math.hypot(ax, ay) * ctx.cm
    return r.acceleration(ctx.cm)


def _angle(ind, frame, source, smooth, ctx):
    r = _record(ind, frame, source)
    return r.angle if r else INVALID


def _num_pixels(ind, frame, source, smooth, ctx):
    b = ind.basic_stuff(frame)
    return b.blob.num_pixels if b else INVALID


def _blobid(ind, frame, source, smooth, ctx):
    b = ind.basic_stuff(frame)
    return b.blob.blob_id if b else INVALID


def _midline_length(ind, frame, source, smooth, ctx):
    p = ind.posture_stuff(frame)
    if p and not math.isnan(p.midline_length):
        return p.midline_length
    return INVALID


def _midline_xy(axis):
    """midline_x/midline_y: blob bounds position + midline offset in cm
    (OutputLibrary.cpp:1014-1036)."""
    def fn(ind, frame, source, smooth, ctx):
        p = ind.posture_stuff(frame)
        b = ind.basic_stuff(frame)
        if p and b and p.midline is not None \
                and len(p.midline.segments):
            return (float(b.blob.bounds[axis])
                    + float(p.midline.offset[axis])) * ctx.cm
        return INVALID
    return fn


def _border_distance(ind, frame, source, smooth, ctx):
    r = _record(ind, frame, source or "pcentroid")
    if r is None:
        return INVALID
    d = ctx.border.distance(r.x, r.y)
    return d * ctx.cm if math.isfinite(d) else INVALID


def _neighbor_distance(ind, frame, source, smooth, ctx):
    r = _record(ind, frame, source)
    if r is None:
        return INVALID
    ds = []
    for other in ctx.tracker.individuals.values():
        if other is ind:
            continue
        ro = _record(other, frame, source)
        if ro is not None:
            ds.append(math.hypot(r.x - ro.x, r.y - ro.y))
    return float(np.mean(ds)) * ctx.cm if ds else INVALID


def _missing(ind, frame, source, smooth, ctx):
    return 0.0 if ind.has(frame) else 1.0


def _time(ind, frame, source, smooth, ctx):
    return ctx.tracker.frame_times.get(frame, INVALID)


def _timestamp(ind, frame, source, smooth, ctx):
    t = ctx.tracker.frame_times.get(frame)
    return t * 1e6 if t is not None else INVALID


def _vi_p(ind, frame, source, smooth, ctx):
    b = ind.basic_stuff(frame)
    if not b:
        return INVALID
    preds = ctx.tracker.predicted.get(frame, {})
    probs = preds.get(b.blob.blob_id)
    if probs is None:
        return INVALID
    return float(np.max(probs))


FUNCTIONS: dict[str, Callable] = {
    "X": _pos_attr("x", center_idx=0),
    "Y": _pos_attr("y", center_idx=1),
    "VX": _pos_attr("vx"),
    "VY": _pos_attr("vy"),
    "AX": _pos_attr("ax"),
    "AY": _pos_attr("ay"),
    "SPEED": _speed,
    "ACCELERATION": _acceleration,
    "ANGLE": _angle,
    "ANGULAR_V": lambda ind, frame, source, smooth, ctx: (
        r.angular_velocity if (r := _record(ind, frame, source)) else INVALID),
    "ANGULAR_A": lambda ind, frame, source, smooth, ctx: (
        r.angular_acceleration if (r := _record(ind, frame, source)) else INVALID),
    "num_pixels": _num_pixels,
    "blobid": _blobid,
    "midline_length": _midline_length,
    "midline_x": _midline_xy(0),
    "midline_y": _midline_xy(1),
    "BORDER_DISTANCE": _border_distance,
    "NEIGHBOR_DISTANCE": _neighbor_distance,
    "missing": _missing,
    "time": _time,
    "timestamp": _timestamp,
    "frame": lambda ind, frame, source, smooth, ctx: float(frame),
    "visual_identification_p": _vi_p,
    "MIDLINE_OFFSET": lambda ind, frame, source, smooth, ctx: (
        _midline_offset_field(ind, frame)),
    "normalized_midline": lambda ind, frame, source, smooth, ctx: (
        p.midline_angle if (p := ind.posture_stuff(frame)) else INVALID),
    "outline_size": lambda ind, frame, source, smooth, ctx: (
        float(p.outline_size) if (p := ind.posture_stuff(frame))
        else INVALID),
    "tracklet_id": lambda ind, frame, source, smooth, ctx: next(
        (float(i) for i, (t0, t1) in enumerate(ind.tracklets)
         if t0 <= frame <= t1), INVALID),
    "consecutive": lambda ind, frame, source, smooth, ctx: next(
        (float(t1 - t0 + 1) for (t0, t1) in ind.tracklets
         if t0 <= frame <= t1), INVALID),
    "ORIENTATION": _angle,
    "SPEED_OLD": _speed,
    "midline_segment_length": lambda ind, frame, source, smooth, ctx: (
        (p.midline_length / max(1, ctx.settings["midline_resolution"] - 1))
        if (p := ind.posture_stuff(frame))
        and not math.isnan(p.midline_length) else INVALID),
}

# units for header annotation (output_annotations defaults)
def column_title(field: str, modifiers: list[str], annotations: dict) -> str:
    sources = [m for m in modifiers
               if m.lower() in ("wcentroid", "centroid", "pcentroid", "head")]
    name = field
    if sources and field not in CENTROID_ONLY:
        name += "#" + sources[0].lower()
    unit = annotations.get(field)
    if unit:
        name += f" ({unit})"
    return name


def _midline_offset_field(ind, frame):
    from ..track.events import midline_offset

    v = midline_offset(ind, frame)
    return v if not math.isnan(v) else INVALID


def _pose_field(field: str):
    """poseX<i>/poseY<i>: keypoint coordinates from the blob prediction
    (find_user_defined_pose_fields, default_config.cpp:360-420)."""
    axis = 0 if field.startswith("poseX") else 1
    idx = int(field[5:])

    def fn(ind, frame, source, smooth, ctx):
        b = ind.basic_stuff(frame)
        pred = b.blob.prediction if b else None
        kp = None
        if isinstance(pred, dict):
            kp = pred.get("keypoints")
        elif pred is not None:
            kp = getattr(pred, "pose", None)
        if kp is None or idx >= len(kp):
            return INVALID
        return float(kp[idx][axis]) * ctx.cm

    return fn


def _neighbor_vector_t(ind, frame, source, smooth, ctx):
    """NEIGHBOR_VECTOR_T: signed distance to the nearest neighbor along
    the body-transverse axis (OutputLibrary neighbor vector family)."""
    r = _record(ind, frame, source)
    if r is None:
        return INVALID
    best = None
    for other in ctx.tracker.individuals.values():
        if other is ind:
            continue
        ro = _record(other, frame, source)
        if ro is None:
            continue
        d = math.hypot(r.x - ro.x, r.y - ro.y)
        if best is None or d < best[0]:
            best = (d, ro)
    if best is None:
        return INVALID
    _, ro = best
    # project neighbor offset onto the perpendicular of the heading
    nx, ny = -math.sin(r.angle), math.cos(r.angle)
    return ((ro.x - r.x) * nx + (ro.y - r.y) * ny) * ctx.cm


def _dot_v(ind, frame, source, smooth, ctx):
    """DOT_V: absolute velocity-direction difference vs the first other
    tracked individual (OutputLibrary.cpp:653-677). The reference's
    early-return guard is inverted (`length(v) > 0 || ...` returns
    invalid whenever either fish MOVES, making the column always
    invalid in practice); this keeps the documented semantics and
    guards the genuinely undefined atan2(0,0) case instead."""
    r = _record(ind, frame, source)
    if r is None:
        return INVALID
    for oid in sorted(ctx.tracker.individuals):
        other = ctx.tracker.individuals[oid]
        if other is ind:
            continue
        ro = _record(other, frame, source)
        if ro is None:
            continue
        if (r.vx == 0 and r.vy == 0) or (ro.vx == 0 and ro.vy == 0):
            return INVALID
        return abs(math.atan2(r.vy, r.vx) - math.atan2(ro.vy, ro.vx))
    return INVALID


def _analysis(ctx, ind):
    """Cached EventAnalysis result for one individual:
    (events list, set of threshold-crossing frames)."""
    cache = ctx.__dict__.setdefault("_events_cache", {})
    if ind.identity not in cache:
        from ..track.events import analyze

        cache[ind.identity] = analyze(ind, ctx.settings)
    return cache[ind.identity]


def _event_at(ctx, ind, frame):
    for ev in _analysis(ctx, ind)[0]:
        if ev.begin <= frame <= ev.end:
            return ev
    return None


def _events_field(attr):
    """events / event_*: the event's value inside an event window, 0
    outside (OutputLibrary.cpp:730-781 — the reference returns 0, not
    invalid, when no event covers the frame)."""
    def fn(ind, frame, source, smooth, ctx):
        ev = _event_at(ctx, ind, frame)
        if ev is None:
            return 0.0
        if attr == "present":
            return float(math.pi * 0.25)
        return float(getattr(ev, attr))
    return fn


def _threshold_reached(ind, frame, source, smooth, ctx):
    """pi*0.3 when the tail offset crossed `limit` at this frame,
    invalid otherwise (OutputLibrary.cpp:684)."""
    return float(math.pi * 0.3) \
        if frame in _analysis(ctx, ind)[1] else INVALID


def _v_direction(ind, frame, source, smooth, ctx):
    """Velocity-direction change across the covering event: mean v over
    50 frames (step 2) before event begin vs after event end, wrapped
    (OutputLibrary.cpp:862-905); 0 when no event covers the frame."""
    ev = _event_at(ctx, ind, frame)
    if ev is None:
        return 0.0

    def mean_v(f0, f1):
        vx = vy = 0.0
        n = 0
        for f in range(f0, f1 + 1, 2):
            r = _record(ind, f, "pcentroid") or _record(ind, f, None)
            if r is not None:
                vx += r.vx
                vy += r.vy
                n += 1
        return (vx / n, vy / n) if n else None

    before = mean_v(ev.begin - 50, ev.begin)
    after = mean_v(ev.end, ev.end + 50)
    if before is None or after is None:
        return 0.0
    da = math.atan2(after[1], after[0]) - math.atan2(before[1], before[0])
    return math.atan2(math.sin(da), math.cos(da))


def _variance(ind, frame, source, smooth, ctx):
    """Squared deviation of the current tail-vector angle from the
    +-100-frame mean tail vector (OutputLibrary.cpp:358-399)."""
    a_now = _midline_offset_field(ind, frame)
    if math.isinf(a_now):
        return INVALID
    sx = sy = 0.0
    n = 0
    for f in range(frame - 100, frame + 101):
        a = _midline_offset_field(ind, f)
        if not math.isinf(a):
            sx += math.cos(a)
            sy += math.sin(a)
            n += 1
    if n == 0:
        return INVALID
    mean_angle = math.atan2(sy, sx)
    return (abs(a_now - mean_angle)) ** 2


def _outline_std(ind, frame, source, smooth, ctx):
    """Outline-size std over a +-5 window, normalized by half the
    individual's overall mean outline size (OutputLibrary.cpp:700-728)."""
    window = []
    for f in range(frame - 5, frame + 6):
        p = ind.posture_stuff(f)
        if p is not None and p.outline_size:
            window.append(float(p.outline_size))
    if not window:
        return INVALID
    if len(window) == 1:
        return 1.0
    sizes = [float(p.outline_size) for p in ind.posture if p.outline_size]
    average = float(np.mean(sizes)) if sizes else float(np.mean(window))
    if average == 0:
        return INVALID
    s = sum((v - average) ** 2 for v in window) / (len(window) - 1)
    return math.sqrt(s) / (average * 0.5)


def _blob_bounds(idx):
    """blob_x/blob_y/blob_width/blob_height in pixels
    (OutputLibrary.cpp:958-1000: compressed-blob bounds, no cm)."""
    def fn(ind, frame, source, smooth, ctx):
        b = ind.basic_stuff(frame)
        return float(b.blob.bounds[idx]) if b else INVALID
    return fn


def _pixels_squared(ind, frame, source, smooth, ctx):
    b = ind.basic_stuff(frame)
    if not b:
        return INVALID
    _, _, w, h = b.blob.bounds
    return float(w * h)


def _detection(key):
    """detection_class/detection_p from the blob's stored prediction
    (OutputLibrary.cpp:784-799)."""
    def fn(ind, frame, source, smooth, ctx):
        b = ind.basic_stuff(frame)
        pred = getattr(b.blob, "prediction", None) if b else None
        if isinstance(pred, dict) and pred.get("clid") is not None:
            v = pred.get(key)
            return float(v) if v is not None else INVALID
        return INVALID
    return fn


def _global_positions(ctx, frame, source):
    pts = []
    for other in ctx.tracker.individuals.values():
        r = _record(other, frame, source)
        if r is not None:
            pts.append((r.x, r.y))
    return pts


def _global_field(ind, frame, source, smooth, ctx):
    """Length of the mean position (px) over all individuals present
    (OutputLibrary.cpp:1038-1067)."""
    pts = _global_positions(ctx, frame, source)
    if not pts:
        return 0.0
    mx = sum(p[0] for p in pts) / len(pts)
    my = sum(p[1] for p in pts) / len(pts)
    return math.hypot(mx, my)


def _compactness(ind, frame, source, smooth, ctx):
    """Group compactness: n / sum of distances to the mean position
    (OutputLibrary.cpp:1069-1107)."""
    pts = _global_positions(ctx, frame, source)
    if not pts:
        return 0.0
    mx = sum(p[0] for p in pts) / len(pts)
    my = sum(p[1] for p in pts) / len(pts)
    distances = sum(math.hypot(mx - x, my - y) for x, y in pts)
    return len(pts) / distances if distances != 0 else 0.0


def _relative_angle(ind, frame, source, smooth, ctx):
    """RELATIVE_ANGLE vs the first other tracked individual: difference
    of |dot(line, heading)| terms (OutputLibrary.cpp:591-628)."""
    r = _record(ind, frame, source)
    if r is None:
        return INVALID
    a0 = r.angle
    for oid in sorted(ctx.tracker.individuals):
        other = ctx.tracker.individuals[oid]
        if other is ind:
            continue
        ro = _record(other, frame, source)
        if ro is None:
            continue
        a1 = ro.angle
        if other.identity > ind.identity:
            lx, ly = (ro.x - r.x) * ctx.cm, (ro.y - r.y) * ctx.cm
        else:
            lx, ly = (r.x - ro.x) * ctx.cm, (r.y - ro.y) * ctx.cm
        n = math.hypot(lx, ly)
        if n == 0:
            return INVALID
        lx, ly = lx / n, ly / n
        d0x, d0y = math.cos(a0), -math.sin(a0)
        d1x, d1y = math.cos(a1), -math.sin(a1)
        angle0 = abs(lx * d0x + ly * d0y)
        angle1 = abs(lx * d1x + ly * d1y)
        return angle1 - angle0
    return INVALID


def _l_v(ind, frame, source, smooth, ctx):
    """Mean velocity-space distance to the other individuals in cm/s
    (OutputLibrary.cpp:630-651)."""
    r = _record(ind, frame, source)
    if r is None:
        return INVALID
    d = 0.0
    n = 0
    for other in ctx.tracker.individuals.values():
        if other is ind:
            continue
        ro = _record(other, frame, source)
        if ro is not None:
            d += math.hypot((r.vx - ro.vx) * ctx.cm,
                            (r.vy - ro.vy) * ctx.cm)
            n += 1
    return d / n if n else INVALID


def _amplitude(ind, frame, source, smooth, ctx):
    """Tail-tip y offset in the midline frame: (back - front).y
    (OutputLibrary.cpp:1109-1119)."""
    p = ind.posture_stuff(frame)
    if p is None or p.midline is None or len(p.midline.segments) < 2:
        return INVALID
    segs = p.midline.segments
    return float(segs[-1][1] - segs[0][1])


FUNCTIONS.update({
    "NEIGHBOR_VECTOR_T": _neighbor_vector_t,
    "DOT_V": _dot_v,
    "L_V": _l_v,
    "RELATIVE_ANGLE": _relative_angle,
    "v_direction": _v_direction,
    "events": _events_field("present"),
    "event_energy": _events_field("energy"),
    "event_acceleration": _events_field("acceleration"),
    "event_direction_change": _events_field("direction_change"),
    # constants echoing the active thresholds, for plotting against the
    # sqrt_a offset stream (OutputLibrary.cpp:680-683)
    "tailbeat_threshold": lambda ind, frame, source, smooth, ctx: (
        float(ctx.settings["limit"])),
    "tailbeat_peak": lambda ind, frame, source, smooth, ctx: (
        float(ctx.settings["event_min_peak_offset"])),
    "threshold_reached": _threshold_reached,
    "sqrt_a": lambda ind, frame, source, smooth, ctx: (
        _midline_offset_field(ind, frame)),
    "amplitude": _amplitude,
    "variance": _variance,
    "outline_std": _outline_std,
    "blob_x": _blob_bounds(0),
    "blob_y": _blob_bounds(1),
    "blob_width": _blob_bounds(2),
    "blob_height": _blob_bounds(3),
    "pixels_squared": _pixels_squared,
    "detection_class": _detection("clid"),
    "detection_p": _detection("p"),
    "global": _global_field,
    "compactness": _compactness,
    "tracklet_length": lambda ind, frame, source, smooth, ctx: next(
        (float(t1 - t0 + 1) for (t0, t1) in ind.tracklets
         if t0 <= frame <= t1), INVALID),
    "average_category": lambda ind, frame, source, smooth, ctx:
        _category(ind, frame, ctx),
    "category": lambda ind, frame, source, smooth, ctx:
        _category(ind, frame, ctx),
    "qr_id": lambda ind, frame, source, smooth, ctx: (
        float(t) if (t := ctx.tracker.tag_assignments.get(
            frame, {}).get(ind.identity)) is not None else INVALID),
    "qr_p": lambda ind, frame, source, smooth, ctx: (
        float(p) if (p := getattr(ctx.tracker, "tag_assignment_p",
                                  {}).get(frame, {}).get(ind.identity))
        is not None else INVALID),
})


def _category(ind, frame, ctx) -> float:
    """category/average_category from the context's DataStore
    (OutputLibrary category fields; INVALID without a store)."""
    store = getattr(ctx, "category_store", None)
    if store is None:
        return INVALID
    lid = store.ranged_label(frame, ind.identity)
    return float(lid) if lid is not None else INVALID


def set_category_lookup(ctx: EvalContext, store):
    """Attach a categorize.DataStore to a context (kept for callers;
    category fields read ctx.category_store)."""
    ctx.category_store = store


def evaluate(ctx: EvalContext, ind, frame: int, field: str,
             modifiers: list[str]) -> float:
    fn = FUNCTIONS.get(field)
    if fn is None and len(field) > 5 and field[:5] in ("poseX", "poseY") \
            and field[5:].isdigit():
        # cache the parsed closure like every other table entry (one
        # per column, not one per (individual, frame) evaluation)
        fn = FUNCTIONS[field] = _pose_field(field)
    if fn is None and field.endswith(("_X", "_Y")):
        # named keypoint columns (<detect_keypoint_names[i]>_X/_Y,
        # default_config.cpp:458-463) resolve to the pose index; NOT
        # cached in FUNCTIONS — the name->index map is per-settings
        names = ctx.settings["detect_keypoint_names"] or []
        base = field[:-2]
        if base in names:
            i = list(names).index(base)
            fn = _pose_field(f"pose{'X' if field.endswith('_X') else 'Y'}{i}")
    if fn is None:
        return INVALID
    source = None
    smooth = False
    for m in modifiers:
        lm = m.lower()
        if lm in ("wcentroid", "centroid", "pcentroid", "head"):
            source = lm
        elif lm == "smooth":
            smooth = True
    try:
        v = fn(ind, frame, source, smooth, ctx)
    except Exception:
        return INVALID
    if v is None:
        return INVALID
    return float(v)
