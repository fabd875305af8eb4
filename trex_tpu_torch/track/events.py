"""Tailbeat / energy event detection.

Re-creates track::EventAnalysis (reference tracking/EventAnalysis.{h,cpp}):
- midline_offset(fish, frame): angle of the normalized midline's
  first->last segment vector (EventAnalysis.cpp:197-218); invalid when
  the midline length ratio vs the fixed midline is < 0.6
- events: state machine over |offset| >= `limit` (default 0.09) with
  sign-aware continuation; accepted when the peak reaches
  `event_min_peak_offset` (0.15); energy = sum 0.5*meta_mass_mg*offset^2
  (EventAnalysis.cpp:122)
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class Event:
    begin: int
    end: int
    energy: float = 0.0
    direction_change: float = 0.0
    acceleration: float = 0.0
    speed_before: float = 0.0
    speed_after: float = 0.0

    @property
    def length(self):
        return self.end - self.begin + 1


def midline_offset(ind, frame: int) -> float:
    """Tail deflection angle in the body frame; NaN when unavailable."""
    post = ind.posture_stuff(frame)
    if post is None or post.midline is None or len(post.midline.segments) < 2:
        return float("nan")
    mid = post.midline
    # fixed-midline sanity check (EventAnalysis.cpp:207-211): a frame
    # whose midline length deviates >40% from the individual's median
    # carries a degenerate posture — its offset would fabricate events
    median_len = getattr(ind, "_median_midline_cache", None)
    if median_len is None:
        lengths = [q.midline_length for q in ind.posture
                   if not math.isnan(q.midline_length)]
        median_len = float(np.median(lengths)) if lengths else 0.0
        ind._median_midline_cache = median_len
    if median_len > 0 and not math.isnan(post.midline_length):
        ratio = post.midline_length / median_len
        if ratio > 1:
            ratio = 1 / ratio
        if ratio < 0.6:
            return float("nan")
    segs = mid.segments
    v = segs[-1] - segs[0]
    n = math.hypot(*v)
    if n == 0:
        return float("nan")
    # rotate into the body frame given by the stiff-part direction
    a = -mid.angle
    vx = v[0] * math.cos(a) - v[1] * math.sin(a)
    vy = v[0] * math.sin(a) + v[1] * math.cos(a)
    return math.atan2(vy, vx)


def crosses_abs_height(p0: float, p1: float, limit: float) -> int:
    """Sign of a +/-limit crossing between consecutive offsets, 0 if none
    (EventAnalysis.cpp crosses_abs_height)."""
    if math.isnan(p0) or math.isnan(p1):
        return 0
    if (p0 < limit <= p1) or (p1 < limit <= p0):
        return 1
    if (p0 > -limit >= p1) or (p1 > -limit >= p0):
        return -1
    return 0


def detect_events(ind, settings, max_gap: Optional[int] = None) -> list[Event]:
    """All tailbeat events for one individual."""
    return analyze(ind, settings, max_gap)[0]


def analyze(ind, settings,
            max_gap: Optional[int] = None) -> tuple[list[Event], set]:
    """Events plus the set of frames where |offset| crossed/exceeded
    `limit` (EventAnalysis state.threshold_reached, EventAnalysis.cpp:
    133-134 — consumed by the `threshold_reached` output field)."""
    s = settings
    limit = float(s["limit"])
    min_peak = float(s["event_min_peak_offset"])
    mass = float(s["meta_mass_mg"])
    if max_gap is None:
        max_gap = max(2, int((s["frame_rate"] or 25) * 0.1))
    frames = sorted(p.frame for p in ind.posture)
    threshold_frames: set[int] = set()
    if not frames:
        return [], threshold_frames
    events: list[Event] = []
    cur_start = None
    cur_end = None
    last_threshold = None
    peak = 0.0
    energy: list[float] = []
    prev_offset = float("nan")
    speeds: list[float] = []

    def speed_at(f):
        b = ind.basic_stuff(f)
        return b.centroid.speed() if b else 0.0

    def finish():
        nonlocal cur_start, cur_end, peak, energy
        if cur_start is not None and peak >= min_peak:
            ev = Event(cur_start, cur_end,
                       energy=float(sum(energy)))
            ev.speed_before = speed_at(max(frames[0], cur_start - 1))
            ev.speed_after = speed_at(cur_end)
            b0 = ind.basic_stuff(cur_start)
            b1 = ind.basic_stuff(cur_end)
            if b0 and b1:
                da = (math.atan2(b1.centroid.vy, b1.centroid.vx)
                      - math.atan2(b0.centroid.vy, b0.centroid.vx))
                # wrap to [-pi, pi]: headings straddling +-pi are small
                # turns, not ~2*pi
                ev.direction_change = abs(
                    math.atan2(math.sin(da), math.cos(da)))
                dt = b1.centroid.time - b0.centroid.time
                if dt > 0:
                    ev.acceleration = (ev.speed_after - ev.speed_before) / dt
            events.append(ev)
        cur_start = cur_end = None
        peak = 0.0
        energy = []

    for f in frames:
        o = midline_offset(ind, f)
        if math.isnan(o):
            prev_offset = o
            continue
        above = abs(o) >= limit or crosses_abs_height(prev_offset, o,
                                                      limit) != 0
        if above:
            last_threshold = f
            threshold_frames.add(f)
            if cur_start is None:
                cur_start = f
            cur_end = f
            peak = max(peak, abs(o))
            energy.append(0.5 * mass * o * o)
        elif cur_start is not None and last_threshold is not None \
                and f - last_threshold > max_gap:
            finish()
        prev_offset = o
    finish()
    return events, threshold_frames


def update_events(tracker, settings) -> dict[int, list[Event]]:
    """Events for all individuals (EventAnalysis::update_events)."""
    return {fid: detect_events(ind, settings)
            for fid, ind in sorted(tracker.individuals.items())}
