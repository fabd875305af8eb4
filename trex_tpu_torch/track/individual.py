"""Per-identity time series and the motion-model cache.

Counterpart of ``trex_tpu/track/individual.py`` (the reference's
track::Individual, tracking/Individual.h:111-403): per-frame BasicStuff
(blob and centroid MotionRecord), PostureStuff, tracklet ranges, and
``cache_for_frame``, the position estimate and time-probability snapshot
of the matching stage.

The archives of the port's engines (``track/archive.py``) replay their
records through ``Individual.add``/``add_posture``; ``CACHE_WINDOW`` is
the decay window of the engines. The object Tracker (``track/tracker.py``)
adds its assignments through ``Individual.add`` and reads
``cache_for_frame`` (through ``track/cache_batch.py::compute_caches``),
the probabilities, ``basic_stuff``/``posture_stuff`` and, in the
pipeline's ``run_postures``, ``calculate_previous_vector``.

Equations implemented 1:1 from the reference:
- velocity/acceleration averaging over the last <=6 assigned frames with
  speed clamping at D_max                       (Individual.cpp:1900-1960)
- estimated position with decay weights
  w(f) = (1+lambda)/(1+lambda*max(1, f-tau+1)), lambda = speed_decay^4
                                                (Individual.cpp:1995-2025)
- time probability T = (1 - min(1,(tdelta-1/fps)/T_max)) scaled by recent
  sample count, then p*0.75+0.25               (Individual.cpp:2061-2095)
- position probability S = 1/(1 + |v|/D_max)^2  (Individual.cpp:2109-2179)
- combined P = S * T (angle term only applies when no centroid history
  exists, mirroring the reference's valid_frame flag semantics)
                                                (Individual.cpp:2197-2237)
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .motion import MotionRecord

# window length of the batched cache path (cache_batch.py): the last
# <=6 velocity samples need the last 7 assigned entries
CACHE_WINDOW = 7


@dataclass
class BasicStuff:
    frame: int
    blob: object  # prefiltered Blob (track.blob.TrackBlob)
    centroid: MotionRecord
    thresholded_size: int = 0


@dataclass
class PostureStuff:
    frame: int
    outline: Optional[np.ndarray] = None  # (N,2) float32 points
    midline: Optional[object] = None  # posture.Midline
    head: Optional[MotionRecord] = None
    centroid_posture: Optional[MotionRecord] = None
    midline_length: float = float("nan")
    midline_angle: float = float("nan")
    outline_size: int = 0


@dataclass
class IndividualCache:
    """Per-(fish, frame) matching cache (data/IndividualCache.h:12-24)."""
    estimated_px: tuple = (0.0, 0.0)
    last_seen_px: tuple = (0.0, 0.0)
    time_probability: float = 0.0
    # time since the global previous frame (Individual.cpp:1753
    # `local_tdelta = prev_props ? time - prev_props->time() : 0` —
    # NOT the time since this fish was last seen). position_probability
    # divides by this, so a long-lost fish's distance is judged against
    # one frame-time, which is what gates far reactivations below
    # match_min_probability.
    local_tdelta: float = 0.0
    # time since this fish's own last assigned frame (the `tdelta` that
    # feeds time_probability and the active/inactive decision)
    fish_tdelta: float = 0.0
    previous_frame: int = -1
    valid_frame: bool = False  # true only when no centroid history/manual
    individual_empty: bool = True


class Individual:
    def __init__(self, identity: int, settings):
        self.identity = identity
        self.settings = settings
        self._frames: dict[int, int] = {}  # frame -> index into stuff
        self.basic: list[BasicStuff] = []
        self.posture: list[PostureStuff] = []
        self._posture_by_frame: dict[int, int] = {}
        self.tracklets: list[list[int]] = []  # [start, end] inclusive
        self.manual_frames: set[int] = set()
        # rolling window over the last CACHE_WINDOW basic entries for
        # the batched cache path: [frame, x, y, time], right-aligned
        # newest-last, empty slots marked frame = -1e9
        self._win = np.full((CACHE_WINDOW, 4), np.nan)
        self._win[:, 0] = -1e9

    # ------------------------------------------------------------------
    @property
    def start_frame(self) -> int:
        return self.basic[0].frame if self.basic else -1

    @property
    def end_frame(self) -> int:
        return self.basic[-1].frame if self.basic else -1

    def empty(self) -> bool:
        return not self.basic

    def has(self, frame: int) -> bool:
        return frame in self._frames

    def basic_stuff(self, frame: int) -> Optional[BasicStuff]:
        i = self._frames.get(frame)
        return self.basic[i] if i is not None else None

    def posture_stuff(self, frame: int) -> Optional[PostureStuff]:
        i = self._posture_by_frame.get(frame)
        return self.posture[i] if i is not None else None

    def centroid(self, frame: int) -> Optional[MotionRecord]:
        b = self.basic_stuff(frame)
        return b.centroid if b else None

    # ------------------------------------------------------------------
    def add(self, frame: int, time: float, blob, prob: float = -1.0,
            manual: bool = False) -> BasicStuff:
        """Assign `blob` (TrackBlob) to this individual at `frame`."""
        if frame in self._frames:
            raise ValueError(f"fish {self.identity} already has frame {frame}")
        if self.basic and frame <= self.basic[-1].frame:
            raise ValueError("frames must be added in order")
        prev = self.basic[-1].centroid if self.basic else None
        cx, cy = blob.center
        rec = MotionRecord.create(prev, time, cx, cy, blob.orientation)
        stuff = BasicStuff(frame=frame, blob=blob, centroid=rec,
                           thresholded_size=blob.num_pixels)
        self._frames[frame] = len(self.basic)
        self.basic.append(stuff)
        self._win[:-1] = self._win[1:]
        self._win[-1] = (frame, cx, cy, time)
        if manual:
            self.manual_frames.add(frame)
        self._update_tracklets(frame, time, prob)
        return stuff

    def _update_tracklets(self, frame: int, time: float,
                          prob: float = -1.0):
        """Tracklet continuation rules (Individual::update_midlines
        error_code, Individual.cpp:1212-1229): break on gaps, low
        assignment probability (track_trusted_probability), huge time
        deltas (tracklet_punish_timedelta x huge_timestamp_seconds),
        suspicious speeds (tracklet_punish_speeding) and
        tracklet_max_length."""
        s = self.settings
        if self.tracklets and self.basic and len(self.basic) >= 2:
            prev = self.basic[-2]
            cur = self.basic[-1]
            consecutive = frame == prev.frame + 1
            ok = consecutive
            # ProbabilityTooSmall: a match below the trusted level
            # starts a new tracklet (prob -1 = no probability known)
            if ok and prob != -1.0 \
                    and prob < s["track_trusted_probability"]:
                ok = False
            if ok and s["tracklet_punish_timedelta"] \
                    and (time - prev.centroid.time) \
                    >= s["huge_timestamp_seconds"]:
                ok = False
            if ok and s["tracklet_punish_speeding"]:
                cm = s["cm_per_pixel"] or 1.0
                if cur.centroid.speed(cm) >= s["track_max_speed"] * 0.99:
                    ok = False
            if ok and s["tracklet_max_length"] > 0:
                t0 = self.basic_stuff(self.tracklets[-1][0])
                if t0 is not None and \
                        time - t0.centroid.time >= s["tracklet_max_length"]:
                    ok = False
            if ok:
                self.tracklets[-1][1] = frame
                return
        self.tracklets.append([frame, frame])

    def add_posture(self, stuff: PostureStuff):
        self._posture_by_frame[stuff.frame] = len(self.posture)
        self.posture.append(stuff)

    def calculate_previous_vector(self, frame: int, n: int):
        """Mean unit direction of the midline angles over the last `n`
        posture frames before `frame`, normalized — the
        posture_direction_smoothing movement vector
        (Individual::calculate_previous_vector,
        Individual.cpp:2296-2349). None when no samples exist."""
        dirs = []
        for p in reversed(self.posture):
            if p.frame >= frame:
                continue
            if p.frame < frame - n:
                break
            a = p.midline_angle
            if p.midline is None or not math.isfinite(a):
                continue
            dirs.append((math.cos(a), math.sin(a)))
        if not dirs:
            return None
        d = np.mean(dirs, axis=0)
        nv = float(np.hypot(*d))
        return d / nv if nv > 0 else None

    def remove_after(self, frame: int):
        """Drop all data at frames >= frame (used by re-tracking)."""
        # formerly-manual frames past the cut must not keep forcing the
        # manual-match cache semantics on re-tracked frames
        self.manual_frames = {f for f in self.manual_frames
                              if f < frame}
        keep = [b for b in self.basic if b.frame < frame]
        self.basic = keep
        self._frames = {b.frame: i for i, b in enumerate(keep)}
        keepp = [p for p in self.posture if p.frame < frame]
        self.posture = keepp
        self._posture_by_frame = {p.frame: i for i, p in enumerate(keepp)}
        self.tracklets = [t for t in self.tracklets if t[0] < frame]
        if self.tracklets and self.tracklets[-1][1] >= frame:
            self.tracklets[-1][1] = frame - 1
        self._win[:, :] = np.nan
        self._win[:, 0] = -1e9
        for b in self.basic[-CACHE_WINDOW:]:
            self._win[:-1] = self._win[1:]
            self._win[-1] = (b.frame, b.centroid.x, b.centroid.y,
                             b.centroid.time)

    # ------------------------------------------------------------------
    def recent_number_samples(self, frame: int) -> int:
        """R_i: assigned frames within the last `frame_rate` frames,
        walking tracklets backwards while gaps stay under
        frame_rate*T_max (Individual.cpp:1802-1838)."""
        s = self.settings
        frame_rate = int(s["frame_rate"] or 25)
        lower_limit = frame - frame_rate
        time_limit = frame_rate * s["track_max_reassign_time"]
        n = 0
        previous = frame
        for t in reversed(self.tracklets):
            if t[1] < lower_limit:
                break
            if previous - t[1] > time_limit:
                break
            start = max(t[0], lower_limit)
            end = min(t[1], frame)
            previous = start
            n += max(0, end - start + 1)
        return n

    def cache_for_frame(self, frame: int, time: float,
                        frame_times: dict[int, float],
                        start_frame: int = 0) -> IndividualCache:
        """Build the matching cache for `frame` (Individual.cpp:1940-2055).

        frame_times maps tracked frame -> time (FrameProperties history).
        """
        s = self.settings
        cache = IndividualCache()
        if self.empty():
            return cache
        prev_frame = self.end_frame
        cache.previous_frame = prev_frame
        cache.individual_empty = False
        prev_stuff = self.basic[-1]
        ptime = prev_stuff.centroid.time
        tdelta = time - ptime
        if tdelta <= 0:
            tdelta = 1e-6
        cache.fish_tdelta = tdelta
        # global frame-to-frame delta (Individual.cpp:1753); 0 when the
        # previous frame was never tracked -> zero velocity, p = tprob
        prev_t = frame_times.get(frame - 1)
        cache.local_tdelta = (time - prev_t) if prev_t is not None else 0.0
        cache.last_seen_px = prev_stuff.centroid.pos

        cm_per_pixel = s["cm_per_pixel"] or 1.0
        track_max_speed = s["track_max_speed"]
        max_speed_px = track_max_speed / cm_per_pixel if cm_per_pixel else 0.0
        max_px_sq = max_speed_px * max_speed_px

        # average velocity / acceleration over last <= 6 frames
        # (scalar math: this runs per fish per frame in the hot loop)
        lo = max(self.start_frame, prev_frame - 6)
        raw_x = raw_y = 0.0
        acc_x = acc_y = 0.0
        speeds_sq: list[float] = []
        used_frames = 0
        prev_vx = prev_vy = 0.0
        prev_px = prev_py = None
        prev_t = 0.0
        last_frame_manual = False
        idx_hi = self._frames[prev_frame]
        idx_lo = idx_hi
        while idx_lo > 0 and self.basic[idx_lo - 1].frame >= lo:
            idx_lo -= 1
        for i in range(idx_lo, idx_hi + 1):
            stuff = self.basic[i]
            f = stuff.frame
            if self.manual_frames and f in self.manual_frames:
                last_frame_manual = True
                continue
            c = stuff.centroid
            c_time = frame_times.get(f, c.time)
            if prev_px is None:
                prev_px, prev_py, prev_t = c.x, c.y, c_time
                continue
            p_time = frame_times.get(f - 1)
            if p_time is None or c_time - p_time > 1.0:
                prev_px, prev_py, prev_t = c.x, c.y, c_time
                continue
            dt = c_time - prev_t
            if dt <= 0:
                continue
            vx = (c.x - prev_px) / dt
            vy = (c.y - prev_py) / dt
            l_sq = vx * vx + vy * vy
            if max_px_sq > 0 and l_sq >= max_px_sq:
                k = max_speed_px / math.sqrt(l_sq)
                vx *= k
                vy *= k
                l_sq = max_px_sq
            raw_x += vx
            raw_y += vy
            speeds_sq.append(l_sq)
            step = c_time - p_time
            if step > 0 and (prev_vx != 0 or prev_vy != 0):
                acc_x += (vx - prev_vx) / step
                acc_y += (vy - prev_vy) / step
            prev_vx, prev_vy = vx, vy
            prev_px, prev_py, prev_t = c.x, c.y, c_time
            used_frames += 1
            if used_frames > 5:
                break

        if used_frames:
            raw_x /= used_frames
            raw_y /= used_frames
            acc_x /= used_frames
            acc_y /= used_frames

        if speeds_sq:
            speeds_sq.sort()
            m = len(speeds_sq)
            med = speeds_sq[m // 2] if m % 2 else \
                0.5 * (speeds_sq[m // 2 - 1] + speeds_sq[m // 2])
        else:
            med = 0.0
        speed = max(0.6, math.sqrt(med))
        decay = min(1.0, max(0.0, s["track_speed_decay"]))
        lam = decay ** 4

        n = math.hypot(raw_x, raw_y)
        dir_x, dir_y = (raw_x / n, raw_y / n) if n > 0 else (0.0, 0.0)
        n = math.hypot(acc_x, acc_y)
        accd_x, accd_y = (acc_x / n, acc_y / n) if n > 0 else (0.0, 0.0)

        est_x = est_y = 0.0
        if used_frames > 0 and lam < 1:
            last_used = frame_times.get(prev_frame - 1, ptime)
            for f in range(prev_frame, frame):
                t_f = frame_times.get(f)
                if t_f is None:
                    continue
                step = t_f - last_used
                last_used = t_f
                weight = (1 + lam) / (1 + lam * max(1, f - prev_frame + 1))
                k = weight * step * speed
                est_x += k * (dir_x + step * accd_x)
                est_y += k * (dir_y + step * accd_y)
        cache.estimated_px = (est_x + prev_stuff.centroid.x,
                              est_y + prev_stuff.centroid.y)

        # time probability (tdelta here is the fish-relative one; the
        # recent-samples walk runs from the CURRENT frameIndex,
        # Individual.cpp:1806 `lower_limit = frameIndex - frame_rate`)
        if not s["track_time_probability_enabled"] or last_frame_manual:
            cache.time_probability = 1.0
        elif tdelta > s["track_max_reassign_time"]:
            cache.time_probability = 0.0
        else:
            cache.time_probability = self.time_probability(
                tdelta, prev_frame, self.recent_number_samples(frame),
                start_frame,
            )
        # reference semantics: valid_frame true only when there is no
        # centroid history or the last assignment was manual; the angle
        # term of position_probability applies only then.
        cache.valid_frame = last_frame_manual
        return cache

    # ------------------------------------------------------------------
    def time_probability(self, tdelta: float, previous_frame: int,
                         recent_number_samples: int,
                         start_frame: int = 0) -> float:
        s = self.settings
        frame_rate = int(s["frame_rate"] or 25)
        t_delta = 1.0 / frame_rate
        minimum_frames = min(frame_rate, 5)
        p = 1.0 - min(1.0, max(
            0.0, (tdelta - t_delta) / s["track_max_reassign_time"]))
        if previous_frame >= start_frame + minimum_frames:
            p *= min(1.0, (recent_number_samples - 1) / minimum_frames
                     + s["match_min_probability"])
        return p * 0.75 + 0.25

    def position_probability(self, cache: IndividualCache,
                             position: tuple, blob_center: tuple) -> float:
        s = self.settings
        cm_per_pixel = s["cm_per_pixel"] or 1.0
        if cache.local_tdelta != 0:
            vx = (position[0] - cache.estimated_px[0]) / cache.local_tdelta
            vy = (position[1] - cache.estimated_px[1]) / cache.local_tdelta
        else:
            vx = vy = 0.0
        # the vectorized path substitutes 1e9 for an unset
        # track_max_speed (tracker.py:197 'no speed limit'); the scalar
        # path must score by the same rule or manual-history fish get
        # probability 0 while everyone else gets ~1
        ms = s["track_max_speed"] or 1e9
        speed = math.hypot(vx, vy) / ms * cm_per_pixel
        speed = 1.0 / (1.0 + speed) ** 2
        if not cache.valid_frame:
            return speed
        ax = blob_center[0] - cache.last_seen_px[0]
        ay = blob_center[1] - cache.last_seen_px[1]
        bx = cache.estimated_px[0] - cache.last_seen_px[0]
        by = cache.estimated_px[1] - cache.last_seen_px[1]
        if ax * ax + ay * ay > 1 and bx * bx + by * by > 1:
            a = -math.atan2(-by * ax + bx * ay, bx * ax + by * ay)
            a = abs(a / math.pi)
            return speed * (0.9 + (1 - a) ** 2 * 0.1)
        return speed

    def probability(self, cache: IndividualCache, position: tuple,
                    label: Optional[int] = None,
                    current_category: Optional[int] = None) -> float:
        """Combined P = S * T (Individual.cpp:2197-2237)."""
        if (label is not None and current_category is not None
                and label != current_category):
            return 0.0
        return (self.position_probability(cache, position, position)
                * cache.time_probability)
