"""Decay estimates over per-fish motion windows (host, float64 numpy).

Counterpart of ``window_motion`` and ``window_estimate_scalar`` in
``trex_tpu/track/cache_batch.py``: the velocity averaging, median speed
and decay-weighted extrapolation of ``Individual.cache_for_frame``
(Individual.cpp:1940-2025) over (F, W, 4) windows of [frame, x, y, time]
rows. ``FastTracker`` with ``track_speed_decay < 1`` evaluates
``window_motion`` over its windows and ``window_estimate_scalar`` for the
fish whose window the array math cannot reproduce (chain breaks, frame
gaps); the DeviceTracker's assist rebuilds the carry's accumulated walk
with ``window_estimate_scalar``.

``compute_caches``, the object tracker's batch path over Individual
objects, comes with the port's object tracker.
"""
from __future__ import annotations

import math

import numpy as np


def window_motion(W4: np.ndarray, starts: np.ndarray, frame: int,
                  time: float, frame_times: dict, settings) -> dict:
    """Motion-model quantities over right-aligned (F, W, 4) windows of
    [frame, x, y, time] rows (empty slots frame = -1e9, newest last) —
    the vectorized equivalent of Individual.cache_for_frame's velocity
    averaging / median speed / decay extrapolation (Individual.cpp:
    1940-2025). Returns a dict of (F,) arrays:

        prev_frames, last_x, last_y, tdelta (fish-relative),
        est_x, est_y (the decay estimate; == last pos when the decay
        is off or no velocity samples exist), counts (velocity
        samples), simple (prev == frame-1), need_scalar (fish whose
        window has chain breaks/gaps the array math cannot reproduce —
        evaluate those through the scalar path).
    """
    s = settings
    F = W4.shape[0]
    wframes = W4[:, :, 0]
    prev_frames = wframes[:, -1].astype(np.int64)
    lo = np.maximum(np.asarray(starts, np.int64), prev_frames - 6)
    valid = wframes >= lo[:, None]  # suffix mask (frames ascending)
    frames = np.where(valid, wframes, -1e9).astype(np.int64)
    pos = np.where(valid[:, :, None], W4[:, :, 1:3], np.nan)

    cm = s["cm_per_pixel"] or 1.0
    max_speed = s["track_max_speed"]
    max_speed_px = max_speed / cm if cm else 0.0
    max_px_sq = max_speed_px * max_speed_px
    decay = min(1.0, max(0.0, s["track_speed_decay"]))
    lam = decay ** 4

    # window frames span only ~WINDOW+1 distinct values across all fish
    # (dense tracking), so frame_times collapses to one small table
    # instead of F*W dict lookups per frame
    real = frames > -10 ** 8
    fmin = int(frames[real].min()) - 1 if real.any() else 0
    fmax = int(frames.max()) if real.any() else 0
    tbl = np.full(max(fmax - fmin + 1, 1), np.nan)
    for f in range(fmin, fmax + 1):
        t = frame_times.get(f)
        if t is not None:
            tbl[f - fmin] = t

    def lookup_time(farr: np.ndarray) -> np.ndarray:
        idx = farr - fmin
        ok = (farr > -10 ** 8) & (idx >= 0) & (idx < tbl.size)
        return np.where(ok, tbl[np.clip(idx, 0, tbl.size - 1)], np.nan)

    # entry time: frame_times when registered, stored time otherwise
    lt = lookup_time(frames)
    times = np.where(np.isfinite(lt), lt,
                     np.where(valid, W4[:, :, 3], np.nan))
    prev_times = times[:, -1]
    last_x = pos[:, -1, 0]
    last_y = pos[:, -1, 1]

    # pairwise velocities between consecutive window entries
    np_err = np.seterr(invalid="ignore", divide="ignore")
    dt = times[:, 1:] - times[:, :-1]
    # skip pairs when the global step t(f)-t(f-1) exceeds 1s
    prev_global = lookup_time(frames - 1)
    step_global = times - prev_global  # t(f) - t(f-1)
    valid_pair = (
        np.isfinite(dt) & (dt > 0)
        & np.isfinite(step_global[:, 1:])
        & (step_global[:, 1:] <= 1.0)
    )
    vx = np.where(valid_pair, (pos[:, 1:, 0] - pos[:, :-1, 0]) / dt, np.nan)
    vy = np.where(valid_pair, (pos[:, 1:, 1] - pos[:, :-1, 1]) / dt, np.nan)
    l_sq = vx * vx + vy * vy
    if max_px_sq > 0:
        over = l_sq >= max_px_sq
        with np.errstate(invalid="ignore"):
            scale = np.where(over, max_speed_px / np.sqrt(
                np.where(l_sq > 0, l_sq, 1.0)), 1.0)
        vx = vx * scale
        vy = vy * scale
        l_sq = np.where(over, max_px_sq, l_sq)

    # NOTE: the scalar path breaks chains at invalid pairs (it resets
    # prev sample); with dense tracking every pair is valid, which is
    # the case this batch path handles — others go scalar (need_scalar).
    counts = np.isfinite(vx).sum(axis=1)
    # used_frames cap: reference stops after 6 samples
    with np.errstate(invalid="ignore"):
        raw_x = np.nansum(vx, axis=1)
        raw_y = np.nansum(vy, axis=1)
        # the scalar path divides by the GLOBAL one-frame step at the
        # newer sample (c_time - p_time), not the inter-sample dt, and
        # skips terms whose previous velocity is exactly zero
        # (Individual.cpp: `previous_v.x != 0 || previous_v.y != 0`)
        acc_step = step_global[:, 2:]
        prev_nonzero = (vx[:, :-1] != 0) | (vy[:, :-1] != 0)
        acc_div = np.where((acc_step > 0) & prev_nonzero, acc_step, np.nan)
        acc_x = np.nansum(np.diff(vx, axis=1) / acc_div, axis=1)
        acc_y = np.nansum(np.diff(vy, axis=1) / acc_div, axis=1)
    used = np.maximum(counts, 1)
    raw_x /= used
    raw_y /= used
    acc_x /= used
    acc_y /= used
    med = np.zeros(F)
    any_fin = np.isfinite(l_sq).any(axis=1)
    if any_fin.any():  # rows with no velocity sample keep med = 0
        med[any_fin] = np.nanmedian(
            np.where(np.isfinite(l_sq[any_fin]), l_sq[any_fin], np.nan),
            axis=1)
    speed = np.maximum(0.6, np.sqrt(med))

    nrm = np.hypot(raw_x, raw_y)
    dir_x = np.where(nrm > 0, raw_x / nrm, 0.0)
    dir_y = np.where(nrm > 0, raw_y / nrm, 0.0)
    nrm = np.hypot(acc_x, acc_y)
    accd_x = np.where(nrm > 0, acc_x / nrm, 0.0)
    accd_y = np.where(nrm > 0, acc_y / nrm, 0.0)

    np.seterr(**np_err)
    tdelta = np.maximum(time - prev_times, 1e-6)

    est_x = last_x.copy()
    est_y = last_y.copy()
    simple = prev_frames == frame - 1
    if lam < 1:
        # common case: prev == frame-1 -> single extrapolation step with
        # weight (1+lam)/(1+lam) == 1
        lu = lookup_time(prev_frames - 1)
        # missing t(prev-1) already trips the per-fish scalar
        # fallback (need_scalar); keep the dead branch harmless — an
        # absolute timestamp here would extrapolate by video-age
        step = np.where(np.isfinite(lu),
                        lookup_time(prev_frames) - lu, 0.0)
        ok = simple & (counts > 0) & np.isfinite(step)
        est_x = np.where(ok, est_x + step * speed
                         * (dir_x + step * accd_x), est_x)
        est_y = np.where(ok, est_y + step * speed
                         * (dir_y + step * accd_y), est_y)

    # a pair of VALID adjacent entries with an unusable velocity means
    # the scalar path's chain-breaking applies -> per-fish fallback;
    # so does a frame gap before a decay estimate (the scalar est loop
    # walks the skipped frames)
    invalid_any = ((~np.isfinite(vx)) & (frames[:, 1:] > -10 ** 8)
                   & (frames[:, :-1] > -10 ** 8)).any(axis=1)
    chain_broken = ~simple & (counts > 0) & (lam < 1)
    return dict(prev_frames=prev_frames, last_x=last_x, last_y=last_y,
                tdelta=tdelta, est_x=est_x, est_y=est_y, counts=counts,
                simple=simple, need_scalar=invalid_any | chain_broken)


def window_estimate_scalar(win: np.ndarray, fish_start: int, frame: int,
                           time: float, frame_times: dict,
                           settings) -> tuple[float, float]:
    """Scalar estimated position from ONE fish's (W, 4) window — a
    window-backed port of Individual.cache_for_frame's velocity loop +
    decay extrapolation (Individual.cpp:1940-2025) for engines that
    keep no Individual objects. The window holds the last <= W
    assignments, a superset of the <= 7 entries the scalar loop reads
    (lo = max(start, prev-6))."""
    s = settings
    rows = win[win[:, 0] > -1e8]
    if not len(rows):
        return 0.0, 0.0
    prev_frame = int(rows[-1, 0])
    last_x = float(rows[-1, 1])
    last_y = float(rows[-1, 2])
    ptime = float(rows[-1, 3])
    lo = max(int(fish_start), prev_frame - 6)
    rows = rows[rows[:, 0] >= lo]

    cm = s["cm_per_pixel"] or 1.0
    max_speed_px = (s["track_max_speed"] / cm) if cm else 0.0
    max_px_sq = max_speed_px * max_speed_px
    decay = min(1.0, max(0.0, s["track_speed_decay"]))
    lam = decay ** 4

    raw_x = raw_y = 0.0
    acc_x = acc_y = 0.0
    speeds_sq: list[float] = []
    used_frames = 0
    prev_vx = prev_vy = 0.0
    prev_px = prev_py = None
    prev_t = 0.0
    for rf, rx, ry, rt in rows:
        f = int(rf)
        c_time = frame_times.get(f, float(rt))
        if prev_px is None:
            prev_px, prev_py, prev_t = float(rx), float(ry), c_time
            continue
        p_time = frame_times.get(f - 1)
        if p_time is None or c_time - p_time > 1.0:
            prev_px, prev_py, prev_t = float(rx), float(ry), c_time
            continue
        dt = c_time - prev_t
        if dt <= 0:
            continue
        vx = (float(rx) - prev_px) / dt
        vy = (float(ry) - prev_py) / dt
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
        prev_px, prev_py, prev_t = float(rx), float(ry), c_time
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
    return est_x + last_x, est_y + last_y
