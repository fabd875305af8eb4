"""Device-resident tracking loop (PyTorch).

Counterpart of ``trex_tpu/ops/device_tracker.py`` for every match mode
the engines accept (``approximate``, and the optimal ``automatic``,
``hungarian`` and ``tree``) with or without the history split, speed
decay (``track_speed_decay < 1``) and posture. The per-frame tracking
recurrence runs over a chunk of detected frames with the tracker state
as carry; the result layout (packed carry vectors, packed per-frame
result) is byte-identical to the reference's, so a chunk can be resumed
in either package from the other's carry.

Per frame (the reference's ``_scan_impl`` step):

- caches: time probability from the recent-samples ring of the last
  ``frame_rate`` frames, size filter on the track-threshold recount;
- probability: p = tprob / (1 + d/global_td * cm/max_speed)^2 against
  blob bbox centres, distances measured from the last positions, or with
  ``track_speed_decay < 1`` from the decay-weighted extrapolation over
  the carry's motion window (:func:`_decay_estimates`);
- history split (``track_do_history_split``): with a SplitSpec and the
  frame pixels (the fused path) the exact expectation
  (``ops/device_split.py``) picks the blobs the host would split, the
  threshold-escalation executor splits them from the pixels and the
  pieces replace their parents at the parent's table position; without
  them (host-built tables), a frame where >= 2 recent fish lie within
  the split radius of one blob's runs is flagged;
- first pass: greedy per blob in index order, highest-p unused active
  fish, p > p_min (:func:`_greedy_pass`), or for the optimal modes the
  auction with its certificate (``ops/device_match.py``);
- second pass: reactivation of inactive fish against blob centroids,
  then new-fish creation in blob order while under max_fish;
- ``needs_host``: float32 decisions that could fall the other way in
  the host's float64 (deferral bands, uncertified auctions, marginal
  split decisions), size-filter knife edges, oversized blobs (with the
  split on the card only at the start frame), split capacity overflows,
  the trusted-probability cut, and under decay a motion window that
  the array math cannot reproduce (a chain break).

With ``calculate_posture`` the fused path runs the posture pass after
the scan, in the same call (``_posture_scan``, ``ops/device_posture.py``):
every (frame, fish) assignment of the chunk through one batch of the
posture chain, then the frame-sequential orientation select; frames
whose assignments include a split child, a blob too big for the crop or
a capacity overflow are flagged ``needs_host``. The packed result and
carry then carry the posture fields and the per-fish direction section.

The frame loop is a Python loop, and the greedy pass, the auction, the
split executor and the posture loops sync with the host every few
rounds: correct and slow. Capturing a chunk in a CUDA graph or a
persistent kernel is later work.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from ..config import SettingsView
from ..device import resolve_device
from .device_match import (GAP_GUARD, TIE_GUARD, auction_match,
                           edge_boundary_marginal)
from .device_posture import (PostureSpec, posture_lanes_batched,
                             posture_select_scan)
from .device_split import (SplitSpec, _hypot, _sqrt32, expectation_counts,
                           spec_from_settings, split_execute_device)
from .runcc import I32_MAX, detect_batch_runs

_F32 = torch.float32
_I32 = torch.int32


class TrackParams(NamedTuple):
    """Static tracking configuration (same fields as the reference)."""
    max_fish: int
    p_min: float
    cm_per_pixel: float
    max_speed: float
    t_max: float             # track_max_reassign_time
    frame_rate: int
    time_prob_enabled: bool
    minimum_frames: int      # min(frame_rate, 5)
    size_min: float          # track_size_filter (recount, cm^2)
    size_max: float
    do_history_split: bool = False
    split_radius: float = 0.0  # HistorySplit max_d in px (0 = off)
    detect_size_min: float = 0.0   # detect_size_filter (cm^2)
    detect_size_max: float = float("inf")
    has_size_filter: bool = False  # track_size_filter set at all
    match_optimal: bool = False    # automatic/hungarian/tree modes
    do_posture: bool = False       # calculate_posture
    size_ranges: tuple = ()        # full multi-range track filters
    detect_size_ranges: tuple = ()
    # track_speed_decay < 1: the carry grows a (F, DECAY_WIN, 5) motion
    # window [frame, x, y, time, global step] and an (F, 3) accumulated
    # chain walk [dx, dy, err]
    do_decay: bool = False
    decay_lambda: float = 1.0      # decay^4
    trusted_p: float = 0.0         # track_trusted_probability


# window length of the decay estimate (track/individual.CACHE_WINDOW)
DECAY_WIN = 7
# f32 machine epsilon: unit for the f32-arithmetic error bounds that
# widen the matching passes' deferral bands
EPS32 = float(2.0 ** -23)
# torch.profiler ranges of the frame step's optimal matcher and history
# split and of the chunk's posture pass, for launch counts by part
AUCTION_RANGE = "trex.auction_match"
SPLIT_RANGE = "trex.history_split"
POSTURE_RANGE = "trex.posture"


def _in_size_ranges(size, ranges: tuple, lo: float, hi: float):
    """In-any-range test; the collapsed [lo, hi] form is exact when <= 1
    range is set."""
    if len(ranges) <= 1:
        return (size >= lo) & (size <= hi)
    ok = torch.zeros(size.shape, dtype=torch.bool, device=size.device)
    for rlo, rhi in ranges:
        ok = ok | ((size >= rlo) & (size <= rhi))
    return ok


def params_from_settings(s) -> TrackParams:
    """TrackParams from any settings mapping (missing keys take the
    port's defaults, see ``config/defaults.py``)."""
    s = SettingsView(s)
    fr = int(s["frame_rate"] or 25)
    ranges = s["track_size_filter"] or []
    lo = min((r[0] for r in ranges), default=0.0)
    hi = max((r[1] for r in ranges), default=float("inf"))
    cm = float(s["cm_per_pixel"] or 1.0)
    radius = (float(s["track_max_speed"]) / cm) / max(1.0, float(fr)) \
        * 0.5
    dranges = s["detect_size_filter"] or []
    dlo = min((r[0] for r in dranges), default=0.0)
    dhi = max((r[1] for r in dranges), default=float("inf"))
    decay = min(1.0, max(0.0, float(s["track_speed_decay"])))
    return TrackParams(
        max_fish=int(s["track_max_individuals"]),
        p_min=float(s["match_min_probability"]),
        cm_per_pixel=cm,
        max_speed=float(s["track_max_speed"]),
        t_max=float(s["track_max_reassign_time"]),
        frame_rate=fr,
        time_prob_enabled=bool(s["track_time_probability_enabled"]),
        minimum_frames=min(fr, 5),
        size_min=float(lo), size_max=float(hi),
        do_history_split=bool(s["track_do_history_split"]),
        split_radius=radius,
        detect_size_min=float(dlo), detect_size_max=float(dhi),
        has_size_filter=bool(ranges),
        match_optimal=s["match_mode"] != "approximate",
        do_posture=bool(s["calculate_posture"]),
        size_ranges=tuple((float(a), float(b)) for a, b in ranges),
        detect_size_ranges=tuple((float(a), float(b))
                                 for a, b in dranges),
        do_decay=decay ** 4 < 1.0,
        decay_lambda=decay ** 4,
        trusted_p=float(s["track_trusted_probability"] or 0.0))


def _init_carry(P: TrackParams, start_frame=0, t0=0.0,
                device=None) -> dict:
    F = P.max_fish
    dev = resolve_device(device)
    c = dict(
        last_x=torch.zeros(F, dtype=_F32, device=dev),
        last_y=torch.zeros(F, dtype=_F32, device=dev),
        last_time=torch.zeros(F, dtype=_F32, device=dev),
        last_frame=torch.full((F,), -(10 ** 9), dtype=_I32, device=dev),
        n_basic=torch.zeros(F, dtype=_I32, device=dev),
        seen=torch.zeros((F, P.frame_rate), dtype=torch.bool,
                         device=dev),  # ring, newest last
        n_fish=torch.zeros((), dtype=_I32, device=dev),
        start_frame=torch.as_tensor(start_frame, device=dev).to(_I32),
        prev_time=torch.as_tensor(t0, device=dev).to(_F32))
    if P.do_decay:
        win = torch.zeros((F, DECAY_WIN, 5), dtype=_F32, device=dev)
        win[:, :, 0] = -1e9
        c["win"] = win
        c["dacc"] = torch.zeros((F, 3), dtype=_F32, device=dev)
    return c


def _sum_lr(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis from left to right, starting at +0: the
    order of XLA's CPU reduction over the window's few pairs
    (``torch.sum`` reduces as a tree on the card and may vectorise on
    the CPU)."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for k in range(x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def _rdiv(c: float, t: torch.Tensor) -> torch.Tensor:
    """The float32 division c / t (``c / t`` of a Python scalar
    multiplies by the reciprocal, which rounds twice)."""
    return torch.full_like(t, c) / t


def _decay_estimates(win: torch.Tensor, P: TrackParams,
                     dacc: torch.Tensor = None):
    """Decay-extrapolated positions over the carry's (F, W, 5) motion
    windows [frame, x, y, time, global step]: the JAX package's
    ``_decay_estimates`` (the array form of cache_batch.window_motion and
    window_estimate_scalar, Individual.cpp:1940-2025).

    Returns (est_x, est_y, need_host, est_err, motion). need_host marks
    fish whose window holds a broken pair (the exact scalar walk runs on
    the host); a fish with a frame gap adds the accumulated walk `dacc`
    [dx, dy, err] over the skipped frames. est_err bounds |est_f32 -
    est_f64| to first order (the host replay computes the chain in
    float64) and widens the deferral bands. `motion` holds the terms the
    step uses to extend dacc for fish still unassigned."""
    wf = win[:, :, 0]
    prev = wf[:, -1]
    valid = (wf > -1e8) & (wf >= (prev - 6)[:, None])
    x = win[:, :, 1]
    y = win[:, :, 2]
    t = win[:, :, 3]
    st = win[:, :, 4]
    dt = t[:, 1:] - t[:, :-1]
    pair_exists = valid[:, 1:] & valid[:, :-1]
    pair_ok = pair_exists & (dt > 0) & (st[:, 1:] <= 1.0)
    bad = (pair_exists & ~pair_ok).any(1)
    dts = torch.where(pair_ok, dt, 1.0)
    vx = torch.where(pair_ok, (x[:, 1:] - x[:, :-1]) / dts, 0.0)
    vy = torch.where(pair_ok, (y[:, 1:] - y[:, :-1]) / dts, 0.0)
    l_sq = vx * vx + vy * vy
    cm = P.cm_per_pixel
    max_speed_px = (P.max_speed / cm) if cm else 0.0
    if max_speed_px > 0:
        over = pair_ok & (l_sq >= max_speed_px * max_speed_px)
        scale = torch.where(over, _rdiv(max_speed_px, _sqrt32(
            torch.where(l_sq > 0, l_sq, 1.0))), 1.0)
        vx = vx * scale
        vy = vy * scale
        l_sq = torch.where(over, max_speed_px * max_speed_px, l_sq)
    counts = pair_ok.sum(1, dtype=_I32)
    used = torch.clamp_min(counts, 1).to(_F32)
    raw_x = _sum_lr(vx) / used
    raw_y = _sum_lr(vy) / used
    # acceleration: the global step at the newer sample; terms with a
    # zero previous velocity are skipped (Individual.cpp)
    acc_step = st[:, 2:]
    prev_nz = pair_ok[:, :-1] & ((vx[:, :-1] != 0) | (vy[:, :-1] != 0))
    acc_ok = pair_ok[:, 1:] & (acc_step > 0) & prev_nz
    acc_div = torch.where(acc_ok, acc_step, 1.0)
    acc_x = _sum_lr(torch.where(acc_ok, (vx[:, 1:] - vx[:, :-1]) / acc_div,
                                0.0)) / used
    acc_y = _sum_lr(torch.where(acc_ok, (vy[:, 1:] - vy[:, :-1]) / acc_div,
                                0.0)) / used
    # median pair speed^2 (numpy's midpoint convention); only the sorted
    # values are read, so the order of equal keys does not matter
    srt = torch.sort(torch.where(pair_ok, l_sq, float("inf")), 1).values
    lo_i = torch.clamp_min(torch.div(counts - 1, 2, rounding_mode="floor"),
                           0).long()
    hi_i = torch.clamp_min(torch.div(counts, 2, rounding_mode="floor"),
                           0).long()
    med = 0.5 * (torch.gather(srt, 1, lo_i[:, None])[:, 0]
                 + torch.gather(srt, 1, hi_i[:, None])[:, 0])
    med = torch.where(counts > 0, med, 0.0)
    speed = torch.clamp_min(_sqrt32(med), 0.6)
    nrm_v = _hypot(raw_x, raw_y)
    dir_x = torch.where(nrm_v > 0, raw_x / nrm_v, 0.0)
    dir_y = torch.where(nrm_v > 0, raw_y / nrm_v, 0.0)
    nrm_a = _hypot(acc_x, acc_y)
    accd_x = torch.where(nrm_a > 0, acc_x / nrm_a, 0.0)
    accd_y = torch.where(nrm_a > 0, acc_y / nrm_a, 0.0)
    step = st[:, -1]
    # the first walk term (f' = prev, weight exactly 1 in both
    # precisions); the terms of the skipped frames of a fish with a gap
    # are in the accumulated dacc section
    ok = counts > 0
    last_x = x[:, -1]
    last_y = y[:, -1]
    est_x = torch.where(ok, last_x + step * speed
                        * (dir_x + step * accd_x), last_x)
    est_y = torch.where(ok, last_y + step * speed
                        * (dir_y + step * accd_y), last_y)
    if dacc is not None:
        est_x = est_x + torch.where(ok, dacc[:, 0], 0.0)
        est_y = est_y + torch.where(ok, dacc[:, 1], 0.0)

    # f32-vs-f64 estimate error bound (first order): the window's
    # positions and times are the float32 images of the host's float64
    # values; per pair the position packing over dt, the division and
    # clamp rounding, and the dt packing through dv/ddt = -v/dt, each
    # with 2x safety. A term whose pair inputs equal the previous pair's
    # cancels within each precision and leaks only the packing.
    pos_mag = torch.maximum(last_x.abs(), last_y.abs())
    ulp_pos = (pos_mag + 1.0) * EPS32
    ulp_t = (torch.where(valid, t.abs(), 0.0).amax(1) + 1.0) * EPS32
    dxp = x[:, 1:] - x[:, :-1]
    dyp = y[:, 1:] - y[:, :-1]
    vmag = vx.abs() + vy.abs()
    pack = (2.0 * ulp_pos[:, None] + vmag * ulp_t[:, None]) / dts
    verr = torch.where(pair_ok, 2.0 * pack + 8.0 * EPS32 * vmag, 0.0)
    dv = _sum_lr(verr) / used
    same = (dxp[:, 1:] == dxp[:, :-1]) & (dyp[:, 1:] == dyp[:, :-1]) \
        & (dt[:, 1:] == dt[:, :-1])
    aerr_full = (verr[:, 1:] + verr[:, :-1]
                 + 8.0 * EPS32 * (vmag[:, 1:] + vmag[:, :-1])) / acc_div
    aerr_same = 2.0 * (pack[:, 1:] + pack[:, :-1]) / acc_div
    aerr = torch.where(acc_ok, torch.where(same, aerr_same, aerr_full), 0.0)
    da = _sum_lr(aerr) / used
    vel_rel = torch.where(dv > 0, torch.clamp_max(
        2.0 * dv / torch.clamp_min(nrm_v, 1e-30), 2.0), 0.0)
    acc_rel = torch.where(da > 0, torch.clamp_max(
        2.0 * da / torch.clamp_min(nrm_a, 1e-30), 2.0), 0.0)
    v_max = _sqrt32(torch.where(pair_ok, l_sq, 0.0).amax(1))
    dv_s = verr.amax(1) + 8.0 * EPS32 * v_max
    speed_rel = dv_s / speed                   # speed >= 0.6 floor
    disp = step.abs() * speed * (1.0 + step.abs())
    est_err = 2.0 * ulp_pos + torch.where(
        ok, disp * (vel_rel + step.abs() * acc_rel + speed_rel
                    + 16.0 * EPS32), 0.0)
    if dacc is not None:
        est_err = est_err + torch.where(ok, dacc[:, 2], 0.0)
    motion = dict(speed=speed, dir_x=dir_x, dir_y=dir_y, accd_x=accd_x,
                  accd_y=accd_y, counts=counts, vel_rel=vel_rel,
                  acc_rel=acc_rel, speed_rel=speed_rel)
    return est_x, est_y, bad, est_err, motion


def _greedy_pass(Pmat, valid_b, taken_f, fish_of_blob, threshold):
    """Per-blob greedy: highest-probability unused fish, first-max
    (= lowest fish id) tie-break, blobs in index order.

    Round-based exact simulation of the sequential scan: each round,
    every still-seeking blob proposes its best available fish; a fish
    grants to its lowest-index proposer, and grants commit only for
    blobs below the first losing proposer. Each round retires >= 1
    blob; the loop syncs with the host once per round."""
    F, B = Pmat.shape
    dev = Pmat.device
    BIG = B + F + 1
    bidx = torch.arange(B, dtype=_I32, device=dev)
    taken, fob = taken_f, fish_of_blob
    while True:
        avail = torch.where(taken[:, None], -1.0, Pmat)  # (F, B)
        bestf = torch.argmax(avail, 0).to(_I32)
        bestp = torch.amax(avail, 0)
        seeking = valid_b & (fob < 0) & (bestp > threshold)
        # min proposer per fish (drop slot F for non-seeking blobs)
        prop_key = torch.where(seeking, bidx, BIG)
        min_prop = torch.full((F + 1,), I32_MAX, dtype=_I32, device=dev)
        min_prop.scatter_reduce_(0, torch.where(seeking, bestf, F).long(),
                                 prop_key, "amin")
        winner = seeking & (min_prop[:F][bestf.long()] == bidx)
        loser_min = torch.where(seeking & ~winner, bidx, BIG).min()
        commit = winner & (bidx < loser_min)
        grant = torch.zeros(F + 1, dtype=torch.bool, device=dev)
        grant.scatter_(0, torch.where(commit, bestf, F).long(), True)
        taken = taken | grant[:F]
        fob = torch.where(commit, bestf, fob)
        if not bool((seeking & ~commit).any() & commit.any()):
            return taken, fob


def _split_on_card(carry, has, est_x, est_y, cx, cy, bcx, bcy, rec, bvalid,
                   size, in_range, frame, at_start, runs, bbox, frame_img,
                   background, S: SplitSpec, P: TrackParams):
    """The exact history split of one frame on the card (the host's
    _apply_history_split with _rebuild_with_splits): the expectation
    picks the blobs the host would split, the executor splits them from
    the frame's pixels, and the pieces replace their parents at the
    parent's table position. Returns the rebuilt table (cx, cy, bcx,
    bcy, rec, bvalid; width B + max_splits * max_pieces), the
    permutation from it to the concatenated [table, pieces] rows, the
    number of split rows, and the frame's needs_host contribution."""
    B = cx.shape[0]
    dev = cx.device
    ry, rx0, rx1, rslot = runs
    bx0i, by0i, bx1i, by1i = bbox
    recent = has & (carry["last_frame"].to(_F32)
                    >= frame - P.frame_rate * P.t_max)
    # the host's candidate table drops `small` rows before its
    # expectation (keep = in any range | big); for <= 1 range that is
    # size >= lo
    exp_ok = bvalid
    if P.has_size_filter:
        if len(P.size_ranges) <= 1:
            exp_ok = exp_ok & (size >= P.size_min)
        else:
            exp_ok = exp_ok & (in_range | (size > P.size_max))
    expect, marg = expectation_counts(
        est_x, est_y, recent, ry, rx0, rx1, rslot,
        bx0i.to(_F32), by0i.to(_F32), bx1i.to(_F32), by1i.to(_F32),
        exp_ok, torch.tensor(P.split_radius, dtype=_F32, device=dev), B)
    split_rows = (expect >= 2) & exp_ok & ~at_start
    n_split = split_rows.sum(dtype=_I32)
    too_big = split_rows & ((bx1i - bx0i + 3 > S.crop_w)
                            | (by1i - by0i + 3 > S.crop_h))
    needs_host = (marg & ~at_start) | too_big.any()
    bidx = torch.arange(B, dtype=_I32, device=dev)
    order = torch.argsort(torch.where(split_rows, bidx, B), stable=True)
    MP = S.max_pieces
    SM = min(S.max_splits, B)
    needs_host = needs_host | (n_split > SM)
    tgts = order[:SM].to(_I32)
    rows_v = torch.zeros((SM, MP, 7), dtype=_F32, device=dev)
    np_v = torch.zeros(SM, dtype=_I32, device=dev)
    n_live = min(int(n_split), SM) if S.enabled else 0
    if n_live:
        # only the live lanes run: the reference's other lanes are
        # masked out of every output (their piece counts and marginal
        # flags), so their values never reach a valid row
        t = tgts[:n_live]
        r, n_out, m = split_execute_device(
            frame_img, background, t, bx0i[t.long()], by0i[t.long()], ry,
            rx0, rx1, rslot, expect[t.long()], S)
        rows_v[:n_live] = r
        np_v[:n_live] = n_out
        needs_host = needs_host | m.any()
    # without a split algorithm the parents drop with no pieces, like
    # the host engine's _split_native returning []
    pr = rows_v.reshape(SM * MP, 7)
    pn = pr[:, 0]
    psafe = torch.clamp_min(pn, 1.0)
    k = torch.arange(MP, device=dev)[None, :]
    live = k < np_v[:, None]
    # a fractional sort key keeps the pieces in order at the parent's
    # place (engine._rebuild_with_splits)
    p_keys = torch.where(
        live, tgts[:, None].to(_F32)
        + (k + 1).to(_F32) / (np_v[:, None] + 2).to(_F32), float("inf"))
    keys = torch.cat([torch.where(bvalid & ~split_rows, bidx.to(_F32),
                                  float("inf")), p_keys.reshape(-1)])
    perm = torch.argsort(keys, stable=True)
    cx = torch.cat([cx, pr[:, 5] / psafe])[perm]
    cy = torch.cat([cy, pr[:, 6] / psafe])[perm]
    bcx = torch.cat([bcx, (pr[:, 1] + pr[:, 3] + 1) * 0.5])[perm]
    bcy = torch.cat([bcy, (pr[:, 2] + pr[:, 4] + 1) * 0.5])[perm]
    rec = torch.cat([rec, pn])[perm]
    bvalid = torch.cat([bvalid & ~split_rows, live.reshape(-1)])[perm]
    return cx, cy, bcx, bcy, rec, bvalid, perm, n_split, needs_host


def _step(carry: dict, cx, cy, bcx, bcy, rec, bvalid, time, frame,
          flag_size, P: TrackParams, t_max_t, min_frames_t, runs=None,
          bbox=None, frame_img=None, background=None, split_spec=None,
          stats=None):
    """One frame of the tracking recurrence -> (new carry, outputs).

    runs: the frame's track-mask run tables (y, x0, x1, slot) or None;
    with `bbox` (x0, y0, x1, y1 int32), the frame's pixels and a
    `split_spec`, history splits run on the card. `stats`, when given,
    receives the frame's auction rounds, whether the auction deferred,
    its split targets, whether the split deferred and with decay whether
    a broken motion window flagged the frame."""
    sq = P.cm_per_pixel * P.cm_per_pixel
    cms = P.cm_per_pixel / P.max_speed
    t_delta_frame = 1.0 / P.frame_rate
    F = P.max_fish
    dev = cx.device
    B = cx.shape[0]
    start_frame = carry["start_frame"]
    prev_time = carry["prev_time"]
    created = torch.arange(F, device=dev) < carry["n_fish"]
    has = (carry["last_frame"] > -(10 ** 8)) & created
    tdelta = torch.clamp_min(time - carry["last_time"], 1e-6)
    # the estimated positions that the matching distances and the
    # history split measure from: with decay the extrapolation over the
    # motion window (the last positions where the window needs the host's
    # scalar walk), else the last positions
    dec_bad = None
    dec_host = False
    if P.do_decay:
        est_x, est_y, dec_bad, est_err, motion = _decay_estimates(
            carry["win"], P, carry["dacc"])
        est_x = torch.where(dec_bad, carry["last_x"], est_x)
        est_y = torch.where(dec_bad, carry["last_y"], est_y)
    else:
        est_x = carry["last_x"]
        est_y = carry["last_y"]
        # est = last f32-packed centroid: packing + one compare
        est_err = 2.0 * EPS32 * (torch.maximum(est_x.abs(), est_y.abs())
                                 + 1.0)
    size = rec * sq
    in_range = _in_size_ranges(size, P.size_ranges, P.size_min,
                               P.size_max)
    at_start = frame == start_frame
    use_split = split_spec is not None
    needs_host = (bvalid & (size > P.size_max)).any()
    if use_split:
        # oversized rows split (or drop) as on the host; only the start
        # frame's big-blob split needs the host
        needs_host = needs_host & at_start
    if flag_size.shape[0]:
        # `huge` parents never appear as child rows: escalate
        needs_host = needs_host | (flag_size * sq > P.size_max * 100).any()
    if dec_bad is not None and runs is not None and P.do_history_split \
            and P.split_radius > 0:
        # a recent fish whose window needs the scalar walk poisons the
        # split expectation too
        recent = has & (carry["last_frame"].to(_F32)
                        >= frame - P.frame_rate * P.t_max)
        dec_host = (recent & dec_bad & ~at_start).any()
        needs_host = needs_host | dec_host
    perm = None
    n_split = None
    B0 = B
    if use_split:
        with record_function(SPLIT_RANGE):
            (cx, cy, bcx, bcy, rec, bvalid, perm, n_split,
             split_host) = _split_on_card(
                carry, has, est_x, est_y, cx, cy, bcx, bcy, rec, bvalid,
                size, in_range, frame, at_start, runs, bbox, frame_img,
                background, split_spec, P)
        needs_host = needs_host | split_host
        if stats is not None:
            stats["split_marginal"] = split_host
        size = rec * sq
        in_range = _in_size_ranges(size, P.size_ranges, P.size_min,
                                   P.size_max)
        B = cx.shape[0]
    bval = bvalid & in_range
    # size-filter knife edge: an f32 size within a few ulp of a bound
    # can sit on the other side of the cut in the host's f64
    if P.has_size_filter or P.size_max < float("inf"):
        serr = 8.0 * EPS32 * (size + 1.0)
        near_b = torch.zeros(size.shape, dtype=torch.bool, device=dev)
        s_bounds = P.size_ranges if len(P.size_ranges) > 1 \
            else ((P.size_min, P.size_max),)
        for lo_b, hi_b in s_bounds:
            if lo_b > 0:
                near_b = near_b | ((size - lo_b).abs() <= serr)
            if hi_b < float("inf"):
                near_b = near_b | ((size - hi_b).abs() <= serr)
        needs_host = needs_host | (near_b & bvalid).any()

    if not use_split and runs is not None and P.do_history_split \
            and P.split_radius > 0:
        # no split on the card: flag frames where >= 2 recent fish lie
        # within the split radius of one blob's runs (a superset of the
        # host expectation: exact point-to-run distances, no sampling,
        # no clique resolution), for the host replay to split
        ry, rx0, rx1, rslot = runs
        recent = has & (carry["last_frame"].to(_F32)
                        >= frame - P.frame_rate * P.t_max)
        fx = est_x[:, None]
        dxr = torch.minimum(torch.maximum(fx, rx0.to(_F32)[None, :]),
                            rx1.to(_F32)[None, :]) - fx
        dyr = ry.to(_F32)[None, :] - est_y[:, None]
        d2 = dxr * dxr + dyr * dyr                        # (F, R)
        slot = torch.clamp_max(rslot, B).long()
        mind2 = torch.full((F, B + 1), float("inf"), dtype=_F32,
                           device=dev).scatter_reduce_(
            1, slot[None, :].expand_as(d2), d2, "amin")[:, :B]
        # the radius widened by device_split.EPS_D keeps the trigger a
        # superset of the host's float64 decision
        r_eps = P.split_radius + 1e-3
        near = (mind2 <= r_eps * r_eps) & recent[:, None]
        contested = (near.sum(0) >= 2) & bvalid
        needs_host = needs_host | (contested.any() & ~at_start)

    # time probability
    if P.time_prob_enabled:
        p = 1.0 - torch.clamp((tdelta - t_delta_frame) / t_max_t, 0.0, 1.0)
        R = carry["seen"].sum(1, dtype=_I32)
        needs = has & (carry["last_frame"]
                       >= start_frame + P.minimum_frames)
        scale = torch.where(
            needs,
            torch.clamp_max((R - 1).to(_F32) / min_frames_t + P.p_min,
                            1.0),
            1.0)
        tprob = torch.where(tdelta > P.t_max, 0.0,
                            (p * scale) * 0.75 + 0.25)
        tprob = torch.where(has, tprob, 0.0)
    else:
        tprob = torch.where(has, 1.0, 0.0)

    # the global one-frame delta divides position speeds; zero -> inf
    gt = time - prev_time
    global_td = torch.where(gt > 0, gt, float("inf"))

    # first pass over bbox centres, active fish only
    d = _hypot(bcx[None, :] - est_x[:, None], bcy[None, :] - est_y[:, None])
    speed = d / global_td * cms
    usable = has & (tprob > 0) & (tdelta < P.t_max)
    if dec_bad is not None:
        # a usable fish whose estimate needs the scalar walk: the whole
        # frame replays on the host
        dec_host = dec_host | (usable & dec_bad).any()
        needs_host = needs_host | dec_host
        if stats is not None:
            stats["decay_flag"] = dec_host
    Pmat = tprob[:, None] / (1.0 + speed) ** 2
    Pmat = torch.where(usable[:, None], Pmat, 0.0)

    # f32-vs-f64 probability error bound (first order)
    inv_gtd = torch.where(torch.isfinite(global_td), 1.0 / global_td, 0.0)
    td_err = 4.0 * EPS32 * (time.abs() + 1.0)
    tprob_err = torch.where(
        has, (0.75 / P.t_max) * td_err + 8.0 * EPS32 * tprob, 0.0)
    d_err = est_err[:, None] + 4.0 * EPS32 * (
        d + torch.maximum(bcx.abs(), bcy.abs())[None, :] + 1.0)
    speed_err = d_err * cms * inv_gtd \
        + speed * (td_err * inv_gtd + 4.0 * EPS32)
    p_err = (2.0 * tprob[:, None] * speed_err / (1.0 + speed) ** 3
             + tprob_err[:, None] / (1.0 + speed) ** 2
             + 8.0 * EPS32 * Pmat)
    p_err = torch.where(usable[:, None] & bval[None, :], p_err, 0.0)
    # the usable/inactive cuts compare tdelta against t_max
    needs_host = needs_host | (
        has & ((tdelta - P.t_max).abs() <= td_err)).any()

    fob = torch.full((B,), -1, dtype=_I32, device=dev)
    if P.match_optimal:
        # automatic/hungarian/tree: the optimal max-sum assignment (per-
        # clique optima compose, so the auction solves the whole frame);
        # near-ties and uncertified frames defer. An alternative the
        # host's f64 values prefer shifts each edge by <= max p_err, so
        # the tightness band widens by twice that
        edge_ok = (Pmat > P.p_min) & usable[:, None] & bval[None, :]
        pad = 2.0 * torch.where(edge_ok, p_err, 0.0).amax()
        astats = {} if stats is not None else None
        with record_function(AUCTION_RANGE):
            fob, marg_m = auction_match(Pmat, edge_ok, gap_guard=GAP_GUARD,
                                        tie_guard=TIE_GUARD + pad,
                                        stats=astats)
        needs_host = needs_host | marg_m | edge_boundary_marginal(
            Pmat, usable, bval, P.p_min, p_err)
        if stats is not None:
            stats.update(rounds=astats["rounds"],
                         cap_hit=astats["cap_hit"], auction_marginal=marg_m)
    else:
        _, fob = _greedy_pass(Pmat, bval, ~usable, fob, P.p_min)
        # defer frames where the f32 p_min edge set or any per-blob
        # ordering could differ from the host's f64 scan
        cand = usable[:, None] & bval[None, :] & (Pmat > P.p_min - p_err)
        col_err = torch.where(cand, p_err, 0.0).amax(0)
        vals = torch.sort(torch.where(cand, Pmat, float("-inf")),
                          0).values
        adj_tie = (vals[1:] - vals[:-1]) <= 2.0 * col_err[None, :]
        needs_host = needs_host \
            | (torch.isfinite(vals[:-1]) & adj_tie).any() \
            | edge_boundary_marginal(Pmat, usable, bval, P.p_min, p_err)
    if stats is not None:
        stats["n_split"] = n_split
    n_first = (fob >= 0).sum(dtype=_I32)
    first_fob = fob

    # second pass: reactivation over centroids (unclamped)
    last_x = carry["last_x"]
    last_y = carry["last_y"]
    inactive = created & ((~has) | (tdelta >= P.t_max))
    sqd = (cx[None, :] - last_x[:, None]) ** 2 \
        + (cy[None, :] - last_y[:, None]) ** 2
    pre = torch.where(sqd > 0, 1.0 / sqd / global_td, 1.0 / global_td)
    pre = torch.where(global_td <= 0, 1.0, pre)
    pre = P.p_min + pre * (1.0 - P.p_min)
    pre = torch.where((carry["n_basic"] > 0)[:, None], pre, P.p_min)
    pre = torch.where(inactive[:, None], pre, -1.0)
    free = bval & (fob < 0)
    _, fob = _greedy_pass(pre, free, ~inactive, fob, 0.0)
    n_react = (fob >= 0).sum(dtype=_I32) - n_first
    # reactivation knife edges (the host runs the same scan in f64 over
    # its own centroids, of which the carry holds f32 roundings)
    pos_err = (torch.maximum(last_x.abs(), last_y.abs()) + 1.0) * EPS32
    sq_rel = torch.where(
        sqd > 0,
        4.0 * pos_err[:, None] / torch.sqrt(torch.clamp_min(sqd, 1e-30)),
        0.0)
    pre_err = 8.0 * EPS32 * pre.abs() \
        + torch.clamp_min(pre - P.p_min, 0.0) \
        * (4.0 * EPS32 + td_err * inv_gtd + sq_rel)
    cand_r = inactive[:, None] & free[None, :]
    needs_host = needs_host | (cand_r & (sqd <= 0)).any()
    colr_err = torch.where(cand_r, pre_err, 0.0).amax(0)
    vals_r = torch.sort(torch.where(cand_r, pre, float("-inf")), 0).values
    tie_r = (vals_r[1:] - vals_r[:-1]) <= 2.0 * colr_err[None, :]
    needs_host = needs_host | (torch.isfinite(vals_r[:-1]) & tie_r).any()

    # creation: remaining free blobs claim new ids in blob order
    still_free = bval & (fob < 0)
    order = torch.cumsum(still_free.to(_I32), 0, dtype=_I32) - 1
    new_id = carry["n_fish"] + order
    create = still_free & (new_id < F)
    fob = torch.where(create, new_id, fob)
    n_fish = torch.clamp_max(carry["n_fish"] + create.sum(dtype=_I32), F)

    # scatter per-fish updates; unassigned rows go to the drop slot F
    assigned = fob >= 0
    fish_idx = torch.where(assigned, fob, F).long()
    fx = torch.zeros(F + 1, dtype=_F32, device=dev) \
        .scatter_(0, fish_idx, cx)[:F]
    fy = torch.zeros(F + 1, dtype=_F32, device=dev) \
        .scatter_(0, fish_idx, cy)[:F]
    got = torch.zeros(F + 1, dtype=torch.bool, device=dev) \
        .scatter_(0, fish_idx, assigned)[:F]
    bi = torch.arange(B, dtype=_I32, device=dev)
    # the row of the assigned blob in the detection table; with splits
    # on the card rows index the permuted table, whose pieces (index >=
    # the table's width) have no row there
    orig_of_b = bi if perm is None else perm.to(_I32)
    fish_row = torch.full((F + 1,), -1, dtype=_I32, device=dev).scatter_(
        0, fish_idx, torch.where(assigned, orig_of_b, -1))[:F]
    fish_child = torch.zeros(F + 1, dtype=torch.bool, device=dev) \
        .scatter_(0, fish_idx, assigned & (orig_of_b >= B0))[:F]
    # assigned first-pass probability per fish (-1 for reactivations and
    # creations)
    first = first_fob >= 0
    fsafe = first_fob.clamp(0, F - 1).long()
    pvals_b = torch.where(first, Pmat[fsafe, bi.long()], -1.0)
    fish_prob = torch.full((F + 1,), -1.0, dtype=_F32, device=dev) \
        .scatter_(0, fish_idx, torch.where(first, pvals_b, -1.0))[:F]
    if P.trusted_p > 0:
        # a committed probability within p_err of the trusted cut could
        # break the archive tracklet differently in the host's f64
        perr_b = torch.where(first, p_err[fsafe, bi.long()], 0.0)
        needs_host = needs_host | (
            first & ((pvals_b - P.trusted_p).abs() <= perr_b)).any()

    seen = torch.cat([carry["seen"][:, 1:], got[:, None]], 1)
    new_carry = dict(
        last_x=torch.where(got, fx, carry["last_x"]),
        last_y=torch.where(got, fy, carry["last_y"]),
        last_time=torch.where(got, time, carry["last_time"]),
        last_frame=torch.where(got, frame, carry["last_frame"]).to(_I32),
        n_basic=carry["n_basic"] + got.to(_I32),
        seen=seen, n_fish=n_fish,
        start_frame=carry["start_frame"],
        prev_time=time.to(_F32))
    if P.do_decay:
        _decay_update(new_carry, carry, got, fx, fy, has, time, frame,
                      motion, P)
    out = dict(fish_x=new_carry["last_x"], fish_y=new_carry["last_y"],
               fish_seen=got, fish_row=fish_row, fish_child=fish_child,
               fish_prob=fish_prob, n_assigned=n_first + n_react,
               needs_host=needs_host,
               carry_vec=_carry_to_vec(new_carry))
    return new_carry, out


def _decay_update(new_carry: dict, carry: dict, got, fx, fy, has, time,
                  frame, motion: dict, P: TrackParams) -> None:
    """The decay sections of the next carry: assigned fish shift their
    motion window and append [frame, x, y, time, global step]; a fish
    left unassigned adds this frame's term of the scalar walk to its
    accumulated `dacc` (window_estimate_scalar's loop, one term a frame,
    weight (1 + lam) / (1 + lam * max(1, j)) with j = frame - prev + 1),
    and an assignment resets it. The error column adds the same first-
    order bound as the one-step estimate, scaled by the term's
    displacement, plus the rounding of the adds."""
    F = P.max_fish
    dev = fx.device
    prev_time = carry["prev_time"]
    g = (time - prev_time).to(_F32)
    entry = torch.stack([
        frame.to(_F32).expand(F), fx.to(_F32), fy.to(_F32),
        time.to(_F32).expand(F), g.expand(F)], 1)
    shifted = torch.cat([carry["win"][:, 1:], entry[:, None, :]], 1)
    new_carry["win"] = torch.where(got[:, None, None], shifted,
                                   carry["win"])
    lam = torch.tensor(P.decay_lambda, dtype=_F32, device=dev)
    j = (frame - carry["last_frame"] + 1).to(_F32)
    w = (1.0 + lam) / (1.0 + lam * torch.clamp_min(j, 1.0))
    kx = w * g * motion["speed"] * (motion["dir_x"] + g * motion["accd_x"])
    ky = w * g * motion["speed"] * (motion["dir_y"] + g * motion["accd_y"])
    disp_t = (w * g).abs() * motion["speed"] * (1.0 + g.abs())
    kerr = disp_t * (motion["vel_rel"] + g.abs() * motion["acc_rel"]
                     + motion["speed_rel"] + 16.0 * EPS32) \
        + 8.0 * EPS32 * (kx.abs() + ky.abs() + 1e-30)
    can = (has & (motion["counts"] > 0) & ~got)[:, None]
    dacc = carry["dacc"]
    new_dacc = torch.where(can, dacc + torch.stack([kx, ky, kerr], 1),
                           dacc)
    new_carry["dacc"] = torch.where(got[:, None], 0.0, new_dacc)


def _scan_impl(det: dict, times: torch.Tensor, frames_idx: torch.Tensor,
               P: TrackParams, carry0: dict, frames=None, background=None,
               split_spec: SplitSpec = None,
               stats: list = None) -> tuple[dict, dict]:
    """Run the tracking recurrence over detected frames.

    det: stacked per-frame blob tables, (T, B) tensors "cx", "cy"
    (centroids), "bcx", "bcy" (bbox centres), "recount" (track-threshold
    pixel count), "valid", optionally "flag_size" (T, Bp), the (T, R)
    track-mask run tables "runs_y", "runs_x0", "runs_x1", "runs_slot"
    (slot = table row, B for padding) and the (T, B) int bboxes "bx0",
    "by0", "bx1", "by1".

    With `frames`/`background` (the chunk's pixels on the card) and a
    `split_spec`, history splits run on the card; without them a
    contested frame is flagged for the host. `stats`, when given, gets
    one dict per frame (auction rounds, split targets).

    Returns (per-frame history, final carry): fish_x/fish_y/fish_seen/
    fish_row/fish_child/fish_prob (T, F), n_assigned (T,), needs_host
    (T,), carry_vec (T, carry size), n_fish."""
    dev = times.device
    T = times.shape[0]
    flag = det.get("flag_size")
    if flag is None:
        flag = torch.zeros((T, 0), dtype=_F32, device=dev)
    has_runs = "runs_slot" in det
    use_split = (split_spec is not None and P.do_history_split
                 and P.split_radius > 0 and has_runs
                 and frames is not None and "bx0" in det)
    if use_split:
        frames = torch.as_tensor(frames, device=dev)
        background = torch.as_tensor(background, device=dev)
    # divisors as device tensors: a CUDA division by a host scalar
    # multiplies by its reciprocal, which rounds differently
    t_max_t = torch.tensor(P.t_max, dtype=_F32, device=dev)
    min_frames_t = torch.tensor(float(P.minimum_frames), dtype=_F32,
                                device=dev)
    carry = carry0
    outs = []
    for t in range(T):
        kw = {}
        if has_runs:
            kw["runs"] = tuple(det[k][t] for k in ("runs_y", "runs_x0",
                                                   "runs_x1", "runs_slot"))
        if use_split:
            kw.update(bbox=tuple(det[k][t] for k in ("bx0", "by0", "bx1",
                                                     "by1")),
                      frame_img=frames[t], background=background,
                      split_spec=split_spec)
        if stats is not None:
            stats.append({})
            kw["stats"] = stats[-1]
        carry, out = _step(
            carry, det["cx"][t], det["cy"][t], det["bcx"][t],
            det["bcy"][t], det["recount"][t], det["valid"][t], times[t],
            frames_idx[t], flag[t], P, t_max_t, min_frames_t, **kw)
        outs.append(out)
    hist = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    hist["n_fish"] = carry["n_fish"]
    return hist, carry


def track_scan(det: dict, times, frames_idx, P: TrackParams,
               carry0: dict = None, frames=None, background=None,
               split_spec: SplitSpec = None, stats: list = None) -> dict:
    """Public scan entry: builds the initial carry when none is given
    and attaches the final carry under "final_carry"."""
    if carry0 is None:
        carry0 = _init_carry(P, frames_idx[0], times[0],
                             device=times.device)
    hist, final = _scan_impl(det, times, frames_idx, P, carry0, frames,
                             background, split_spec, stats)
    hist["final_carry"] = final
    return hist


# ---------------------------------------------------------------------------
# packed layout: one float32 vector per direction per chunk, the same
# layout as the reference (carry_to_vec / _pack_result / unpack_result)
# ---------------------------------------------------------------------------

def carry_vec_size(P: TrackParams) -> int:
    """Width of the packed carry: the tracking scan's section, then with
    posture the (F, 2) previous-midline-direction section."""
    return _track_vec_size(P) + (2 * P.max_fish if P.do_posture else 0)


def _track_vec_size(P: TrackParams) -> int:
    """Width of the tracking scan's carry: five (F,) rows, the (F,
    frame_rate) seen ring, then n_fish, start_frame, prev_time; with
    decay the (F, DECAY_WIN, 5) motion window and the (F, 3) accumulated
    walk follow."""
    F = P.max_fish
    base = 5 * F + F * P.frame_rate + 3
    return base + ((5 * DECAY_WIN + 3) * F if P.do_decay else 0)


def n_fish_index(P: TrackParams) -> int:
    """Position of n_fish in the packed carry."""
    return 5 * P.max_fish + P.max_fish * P.frame_rate


def _carry_to_vec(c: dict) -> torch.Tensor:
    """Carry dict of tensors -> 1-D float32 tensor (packed layout)."""
    parts = [
        c["last_x"].to(_F32), c["last_y"].to(_F32),
        c["last_time"].to(_F32), c["last_frame"].to(_F32),
        c["n_basic"].to(_F32), c["seen"].to(_F32).reshape(-1),
        torch.stack([c["n_fish"].to(_F32), c["start_frame"].to(_F32),
                     c["prev_time"].to(_F32)])]
    if "win" in c:
        parts += [c["win"].to(_F32).reshape(-1),
                  c["dacc"].to(_F32).reshape(-1)]
    return torch.cat(parts)


def carry_to_vec(carry) -> np.ndarray:
    """Host-side carry dict (numpy or tensors) -> 1-D float32 vector;
    "win" (F, DECAY_WIN, 5) and "dacc" (F, 3, zeros when absent) become
    the decay section, a "posture_dir" (F, 2) entry the trailing posture
    section."""
    c = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
             else np.asarray(v)) for k, v in carry.items()}
    parts = [
        c["last_x"].astype(np.float32),
        c["last_y"].astype(np.float32),
        c["last_time"].astype(np.float32),
        c["last_frame"].astype(np.float32),
        c["n_basic"].astype(np.float32),
        c["seen"].astype(np.float32).reshape(-1),
        np.asarray([float(c["n_fish"]), float(c["start_frame"]),
                    float(c["prev_time"])], np.float32)]
    if "win" in c:
        parts.append(c["win"].astype(np.float32).reshape(-1))
        parts.append(np.asarray(
            c.get("dacc", np.zeros((len(c["last_x"]), 3))),
            np.float32).reshape(-1))
    if "posture_dir" in c:
        parts.append(c["posture_dir"].astype(np.float32).reshape(-1))
    return np.concatenate(parts)


def carry_from_vec_np(vec: np.ndarray, P: TrackParams) -> dict:
    """Host-side inverse of carry_to_vec."""
    F = P.max_fish
    W = P.frame_rate
    o = 0

    def take(n):
        nonlocal o
        out = vec[o:o + n]
        o += n
        return out

    out = dict(
        last_x=take(F).astype(np.float64),
        last_y=take(F).astype(np.float64),
        last_time=take(F).astype(np.float64),
        last_frame=take(F).astype(np.int64),
        n_basic=take(F).astype(np.int64),
        seen=take(F * W).reshape(F, W) > 0.5,
        n_fish=int(vec[o]), start_frame=int(vec[o + 1]),
        prev_time=float(vec[o + 2]))
    o += 3
    if P.do_decay:
        out["win"] = take(5 * DECAY_WIN * F).reshape(F, DECAY_WIN, 5) \
            .astype(np.float64)
        out["dacc"] = take(3 * F).reshape(F, 3).astype(np.float64)
    if P.do_posture:
        out["posture_dir"] = take(2 * F).reshape(F, 2).astype(np.float64)
    return out


def _carry_from_vec(vec: torch.Tensor, P: TrackParams) -> dict:
    """Packed float32 carry tensor -> the scan's carry dict (the tracking
    section with its decay sections; a posture section after it is not
    read)."""
    F = P.max_fish
    W = P.frame_rate
    base = 5 * F
    parts = vec[:base].reshape(5, F)
    seen = vec[base:base + F * W].reshape(F, W)
    o = base + F * W
    tail = vec[o:o + 3]
    out = dict(
        last_x=parts[0].clone(), last_y=parts[1].clone(),
        last_time=parts[2].clone(),
        last_frame=parts[3].to(_I32), n_basic=parts[4].to(_I32),
        seen=seen > 0.5,
        n_fish=tail[0].to(_I32), start_frame=tail[1].to(_I32),
        prev_time=tail[2].clone())
    if P.do_decay:
        o += 3
        n = 5 * DECAY_WIN * F
        out["win"] = vec[o:o + n].reshape(F, DECAY_WIN, 5).clone()
        out["dacc"] = vec[o + n:o + n + 3 * F].reshape(F, 3).clone()
    return out


def _pack_result(hist: dict, overflow, P: TrackParams) -> torch.Tensor:
    """Per-frame history -> the 1-D float32 result of the packed entry
    points; ``needs_host`` and detect overflow share one flags row
    (needs_host + 2 * overflow). With posture, the posture lengths,
    angles and flags follow, and each frame's carry row ends with its
    posture-direction section."""
    parts = [
        hist["fish_x"].to(_F32).reshape(-1),
        hist["fish_y"].to(_F32).reshape(-1),
        hist["fish_seen"].to(_F32).reshape(-1),
        hist["fish_row"].to(_F32).reshape(-1),
        hist["fish_child"].to(_F32).reshape(-1),
        hist["fish_prob"].to(_F32).reshape(-1),
        hist["n_assigned"].to(_F32),
        hist["needs_host"].to(_F32) + 2.0 * overflow.to(_F32),
    ]
    carry = hist["carry_vec"]
    if P.do_posture:
        T, F = hist["fish_x"].shape
        parts += [hist["p_len"].to(_F32).reshape(-1),
                  hist["p_ang"].to(_F32).reshape(-1),
                  hist["p_ok"].to(_F32).reshape(-1)]
        carry = torch.cat([carry, hist["p_dir"].to(_F32).reshape(T, 2 * F)],
                          1)
    parts.append(carry.reshape(-1))
    return torch.cat(parts)


def unpack_result(vec: np.ndarray, T: int, P: TrackParams):
    """1-D result vector -> (hist dict numpy, per-frame carry rows
    (T, carry_vec_size))."""
    if isinstance(vec, torch.Tensor):
        vec = vec.detach().cpu().numpy()
    F = P.max_fish
    o = 0

    def take(n):
        nonlocal o
        out = vec[o:o + n]
        o += n
        return out

    fx = take(T * F).reshape(T, F).astype(np.float64)
    fy = take(T * F).reshape(T, F).astype(np.float64)
    seen = take(T * F).reshape(T, F) > 0.5
    fish_row = take(T * F).reshape(T, F).astype(np.int64)
    fish_child = take(T * F).reshape(T, F) > 0.5
    fish_prob = take(T * F).reshape(T, F).astype(np.float64)
    n_assigned = take(T).astype(np.int64)
    flags = take(T)
    hist = dict(fish_x=fx, fish_y=fy, fish_seen=seen,
                fish_row=fish_row, fish_child=fish_child,
                fish_prob=fish_prob,
                n_assigned=n_assigned,
                needs_host=(flags % 2) >= 1,
                detect_overflow=flags >= 2)
    if P.do_posture:
        hist["p_len"] = take(T * F).reshape(T, F).astype(np.float64)
        hist["p_ang"] = take(T * F).reshape(T, F).astype(np.float64)
        hist["p_ok"] = take(T * F).reshape(T, F) > 0.5
    cs = carry_vec_size(P)
    carry_rows = take(T * cs).reshape(T, cs)
    hist["n_fish"] = np.int32(carry_rows[-1, n_fish_index(P)])
    return hist, carry_rows


def _aux_split(aux: torch.Tensor, T: int, P: TrackParams):
    """aux -> (tracking carry dict, posture_dir (F, 2) or None, times,
    frame indices). The posture section is not part of the tracking
    scan's carry: the posture pass reads it."""
    base = _track_vec_size(P)
    cs = carry_vec_size(P)
    carry0 = _carry_from_vec(aux[:base], P)
    pdir0 = aux[base:cs].reshape(P.max_fish, 2) if P.do_posture else None
    times = aux[cs:cs + T]
    fidx = aux[cs + T:cs + 2 * T].to(_I32)
    return carry0, pdir0, times, fidx


def make_aux(carry_vec: np.ndarray, times, frames_idx) -> np.ndarray:
    return np.concatenate([
        np.asarray(carry_vec, np.float32),
        np.asarray(times, np.float32),
        np.asarray(frames_idx, np.float32)])


def scan_packed(det_packed, aux, P: TrackParams, B: int, R: int = 0,
                device=None) -> torch.Tensor:
    """One-array-in / one-array-out scan for host-built det tables.
    det_packed is (T, 6B [+ 4R]) float32: [cx, cy, bcx, bcy, recount,
    valid (+ runs_y, x0, x1, slot)]; aux = make_aux(carry_vec, times,
    frame indices). The run tables feed the history split's contested
    trigger. Without pixels there is no posture on this path: its
    fields stay empty and the carry's posture section rides through
    (the DeviceTracker runs posture on the host)."""
    dev = resolve_device(device)
    det_packed = torch.as_tensor(det_packed, dtype=_F32, device=dev)
    aux = torch.as_tensor(aux, dtype=_F32, device=dev)
    T = det_packed.shape[0]
    det = dict(
        cx=det_packed[:, 0 * B:1 * B],
        cy=det_packed[:, 1 * B:2 * B],
        bcx=det_packed[:, 2 * B:3 * B],
        bcy=det_packed[:, 3 * B:4 * B],
        recount=det_packed[:, 4 * B:5 * B],
        valid=det_packed[:, 5 * B:6 * B] > 0.5)
    if R:
        base = 6 * B
        for i, k in enumerate(("runs_y", "runs_x0", "runs_x1",
                               "runs_slot")):
            det[k] = det_packed[:, base + i * R:base + (i + 1) * R].to(_I32)
    carry0, pdir0, times, fidx = _aux_split(aux, T, P)
    hist, _ = _scan_impl(det, times, fidx, P, carry0)
    if P.do_posture:
        _no_posture(hist, pdir0, P)
    return _pack_result(hist, torch.zeros(T, dtype=torch.bool, device=dev),
                        P)


def _no_posture(hist: dict, pdir0, P: TrackParams) -> None:
    """Empty posture fields; the direction section carries on as given."""
    T = hist["fish_x"].shape[0]
    F = P.max_fish
    dev = pdir0.device
    hist["p_len"] = torch.zeros((T, F), dtype=_F32, device=dev)
    hist["p_ang"] = torch.zeros((T, F), dtype=_F32, device=dev)
    hist["p_ok"] = torch.zeros((T, F), dtype=torch.bool, device=dev)
    hist["p_dir"] = pdir0[None].expand(T, F, 2)


def _posture_scan(frames, background, det, hist, pdir0, P: TrackParams,
                  spec: PostureSpec, stats: dict = None):
    """Posture pass over the scan's assignments (the host engine's
    _run_posture_batch): every (frame, fish) lane of the chunk through
    one batch of the chain (posture_lanes_batched), then the
    frame-sequential orientation select (posture_select_scan). A frame
    whose assigned lanes include a split child (no run tables), a blob
    too big for the crop or a capacity overflow needs the host.

    `stats`, when given, gets the active lanes, the lanes with a
    posture, the frames flagged by each cause ((T,) bool: "child",
    "too_big", "overflow") and the chain's loop counts."""
    with record_function(POSTURE_RANGE):
        B = det["bx0"].shape[1]
        f_row = hist["fish_row"]                          # (T, F)
        assigned = f_row >= 0
        bi = f_row.clamp(0, B - 1).to(_I32)
        box = {k: torch.gather(det[k], 1, bi.long())
               for k in ("bx0", "by0", "bx1", "by1")}
        too_big = (box["bx1"] - box["bx0"] + 3 > spec.crop_w) \
            | (box["by1"] - box["by0"] + 3 > spec.crop_h)
        active = assigned & ~hist["fish_child"] & ~too_big
        out = posture_lanes_batched(
            frames, background, bi, box["bx0"], box["by0"], det["runs_y"],
            det["runs_x0"], det["runs_x1"], det["runs_slot"], active, spec,
            stats)
        p_len, p_ang, p_ok, p_dir, _ = posture_select_scan(
            out, pdir0.to(_F32), spec)
        host = (assigned & (hist["fish_child"] | too_big
                            | out["overflow"])).any(1)
        hist.update(p_len=p_len, p_ang=p_ang, p_ok=p_ok, p_dir=p_dir)
        hist["needs_host"] = hist["needs_host"] | host
    if stats is not None:
        stats.update(
            active_lanes=int(active.sum()), ok_lanes=int(p_ok.sum()),
            child=(assigned & hist["fish_child"]).any(1).cpu().numpy(),
            too_big=(assigned & too_big).any(1).cpu().numpy(),
            overflow=(assigned & out["overflow"]).any(1).cpu().numpy())
    return hist


def fused_scan_packed(frames, background, aux, P: TrackParams,
                      split_spec: SplitSpec = None,
                      posture_spec: PostureSpec = None, device=None,
                      posture_stats: dict = None, **kw) -> torch.Tensor:
    """Fused detect + scan with one packed output array (the raw-frames
    product path): ``kw`` are detect_batch_runs' threshold and capacity
    options, ``aux = make_aux(carry_vec, times, frame indices)``;
    `split_spec` (``default_split_spec``) runs history splits on the
    card, `posture_spec` (``ops/device_posture.spec_from_settings``) the
    posture pass after the scan. The JAX package's ``two_stage`` option
    splits this call in two programs to dodge an XLA compile problem;
    the port has the one path, posture after the scan in the same call.
    `posture_stats`, when given, receives _posture_scan's stats.

    With posture on and no enabled spec, as in the JAX package, the
    posture fields stay empty and every frame with an assignment needs
    the host."""
    dev = resolve_device(device)
    frames = torch.as_tensor(frames, device=dev)
    background = torch.as_tensor(background, device=dev)
    out = detect_batch_runs(frames, background, device=dev, **kw)
    det = detections_from_runcc(out, P)
    aux = torch.as_tensor(aux, dtype=_F32, device=dev)
    carry0, pdir0, times, fidx = _aux_split(aux, out["overflow"].shape[0],
                                            P)
    hist, _ = _scan_impl(det, times, fidx, P, carry0, frames, background,
                         split_spec)
    if P.do_posture:
        if posture_spec is not None and posture_spec.enabled:
            hist = _posture_scan(frames, background, det, hist, pdir0, P,
                                 posture_spec, posture_stats)
        else:
            _no_posture(hist, pdir0, P)
            hist["needs_host"] = hist["needs_host"] \
                | (hist["fish_row"] >= 0).any(1)
    return _pack_result(hist, out["overflow"], P)


def detections_from_runcc(out: dict, P: TrackParams) -> dict:
    """Adapt detect_batch_runs output to the scan's blob tables:
    centroids, bbox centres, recount, valid, the int bboxes and the
    track-mask run tables that the history split reads.

    With a track threshold, the tracked rows are the track-threshold
    children; `huge` parents (count > 100x the size maximum) raise the
    needs_host flag via `flag_size` instead."""
    det = out["det"]
    n = det["count"]
    dev = n.device
    cols = torch.arange(n.shape[1], device=dev)[None, :]
    pvalid = (cols < det["n_blobs"][:, None]) & (n > 0)
    sq = P.cm_per_pixel * P.cm_per_pixel
    detect_filter = P.detect_size_min > 0 \
        or P.detect_size_max != float("inf")

    if "child" in out:
        ch = out["child"]
        cn = ch["count"]
        ccols = torch.arange(cn.shape[1], device=dev)[None, :]
        cvalid = (ccols < ch["n_blobs"][:, None]) & (cn > 0)
        if detect_filter:
            psize = n * sq
            pok = pvalid & _in_size_ranges(
                psize, P.detect_size_ranges,
                P.detect_size_min, P.detect_size_max)
            Bp = n.shape[1]
            parent = torch.clamp_max(ch["parent"], Bp)
            pok_pad = torch.cat(
                [pok, torch.zeros((pok.shape[0], 1), dtype=torch.bool,
                                  device=dev)], 1)
            cvalid = cvalid & torch.gather(pok_pad, 1, parent.long())
        safe = torch.clamp_min(cn, 1.0)
        d = dict(
            cx=ch["sum_x"] / safe, cy=ch["sum_y"] / safe,
            bcx=(ch["x0"] + ch["x1"] + 1) * 0.5,
            bcy=(ch["y0"] + ch["y1"] + 1) * 0.5,
            recount=cn, valid=cvalid, **_bbox_runs(ch, out.get(
                "child_runs")))
        if P.has_size_filter:
            d["flag_size"] = torch.where(pvalid, n, 0.0)
        return d

    if detect_filter:
        # the host pipeline drops out-of-range detections before the
        # tracker sees them
        pvalid = pvalid & _in_size_ranges(
            n * sq, P.detect_size_ranges,
            P.detect_size_min, P.detect_size_max)
    safe = torch.clamp_min(n, 1.0)
    d = dict(
        cx=det["sum_x"] / safe, cy=det["sum_y"] / safe,
        bcx=(det["x0"] + det["x1"] + 1) * 0.5,
        bcy=(det["y0"] + det["y1"] + 1) * 0.5,
        # without a track threshold there is no track_count: size-filter
        # on the detect count, like the host engine
        recount=det.get("track_count", n), valid=pvalid,
        **_bbox_runs(det, out.get("det_runs")))
    return d


def _bbox_runs(tab: dict, runs) -> dict:
    """The int bbox columns of a blob table and its run tables."""
    d = {k: tab[s].to(_I32) for k, s in (("bx0", "x0"), ("by0", "y0"),
                                          ("bx1", "x1"), ("by1", "y1"))}
    if runs is not None:
        d.update(runs_y=runs["y"], runs_x0=runs["x0"], runs_x1=runs["x1"],
                 runs_slot=runs["slot"])
    return d


def _detect_kwargs(settings, caps) -> dict:
    s = SettingsView(settings)
    kw = dict(
        detect_threshold=int(s["detect_threshold"]),
        detect_absolute=bool(s["detect_threshold_is_absolute"]),
        track_threshold=int(s["track_threshold"])
        if s["track_background_subtraction"] else 0,
        track_absolute=bool(s["track_threshold_is_absolute"]))
    kw.update(caps)
    return kw


def frame_times(T: int, frame_rate: float) -> np.ndarray:
    """Chunk timestamps i / frame_rate as float32 (one IEEE division per
    frame, like the reference's ``arange(T) / fr``)."""
    return np.arange(T, dtype=np.float32) / np.float32(frame_rate)


def default_split_spec(settings, P: TrackParams = None,
                       split_caps: dict = None):
    """SplitSpec of the history split on the card, or None when history
    splits are off (spec_from_settings with the capacity defaults, which
    `split_caps` overrides)."""
    if P is None:
        P = params_from_settings(settings)
    if not (P.do_history_split and P.split_radius > 0):
        return None
    caps = dict(split_caps or {})
    # split lanes scale with the population: a dense 256-fish arena has
    # more than 8 contested merges in most frames
    caps.setdefault("max_splits", max(8, P.max_fish // 8))
    return spec_from_settings(settings, **caps)


def track_video_device(frames, background, settings, device=None,
                       stats: list = None, split_caps: dict = None,
                       **caps) -> dict:
    """Fused device pipeline: batched run-CC detection + scan tracking
    over one chunk of raw frames; with track_do_history_split, history
    splits run on the card. ``caps`` are detect_batch_runs' capacity
    options, `split_caps` the split executor's (``default_split_spec``);
    `stats` as in _scan_impl.
    Returns the per-frame history (tensors) with "final_carry" and
    "detect_overflow"."""
    P = params_from_settings(settings)
    dev = resolve_device(device)
    kw = _detect_kwargs(settings, caps)
    T = frames.shape[0]
    fr = float(SettingsView(settings)["frame_rate"] or 25)
    frames = torch.as_tensor(frames, device=dev)
    background = torch.as_tensor(background, device=dev)
    out = detect_batch_runs(frames, background, device=dev, **kw)
    det = detections_from_runcc(out, P)
    times = torch.as_tensor(frame_times(T, fr), device=dev)
    hist = track_scan(det, times,
                      torch.arange(T, dtype=_I32, device=dev), P,
                      frames=frames, background=background,
                      split_spec=default_split_spec(settings, P,
                                                    split_caps),
                      stats=stats)
    hist["detect_overflow"] = out["overflow"]
    return hist


def track_videos_sharded(frames, background, settings, mesh=None,
                         axis: str = "data", device=None, **caps) -> dict:
    """Multi-video tracking: a (V, T, H, W) batch of videos, one
    independent detect and scan recurrence a video, the videos given to
    the devices along the mesh's `axis` in contiguous blocks of V / n as
    the JAX package shards them, each device running its videos one
    after another (``parallel.mesh.run_shards``; the scan's inner loops
    depend on the data, so ``torch.vmap`` does not serve). Without a
    mesh, every video runs on `device` (the card when None).

    Computes what the JAX function computes: ``track_scan`` gets neither
    the frames nor a split spec, so no video runs the history split on
    the card, even with ``track_do_history_split`` on (the frames it
    would split are flagged ``needs_host``; ROADMAP.md C11). Returns the
    histories stacked along V (on the axis' first device), with
    ``detect_overflow``."""
    from ..parallel.mesh import join_shards, run_shards

    P = params_from_settings(settings)
    kw = _detect_kwargs(settings, caps)
    V, T = frames.shape[:2]
    fr = float(SettingsView(settings)["frame_rate"] or 25)
    times = frame_times(T, fr)
    devs = [resolve_device(device)] if mesh is None \
        else mesh.axis_devices(axis)
    if V % len(devs):
        raise ValueError(f"{V} videos do not split over {len(devs)} "
                         f"devices of axis {axis!r}")
    per = V // len(devs)

    def one_video(video, dev):
        video = torch.as_tensor(video, device=dev)
        out = detect_batch_runs(video, torch.as_tensor(background,
                                                       device=dev),
                                device=dev, **kw)
        det = detections_from_runcc(out, P)
        hist = track_scan(det, torch.as_tensor(times, device=dev),
                          torch.arange(T, dtype=_I32, device=dev), P)
        hist["detect_overflow"] = out["overflow"]
        return {k: v.unsqueeze(0) if isinstance(v, torch.Tensor)
                else {c: x.unsqueeze(0) for c, x in v.items()}
                for k, v in hist.items()}

    def shard(i, dev):
        return join_shards([one_video(frames[v], dev)
                            for v in range(i * per, (i + 1) * per)], dev)
    return join_shards(run_shards(shard, devs), devs[0])


def _history_from_fast_tracker(tracker, n_frames: int,
                               max_fish: int) -> dict:
    """FastTracker per-frame history -> the track_scan output schema
    (numpy arrays)."""
    fx = np.zeros((n_frames, max_fish))
    fy = np.zeros((n_frames, max_fish))
    seen = np.zeros((n_frames, max_fish), bool)
    n_assigned = np.zeros(n_frames, np.int64)
    for f in range(n_frames):
        h = tracker.history.get(f)
        if not h:
            continue
        fid = np.asarray(h["fish"], np.int64)
        ok = fid < max_fish
        fx[f, fid[ok]] = np.asarray(h["x"])[ok]
        fy[f, fid[ok]] = np.asarray(h["y"])[ok]
        seen[f, fid[ok]] = True
        n_assigned[f] = int(tracker.statistics[f].number_fish) \
            if f in tracker.statistics else ok.sum()
    # carry last positions forward like the scan does
    for f in range(1, n_frames):
        hold = ~seen[f] & (seen[:f].any(axis=0))
        fx[f, hold] = fx[f - 1, hold]
        fy[f, hold] = fy[f - 1, hold]
    return dict(fish_x=fx, fish_y=fy, fish_seen=seen,
                n_assigned=n_assigned,
                needs_host=np.zeros(n_frames, bool),
                n_fish=np.int32(tracker.n_fish))


def track_video_hybrid(frames, background, settings, device=None,
                       **caps) -> dict:
    """Device-first tracking with the host engine behind it: run the
    fused detect+scan chunk on `device` (the card when None); when any
    frame flagged needs_host (split candidates) or overflowed the
    detection caps, track the chunk again with the host FastTracker
    (history splits, automatic matching) and return its history in the
    same schema. The returned dict (numpy arrays) carries `engine`:
    "device" or "host". An error on the card propagates; only the scan's
    own flags send the chunk to the host."""
    from ..track.engine import FastTracker
    from .labeling import label_blobs_raw

    def host(v):
        if isinstance(v, dict):
            return {k: host(x) for k, x in v.items()}
        return v.cpu().numpy() if isinstance(v, torch.Tensor) else v

    frames = np.asarray(frames)
    hist = host(track_video_device(frames, background, settings,
                                   device=device, **caps))
    if not (hist["needs_host"].any() or hist["detect_overflow"].any()):
        hist["engine"] = "device"
        return hist

    s = SettingsView(settings)
    det = dict(threshold=int(s["detect_threshold"]),
               absolute=bool(s["detect_threshold_is_absolute"]),
               track_threshold=int(s["track_threshold"])
               if s["track_background_subtraction"] else 0,
               track_absolute=bool(s["track_threshold_is_absolute"]))
    fr = float(s["frame_rate"] or 25)
    background = np.asarray(background)
    tracker = FastTracker(settings, background)
    for i, frame in enumerate(frames):
        tracker.add_frame(i, i / fr, **label_blobs_raw(frame, background,
                                                       **det))
    out = _history_from_fast_tracker(tracker, len(frames),
                                     int(s["track_max_individuals"]))
    out["engine"] = "host"
    out["detect_overflow"] = hist["detect_overflow"]
    return out
