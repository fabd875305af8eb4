"""Device-resident tracking loop, base configuration (PyTorch).

Counterpart of ``trex_tpu/ops/device_tracker.py`` for the configuration
``match_mode=approximate`` with no history split, no posture and no
speed decay. The per-frame tracking recurrence runs over a chunk of
detected frames with the tracker state as carry; the result layout
(packed carry vectors, packed per-frame result) is byte-identical to
the reference's, so a chunk can be resumed in either package from the
other's carry.

Per frame (the reference's ``_scan_impl`` step):

- caches: time probability from the recent-samples ring of the last
  ``frame_rate`` frames, size filter on the track-threshold recount;
- probability: p = tprob / (1 + d/global_td * cm/max_speed)^2 against
  blob bbox centres, distances measured from the last positions;
- first pass: greedy per blob in index order, highest-p unused active
  fish, p > p_min (:func:`_greedy_pass`);
- second pass: reactivation of inactive fish against blob centroids,
  then new-fish creation in blob order while under max_fish;
- ``needs_host``: float32 decisions that could fall the other way in
  the host's float64 (deferral bands), size-filter knife edges,
  oversized blobs and the trusted-probability cut.

The frame loop is a Python loop and the greedy pass syncs with the host
once per round: correct and slow. Capturing a chunk in a CUDA graph or
a persistent kernel is later work.

Configurations left to later slices (speed decay, history split,
optimal matching, posture) raise NotImplementedError.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SettingsView
from ..device import resolve_device
from .device_match import edge_boundary_marginal
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
    do_decay: bool = False         # track_speed_decay < 1
    decay_lambda: float = 1.0      # decay^4
    trusted_p: float = 0.0         # track_trusted_probability


# f32 machine epsilon: unit for the f32-arithmetic error bounds that
# widen the matching passes' deferral bands
EPS32 = float(2.0 ** -23)


def _require_base(P: TrackParams) -> None:
    """Raise for the configurations this slice of the port lacks."""
    missing = []
    if P.do_decay:
        missing.append("track_speed_decay < 1 (decay slice)")
    if P.do_history_split and P.split_radius > 0:
        missing.append("track_do_history_split (device_split slice)")
    if P.match_optimal:
        missing.append("match_mode other than approximate "
                       "(device_match slice)")
    if P.do_posture:
        missing.append("calculate_posture (device_posture slice)")
    if missing:
        raise NotImplementedError(
            "trex_tpu_torch tracks only the base configuration so far; "
            "ported in a later slice: " + ", ".join(missing))


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
    _require_base(P)
    F = P.max_fish
    dev = resolve_device(device)
    return dict(
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


def _hypot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's hypot: hi * sqrt(1 + (lo/hi)^2) with |hi| >= |lo|
    (``torch.hypot`` rounds differently)."""
    a = a.abs()
    b = b.abs()
    is_inf = torch.isposinf(a) | torch.isposinf(b)
    hi = torch.maximum(a, b)
    lo = torch.minimum(a, b)
    r = lo / torch.where(hi == 0, torch.ones_like(hi), hi)
    x = torch.where(hi == 0, hi, hi * torch.sqrt(1 + r * r))
    return torch.where(is_inf, torch.full_like(x, float("inf")), x)


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


def _step(carry: dict, cx, cy, bcx, bcy, rec, bvalid, time, frame,
          flag_size, P: TrackParams, t_max_t, min_frames_t):
    """One frame of the tracking recurrence -> (new carry, outputs)."""
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
    est_x = carry["last_x"]
    est_y = carry["last_y"]
    # est = last f32-packed centroid: packing + one compare
    est_err = 2.0 * EPS32 * (torch.maximum(est_x.abs(), est_y.abs()) + 1.0)
    size = rec * sq
    in_range = _in_size_ranges(size, P.size_ranges, P.size_min,
                               P.size_max)
    needs_host = (bvalid & (size > P.size_max)).any()
    if flag_size.shape[0]:
        # `huge` parents never appear as child rows: escalate
        needs_host = needs_host | (flag_size * sq > P.size_max * 100).any()
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
    _, fob = _greedy_pass(Pmat, bval, ~usable, fob, P.p_min)
    # defer frames where the f32 p_min edge set or any per-blob ordering
    # could differ from the host's f64 scan
    cand = usable[:, None] & bval[None, :] & (Pmat > P.p_min - p_err)
    col_err = torch.where(cand, p_err, 0.0).amax(0)
    vals = torch.sort(torch.where(cand, Pmat, float("-inf")), 0).values
    adj_tie = (vals[1:] - vals[:-1]) <= 2.0 * col_err[None, :]
    needs_host = needs_host | (torch.isfinite(vals[:-1]) & adj_tie).any() \
        | edge_boundary_marginal(Pmat, usable, bval, P.p_min, p_err)
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
    fish_row = torch.full((F + 1,), -1, dtype=_I32, device=dev).scatter_(
        0, fish_idx, torch.where(assigned, bi, -1))[:F]
    # the base path has no split children
    fish_child = torch.zeros(F, dtype=torch.bool, device=dev)
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
    out = dict(fish_x=new_carry["last_x"], fish_y=new_carry["last_y"],
               fish_seen=got, fish_row=fish_row, fish_child=fish_child,
               fish_prob=fish_prob, n_assigned=n_first + n_react,
               needs_host=needs_host,
               carry_vec=_carry_to_vec(new_carry))
    return new_carry, out


def _scan_impl(det: dict, times: torch.Tensor, frames_idx: torch.Tensor,
               P: TrackParams, carry0: dict) -> tuple[dict, dict]:
    """Run the tracking recurrence over detected frames.

    det: stacked per-frame blob tables, (T, B) tensors "cx", "cy"
    (centroids), "bcx", "bcy" (bbox centres), "recount" (track-threshold
    pixel count), "valid", and optionally "flag_size" (T, Bp).

    Returns (per-frame history, final carry): fish_x/fish_y/fish_seen/
    fish_row/fish_child/fish_prob (T, F), n_assigned (T,), needs_host
    (T,), carry_vec (T, carry size), n_fish."""
    _require_base(P)
    dev = times.device
    T = times.shape[0]
    flag = det.get("flag_size")
    if flag is None:
        flag = torch.zeros((T, 0), dtype=_F32, device=dev)
    # divisors as device tensors: a CUDA division by a host scalar
    # multiplies by its reciprocal, which rounds differently
    t_max_t = torch.tensor(P.t_max, dtype=_F32, device=dev)
    min_frames_t = torch.tensor(float(P.minimum_frames), dtype=_F32,
                                device=dev)
    carry = carry0
    outs = []
    for t in range(T):
        carry, out = _step(
            carry, det["cx"][t], det["cy"][t], det["bcx"][t],
            det["bcy"][t], det["recount"][t], det["valid"][t], times[t],
            frames_idx[t], flag[t], P, t_max_t, min_frames_t)
        outs.append(out)
    hist = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    hist["n_fish"] = carry["n_fish"]
    return hist, carry


def track_scan(det: dict, times, frames_idx, P: TrackParams,
               carry0: dict = None) -> dict:
    """Public scan entry: builds the initial carry when none is given
    and attaches the final carry under "final_carry"."""
    if carry0 is None:
        carry0 = _init_carry(P, frames_idx[0], times[0],
                             device=times.device)
    hist, final = _scan_impl(det, times, frames_idx, P, carry0)
    hist["final_carry"] = final
    return hist


# ---------------------------------------------------------------------------
# packed layout: one float32 vector per direction per chunk, the same
# layout as the reference (carry_to_vec / _pack_result / unpack_result)
# ---------------------------------------------------------------------------

def carry_vec_size(P: TrackParams) -> int:
    """Width of the packed carry: five (F,) rows, the (F, frame_rate)
    seen ring, then n_fish, start_frame, prev_time. (Decay and posture
    append sections in later slices.)"""
    _require_base(P)
    F = P.max_fish
    return 5 * F + F * P.frame_rate + 3


def _carry_to_vec(c: dict) -> torch.Tensor:
    """Carry dict of tensors -> 1-D float32 tensor (packed layout)."""
    return torch.cat([
        c["last_x"].to(_F32), c["last_y"].to(_F32),
        c["last_time"].to(_F32), c["last_frame"].to(_F32),
        c["n_basic"].to(_F32), c["seen"].to(_F32).reshape(-1),
        torch.stack([c["n_fish"].to(_F32), c["start_frame"].to(_F32),
                     c["prev_time"].to(_F32)])])


def carry_to_vec(carry) -> np.ndarray:
    """Host-side carry dict (numpy or tensors) -> 1-D float32 vector."""
    c = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
             else np.asarray(v)) for k, v in carry.items()}
    return np.concatenate([
        c["last_x"].astype(np.float32),
        c["last_y"].astype(np.float32),
        c["last_time"].astype(np.float32),
        c["last_frame"].astype(np.float32),
        c["n_basic"].astype(np.float32),
        c["seen"].astype(np.float32).reshape(-1),
        np.asarray([float(c["n_fish"]), float(c["start_frame"]),
                    float(c["prev_time"])], np.float32)])


def carry_from_vec_np(vec: np.ndarray, P: TrackParams) -> dict:
    """Host-side inverse of carry_to_vec."""
    _require_base(P)
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
    return out


def _carry_from_vec(vec: torch.Tensor, P: TrackParams) -> dict:
    """Packed float32 carry tensor -> the scan's carry dict."""
    _require_base(P)
    F = P.max_fish
    W = P.frame_rate
    base = 5 * F
    parts = vec[:base].reshape(5, F)
    seen = vec[base:base + F * W].reshape(F, W)
    tail = vec[base + F * W:base + F * W + 3]
    return dict(
        last_x=parts[0].clone(), last_y=parts[1].clone(),
        last_time=parts[2].clone(),
        last_frame=parts[3].to(_I32), n_basic=parts[4].to(_I32),
        seen=seen > 0.5,
        n_fish=tail[0].to(_I32), start_frame=tail[1].to(_I32),
        prev_time=tail[2].clone())


def _pack_result(hist: dict, overflow) -> torch.Tensor:
    """Per-frame history -> the 1-D float32 result of the packed entry
    points; ``needs_host`` and detect overflow share one flags row
    (needs_host + 2 * overflow)."""
    parts = [
        hist["fish_x"].to(_F32).reshape(-1),
        hist["fish_y"].to(_F32).reshape(-1),
        hist["fish_seen"].to(_F32).reshape(-1),
        hist["fish_row"].to(_F32).reshape(-1),
        hist["fish_child"].to(_F32).reshape(-1),
        hist["fish_prob"].to(_F32).reshape(-1),
        hist["n_assigned"].to(_F32),
        hist["needs_host"].to(_F32) + 2.0 * overflow.to(_F32),
        hist["carry_vec"].reshape(-1),
    ]
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
    cs = carry_vec_size(P)
    carry_rows = take(T * cs).reshape(T, cs)
    hist["n_fish"] = np.int32(carry_rows[-1, 5 * F + F * P.frame_rate])
    return hist, carry_rows


def _aux_split(aux: torch.Tensor, T: int, P: TrackParams):
    """aux -> (tracking carry dict, times, frame indices)."""
    cs = carry_vec_size(P)
    carry0 = _carry_from_vec(aux[:cs], P)
    times = aux[cs:cs + T]
    fidx = aux[cs + T:cs + 2 * T].to(_I32)
    return carry0, times, fidx


def make_aux(carry_vec: np.ndarray, times, frames_idx) -> np.ndarray:
    return np.concatenate([
        np.asarray(carry_vec, np.float32),
        np.asarray(times, np.float32),
        np.asarray(frames_idx, np.float32)])


def scan_packed(det_packed, aux, P: TrackParams, B: int,
                device=None) -> torch.Tensor:
    """One-array-in / one-array-out scan for host-built det tables.
    det_packed is (T, 6B) float32: [cx, cy, bcx, bcy, recount, valid];
    aux = make_aux(carry_vec, times, frame indices). (The reference's
    trailing run tables feed only the history split, a later slice.)"""
    _require_base(P)
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
    carry0, times, fidx = _aux_split(aux, T, P)
    hist, _ = _scan_impl(det, times, fidx, P, carry0)
    return _pack_result(hist, torch.zeros(T, dtype=torch.bool, device=dev))


def fused_scan_packed(frames, background, aux, P: TrackParams,
                      device=None, **kw) -> torch.Tensor:
    """Fused detect + scan with one packed output array (the raw-frames
    product path): ``kw`` are detect_batch_runs' threshold and capacity
    options, ``aux = make_aux(carry_vec, times, frame indices)``."""
    _require_base(P)
    dev = resolve_device(device)
    out = detect_batch_runs(frames, background, device=dev, **kw)
    det = detections_from_runcc(out, P)
    aux = torch.as_tensor(aux, dtype=_F32, device=dev)
    carry0, times, fidx = _aux_split(aux, out["overflow"].shape[0], P)
    hist, _ = _scan_impl(det, times, fidx, P, carry0)
    return _pack_result(hist, out["overflow"])


def detections_from_runcc(out: dict, P: TrackParams) -> dict:
    """Adapt detect_batch_runs output to the scan's blob tables (the
    base configuration's: centroids, bbox centres, recount, valid; the
    run and bbox tables that the history split and posture read come
    with those slices).

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
            recount=cn, valid=cvalid)
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
        recount=det.get("track_count", n), valid=pvalid)
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


def track_video_device(frames, background, settings, device=None,
                       **caps) -> dict:
    """Fused device pipeline: batched run-CC detection + scan tracking
    over one chunk of raw frames. ``caps`` are detect_batch_runs'
    capacity options. Returns the per-frame history (tensors) with
    "final_carry" and "detect_overflow"."""
    P = params_from_settings(settings)
    _require_base(P)
    dev = resolve_device(device)
    kw = _detect_kwargs(settings, caps)
    T = frames.shape[0]
    fr = float(SettingsView(settings)["frame_rate"] or 25)
    out = detect_batch_runs(frames, background, device=dev, **kw)
    det = detections_from_runcc(out, P)
    times = torch.as_tensor(frame_times(T, fr), device=dev)
    hist = track_scan(det, times,
                      torch.arange(T, dtype=_I32, device=dev), P)
    hist["detect_overflow"] = out["overflow"]
    return hist
