"""Posture on the card: outline trace to midline, over a batch of lanes.

Counterpart of ``trex_tpu/ops/device_posture.py``, the chain of the host
posture (``track/posture.py``, ``native/posture_chain.cpp``; the
reference's tracking/Posture.cpp:305-410 and tracking/Outline.cpp) in
fixed shapes, so the fused tracking path runs ``calculate_posture`` on
the card:

1. masked difference crop and the posture threshold;
2. the biggest 8-connected component (run tables and the run labels of
   ``ops/device_split.py``);
3. the Moore boundary trace of the 4x-supersampled mask, read from the
   1x mask;
4. Outline::resample with closed-form emission counts per segment;
5. triangular smoothing, clockwise orientation, the elliptic Fourier
   approximation;
6. Menger curvature, tail at the strongest peak, head at the peak
   circularly farthest from it;
7. the midline pairing walk from the tail;
8. Midline::post_process (both orientations, selected afterwards) and
   Midline::normalize, midline length as the chord sum;
9. threshold escalation (+2 up to +100) while the midline fails.

Every function takes a leading lane dimension: the JAX package's
``jax.vmap`` over blobs (and over the chunk's (frame, fish) lanes) is
that dimension here. Each ``lax.while_loop`` under ``vmap`` runs its
body while any lane's condition holds, and a lane whose condition
failed keeps its state: the loops here do the same with per-lane masks,
checking the host every block of steps. A ``lax.cond`` under ``vmap``
selects per lane: here both branches are computed and selected. The
threshold escalation runs each round on the lanes still escalating
only, and the chunk-batched chain on the active lanes only, since the
other lanes' outputs are fixed (masked, or the chain's values on empty
input).

All capacities are the spec's; a lane over one sets ``overflow``. The
chain is float32; cosines, sines and arc functions are rounded from
float64 (:func:`_rounded`), so the card and the CPU agree. Float sums that
decide integers (the resample's emission counts, the normalisation's
segment search) are prefix sums in the JAX package's order on the CPU
(:func:`_cumsum`); the other float reductions follow PyTorch's order,
within float tolerance of the JAX package.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SettingsView
from .device_split import _cc_run_labels, _crop_window, _hypot
from .runcc import _compact, _seg

_F32 = torch.float32
_I32 = torch.int32
_NEG = -1e9
INF = float("inf")

# Moore neighbourhood, clockwise (dy, dx), as the host trace walks it
_ORDER_Y = (0, -1, -1, -1, 0, 1, 1, 1)
_ORDER_X = (-1, -1, 0, 1, 1, 1, 0, -1)
# block length of XLA's rewrite of a cumulative sum on the CPU
_SCAN_BASE = 16
# masked steps between host checks in the trace and the walk
_TRACE_BLOCK = 32
_WALK_BLOCK = 16
# active lanes per pass of the chunk-batched chain
LANE_BLOCK = 16384


class PostureSpec(NamedTuple):
    """Static posture configuration and device capacities."""
    threshold: int              # track_posture_threshold
    absolute: bool              # track_threshold_is_absolute
    resample_d: float           # outline_resample
    smooth_samples: int         # outline_smooth_samples
    smooth_step: int            # outline_smooth_step (>= 1)
    approximate: int            # outline_approximate (EFT harmonics)
    curvature_ratio: float      # outline_curvature_range_ratio
    walk_offset: float          # midline_walk_offset
    stiff_pct: float            # midline_stiff_percentage
    midline_res: int            # midline_resolution
    invert: bool                # midline_invert
    start_with_head: bool       # midline_start_with_head
    crop_h: int = 64
    crop_w: int = 64
    max_runs: int = 256         # run-table capacity per crop
    max_trace: int = 2048       # supersampled boundary point cap
    max_outline: int = 512      # resampled outline cap
    enabled: bool = True


def spec_from_settings(s, **caps) -> PostureSpec:
    s = SettingsView(s)
    if int(s["posture_closing_steps"]) != 0:
        # morphological closing stays on the host chain
        caps.setdefault("enabled", False)
    return PostureSpec(
        threshold=int(s["track_posture_threshold"]),
        absolute=bool(s["track_threshold_is_absolute"]),
        resample_d=float(s["outline_resample"]),
        smooth_samples=int(s["outline_smooth_samples"]),
        smooth_step=max(1, int(s["outline_smooth_step"])),
        approximate=int(s["outline_approximate"]),
        curvature_ratio=float(s["outline_curvature_range_ratio"]),
        walk_offset=float(s["midline_walk_offset"]),
        stiff_pct=float(s["midline_stiff_percentage"]),
        midline_res=int(s["midline_resolution"]),
        invert=bool(s["midline_invert"]),
        start_with_head=bool(s["midline_start_with_head"]),
        **caps)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sum over the last dimension in the JAX
    package's order on the CPU: XLA rewrites the cumulative sum into
    blocks of 16 summed left to right, plus the prefix sum (found the
    same way) of the block totals. ``torch.cumsum`` rounds in another
    order on the CPU and on the card alike."""
    n = x.shape[-1]
    if n <= _SCAN_BASE:
        out = x.clone()
        for i in range(1, n):
            out[..., i] = out[..., i - 1] + x[..., i]
        return out
    m = -(-n // _SCAN_BASE)
    blocks = _cumsum(F.pad(x, (0, m * _SCAN_BASE - n))
                     .reshape(*x.shape[:-1], m, _SCAN_BASE))
    carry = F.pad(_cumsum(blocks[..., -1])[..., :-1], (1, 0))
    return (blocks + carry[..., None]).reshape(
        *x.shape[:-1], m * _SCAN_BASE)[..., :n]


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-lane gather along dimension 1: t (L, N[, C]), idx (L, ...) ->
    (L, ...[, C])."""
    flat = idx.reshape(idx.shape[0], -1).long()
    if t.dim() == 3:
        out = torch.gather(t, 1, flat[:, :, None].expand(-1, -1, t.shape[2]))
        return out.reshape(*idx.shape, t.shape[2])
    return torch.gather(t, 1, flat).reshape(idx.shape)


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar on `like`'s device: dividing by it divides (a
    division by a host scalar on the card multiplies by its reciprocal,
    which rounds differently)."""
    return torch.tensor(v, dtype=_F32, device=like.device)


def _masked_write(buf, lane, pos, val, go):
    """buf[lane, pos] = val where `go`, per lane (pos clamped in range)."""
    pos = pos.clamp(0, buf.shape[1] - 1).long()
    keep = go.reshape(go.shape + (1,) * (val.dim() - 1))
    buf[lane, pos] = torch.where(keep, val, buf[lane, pos])


# ---------------------------------------------------------------------------
# crop + biggest component
# ---------------------------------------------------------------------------

def _crop_blob(frame, background, bi, bx0i, by0i,
               runs_y, runs_x0, runs_x1, runs_slot, spec: PostureSpec):
    """Blob-masked difference crops of lanes `bi` of one frame, origin
    bbox - 1 (to_dense(pad=1)). Returns (diff (L, CH, CW) int32, in_run
    bool, npix (L,) int32). The window and the run painting are the
    split executor's (``_crop_window``); the posture chain masks the
    difference, where the executor masks the image."""
    img, bgc, in_run, _, _ = _crop_window(
        frame, background, bi, bx0i, by0i, runs_y, runs_x0, runs_x1,
        runs_slot, spec.crop_h, spec.crop_w)
    mine = runs_slot[None, :] == bi[:, None]
    npix = torch.where(mine, (runs_x1 - runs_x0 + 1)[None, :], 0) \
        .sum(1, dtype=_I32)
    if spec.absolute:
        diff = torch.where(in_run, (img - bgc).abs(), 0)
    else:
        diff = torch.where(in_run, torch.clamp_min(bgc - img, 0), 0)
    return diff, in_run, npix


def _run_starts(mask):
    left = F.pad(mask[:, :, :-1], (1, 0))
    right = F.pad(mask[:, :, 1:], (0, 1))
    return mask & ~left, mask & ~right


def _mask_run_tables(mask, R: int):
    """Horizontal run tables of (L, CH, CW) bool masks: (y, x0, x1) each
    (L, R), -1 padding (the row-major ``nonzero(size=R, fill_value=-1)``),
    the end rows, and overflow (more than R runs)."""
    L, CH, CW = mask.shape
    starts, ends = _run_starts(mask)
    ps = _compact(starts.reshape(L, -1), R, -1)
    pe = _compact(ends.reshape(L, -1), R, -1)
    ys = torch.where(ps >= 0, ps // CW, -1)
    xs = torch.where(ps >= 0, ps % CW, -1)
    ye = torch.where(pe >= 0, pe // CW, -1)
    xe = torch.where(pe >= 0, pe % CW, -1)
    return ys, xs, xe, ye, starts.sum((1, 2)) > R


def _biggest_component(mask, spec: PostureSpec):
    """Largest 8-connected component of (L, CH, CW) crop masks (run-table
    components). Returns (dense (L, CH, CW) bool, its pixels (L,) int32,
    overflow (L,)).

    The run tables are cut to the most runs any lane has (at most
    ``max_runs``): the labels are the least run index of each component
    either way, and the sizes past that count are zero in the JAX
    package's full-width tables."""
    L, CH, CW = mask.shape
    dev = mask.device
    n_max = int(_run_starts(mask)[0].sum((1, 2)).max()) if L else 0
    R = max(1, min(spec.max_runs, n_max))
    ry, rx0, rx1, _, overflow = _mask_run_tables(mask, R)
    valid = ry >= 0
    labels = _cc_run_labels(ry, rx0, rx1, valid, R)
    length = torch.where(valid, rx1 - rx0 + 1, 0)
    sizes = _seg(length, torch.where(valid, labels, R), R + 1, "sum")[:, :R]
    big = torch.argmax(sizes, 1)
    npx = torch.gather(sizes, 1, big[:, None])[:, 0]
    keep = valid & (labels == big[:, None])
    row = torch.where(keep, ry, CH).clamp(0, CH).long()
    c0 = torch.where(keep, rx0, CW).clamp(0, CW).long()
    c1 = torch.where(keep, rx1 + 1, CW).clamp(0, CW).long()
    lane = torch.arange(L, device=dev)[:, None].expand_as(row)
    acc = torch.zeros((L, CH + 1, CW + 1), dtype=_I32, device=dev)
    ones = torch.ones(row.shape, dtype=_I32, device=dev)
    acc.index_put_((lane, row, c0), ones, accumulate=True)
    acc.index_put_((lane, row, c1), -ones, accumulate=True)
    dense = torch.cumsum(acc[:, :CH, :CW], 2, dtype=_I32) > 0
    return dense, npx.to(_I32), overflow


# ---------------------------------------------------------------------------
# supersampled Moore trace
# ---------------------------------------------------------------------------

def _trace4(dense, spec: PostureSpec):
    """Moore boundary trace of kron(dense, 4x4) / 4 without building the
    4x image (occupancy at (Y, X) is dense[Y // 4, X // 4]): from the
    topmost-leftmost pixel, clockwise, until the trace closes; the
    duplicated start is dropped.

    Returns (pts (L, max_trace, 2) float32 [x, y] in 1x crop coordinates,
    n (L,) int32, overflow (L,) bool)."""
    L, CH, CW = dense.shape
    S = spec.max_trace
    dev = dense.device
    oy = torch.tensor(_ORDER_Y, dtype=_I32, device=dev)
    ox = torch.tensor(_ORDER_X, dtype=_I32, device=dev)
    lane = torch.arange(L, device=dev)
    flat = dense.reshape(L, CH * CW)

    any_row = dense.any(2)
    y0 = torch.argmax(any_row.to(_I32), 1).to(_I32)
    x0 = torch.argmax(dense[lane, y0.long()].to(_I32), 1).to(_I32)
    sy, sx = y0 * 4, x0 * 4
    empty = ~any_row.any(1)

    def occ(y, x):
        inb = (y >= 0) & (y < CH * 4) & (x >= 0) & (x < CW * 4)
        yc = torch.div(y, 4, rounding_mode="floor").clamp(0, CH - 1)
        xc = torch.div(x, 4, rounding_mode="floor").clamp(0, CW - 1)
        return inb & torch.gather(flat, 1, (yc * CW + xc).long())

    buf = torch.zeros((L, S, 2), dtype=_I32, device=dev)
    buf[:, 0, 0] = sy
    buf[:, 0, 1] = sx
    cy, cx = sy.clone(), sx.clone()
    back = torch.zeros(L, dtype=_I32, device=dev)
    n = torch.ones(L, dtype=_I32, device=dev)
    done = empty.clone()
    ar8 = torch.arange(8, dtype=_I32, device=dev)
    while bool((~done & (n < S)).any()):
        for _ in range(_TRACE_BLOCK):
            go = ~done & (n < S)
            d = (back[:, None] + 1 + ar8) % 8
            ny = cy[:, None] + oy[d.long()]
            nx = cx[:, None] + ox[d.long()]
            hit = occ(ny, nx)
            k = torch.argmax(hit.to(_I32), 1)[:, None]
            found = hit.any(1)
            cy2 = torch.where(found, torch.gather(ny, 1, k)[:, 0], cy)
            cx2 = torch.where(found, torch.gather(nx, 1, k)[:, 0], cx)
            _masked_write(buf, lane, n, torch.stack([cy2, cx2], 1), go)
            n2 = torch.where(found, n + 1, n)
            closed = found & (cy2 == sy) & (cx2 == sx) & (n2 > 2)
            back2 = torch.where(found, (torch.gather(d, 1, k)[:, 0] + 4) % 8,
                                back)
            cy = torch.where(go, cy2, cy)
            cx = torch.where(go, cx2, cx)
            back = torch.where(go, back2, back)
            n = torch.where(go, n2, n)
            done = torch.where(go, ~found | closed, done)
    overflow = ~done & (n >= S)
    closed = done & (cy == sy) & (cx == sx) & (n > 2)
    n = torch.where(closed, n - 1, n)
    pts = torch.stack([buf[:, :, 1].to(_F32) * 0.25,
                       buf[:, :, 0].to(_F32) * 0.25], 2)
    n = torch.where(empty, 0, n)
    return pts, n, overflow


# ---------------------------------------------------------------------------
# Outline::resample - closed-form emission counts
# ---------------------------------------------------------------------------

def _resample(pts, n, spec: PostureSpec):
    """Outline::resample: walk the closed polygon and, where the walked
    distance crosses the spacing, emit points p0 + dir * (o * d / seg)
    for o = 0 .. k - 1; k per segment and the offsets are closed-form in
    the prefix arc length, so the walk is a gather.

    Returns (out (L, max_outline, 2) float32, m (L,) int32, overflow)."""
    L, S, _ = pts.shape
    M = spec.max_outline
    dev = pts.device
    d = _const(spec.resample_d, pts)
    idx = torch.arange(S, dtype=_I32, device=dev)[None, :]
    valid = idx < n[:, None]
    nxt = torch.where(idx + 1 >= n[:, None], 0, idx + 1)
    p0 = pts
    p1 = _take(pts, nxt)
    seg = torch.where(valid, _hypot(p1[..., 0] - p0[..., 0],
                                    p1[..., 1] - p0[..., 1]), 0.0)
    cum = _cumsum(seg)
    wb = torch.remainder(cum - seg, d)
    k = torch.where(valid, torch.floor((wb + seg) / d), 0.0).to(_I32)
    cum_k = torch.cumsum(k, 1, dtype=_I32)
    total = torch.clamp_max(cum_k[:, -1], 1 << 30)
    overflow = total > M
    j = torch.arange(M, dtype=_I32, device=dev)[None, :].expand(L, M)
    si = torch.searchsorted(cum_k, j.contiguous(), right=True)
    si = torch.clamp_max(si, S - 1)
    o = (j - (_take(cum_k, si) - _take(k, si))).to(_F32)
    seg_safe = torch.clamp_min(_take(seg, si), 1e-12)
    t = o * d / seg_safe
    a = _take(p0, si)
    out = a + (_take(p1, si) - a) * t[..., None]
    m = torch.clamp_max(total, M)
    out = torch.where((j < m[:, None])[..., None], out, 0.0)
    return out, m, overflow


# ---------------------------------------------------------------------------
# smoothing / orientation / EFT / curvature
# ---------------------------------------------------------------------------

def _smooth(pts, Lo, spec: PostureSpec):
    """Triangular periodic smoothing (Outline.cpp:380-436), the taps
    summed in order."""
    samples = spec.smooth_samples
    if samples <= 0:
        return pts
    step_row = int(samples * spec.smooth_step)
    if step_row < 1:
        return pts
    offs = np.arange(-step_row, step_row + 1, spec.smooth_step)
    w = (step_row - np.abs(offs)) / step_row
    w = (w / w.sum()).astype(np.float32)
    M = pts.shape[1]
    ar = torch.arange(M, dtype=_I32, device=pts.device)[None, :]
    Lc = torch.clamp_min(Lo, 1)[:, None]
    sm = None
    for o, wk in zip(offs.tolist(), w.tolist()):
        term = _take(pts, torch.remainder(ar + o, Lc)) \
            * _const(wk, pts)
        sm = term if sm is None else sm + term
    # the host skips smoothing when L <= samples
    return torch.where((Lo > samples)[:, None, None], sm, pts)


def _make_clockwise(pts, Lo):
    """Positive signed area in image coordinates; reversed otherwise."""
    M = pts.shape[1]
    idx = torch.arange(M, dtype=_I32, device=pts.device)[None, :]
    valid = idx < Lo[:, None]
    nxt = _take(pts, torch.where(idx + 1 >= Lo[:, None], 0, idx + 1))
    x, y = pts[..., 0], pts[..., 1]
    area = 0.5 * torch.where(valid, x * nxt[..., 1] - nxt[..., 0] * y,
                             0.0).sum(1)
    rev = torch.remainder(Lo[:, None] - 1 - idx,
                          torch.clamp_min(Lo, 1)[:, None])
    return torch.where((area < 0)[:, None, None], _take(pts, rev), pts)


def _rounded(fn, *args):
    """float32 `fn` of float32 tensors, computed in float64 and rounded:
    the float32 cosines, sines and arc functions of the card and of the
    CPU differ in the last bits, which on a symmetric outline decides
    which of two equal curvature peaks is the tail."""
    return fn(*(a.to(torch.float64) for a in args)).to(_F32)


def _cos_sin(x: torch.Tensor):
    return _rounded(torch.cos, x), _rounded(torch.sin, x)


def _eft_approx(pts, Lo, spec: PostureSpec):
    """outline_approximate > 0: the outline's elliptic Fourier
    reconstruction (Outline.cpp:499-513; Kuhl and Giardina)."""
    H = spec.approximate
    if H <= 0:
        return pts
    L, M, _ = pts.shape
    dev = pts.device
    idx = torch.arange(M, dtype=_I32, device=dev)[None, :]
    valid = idx < Lo[:, None]
    Lf = torch.clamp_min(Lo, 1).to(_F32)
    center = torch.where(valid[..., None], pts, 0.0).sum(1) / Lf[:, None]
    p = torch.where(valid[..., None], pts - center[:, None, :], 0.0)
    nxt = torch.where(idx + 1 >= Lo[:, None], 0, idx + 1)
    dvec = torch.where(valid[..., None], _take(p, nxt) - p, 0.0)
    dt = _hypot(dvec[..., 0], dvec[..., 1])
    dt = torch.where(dt == 0, 1e-12, dt)
    dt = torch.where(valid, dt, 1e-12)
    t = F.pad(_cumsum(torch.where(valid, dt, 0.0)), (1, 0))  # (L, M + 1)
    T = t[:, -1]
    T = torch.where(T <= 0, 1.0, T)[:, None, None]
    nh = torch.arange(1, H + 1, dtype=_F32, device=dev)[None, :, None]
    phi = 2 * math.pi * nh * t[:, None, :] / T              # (L, H, M + 1)
    ph0 = phi[..., :-1]
    ph1 = torch.where(valid[:, None, :], phi[..., 1:], phi[..., :-1])
    (c1, s1), (c0, s0) = _cos_sin(ph1), _cos_sin(ph0)
    dcos = c1 - c0
    dsin = s1 - s0
    c = T[..., 0] / (2 * (nh[..., 0] ** 2) * math.pi ** 2)   # (L, H)
    vx = torch.where(valid, dvec[..., 0] / dt, 0.0)[:, None, :]
    vy = torch.where(valid, dvec[..., 1] / dt, 0.0)[:, None, :]
    a = c * (vx * dcos).sum(2)
    b = c * (vx * dsin).sum(2)
    cc = c * (vy * dcos).sum(2)
    dd = c * (vy * dsin).sum(2)
    # L uniformly spaced points
    tt = T[..., 0] * idx.to(_F32) / Lf[:, None]              # (L, M)
    ph = 2 * math.pi * nh * tt[:, None, :] / T              # (L, H, M)
    cph, sph = _cos_sin(ph)
    x = y = None
    for h in range(H):
        xh = a[:, h, None] * cph[:, h] + b[:, h, None] * sph[:, h]
        yh = cc[:, h, None] * cph[:, h] + dd[:, h, None] * sph[:, h]
        x = xh if x is None else x + xh
        y = yh if y is None else y + yh
    rec = torch.stack([center[:, 0, None] + x, center[:, 1, None] + y], 2)
    return torch.where((Lo > 2)[:, None, None],
                       torch.where(valid[..., None], rec, 0.0), pts)


def _tail_head(pts, Lo, spec: PostureSpec):
    """Menger curvature over the ratio window; tail = the strongest local
    maximum, head = the peak circularly farthest from the tail. Returns
    (tail (L,) int32, head (L,) int32, any peak (L,) bool)."""
    M = pts.shape[1]
    dev = pts.device
    idx = torch.arange(M, dtype=_I32, device=dev)[None, :]
    valid = idx < Lo[:, None]
    Lc = torch.clamp_min(Lo, 1)[:, None]
    rng = torch.clamp_min((spec.curvature_ratio * Lo.to(_F32)).to(_I32),
                          1)[:, None]
    p1 = _take(pts, torch.remainder(idx - rng, Lc))
    p3 = _take(pts, torch.remainder(idx + rng, Lc))
    a = pts - p1
    b = p3 - pts
    cross = a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
    d12 = _hypot(a[..., 0], a[..., 1])
    d23 = _hypot(b[..., 0], b[..., 1])
    d13 = _hypot(p3[..., 0] - p1[..., 0], p3[..., 1] - p1[..., 1])
    denom = torch.sqrt(torch.clamp_min(d12 * d23 * d13, 1e-12))
    curv = torch.where(valid, 2.0 * cross / denom, _NEG)
    left = _take(curv, torch.remainder(idx - 1, Lc))
    right = _take(curv, torch.remainder(idx + 1, Lc))
    peak = valid & (curv >= left) & (curv > right)
    tail = torch.argmax(torch.where(peak, curv, _NEG), 1).to(_I32)
    dist = (idx - tail[:, None]).abs()
    dist = torch.minimum(dist, Lo[:, None] - dist)
    head = torch.argmax(torch.where(peak, dist, -1), 1).to(_I32)
    return tail, head, peak.any(1)


# ---------------------------------------------------------------------------
# midline walk + post-process + normalize
# ---------------------------------------------------------------------------

def _midline_walk(pts, Lo, spec: PostureSpec):
    """Pairing walk from the tail (Outline.cpp:768-866); `pts` rotated so
    the tail is index 0. Each step takes the right point nearest the
    current left one in the window ahead, then the left point nearest it
    in the window behind (ties: the first ahead, the first behind).
    Returns (segs (L, K, 2), heights (L, K), m (L,) int32), K =
    max_outline // 2 + 4."""
    L, M, _ = pts.shape
    dev = pts.device
    K = spec.max_outline // 2 + 4
    WCAP = int(spec.walk_offset * spec.max_outline) + 4
    lane = torch.arange(L, device=dev)
    w = torch.arange(WCAP, dtype=_I32, device=dev)[None, :]
    pts_pad = F.pad(pts, (0, 0, 0, WCAP))                 # (L, M + WCAP, 2)
    max_off = torch.clamp_min(
        (spec.walk_offset * Lo.to(_F32)).to(_I32), 3)

    def point(i):
        return _take(pts_pad, i.clamp(0, M - 1)[:, None])[:, 0]

    idx_r = torch.ones(L, dtype=_I32, device=dev)
    idx_l = torch.full((L,), -1, dtype=_I32, device=dev)
    m = torch.zeros(L, dtype=_I32, device=dev)
    guard = torch.zeros(L, dtype=_I32, device=dev)
    segs = torch.zeros((L, K, 2), dtype=_F32, device=dev)
    hts = torch.zeros((L, K), dtype=_F32, device=dev)

    def cond():
        return (idx_r < Lo + idx_l) & (guard < 4 * Lo) & (m < K)

    while bool(cond().any()):
        for _ in range(_WALK_BLOCK):
            go = cond()
            ptl = point(Lo + idx_l)
            # right window [idx_r, min(L, idx_r + max_off)), ascending
            hi = torch.minimum(Lo, idx_r + max_off)
            win_r = _take(pts_pad, idx_r.clamp(0, M)[:, None] + w)
            okr = w < (hi - idx_r)[:, None]
            ddr = torch.where(okr, _hypot(win_r[..., 0] - ptl[:, None, 0],
                                          win_r[..., 1] - ptl[:, None, 1]),
                              INF)
            idx_r2 = torch.where(okr.any(1),
                                 idx_r + torch.argmin(ddr, 1).to(_I32), idx_r)
            ptr = point(idx_r2)
            # left window idx_l, idx_l - 1, ... lo (descending): read
            # ascending from the clamped start, then reversed so that
            # ties break like the host's descending argmin
            lo = torch.maximum(-Lo + 1, idx_l - max_off + 1)
            start_l = (Lo + idx_l - (WCAP - 1)).clamp(0, M)
            win_l = _take(pts_pad, start_l[:, None] + w)
            true_l = start_l[:, None] + w - Lo[:, None]
            okl = (true_l >= lo[:, None]) & (true_l <= idx_l[:, None])
            ddl = torch.where(okl, _hypot(win_l[..., 0] - ptr[:, None, 0],
                                          win_l[..., 1] - ptr[:, None, 1]),
                              INF)
            kk = torch.argmin(ddl.flip(1), 1).to(_I32)
            idx_l2 = torch.where(okl.any(1),
                                 start_l + (WCAP - 1 - kk) - Lo, idx_l)
            ptl2 = point(Lo + idx_l2)
            _masked_write(segs, lane, m, (ptl2 + ptr) * 0.5, go)
            _masked_write(hts, lane, m, _hypot(ptr[:, 0] - ptl2[:, 0],
                                               ptr[:, 1] - ptl2[:, 1]), go)
            idx_r = torch.where(go, idx_r2 + 1, idx_r)
            idx_l = torch.where(go, idx_l2 - 1, idx_l)
            m = torch.where(go, m + 1, m)
            guard = torch.where(go, guard + 1, guard)
    return segs, hts, m


def _roll_next(segs):
    """jnp.roll(segs, -1, axis=0) per lane: element i + 1 at i."""
    return torch.roll(segs, -1, 1)


def _midline_direction(segs, m, stiff_pct: float):
    """Midline.midline_direction: the mean of the first max(1, m *
    stiff_pct) segment vectors, normalised."""
    K = segs.shape[1]
    idx = torch.arange(K, dtype=_I32, device=segs.device)[None, :]
    n = torch.clamp_min((m.to(_F32) * stiff_pct).to(_I32), 1)[:, None]
    use = (idx < n) & (idx + 1 < m[:, None])
    d = torch.where(use[..., None], _roll_next(segs) - segs, 0.0).sum(1)
    cnt = use.sum(1)
    d = torch.where((cnt > 0)[:, None],
                    d / torch.clamp_min(cnt, 1)[:, None], d)
    norm = _hypot(d[:, 0], d[:, 1])
    return torch.where((norm > 0)[:, None], d / norm[:, None], d)


def _stiff_variant(segs, hts, m, do_rev: bool, spec: PostureSpec):
    """One orientation of Midline::post_process's tail: the (static)
    reversal, then stiff-percentage straightening (Outline.cpp:890-1010).
    The orientation decision is a select between both variants
    afterwards (:func:`_orient_select`)."""
    L, K, _ = segs.shape
    dev = segs.device
    idx = torch.arange(K, dtype=_I32, device=dev)[None, :]
    if do_rev:
        rev = (m[:, None] - 1 - idx).clamp(0, K - 1)
        segs = _take(segs, rev)
        hts = _take(hts, rev)
    if spec.stiff_pct > 0:
        mf = m.to(_F32)
        center = torch.minimum(
            m - 1, (torch.round(mf * spec.stiff_pct) + 1).to(_I32))
        center = torch.clamp_min(center, 0)
        center_point = _take(segs, center.clamp(0, K - 1)[:, None])[:, 0]
        extra = torch.minimum(
            m, center + torch.clamp_min(mf * 0.1, 0.0).to(_I32))
        use = (idx >= center[:, None]) & (idx < extra[:, None]) \
            & (idx + 1 < m[:, None])
        v = segs - _roll_next(segs)
        nv = _hypot(v[..., 0], v[..., 1])
        vn = torch.where((nv > 0)[..., None],
                         v / torch.clamp_min(nv, 1e-12)[..., None], 0.0)
        axis = torch.where(use[..., None], vn, 0.0).sum(1)
        count = use.sum(1)
        axis = torch.where((count > 0)[:, None],
                           axis / torch.clamp_min(count, 1)[:, None], axis)
        prev = torch.roll(segs, 1, 1)
        seg_len = _hypot(segs[..., 0] - prev[..., 0],
                         segs[..., 1] - prev[..., 1])
        segs = segs.clone()
        lane = torch.arange(L, device=dev)
        i = center.clone()
        for _ in range(int(center.max()) if L else 0):
            go = i > 0
            ic = i.clamp(0, K - 1)[:, None]
            im = (i - 1).clamp(0, K - 1)
            p1 = _take(segs, ic)[:, 0]
            sl = _take(seg_len, ic)[:, 0]
            dtc = _take(segs, im[:, None])[:, 0] - center_point
            n1 = _hypot(dtc[:, 0], dtc[:, 1])[:, None]
            dtc = torch.where(n1 > 0, dtc / torch.clamp_min(n1, 1e-12), dtc)
            test = (dtc + axis) * 0.5
            n2 = _hypot(test[:, 0], test[:, 1])[:, None]
            test = torch.where(n2 > 0, test / torch.clamp_min(n2, 1e-12),
                               test)
            _masked_write(segs, lane, im, p1 + sl[:, None] * test, go)
            i = torch.where(go, i - 1, i)
    return segs, hts


def _normalize_len(segs, m, spec: PostureSpec):
    """Midline::normalize's arc-length resample to midline_resolution
    points (Outline.cpp:1270-1408) and the chord-sum length. Returns (ok,
    length)."""
    K = segs.shape[1]
    res = spec.midline_res
    dev = segs.device
    idx = torch.arange(K, dtype=_I32, device=dev)[None, :]
    d = _roll_next(segs) - segs
    lens = torch.where(idx + 1 < m[:, None], _hypot(d[..., 0], d[..., 1]),
                       0.0)
    raw_len = lens.sum(1)
    ok = (raw_len > 0) & (m > 2)
    step = raw_len / _const(res - 1, segs)
    cum = _cumsum(lens)
    # emission j (1 .. res-2) at arc position j * step on its segment;
    # the end points are segs[0] and segs[m - 1]
    j = torch.arange(1, res - 1, dtype=_F32, device=dev)[None, :]
    pos = (j * step[:, None]).contiguous()
    si = torch.searchsorted(cum.contiguous(), pos).clamp(0, K - 1)
    prev_cum = torch.where(si > 0, _take(cum, (si - 1).clamp_min(0)), 0.0)
    local = torch.clamp_min(_take(lens, si), 1e-12)
    t = (pos - prev_cum) / local
    pts_mid = _take(segs, si) + _take(d, si) * t[..., None]
    last = _take(segs, (m - 1).clamp(0, K - 1)[:, None])
    red = torch.cat([segs[:, :1], pts_mid, last], 1)     # (L, res, 2)
    dd = red[:, 1:] - red[:, :-1]
    length = _hypot(dd[..., 0], dd[..., 1]).sum(1)
    return ok, torch.where(ok, length, 0.0)


# ---------------------------------------------------------------------------
# the chain through the walk, with threshold escalation
# ---------------------------------------------------------------------------

def _chain_to_walk(diff, in_run, thr, spec: PostureSpec, stats=None):
    """One threshold's outline -> midline walk per lane (everything that
    does not depend on the orientation). Returns (ok, segs (L, K, 2),
    hts (L, K), mcnt, comp_px, overflow); `ok` is the host's midline
    condition (peaks, more than two walk segments, a positive length).
    The JAX package's early exits (``lax.cond``) are selects here.
    `stats`, when given, keeps the most trace points and walk segments
    of any lane."""
    K = spec.max_outline // 2 + 4
    t3 = thr[:, None, None]
    keep = torch.where(t3 > 0, diff >= t3, in_run)
    dense, comp_px, ov1 = _biggest_component(keep, spec)
    tr, n_tr, ov2 = _trace4(dense, spec)
    if spec.resample_d > 0:
        rs, Lo, ov3 = _resample(tr, n_tr, spec)
    else:
        rs, Lo, ov3 = tr, n_tr, torch.zeros_like(ov2)
    sm = _smooth(rs, Lo, spec)
    cw = _make_clockwise(sm, Lo)
    ap = _eft_approx(cw, Lo, spec)
    tail, _, has_peak = _tail_head(ap, Lo, spec)
    M = ap.shape[1]
    ar = torch.arange(M, dtype=_I32, device=ap.device)[None, :]
    rot = _take(ap, torch.remainder(ar + tail[:, None],
                                    torch.clamp_min(Lo, 1)[:, None]))
    segs, hts, mcnt = _midline_walk(rot, Lo, spec)
    d = _roll_next(segs) - segs
    kidx = torch.arange(K, dtype=_I32, device=ap.device)[None, :]
    lens = torch.where(kidx + 1 < mcnt[:, None], _hypot(d[..., 0], d[..., 1]),
                       0.0)
    has_cc = comp_px >= 1
    has_tr = n_tr >= 3
    full = has_cc & has_tr & (mcnt > 2)
    ok = full & (Lo >= 3) & has_peak & (lens.sum(1) > 0)
    segs = torch.where(full[:, None, None], segs, 0.0)
    hts = torch.where(full[:, None], hts, 0.0)
    mcnt = torch.where(full, mcnt, 0)
    ov = ov1 | (has_cc & (ov2 | (has_tr & ov3)))
    if stats is not None:
        for k, v in (("trace_points_max", n_tr), ("walk_segments_max", mcnt)):
            stats[k] = max(stats.get(k, 0), int(v.max()))
    return ok, segs, hts, mcnt, comp_px, ov


def _escalate_to_walk(diff, in_run, npix, active, spec: PostureSpec,
                      stats=None):
    """Threshold escalation around _chain_to_walk (Posture.cpp:305-410:
    +2 per retry up to +100, until the midline succeeds or the biggest
    component drops under num_pixels / 10). Each round runs on the lanes
    still escalating. Returns (ok, segs, hts, mcnt, overflow). `stats`,
    when given, gets the lanes of each round under "round_lanes"."""
    L = diff.shape[0]
    dev = diff.device
    K = spec.max_outline // 2 + 4
    base = spec.threshold
    min_px = torch.clamp_min(torch.div(npix, 10, rounding_mode="floor"), 1)
    ok_last = torch.zeros(L, dtype=torch.bool, device=dev)
    ok_acc = torch.zeros(L, dtype=torch.bool, device=dev)
    thr = torch.full((L,), base, dtype=_I32, device=dev)
    segs = torch.zeros((L, K, 2), dtype=_F32, device=dev)
    hts = torch.zeros((L, K), dtype=_F32, device=dev)
    mcnt = torch.zeros(L, dtype=_I32, device=dev)
    alive = active.clone()
    ov = torch.zeros(L, dtype=torch.bool, device=dev)
    while True:
        sel = torch.nonzero(~ok_last & alive)[:, 0]
        if not sel.numel():
            break
        if stats is not None:
            stats.setdefault("round_lanes", []).append(sel.numel())
        t = thr[sel]
        ok, s2, h2, m2, comp_px, ov_r = _chain_to_walk(
            diff[sel], in_run[sel], t, spec, stats)
        nonempty = comp_px >= 1
        ok = ok & nonempty
        ok_last[sel] = ok
        alive[sel] = nonempty & ~ok & (comp_px >= min_px[sel]) \
            & (t + 2 < base + 100)
        thr[sel] = t + 2
        ok_acc[sel] = ok_acc[sel] | ok
        segs[sel] = torch.where(ok[:, None, None], s2, segs[sel])
        hts[sel] = torch.where(ok[:, None], h2, hts[sel])
        mcnt[sel] = torch.where(ok, m2, mcnt[sel])
        ov[sel] = ov[sel] | ov_r
    return ok_acc & active, segs, hts, mcnt, ov & active


def _post_norm_both(segs, hts, mcnt, spec: PostureSpec):
    """Both orientations' post-process and normalisation per lane.
    Returns a dict with dir_entry (L, 2) (the direction before the
    reversal, which drives the orientation decision) and per variant
    (fwd, rev) length, angle, dir and norm_ok."""
    out = dict(dir_entry=_midline_direction(segs, mcnt, spec.stiff_pct))
    for name, do_rev in (("fwd", False), ("rev", True)):
        s2, _ = _stiff_variant(segs, hts, mcnt, do_rev, spec)
        norm_ok, length = _normalize_len(s2, mcnt, spec)
        direction = _midline_direction(s2, mcnt, spec.stiff_pct)
        out[name] = dict(
            length=torch.where(norm_ok, length, 0.0),
            angle=_rounded(torch.atan2, direction[:, 1], direction[:, 0]),
            dir=direction, norm_ok=norm_ok)
    return out


def _orient_select(dir_entry, prev_move, fwd, rev, spec: PostureSpec):
    """Midline::post_process's orientation decision as a select between
    the two variants. Inputs may carry any leading lane dimensions;
    prev_move is the movement direction (= -previous midline direction;
    zeros = none)."""
    needs0 = not spec.invert
    d = dir_entry if needs0 else -dir_entry
    mvn = _hypot(prev_move[..., 0], prev_move[..., 1])
    mv = prev_move / torch.clamp_min(mvn, 1e-12)[..., None]
    has_move = (prev_move != 0).any(-1) & (mvn > 0)
    dot = (d[..., 0] * mv[..., 0] + d[..., 1] * mv[..., 1]).clamp(-1.0, 1.0)
    flip = has_move & (_rounded(torch.arccos, -dot)
                       < _rounded(torch.arccos, dot))
    needs_invert = torch.where(flip, not needs0, needs0)
    do_rev = needs_invert != spec.start_with_head
    length = torch.where(do_rev, rev["length"], fwd["length"])
    angle = torch.where(do_rev, rev["angle"], fwd["angle"])
    direction = torch.where(do_rev[..., None], rev["dir"], fwd["dir"])
    ok_n = torch.where(do_rev, rev["norm_ok"], fwd["norm_ok"])
    return length, angle, direction, ok_n


def posture_blob(frame, background, bi, bx0i, by0i,
                 runs_y, runs_x0, runs_x1, runs_slot,
                 prev_move, active, spec: PostureSpec):
    """Posture of blobs `bi` (lanes) of one frame with threshold
    escalation (Posture.cpp:305-410); inactive lanes do not run. bi,
    bx0i, by0i, active (L,); prev_move (L, 2); runs_* (R,) the frame's
    run tables. Returns dict(ok, length, angle, dir (L, 2), overflow)."""
    diff, in_run, npix = _crop_blob(frame, background, bi, bx0i, by0i,
                                    runs_y, runs_x0, runs_x1, runs_slot,
                                    spec)
    ok, segs, hts, mcnt, overflow = _escalate_to_walk(
        diff, in_run, npix, active, spec)
    both = _post_norm_both(segs, hts, mcnt, spec)
    length, angle, direction, ok_n = _orient_select(
        both["dir_entry"], prev_move, both["fwd"], both["rev"], spec)
    ok = ok & ok_n
    return dict(ok=ok, length=torch.where(ok, length, 0.0),
                angle=torch.where(ok, angle, 0.0), dir=direction,
                overflow=overflow)


def make_posture_batch(spec: PostureSpec):
    """Per-blob posture over lanes with the (static) spec bound: the JAX
    package's vmapped ``posture_blob``."""
    def batch(frame, background, bi, bx0i, by0i,
              runs_y, runs_x0, runs_x1, runs_slot, prev_move, active):
        return posture_blob(frame, background, bi, bx0i, by0i,
                            runs_y, runs_x0, runs_x1, runs_slot,
                            prev_move, active, spec)
    return batch


# ---------------------------------------------------------------------------
# chunk-batched posture: every (frame, fish) lane at once
# ---------------------------------------------------------------------------

def posture_lanes_batched(frames, background, bi, bx0, by0,
                          runs_y, runs_x0, runs_x1, runs_slot,
                          active, spec: PostureSpec, stats=None):
    """The chain through the walk for all (T, F) lanes in one batch, then
    both orientation variants per lane; the orientation decision that
    couples consecutive frames is posture_select_scan's.

    Only the active lanes run, in blocks of LANE_BLOCK lanes; an inactive
    lane gets the values the JAX package's chain gives it (not ok, no
    overflow, every length, angle and direction zero).

    frames (T, H, W); runs_* (T, R); bi, bx0, by0, active (T, F).
    Returns a dict of (T, F[, 2]) tensors: ok, overflow, dir_entry, and
    the fwd and rev variants (length, angle, dir, norm_ok). `stats`, when
    given, gets the escalation rounds' lane counts and the most trace
    points and walk segments of any lane."""
    T, Fn = bi.shape
    dev = bi.device
    zf = torch.zeros((T * Fn,), dtype=_F32, device=dev)
    zb = torch.zeros((T * Fn,), dtype=torch.bool, device=dev)
    z2 = torch.zeros((T * Fn, 2), dtype=_F32, device=dev)
    out = dict(ok=zb.clone(), overflow=zb.clone(), dir_entry=z2.clone(),
               fwd=dict(length=zf.clone(), angle=zf.clone(), dir=z2.clone(),
                        norm_ok=zb.clone()),
               rev=dict(length=zf.clone(), angle=zf.clone(), dir=z2.clone(),
                        norm_ok=zb.clone()))
    lanes = torch.nonzero(active.reshape(-1))[:, 0]
    frame_of = (lanes // Fn).cpu().numpy()
    flat = [x.reshape(-1) for x in (bi, bx0, by0)]
    for s0 in range(0, lanes.numel(), LANE_BLOCK):
        blk = lanes[s0:s0 + LANE_BLOCK]
        f_blk = frame_of[s0:s0 + LANE_BLOCK]
        parts = []
        for t in np.unique(f_blk).tolist():
            sel = blk[torch.as_tensor(f_blk == t, device=dev)]
            parts.append(_crop_blob(
                frames[t], background, *(x[sel] for x in flat),
                runs_y[t], runs_x0[t], runs_x1[t], runs_slot[t], spec))
        diff, in_run, npix = (torch.cat(p) for p in zip(*parts))
        ok, segs, hts, mcnt, overflow = _escalate_to_walk(
            diff, in_run, npix, torch.ones_like(blk, dtype=torch.bool),
            spec, stats)
        both = _post_norm_both(segs, hts, mcnt, spec)
        out["ok"][blk] = ok
        out["overflow"][blk] = overflow
        out["dir_entry"][blk] = both["dir_entry"]
        for v in ("fwd", "rev"):
            for k in out[v]:
                out[v][k][blk] = both[v][k]

    def shaped(x):
        return x.reshape(T, Fn, *x.shape[1:])

    return {k: ({kk: shaped(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else shaped(v))
            for k, v in out.items()}


def posture_select_scan(out, pdir0, spec: PostureSpec):
    """Frame-sequential orientation selection: walks the per-fish
    previous-midline-direction carry (FastTracker._posture_dir) through
    the chunk, picking each lane's precomputed variant (elementwise).

    Returns (p_len, p_ang, p_ok (T, F), p_dir (T, F, 2), pdir_final)."""
    pdir = pdir0
    p_len, p_ang, p_ok, p_dir = [], [], [], []
    for t in range(out["ok"].shape[0]):
        fwd = {k: v[t] for k, v in out["fwd"].items()}
        rev = {k: v[t] for k, v in out["rev"].items()}
        length, angle, direction, ok_n = _orient_select(
            out["dir_entry"][t], -pdir, fwd, rev, spec)
        ok = out["ok"][t] & ok_n
        pdir = torch.where(ok[:, None], direction, pdir)
        p_len.append(torch.where(ok, length, 0.0))
        p_ang.append(torch.where(ok, angle, 0.0))
        p_ok.append(ok)
        p_dir.append(pdir)
    return (torch.stack(p_len), torch.stack(p_ang), torch.stack(p_ok),
            torch.stack(p_dir), pdir)
