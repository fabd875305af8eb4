"""On-device HistorySplit: expectation and threshold-escalation split.

Counterpart of ``trex_tpu/ops/device_split.py``: the card's versions of
the host engine's native pair ``trex_expectation`` /
``trex_split_execute`` (HistorySplit.cpp:170-320, SplitBlob.cpp:190-245,
406-640). The tracking scan (``ops/device_tracker.py``) calls both per
frame, so frames with merged blobs are split and re-matched on the card.

Wherever these functions decide anything, they decide it as the host
does, and every decision that float32 against the host's float64 could
flip (a distance within EPS_D of the radius or of a competing distance,
a size within relative EPS_S of a dynamic bound, a crop, run or piece
capacity overflow) raises ``marginal`` instead, which the tracking scan
turns into ``needs_host``.

Expectation (``engine._split_expectation_py`` is its host twin):
- near(f, b): bbox distance <= max_d; contested blobs have >= 2 near
  fish; involved fish touch one;
- sampled mask points per blob (PPFrame::fill_proximity_grid): first and
  last line and even-y lines (all lines below 4), per kept line both ends,
  the middle and interior points every floor(max(1, width * 0.1)) px
  when that step is >= 5 and x1 - x0 >= 2 * step;
- edge(f, b) = near and the least sampled-point distance <= max_d;
- per clique with more fish than blobs, deferred acceptance closest
  first (proposer-optimal, so independent of the host queue's order for
  strict preferences; distance ties raise ``marginal``);
- a fish that exhausted its edges adds 1 to its closest blob's
  expectation, plus 1 the first time if that blob ended the round owned.

The reference's while loops are Python loops here; loops whose body is a
fixed point once they end check the host only every few rounds
(``_LOOP_BLOCK``). The split executor's ``jax.vmap`` over split targets
is a leading lane dimension: lanes that are done keep their state while
the others go on, as the vmapped loop does.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .runcc import I32_MAX, I32_MIN, _run_tables, _seg

_F32 = torch.float32
_I32 = torch.int32
INF = float("inf")
# px guard on distance comparisons: covers the f32-vs-host-f64 gap
EPS_D = 1e-3
EPS_S = 1e-5     # relative: dynamic-bound size comparisons
# rounds of a fixed-point loop between host checks
_LOOP_BLOCK = 4


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
    return torch.where(is_inf, torch.full_like(x, INF), x)


def _fixed_point_loop(body, state, changed):
    """Run `state = body(state)` until `changed(old, new)` is false,
    checking on the host every _LOOP_BLOCK rounds. Only for bodies that
    return their input unchanged once the loop has ended."""
    while True:
        new = state
        for _ in range(_LOOP_BLOCK):
            prev, new = new, body(new)
        if not bool(changed(prev, new)):
            return new
        state = new


def _run_sample_min_d2(fish_x, fish_y, runs_y, runs_x0, runs_x1,
                       runs_slot, step_b, count_b, B: int):
    """Least squared distance from each fish to each blob's sampled mask
    points. fish_x/fish_y: (F,) float32; runs_*: (R,) int32, slot == B
    for padding; step_b: (B,) int32 interior step per blob; count_b:
    (B,) int32 runs per blob. Returns (F, B) float32."""
    R = runs_y.shape[0]
    dev = runs_y.device
    valid = runs_slot < B
    slot = torch.clamp_max(runs_slot, B).long()
    order = torch.arange(R, dtype=_I32, device=dev)
    first = torch.full((B + 1,), I32_MAX, dtype=_I32, device=dev) \
        .scatter_reduce_(0, slot, torch.where(valid, order, 1 << 30),
                         "amin")
    last = torch.full((B + 1,), I32_MIN, dtype=_I32, device=dev) \
        .scatter_reduce_(0, slot, torch.where(valid, order, -1), "amax")
    in_b = torch.clamp_max(slot, B - 1)
    keep = valid & ((runs_y % 2 == 0) | (count_b[in_b] < 4)
                    | (order == first[slot]) | (order == last[slot]))
    st = step_b[in_b]
    wide = keep & (st >= 5) & (runs_x1 - runs_x0 >= 2 * st)
    st_safe = torch.clamp_min(st, 1)
    n_int = torch.where(
        wide, torch.div(runs_x1 - runs_x0 - 2 * st_safe, st_safe,
                        rounding_mode="floor") + 1, 0)

    x0 = runs_x0.to(_F32)[None, :]
    x1 = runs_x1.to(_F32)[None, :]
    y = runs_y.to(_F32)[None, :]
    xm = x0 + (x1 - x0) * 0.5
    stf = st_safe.to(_F32)[None, :]
    fx = fish_x[:, None]
    fy = fish_y[:, None]

    def sq(v):
        return v * v

    dy2 = sq(y - fy)                                   # (F, R)
    best = torch.minimum(sq(x0 - fx), sq(x1 - fx))
    best = torch.minimum(best, sq(xm - fx))
    # the nearest interior sample analytically (+/-1 for rounding)
    k = torch.round((fx - x0 - stf) / stf)
    top = (n_int - 1).to(_F32)[None, :]
    for dk in (-1.0, 0.0, 1.0):
        kk = torch.minimum(torch.clamp_min(k + dk, 0.0), top)
        xi = x0 + stf * (1.0 + kk)
        best = torch.minimum(best, torch.where(n_int[None, :] > 0,
                                               sq(xi - fx), INF))
    d2 = torch.where(keep[None, :], best + dy2, INF)
    F = fish_x.shape[0]
    out = torch.full((F, B + 1), INF, dtype=_F32, device=dev)
    out.scatter_reduce_(1, slot[None, :].expand(F, R), d2, "amin")
    return out[:, :B]


def _clique_labels(edge, F: int, B: int):
    """Min-label propagation over the fish/blob bipartite edge graph.
    Returns (labf (F,), labb (B,)) int32; nodes without edges keep
    their own index as a unique label."""
    dev = edge.device
    big = torch.tensor(1 << 30, dtype=_I32, device=dev)

    def body(st):
        labf, labb = st
        bmin = torch.where(edge, labb[None, :], big).amin(1)
        labf2 = torch.minimum(labf, bmin)
        fmin = torch.where(edge, labf2[:, None], big).amin(0)
        return labf2, torch.minimum(labb, fmin)

    def changed(a, b):
        return (a[0] != b[0]).any() | (a[1] != b[1]).any()

    return _fixed_point_loop(
        body, (torch.arange(F, dtype=_I32, device=dev),
               torch.arange(F, F + B, dtype=_I32, device=dev)), changed)


def _gale_shapley(DM, resolving_f, F: int, B: int):
    """Parallel deferred acceptance over the (F, B) preference matrix DM
    (float32 distances, INF = no edge) among the `resolving_f` fish.
    Returns (owner (B,) int32 or -1, exhausted (F,) bool)."""
    dev = DM.device
    DM = torch.where(resolving_f[:, None], DM, INF)
    has_edge = (DM < INF).any(1)
    fidx = torch.arange(F, device=dev)
    bidx = torch.arange(B, device=dev)

    def body(st):
        popped, owner, owner_d, matched = st
        rem = torch.where(popped, INF, DM)
        best_d = rem.amin(1)
        prop_b = torch.argmin(rem, 1)                # ties: lowest blob
        proposing = ~matched & (best_d < INF)
        pd = torch.where(proposing, best_d, INF)
        prop_of_b = torch.full((B,), INF, dtype=_F32, device=dev) \
            .scatter_reduce_(0, torch.where(proposing, prop_b, B - 1), pd,
                             "amin")
        # the best proposer per blob (ties raise marginal upstream)
        key = torch.where(proposing[:, None]
                          & (prop_b[:, None] == bidx[None, :]),
                          best_d[:, None], INF)
        win_f = torch.argmin(key, 0).to(_I32)
        beats = (prop_of_b < INF) & (prop_of_b < owner_d)
        # displaced owners pop that edge (their next sequential proposal
        # there would be rejected: owner_d only decreases)
        displaced = beats & (owner >= 0)
        rows = torch.clamp(owner, 0, F - 1).long()
        # one (row, blob) pair per blob: no slot is written twice
        popped = popped.clone()
        popped[rows, bidx] = popped[rows, bidx] | displaced
        old_owner = owner
        owner = torch.where(beats, win_f, owner)
        owner_d = torch.where(beats, prop_of_b, owner_d)
        matched = matched & ~((old_owner[None, :] == fidx[:, None])
                              & displaced[None, :]).any(1)
        mine = (owner[None, :] == fidx[:, None]) & beats[None, :]
        matched = matched | mine.any(1)
        won = (mine & (prop_b[:, None] == bidx[None, :])).any(1)
        reject = proposing & ~won
        # one (fish, blob) pair per fish
        cols = torch.clamp_max(prop_b, B - 1)
        popped[fidx, cols] = popped[fidx, cols] | reject
        return popped, owner, owner_d, matched

    def changed(a, b):
        # the loop's own test: did any fish propose in the last round
        rem = torch.where(a[0], INF, DM)
        return (~a[3] & (rem.amin(1) < INF)).any()

    st = (torch.zeros((F, B), dtype=torch.bool, device=dev),
          torch.full((B,), -1, dtype=_I32, device=dev),
          torch.full((B,), INF, dtype=_F32, device=dev),
          torch.zeros(F, dtype=torch.bool, device=dev))
    popped, owner, _, matched = _fixed_point_loop(body, st, changed)
    exhausted = has_edge & ~matched & (popped | (DM >= INF)).all(1)
    return owner, exhausted


def expectation_counts(fish_x, fish_y, fish_valid,
                       runs_y, runs_x0, runs_x1, runs_slot,
                       bx0, by0, bx1, by1, bvalid, max_d, B: int):
    """HistorySplit expectation over one frame's blob table.

    fish_*: (F,) float32 positions and validity (the host's pos_ok set);
    runs_*: (R,) int32 track-mask run tables (slot == B for padding);
    b*: (B,) float32 bounding boxes, bvalid bool; max_d float32 0-d.
    Returns (expect (B,) int32, marginal 0-d bool): expect >= 2 marks a
    blob the host would split into that many pieces; `marginal` means a
    decision was within EPS of flipping."""
    F = fish_x.shape[0]
    dev = fish_x.device
    fx = fish_x[:, None]
    fy = fish_y[:, None]
    dx = torch.clamp_min(torch.maximum(bx0[None, :] - fx,
                                       fx - bx1[None, :]), 0.0)
    dy = torch.clamp_min(torch.maximum(by0[None, :] - fy,
                                       fy - by1[None, :]), 0.0)
    bbd = _hypot(dx, dy)
    ok = fish_valid[:, None] & bvalid[None, :]
    near = ok & (bbd <= max_d)
    marginal = (ok & ((bbd - max_d).abs() <= EPS_D)).any()

    contested = near.sum(0) >= 2
    involved = (near & contested[None, :]).any(1)
    any_contested = contested.any()

    # floor(max(1, width * 0.1)) equals max(1, width // 10) for every
    # integer width, so the step is exact
    width_i = (bx1 - bx0).to(_I32) + 1
    step_b = torch.clamp_min(torch.div(width_i, 10, rounding_mode="floor"),
                             1)
    valid_run = runs_slot < B
    count_b = torch.zeros(B + 1, dtype=_I32, device=dev).scatter_add_(
        0, torch.clamp_max(runs_slot, B).long(), valid_run.to(_I32))[:B]
    md2 = _run_sample_min_d2(fish_x, fish_y, runs_y, runs_x0, runs_x1,
                             runs_slot, step_b, count_b, B)
    md = torch.sqrt(md2)
    edge = near & involved[:, None] & (md <= max_d)
    marginal = marginal | (near & involved[:, None]
                           & ((md - max_d).abs() <= EPS_D)).any()

    labf, labb = _clique_labels(edge, F, B)
    f_in = edge.any(1)
    b_in = edge.any(0)
    nf_of_f = ((labf[:, None] == labf[None, :]) & f_in[None, :]).sum(1)
    nb_of_f = ((labf[:, None] == labb[None, :]) & b_in[None, :]).sum(1)
    resolving_f = f_in & (nf_of_f > nb_of_f)

    # distance ties within a resolving clique make the host queue's order
    # observable: sort the (clique, distance) pairs and compare neighbours
    rez_edge = edge & resolving_f[:, None]
    keys = torch.where(rez_edge, labf[:, None].expand(F, B), 1 << 30) \
        .reshape(-1)
    dist = torch.where(rez_edge, md, INF).reshape(-1)
    o = torch.argsort(dist, stable=True)
    o = o[torch.argsort(keys[o], stable=True)]
    sk, sd = keys[o], dist[o]
    tie = (sk[1:] == sk[:-1]) & (sk[1:] < (1 << 30)) \
        & ((sd[1:] - sd[:-1]).abs() <= EPS_D)
    marginal = marginal | tie.any()

    DM = torch.where(edge, md, INF)
    owner, exhausted = _gale_shapley(DM, resolving_f, F, B)
    orig_best = torch.argmin(DM, 1)                    # ties: lowest blob
    cnt = torch.zeros(B + 1, dtype=_I32, device=dev).scatter_add_(
        0, torch.where(exhausted, orig_best, B), exhausted.to(_I32))[:B]
    expect = cnt + ((cnt > 0) & (owner >= 0)).to(_I32)
    expect = torch.where(any_contested, expect, 0)
    # defer only where the EPS-widened near sets contest some blob: the
    # host's near set is a subset of them
    near_eps = ok & (bbd <= max_d + EPS_D)
    marginal = marginal & (near_eps.sum(0) >= 2).any()
    return expect, marginal


# ---------------------------------------------------------------------------
# split execution (native trex_split_execute, SplitBlob.cpp semantics)
# ---------------------------------------------------------------------------

class SplitSpec(NamedTuple):
    """Static configuration of the split executor (the arguments the
    host engine gives trex_split_execute, and the crop capacities)."""
    initial: int            # _initial_threshold(settings)
    absolute: bool          # track_threshold_is_absolute
    cm_sqr: float
    max_shrink: float       # blob_split_max_shrink
    shrink_limit: float     # blob_split_global_shrink_limit
    ranges: tuple           # track_size_filter ((lo, hi), ...)
    enabled: bool = True    # blob_split_algorithm != "none"
    crop_h: int = 64
    crop_w: int = 64
    max_runs: int = 256     # runs per crop at one threshold
    max_pieces: int = 8     # kept pieces per split blob
    max_splits: int = 8     # split blobs handled per frame


def spec_from_settings(s, **caps) -> SplitSpec:
    from ..config import SettingsView
    from ..track.splitting import _initial_threshold

    s = SettingsView(s)
    cm = float(s["cm_per_pixel"] or 1.0)
    ranges = tuple(tuple(float(v) for v in r)
                   for r in (s["track_size_filter"] or []))
    return SplitSpec(
        initial=_initial_threshold(s),
        absolute=bool(s["track_threshold_is_absolute"]),
        cm_sqr=cm * cm,
        max_shrink=float(s["blob_split_max_shrink"]),
        shrink_limit=float(s["blob_split_global_shrink_limit"]),
        ranges=ranges,
        enabled=s["blob_split_algorithm"] != "none",
        **caps)


def _cc_run_labels(ry, rx0, rx1, valid, R: int):
    """Component labels (least run index) over (L, R) run tables by
    pairwise 8-connectivity and min propagation with path halving.
    Returns (L, R) int32, R for invalid runs."""
    L = ry.shape[0]
    dev = ry.device
    adj = (valid[:, :, None] & valid[:, None, :]
           & ((ry[:, :, None] - ry[:, None, :]).abs() == 1)
           & (rx0[:, :, None] <= rx1[:, None, :] + 1)
           & (rx0[:, None, :] <= rx1[:, :, None] + 1))
    init = torch.where(valid, torch.arange(R, dtype=_I32, device=dev), R)
    pad = torch.full((L, 1), R, dtype=_I32, device=dev)

    def body(Lp):
        neigh = torch.where(adj, Lp[:, None, :R], R).amin(2)
        new = torch.cat([torch.minimum(Lp[:, :R], neigh), pad], 1)
        new = torch.gather(new, 1, new.long())
        return torch.gather(new, 1, new.long())

    out = _fixed_point_loop(body, torch.cat([init, pad], 1),
                            lambda a, b: (a != b).any())
    return out[:, :R]


def _crop_window(frame, background, bi, bx0i, by0i,
                 runs_y, runs_x0, runs_x1, runs_slot,
                 crop_h: int, crop_w: int):
    """Per lane, the (crop_h, crop_w) image and background windows at
    origin bbox - 1 (to_dense(pad=1)) and blob `bi`'s runs painted into
    an in-run mask (start/stop scatter + cumsum). bi, bx0i, by0i: (L,)."""
    H, W = frame.shape
    dev = frame.device
    ox = (bx0i - 1).to(_I32)
    oy = (by0i - 1).to(_I32)
    gy = oy[:, None] + torch.arange(crop_h, dtype=_I32, device=dev)[None]
    gx = ox[:, None] + torch.arange(crop_w, dtype=_I32, device=dev)[None]
    inb = ((gy >= 0) & (gy < H))[:, :, None] \
        & ((gx >= 0) & (gx < W))[:, None, :]
    gyc = gy.clamp(0, H - 1).long()[:, :, None]
    gxc = gx.clamp(0, W - 1).long()[:, None, :]
    img = torch.where(inb, frame[gyc, gxc].to(_I32), 0)
    bgc = torch.where(inb, background[gyc, gxc].to(_I32), 0)

    mine = runs_slot[None, :] == bi[:, None]               # (L, R)
    row = torch.where(mine, runs_y[None, :] - oy[:, None], crop_h) \
        .clamp(0, crop_h)                  # foreign or padded runs: dump
    c0 = torch.where(mine, runs_x0[None, :] - ox[:, None], crop_w) \
        .clamp(0, crop_w)
    c1 = torch.where(mine, runs_x1[None, :] - ox[:, None] + 1, crop_w) \
        .clamp(0, crop_w)
    L = bi.shape[0]
    lane = torch.arange(L, device=dev)[:, None].expand_as(row)
    acc = torch.zeros((L, crop_h + 1, crop_w + 1), dtype=_I32, device=dev)
    # integer adds commute: repeated slots sum the same in any order
    acc.index_put_((lane, row.long(), c0.long()),
                   torch.ones_like(row), accumulate=True)
    acc.index_put_((lane, row.long(), c1.long()),
                   -torch.ones_like(row), accumulate=True)
    in_run = torch.cumsum(acc[:, :crop_h, :crop_w], 2) > 0
    return img, bgc, in_run, ox, oy


def _crop_diff(frame, background, bi, bx0i, by0i,
               runs_y, runs_x0, runs_x1, runs_slot, spec: SplitSpec):
    """Masked difference crops for the escalation scan (trex_split_
    execute's image/background/diff build, origin bbox - 1)."""
    img, bgc, in_run, ox, oy = _crop_window(
        frame, background, bi, bx0i, by0i, runs_y, runs_x0, runs_x1,
        runs_slot, spec.crop_h, spec.crop_w)
    imgm = torch.where(in_run, img, bgc)
    if spec.absolute:
        diff = torch.where(imgm != 0, (imgm - bgc).abs(), 0)
    else:
        d = bgc - imgm
        diff = torch.where((imgm != 0) & (d > 0), d, 0)
    return diff, ox, oy


def _int_ge(bound: float, cm_sqr: float) -> int:
    """Least integer n with n * cm_sqr >= bound in float64 (the host's
    double): integer pixel counts then compare exactly."""
    if bound <= 0:
        return 0
    if math.isinf(bound):
        return 1 << 60
    n = max(0, int(math.floor(bound / cm_sqr)) - 2)
    while n * cm_sqr < bound:
        n += 1
    return n


def _int_le(bound: float, cm_sqr: float) -> int:
    """Largest integer n with n * cm_sqr <= bound in float64; -1 when
    none."""
    if bound < 0:
        return -1
    if math.isinf(bound):
        return 1 << 60
    n = max(0, int(math.floor(bound / cm_sqr)) + 2)
    while n > 0 and n * cm_sqr > bound:
        n -= 1
    if n == 0 and 0 * cm_sqr > bound:
        return -1
    return n


def _size_bounds(spec: SplitSpec):
    """Integer decision bounds of the escalation scan: (per-range
    (n_lo, n_hi) pairs, n_min_thresh or None without ranges, n_max_hi)."""
    if not spec.ranges:
        return (), None, 1 << 60
    bounds = tuple((_int_ge(lo, spec.cm_sqr), _int_le(hi, spec.cm_sqr))
                   for lo, hi in spec.ranges)
    max_lo, max_hi = spec.ranges[0]
    for lo, hi in spec.ranges:
        if hi > max_hi:
            max_lo, max_hi = lo, hi
    return (bounds, _int_ge(max_lo * spec.shrink_limit, spec.cm_sqr),
            _int_le(max_hi, spec.cm_sqr))


def _in_any_range(n, spec: SplitSpec):
    """Range membership of integer piece sizes (exact)."""
    if not spec.ranges:
        return torch.ones(n.shape, dtype=torch.bool, device=n.device)
    bounds, _, _ = _size_bounds(spec)
    out = torch.zeros(n.shape, dtype=torch.bool, device=n.device)
    for n_lo, n_hi in bounds:
        out = out | ((n >= min(n_lo, I32_MAX)) & (n <= min(n_hi, I32_MAX)))
    return out


def split_execute_device(frame, background, bi, bx0i, by0i,
                         runs_y, runs_x0, runs_x1, runs_slot,
                         expected, spec: SplitSpec):
    """Split of blob `bi` (native trex_split_execute): masked difference
    crop, threshold escalation until the evaluation keeps or aborts
    (trex_split_scan), then the winning components.

    frame/background: (H, W) uint8; bi, bx0i, by0i, expected: int32
    scalars or (L,) lanes of split targets; runs_*: (R,) the frame's
    track-mask runs. Returns (rows (max_pieces, 7) float32 [n, x0, y0,
    x1, y1, sum_x, sum_y] in frame coordinates, size-descending; n_out
    int32; marginal bool), each with the lane dimension when the targets
    have one. `marginal`: a size decision within EPS of flipping, or a
    crop, run or piece capacity overflow."""
    lanes = torch.as_tensor(bi).dim() == 1
    dev = frame.device

    def lane_vec(v):
        return torch.as_tensor(v, device=dev).to(_I32).reshape(-1)

    bi, bx0i, by0i, expected = (lane_vec(v) for v in
                                (bi, bx0i, by0i, expected))
    L = bi.shape[0]
    R = spec.max_runs
    diff, ox, oy = _crop_diff(frame, background, bi, bx0i, by0i, runs_y,
                              runs_x0, runs_x1, runs_slot, spec)
    _, n_min_static, n_hi_static = _size_bounds(spec)
    if spec.ranges:
        # int32 counts against bounds that may be 2^60 for infinite ones
        n_min_static = min(n_min_static, I32_MAX)
        n_hi_static = min(n_hi_static, I32_MAX)
    ar = torch.arange(R, device=dev)

    def rel(a, b):
        return (a - b).abs() <= EPS_S * torch.clamp_min(
            torch.maximum(a.abs(), b.abs()), 1.0)

    def decide(sizes_desc, total, n_first):
        """Keep/abort at one threshold per lane (shared by the scan and
        the re-evaluation on the materialised pieces). Range and shrink
        tests compare integer counts with static float64-derived bounds,
        exactly; only the dynamic bounds carry a marginality guard."""
        total_cm = total.to(_F32) * spec.cm_sqr
        fs = n_first.to(_F32) * spec.cm_sqr
        abort = total_cm < spec.max_shrink * fs
        marg = rel(total_cm, spec.max_shrink * fs) & (n_first > 0)
        nonzero = sizes_desc > 0
        if spec.ranges:
            kept = (nonzero & (sizes_desc >= n_min_static)).sum(1)
        else:
            scm = sizes_desc.to(_F32) * spec.cm_sqr
            thrf = total_cm * spec.max_shrink
            kept = (nonzero & (scm >= thrf[:, None])).sum(1)
            marg = marg | (nonzero & rel(scm, thrf[:, None])).any(1)
        take = torch.minimum(kept, expected)
        top = ar[None, :] < take[:, None]
        valid_cnt = (top & _in_any_range(sizes_desc, spec)).sum(1)
        min_n = torch.where(
            take > 0, torch.gather(sizes_desc, 1, torch.clamp_min(
                take - 1, 0)[:, None].long())[:, 0], 0)
        if spec.ranges:
            remove = (take > 0) & (min_n > n_hi_static)
        else:
            remove = torch.zeros_like(take, dtype=torch.bool)
        keep = ~remove & (valid_cnt >= expected)
        return keep, abort, kept, marg

    zi = torch.zeros((L, R), dtype=_I32, device=dev)
    thr = torch.full((L,), max(1, spec.initial), dtype=_I32, device=dev)
    best = torch.full((L,), -1, dtype=_I32, device=dev)
    n_first = torch.zeros(L, dtype=_I32, device=dev)
    marginal = torch.zeros(L, dtype=torch.bool, device=dev)
    done = torch.zeros(L, dtype=torch.bool, device=dev)
    tables = (zi, zi, zi, torch.zeros((L, R), dtype=torch.bool,
                                      device=dev), zi)
    while not bool(done.all()):
        mask = diff >= thr[:, None, None]
        rt = _run_tables(mask, R)
        valid = rt["y"] >= 0
        ry, rx0, rx1 = rt["y"], rt["x0"], rt["x1"]
        labels = _cc_run_labels(ry, rx0, rx1, valid, R)
        length = torch.where(valid, rx1 - rx0 + 1, 0)
        sizes = _seg(length, torch.where(valid, labels, R), R + 1,
                     "sum")[:, :R]
        sizes_desc = -torch.sort(-sizes, 1).values
        total = length.sum(1)
        nf = torch.where(thr == spec.initial, sizes_desc[:, 0], n_first)
        keep, abort, _, m2 = decide(sizes_desc, total, nf)
        # the mask is constant for thresholds up to the least value
        # present, so the native per-1 escalation decides identically
        # there: jump to the next threshold that changes the mask
        min_in = torch.where(diff >= thr[:, None, None], diff, 256) \
            .amin((1, 2))
        nxt = (min_in + 1).to(_I32)
        live = ~done
        n_first = torch.where(live, nf, n_first)
        marginal = torch.where(live, marginal | rt["overflow"] | m2,
                               marginal)
        best = torch.where(live, torch.where(keep, thr, -1), best)
        thr = torch.where(live, nxt, thr)
        new = (ry, rx0, rx1, valid, labels)
        tables = tuple(torch.where(live[:, None], a, b)
                       for a, b in zip(new, tables))
        done = done | keep | abort | (nxt > 255) | (total == 0)
    ry, rx0, rx1, valid, labels = tables

    # pieces at the winning threshold from its tables, in size-descending
    # order, stable on the root's run index (the native stable_sort over
    # creation order)
    ilen = torch.where(valid, rx1 - rx0 + 1, 0)
    length = ilen.to(_F32)
    seg = torch.where(valid, labels, R)
    n_root = _seg(ilen, seg, R + 1, "sum")[:, :R]
    # float32 sums of half-integers times integers below 2^24: exact in
    # any order
    sx_root = _seg((rx0 + rx1).to(_F32) * 0.5 * length, seg, R + 1,
                   "sum")[:, :R]
    sy_root = _seg(ry.to(_F32) * length, seg, R + 1, "sum")[:, :R]
    x0_root = _seg(torch.where(valid, rx0, 1 << 30), seg, R + 1,
                   "amin")[:, :R]
    y0_root = _seg(torch.where(valid, ry, 1 << 30), seg, R + 1,
                   "amin")[:, :R]
    x1_root = _seg(torch.where(valid, rx1, -1), seg, R + 1, "amax")[:, :R]
    y1_root = _seg(torch.where(valid, ry, -1), seg, R + 1, "amax")[:, :R]
    key = torch.where(n_root > 0, -n_root, 1)
    order = torch.argsort(key, dim=1, stable=True)
    n_o = torch.gather(n_root, 1, order)
    # the re-evaluation on the materialised pieces sees the winning
    # iteration's arrays, so it cannot flip; it gives the kept prefix
    keep2, abort2, kept, _ = decide(n_o, n_o.sum(1), n_first)
    ok = (best >= 0) & keep2 & ~abort2
    n_out = torch.where(ok, torch.clamp_max(kept, spec.max_pieces), 0)
    marginal = marginal | (ok & (kept > spec.max_pieces))

    MP = spec.max_pieces
    sel = order[:, :MP]
    n_of = n_o[:, :MP].to(_F32)
    oxf = ox.to(_F32)[:, None]
    oyf = oy.to(_F32)[:, None]

    def pick(t):
        return torch.gather(t, 1, sel)

    rows = torch.stack([
        n_of,
        pick(x0_root).to(_F32) + oxf,
        pick(y0_root).to(_F32) + oyf,
        pick(x1_root).to(_F32) + oxf,
        pick(y1_root).to(_F32) + oyf,
        pick(sx_root) + n_of * oxf,
        pick(sy_root) + n_of * oyf], 2)
    live = torch.arange(MP, device=dev)[None, :] < n_out[:, None]
    rows = torch.where(live[:, :, None], rows, 0.0)
    n_out = n_out.to(_I32)
    if not lanes:
        return rows[0], n_out[0], marginal[0]
    return rows, n_out, marginal
