"""Posture on the host: the native batch chain and the per-blob chain.

Counterpart of ``trex_tpu/track/posture.py`` (reference
tracking/Posture.cpp:305-410, tracking/Outline.cpp):

1. threshold the blob at track_posture_threshold, keep the biggest
   component (commons pixel::threshold_get_biggest_blob);
2. trace the outer boundary (a Moore trace over the dense mask,
   supersampled 4x);
3. resample to `outline_resample` spacing (Outline.cpp:724-767);
4. smooth with triangular weights (Outline.cpp:380-436);
5. with outline_approximate > 0, the outline's elliptic Fourier
   reconstruction (Outline.cpp:499-513);
6. curvature peaks: the tail is the strongest, the head the peak
   circularly farthest from it (Outline.cpp:515-700);
7. the midline walk pairs left and right outline points from the tail
   (Outline.cpp:768-866);
8. post-processing: orientation toward the previous movement and the
   stiff front part straightened (Outline.cpp:890-1010), then the
   midline normalised to `midline_resolution` points.

``posture_batch`` runs the whole chain for a frame's blobs in one call
of ``trex_posture_batch`` (the port's copy of
``native/posture_chain.cpp``), ``posture_batch_full`` with the full
geometry the archives keep (``trex_posture_batch_full``). The per-blob
chain ``calculate_posture`` takes the rows the batch truncates or fails;
its steps run natively (``trex_trace_boundary``,
``trex_outline_resample``, ``trex_midline_walk``, and steps 4-8 in
``trex_midline_chain``), and with ``_force_python_chain`` (or
``peak_mode`` broad) steps 4-8 run in numpy, the ``_py`` functions being
the numpy twins of the native steps.

Posture from pose keypoints (``calculate_posture_from_pose``: circles
along the skeleton, filled as OpenCV fills them, traced) and from a
detection's outline (``calculate_posture_from_outline``) feed the same
midline chain. ``posture_closing_steps``
(the mask closed before the biggest component is kept) runs in the
per-blob chain, which the object Tracker takes; the batch chains refuse
it, as the JAX package's do.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..config import SettingsView
from ..ops.labeling import (_c, _f32p, _f64p, _i32p, _i64p, _lib,
                             label_blobs)
from ..utils.imgproc import rect_extreme
from .blob import TrackBlob

# the differential tests set this to run steps 4-8 in numpy
_force_python_chain = False


def _get_native_posture():
    """The port's host library with the posture chain bound (``ctypes``
    signatures in ``ops/labeling.py``); raises when it cannot be built."""
    return _lib()


def trace_boundary(mask: np.ndarray) -> np.ndarray:
    """Moore boundary trace (8-connectivity, clockwise) over a binary
    mask in the native ``trex_trace_boundary``; returns (N, 2) float32
    [x, y] pixel-centre points. ``_trace_boundary_py`` is its numpy
    twin."""
    fn = _lib().trex_trace_boundary
    mask = np.ascontiguousarray((mask > 0).astype(np.uint8))
    h, w = mask.shape
    cap = 8 * (h + w) + 64
    out = np.empty((cap, 2), np.float32)
    n = fn(mask.ctypes.data_as(_c), w, h, out.ctypes.data_as(_f32p), cap)
    if n >= cap:  # an extremely convoluted boundary: the full capacity
        cap = 8 * h * w + 8
        out = np.empty((cap, 2), np.float32)
        n = fn(mask.ctypes.data_as(_c), w, h, out.ctypes.data_as(_f32p),
               cap)
    return out[:n].copy()


def _trace_boundary_py(mask: np.ndarray) -> np.ndarray:
    """Pure-Python Moore trace (reference implementation)."""
    h, w = mask.shape
    padded = np.zeros((h + 2, w + 2), np.uint8)
    padded[1:-1, 1:-1] = mask > 0
    ys, xs = np.nonzero(padded)
    if len(ys) == 0:
        return np.zeros((0, 2), np.float32)
    # start: topmost-leftmost pixel
    start = (ys[0], xs[0])
    boundary = [start]
    # previous direction: entered from the left
    prev_dir = 6  # pointing left->right scan: backtrack cell is to the left
    cur = start
    # Moore neighbor order clockwise starting from backtrack
    order = [(0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1)]
    # direction index of the cell we came FROM relative to current
    back = 0
    closed = False
    for _ in range(8 * len(ys) + 8):
        found = False
        for k in range(8):
            d = (back + 1 + k) % 8
            ny, nx = cur[0] + order[d][0], cur[1] + order[d][1]
            if padded[ny, nx]:
                boundary.append((ny, nx))
                # new backtrack: direction pointing from new cell to cur
                back = (d + 4) % 8
                # rotate so scanning starts just after the backtrack
                cur = (ny, nx)
                found = True
                break
        if not found:
            break  # isolated pixel
        if cur == start and len(boundary) > 2:
            closed = True
            break
    if closed:
        boundary = boundary[:-1]  # drop the duplicated start point
    pts = np.array([(x - 1, y - 1) for (y, x) in boundary], np.float32)
    return pts


def close_mask(m: np.ndarray, steps: int, size: int) -> np.ndarray:
    """``cv2.erode(cv2.dilate(m, k, iterations=steps), k,
    iterations=steps)`` with ``k = np.ones((size, size))``, bit for bit,
    without OpenCV: the kernel's anchor is its centre (``size // 2``),
    pixels outside the crop are neutral (dilation never grows in from
    outside, erosion never eats in from the edge), and `steps` passes of
    a full rectangle are one rectangle of ``steps * (size - 1) + 1`` with
    its anchor at ``steps * (size // 2)``, as OpenCV folds them. An empty
    kernel (size 0) is OpenCV's default 3 x 3."""
    if steps <= 0:
        return m
    size = int(size) if size > 0 else 3
    anchor = size // 2
    lo, hi = -steps * anchor, steps * (size - 1 - anchor)
    m = rect_extreme(np.asarray(m, np.uint8), lo, hi, True)
    return rect_extreme(m, lo, hi, False)


def biggest_component(blob: TrackBlob, threshold: int,
                      background: Optional[np.ndarray], settings,
                      closing_steps: int = 0, closing_size: int = 2):
    """threshold_get_biggest_blob: mask of the largest component of the
    blob's pixels after the posture threshold."""
    mask, gray, (ox, oy) = blob.to_dense(pad=1)
    if background is not None and threshold > 0:
        bg = np.zeros_like(gray)
        bh, bw = background.shape[:2]
        ys0, ys1 = max(0, oy), min(bh, oy + gray.shape[0])
        xs0, xs1 = max(0, ox), min(bw, ox + gray.shape[1])
        bg[ys0 - oy : ys1 - oy, xs0 - ox : xs1 - ox] = background[ys0:ys1, xs0:xs1]
        absolute = bool(settings["track_threshold_is_absolute"])
        if absolute:
            keep = (np.abs(gray.astype(np.int16) - bg.astype(np.int16))
                    >= threshold) & (mask > 0)
        else:
            keep = ((bg.astype(np.int16) - gray.astype(np.int16))
                    >= threshold) & (mask > 0)
    else:
        keep = mask > 0
    m = keep.astype(np.uint8)
    if closing_steps > 0:
        # dilate xN then erode xN (the reference's closing; repeated
        # MORPH_CLOSE is near-idempotent and cannot bridge wider gaps
        # or shed extremities as the parameter doc describes)
        m = close_mask(m, closing_steps, closing_size)
    comps = label_blobs(m * 255)
    if not comps:
        return None, (ox, oy)
    big = max(comps, key=lambda c: c.num_pixels)
    dense = np.zeros_like(m)
    for y, x0, x1 in big.lines:
        dense[y, x0 : x1 + 1] = 1
    return dense, (ox, oy)


def resample(points: np.ndarray, distance: float) -> np.ndarray:
    """Outline::resample in the native ``trex_outline_resample``: walk the
    closed polygon, emitting a point every `distance` pixels along it;
    the emitted set replaces the outline even when smaller
    (Outline.cpp:726-766). ``_resample_py`` is its numpy twin."""
    if distance <= 0 or len(points) <= 1:
        return points
    pts = np.ascontiguousarray(points, np.float32)
    cap = 8 * len(pts) + 16
    buf = np.empty((cap, 2), np.float32)
    n = _lib().trex_outline_resample(pts.ctypes.data_as(_f32p), len(pts),
                                     float(distance),
                                     buf.ctypes.data_as(_f32p), cap)
    return buf[:n].copy()


def _midline_walk(points: np.ndarray, max_offset: int) -> np.ndarray:
    """The pairing walk in the native ``trex_midline_walk``; returns (M,
    3) rows [mid_x, mid_y, height]. ``_midline_walk_py`` is its numpy
    twin."""
    points = np.ascontiguousarray(points, np.float32)
    L = len(points)
    buf = np.empty((L + 4, 3), np.float32)
    n = _lib().trex_midline_walk(points.ctypes.data_as(_f32p), L,
                                 int(max_offset), buf.ctypes.data_as(_f32p),
                                 len(buf))
    return buf[:n].copy()


def _midline_walk_py(points: np.ndarray, max_offset: int) -> np.ndarray:
    L = len(points)
    px = points[:, 0]
    py = points[:, 1]
    segments = []
    idx_r, idx_l = 1, -1
    guard = 0
    while idx_r < L + idx_l and guard < 4 * L:
        guard += 1
        pt_l = points[(L + idx_l) % L]
        # find best right point (vectorized candidate window)
        hi = min(L, idx_r + max_offset)
        if hi > idx_r:
            dd = np.hypot(px[idx_r:hi] - pt_l[0], py[idx_r:hi] - pt_l[1])
            idx_r = idx_r + int(np.argmin(dd))
        pt_r = points[idx_r]
        # find best left point
        lo = max(-L + 1, idx_l - max_offset + 1)
        cand = np.arange(idx_l, lo - 1, -1) % L
        if len(cand):
            dd = np.hypot(px[cand] - pt_r[0], py[cand] - pt_r[1])
            idx_l = idx_l - int(np.argmin(dd))
        pt_l = points[(L + idx_l) % L]
        m = (pt_l + pt_r) * 0.5
        segments.append((float(m[0]), float(m[1]),
                         float(np.hypot(*(pt_r - pt_l)))))
        idx_r += 1
        idx_l -= 1
    return np.asarray(segments, np.float32).reshape(-1, 3)


def _resample_py(points: np.ndarray, distance: float) -> np.ndarray:
    if distance <= 0 or len(points) <= 1:
        return points
    out = []
    walked = 0.0
    L = len(points)
    for i in range(L):
        p0 = points[i]
        p1 = points[(i + 1) % L]
        line = p1 - p0
        seg = float(np.hypot(line[0], line[1]))
        walked += seg
        percent = seg / distance
        walked_percent = walked / distance
        offset = 0
        while walked_percent >= 1.0:
            t = (offset * 1.0 / percent) if percent > 0 else 0.0
            out.append(p0 + line * t)
            offset += 1
            walked -= distance
            walked_percent -= 1.0
    return np.asarray(out, np.float32).reshape(-1, 2)


def smooth_points(points: np.ndarray, samples: float, step: int) -> np.ndarray:
    """Triangular-weighted periodic smoothing (Outline.cpp:380-436)."""
    L = len(points)
    if L <= samples or samples <= 0:
        return points
    step_row = int(samples * step)
    if step_row < 1:  # 0 < samples*step < 1 would divide by zero
        return points
    offs = np.arange(-step_row, step_row + 1, step)
    weights = (step_row - np.abs(offs)) / step_row
    weights = weights / weights.sum()
    idx = (np.arange(L)[:, None] + offs[None, :]) % L
    return (points[idx] * weights[None, :, None]).sum(axis=1).astype(np.float32)


def eft(points: np.ndarray, harmonics: int) -> tuple:
    """Elliptic Fourier coefficients (Kuhl & Giardina) of a closed contour."""
    d = np.diff(np.vstack([points, points[:1]]), axis=0)
    dt = np.hypot(d[:, 0], d[:, 1])
    dt = np.where(dt == 0, 1e-12, dt)
    t = np.concatenate([[0.0], np.cumsum(dt)])
    T = t[-1]
    n = np.arange(1, harmonics + 1)[:, None]
    phi = 2 * np.pi * n * t[None, :] / T  # (H, N+1)
    dcos = np.cos(phi[:, 1:]) - np.cos(phi[:, :-1])
    dsin = np.sin(phi[:, 1:]) - np.sin(phi[:, :-1])
    c = T / (2 * (n[:, 0] ** 2) * np.pi ** 2)
    a = c * np.sum(d[:, 0] / dt * dcos, axis=1)
    b = c * np.sum(d[:, 0] / dt * dsin, axis=1)
    cc = c * np.sum(d[:, 1] / dt * dcos, axis=1)
    dd = c * np.sum(d[:, 1] / dt * dsin, axis=1)
    return a, b, cc, dd, T


def ieft(coeffs, n_points: int, center: np.ndarray) -> np.ndarray:
    """Reconstruct `n_points` uniformly-spaced points from EFT coeffs."""
    a, b, c, d, T = coeffs
    t = np.linspace(0, T, n_points, endpoint=False)
    n = np.arange(1, len(a) + 1)[:, None]
    phi = 2 * np.pi * n * t[None, :] / T
    x = center[0] + (a[:, None] * np.cos(phi) + b[:, None] * np.sin(phi)).sum(0)
    y = center[1] + (c[:, None] * np.cos(phi) + d[:, None] * np.sin(phi)).sum(0)
    return np.stack([x, y], axis=1).astype(np.float32)


def signed_area(points: np.ndarray) -> float:
    x, y = points[:, 0], points[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def periodic_curvature(points: np.ndarray, rng: int) -> np.ndarray:
    """Discrete curvature over a periodic point array with offset `rng`:
    2*cross(p2-p1, p3-p2) / sqrt(|p1p2||p2p3||p1p3|) — the circumcircle
    (Menger) form used by the reference's commons periodic::curvature."""
    p1 = np.roll(points, rng, axis=0)
    p2 = points
    p3 = np.roll(points, -rng, axis=0)
    a = p2 - p1
    b = p3 - p2
    cross = a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]
    d12 = np.hypot(*(p2 - p1).T)
    d23 = np.hypot(*(p3 - p2).T)
    d13 = np.hypot(*(p3 - p1).T)
    denom = np.sqrt(np.maximum(d12 * d23 * d13, 1e-12))
    return 2.0 * cross / denom


def find_peak_indices(curv: np.ndarray) -> list[int]:
    """Local maxima of a periodic series."""
    left = np.roll(curv, 1)
    right = np.roll(curv, -1)
    peaks = np.flatnonzero((curv >= left) & (curv > right))
    return peaks.tolist()


def peak_half_width(curv: np.ndarray, idx: int) -> int:
    """Width of the curvature peak at `idx`: how many contiguous
    points around it stay above half the peak value (the `broadest =
    peak.range.length()` measure of Outline.cpp:683 for
    peak_mode=broad)."""
    n = len(curv)
    half = curv[idx] * 0.5
    w = 1
    k = idx
    for _ in range(n - 1):
        k = (k - 1) % n
        if curv[k] < half or k == idx:
            break
        w += 1
    k = idx
    for _ in range(n - 1):
        k = (k + 1) % n
        if curv[k] < half or k == idx:
            break
        w += 1
    return w


@dataclass
class Midline:
    segments: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    heights: np.ndarray = field(default_factory=lambda: np.zeros(0))
    tail_index: int = 0
    head_index: int = -1
    len: float = 0.0
    angle: float = 0.0
    inverted_because_previous: bool = False
    offset: tuple = (0.0, 0.0)

    @property
    def empty(self):
        return len(self.segments) == 0

    def midline_direction(self, stiff_percentage: float) -> np.ndarray:
        n = max(1, int(len(self.segments) * stiff_percentage))
        d = np.zeros(2)
        cnt = 0
        for i in range(n):
            if i + 1 >= len(self.segments):
                break
            d += self.segments[i + 1] - self.segments[i]
            cnt += 1
        if cnt:
            d /= cnt
            norm = np.hypot(*d)
            if norm > 0:
                d /= norm
        return d

    def normalize_points(self, resolution: int) -> np.ndarray:
        """Resample to `resolution` points evenly spaced along the
        midline (Midline::normalize, Outline.cpp:1270-1330)."""
        segs = self.segments
        if len(segs) < 2:
            return segs
        d = np.hypot(*np.diff(segs, axis=0).T)
        total = float(d.sum())
        if total == 0:
            return segs
        t = np.concatenate([[0], np.cumsum(d)])
        want = np.linspace(0, total, resolution)
        x = np.interp(want, t, segs[:, 0])
        y = np.interp(want, t, segs[:, 1])
        return np.stack([x, y], axis=1)


@dataclass
class PostureResult:
    outline: np.ndarray  # (N, 2) in blob-local coordinates
    midline: Optional[Midline]
    offset: tuple  # blob-local -> image coordinates


def _midline_chain_native(points, s, movement_direction):
    fn = _lib().trex_midline_chain
    pts = np.ascontiguousarray(points, np.float32)
    L = len(pts)
    cap = 4 * L + 16
    segs = np.empty((cap, 2), np.float64)
    heights = np.empty(cap, np.float64)
    nseg = ctypes.c_int64(0)
    tail = ctypes.c_int32(0)
    head = ctypes.c_int32(0)
    mlen = ctypes.c_double(0.0)
    angle = ctypes.c_double(0.0)
    inverted = ctypes.c_int32(0)
    mv = None
    if movement_direction is not None:
        mv_arr = np.ascontiguousarray(movement_direction, np.float64)
        if np.any(mv_arr != 0):
            mv = mv_arr.ctypes.data_as(_f64p)
    rc = fn(
        pts.ctypes.data_as(_f32p),
        ctypes.c_int64(L),
        ctypes.c_double(float(s["outline_smooth_samples"])),
        ctypes.c_int32(max(1, int(s["outline_smooth_step"]))),
        ctypes.c_int32(int(s["outline_approximate"])),
        ctypes.c_double(float(s["outline_curvature_range_ratio"])),
        ctypes.c_int32(1 if s["midline_invert"] else 0),
        ctypes.c_double(float(s["midline_walk_offset"])),
        ctypes.c_double(float(s["midline_stiff_percentage"])),
        ctypes.c_int32(1 if s["midline_start_with_head"] else 0),
        ctypes.c_int32(int(s["midline_resolution"])),
        mv,
        segs.ctypes.data_as(_f64p), heights.ctypes.data_as(_f64p),
        ctypes.c_int64(cap),
        ctypes.byref(nseg), ctypes.byref(tail), ctypes.byref(head),
        ctypes.byref(mlen), ctypes.byref(angle), ctypes.byref(inverted))
    if rc > 0:
        return None
    if rc < 0:  # capacity overflow: the python path handles it
        raise OverflowError("native midline chain overflow")
    m = nseg.value
    return Midline(segments=segs[:m].copy(), heights=heights[:m].copy(),
                   tail_index=tail.value, head_index=head.value,
                   len=mlen.value, angle=angle.value,
                   inverted_because_previous=bool(inverted.value))


def calculate_midline_from_outline(points: np.ndarray, settings,
                                   movement_direction=None) -> Optional[Midline]:
    s = settings
    L0 = len(points)
    if L0 < 3:
        return None
    if not _force_python_chain \
            and str(s["peak_mode"] or "pointy") != "broad":
        # the native chain implements the default pointy tail pick;
        # peak_mode=broad takes the python path below
        try:
            return _midline_chain_native(points, s, movement_direction)
        except OverflowError:
            pass  # segment capacity exceeded: the python path below
    # smoothing
    smooth_samples = s["outline_smooth_samples"]
    if smooth_samples > 0:
        points = smooth_points(points, smooth_samples,
                               max(1, int(s["outline_smooth_step"])))
    # make clockwise (positive signed area in image coords)
    if signed_area(points) < 0:
        points = points[::-1].copy()
    # EFT approximation
    n_approx = int(s["outline_approximate"])
    if n_approx > 0 and len(points) > 2:
        center = points.mean(axis=0)
        points = ieft(eft(points - center, n_approx), len(points),
                      center)
    L = len(points)
    if L < 3:
        return None
    rng = max(1, int(s["outline_curvature_range_ratio"] * L))
    curv = periodic_curvature(points, rng)

    peaks = find_peak_indices(curv)
    if not peaks:
        return None
    if str(s["peak_mode"] or "pointy") == "broad":
        # broad mode: the tail is the WIDEST curvature peak, not the
        # sharpest (Outline.cpp:527 FIND_BROAD + :683 broadest range)
        tail = max(peaks, key=lambda i: (peak_half_width(curv, i),
                                         curv[i]))
    else:
        # pointy mode: tail = highest-curvature peak
        tail = max(peaks, key=lambda i: curv[i])
    # head = peak circularly farthest from the tail
    head = -1
    max_d = -1
    for p in peaks:
        d = abs(p - tail)
        d = min(d, L - d)
        if d > max_d:
            max_d = d
            head = p
    # rotate so tail is index 0
    points = np.roll(points, -tail, axis=0)
    head_index = (head - tail) % L if head >= 0 else -1
    tail_index = 0
    if s["midline_invert"]:
        tail_index, head_index = head_index, tail_index

    # midline walk (Outline.cpp:768-866) — native kernel with the
    # python loop as fallback/reference (differential-tested)
    max_offset = max(3, int(s["midline_walk_offset"] * L))
    seg_h = _midline_walk(np.ascontiguousarray(points, np.float32),
                          max_offset)
    if seg_h.shape[0] <= 2:
        return None
    mid = Midline(segments=seg_h[:, :2].astype(np.float64),
                  heights=seg_h[:, 2].astype(np.float64),
                  tail_index=tail_index, head_index=head_index)
    _post_process(mid, settings, movement_direction)
    # the cached midline is the NORMALIZED one (Individual.cpp:1372:
    # post_process + Midline::normalize): its length is the chord sum
    # of the midline resampled to `midline_resolution` points
    # (Outline.cpp:1270-1408), not the raw segment sum. Resampling can
    # fail (point-count mismatch) — then there is no midline.
    reduced = _normalize_resample(mid.segments,
                                  int(s["midline_resolution"]))
    if reduced is None:
        return None
    d = np.hypot(*np.diff(reduced, axis=0).T)
    mid.len = float(d.sum())
    direction = mid.midline_direction(s["midline_stiff_percentage"])
    mid.angle = math.atan2(direction[1], direction[0])
    return mid


def _normalize_resample(segments: np.ndarray,
                        resolution: int) -> Optional[np.ndarray]:
    """Midline::normalize's arc-length resampler (Outline.cpp:
    1279-1376), ported step for step: walk the polyline accumulating
    segment lengths; every full `step` of walked distance emits an
    interpolated point; append the raw endpoint when the walk stopped
    short; exactly `resolution` points or failure. Positions compute
    in float32 like the reference's Float2_t."""
    segs = np.asarray(segments, np.float32)
    dif = np.diff(segs, axis=0)
    lens = np.hypot(dif[:, 0], dif[:, 1]).astype(np.float64)
    raw_len = float(lens.sum())
    if raw_len == 0.0:
        return None
    max_segments = resolution - 1
    step = raw_len / max_segments
    n = len(segs)
    reduced = [segs[0]]
    index = 0
    last_pt_distance = 0.0
    distance = 0.0
    while distance <= raw_len and index < n - 1:
        while distance - last_pt_distance < step and index < n - 1:
            distance += float(lens[index])
            index += 1
        off = distance - last_pt_distance
        if off < step:
            break
        while off >= step:
            off -= step
            if index > 0:
                s0 = segs[index - 1]
                s1 = segs[index]
                line = s1 - s0
                local_d = float(np.hypot(line[0], line[1]))
                percent = off
                if local_d > 0:
                    percent /= local_d
                percent = 1.0 - percent
                pos = s0 + line * np.float32(percent)
                reduced.append(pos)
                rem = line * np.float32(1.0 - percent)
                last_pt_distance = distance - float(
                    np.hypot(rem[0], rem[1]))
            else:
                reduced.append(segs[index])
                last_pt_distance = distance
    if float(np.hypot(*(reduced[-1] - segs[-1]))) >= 0.01:
        reduced.append(segs[-1])
    if len(reduced) != resolution:
        return None
    return np.asarray(reduced, np.float32)


def fixed_midline_points(mid: Midline, fix_length: float,
                         resolution: int) -> Optional[np.ndarray]:
    """Canonical-pose midline (Individual::fixed_midline,
    Individual.cpp:507-522 → Midline::normalize(fix_length),
    Outline.cpp:1396-1430): resample to `resolution` points, translate
    the tail end to the origin, rotate the chord onto +x, and scale the
    whole polyline to `fix_length` so the data is comparable across
    frames (output_normalize_midline_data)."""
    pts = _normalize_resample(mid.segments, resolution)
    if pts is None:
        pts = mid.normalize_points(resolution)
    pts = np.asarray(pts, np.float64)
    if len(pts) < 2:
        return None
    pts = pts - pts[-1]  # tail (last point) at the origin
    chord = pts[0] - pts[-1]
    ang = math.atan2(chord[1], chord[0])
    c, s_ = math.cos(-ang), math.sin(-ang)
    rot = np.array([[c, -s_], [s_, c]])
    pts = pts @ rot.T
    d = np.hypot(*np.diff(pts, axis=0).T)
    total = float(d.sum())
    if total > 0 and fix_length > 0:
        pts *= fix_length / total
    return pts.astype(np.float32)


def _post_process(mid: Midline, settings, movement_direction=None):
    """Midline::post_process (Outline.cpp:890-1010): orientation fix
    toward previous movement + stiff-part straightening."""
    s = settings
    if len(mid.segments) <= 2:
        return
    needs_invert = not s["midline_invert"]
    direction = mid.midline_direction(s["midline_stiff_percentage"])
    d = direction if needs_invert else -direction
    if movement_direction is not None and np.any(np.asarray(movement_direction) != 0):
        mv = np.asarray(movement_direction, float)
        nv = np.hypot(*mv)
        if nv > 0:
            mv = mv / nv
            if math.acos(np.clip((-d) @ mv, -1, 1)) < math.acos(np.clip(d @ mv, -1, 1)):
                needs_invert = not needs_invert
                mid.inverted_because_previous = True
                mid.tail_index, mid.head_index = mid.head_index, mid.tail_index
    start_with_head = bool(s["midline_start_with_head"])
    if needs_invert:
        if not start_with_head:
            mid.segments = mid.segments[::-1].copy()
            mid.heights = mid.heights[::-1].copy()
    elif start_with_head:
        mid.segments = mid.segments[::-1].copy()
        mid.heights = mid.heights[::-1].copy()

    stiff = s["midline_stiff_percentage"]
    if stiff > 0:
        segs = mid.segments
        n = len(segs)
        center = int(min(n - 1, round(n * stiff) + 1))
        center_point = segs[center].copy()
        axis = np.zeros(2)
        count = 0
        extra = int(min(n, center + max(0.0, n * 0.1)))
        for i in range(center, extra):
            if i + 1 >= n:
                break
            v = segs[i] - segs[i + 1]
            nv = np.hypot(*v)
            if nv > 0:
                axis += v / nv
            count += 1
        if count > 0:
            axis /= count
        copy = segs.copy()
        for i in range(center, 0, -1):
            p1 = segs[i]
            seg_len = float(np.hypot(*(copy[i] - copy[i - 1])))
            dtc = segs[i - 1] - center_point
            nv = np.hypot(*dtc)
            if nv > 0:
                dtc = dtc / nv
            test = (dtc + axis) * 0.5
            nv = np.hypot(*test)
            if nv > 0:
                test = test / nv
            segs[i - 1] = p1 + seg_len * test


def calculate_posture(blob: TrackBlob, settings,
                      background: Optional[np.ndarray] = None,
                      movement_direction=None) -> Optional[PostureResult]:
    """Full posture path with threshold escalation
    (Posture.cpp:305-410)."""
    s = SettingsView(settings)
    base = int(s["track_posture_threshold"])
    threshold = base
    minimum_pixels = max(1, blob.num_pixels // 10)
    first_outline = None
    offset = (0, 0)
    bx, by = blob.bounds[:2]
    while True:
        dense, goff = biggest_component(
            blob, threshold, background, s,
            int(s["posture_closing_steps"]), int(s["posture_closing_size"]))
        # biggest_component's crop origin is global; PostureResult's
        # offset contract is BLOB-RELATIVE (consumers add blob bounds +
        # offset: pipeline.run_postures, visual_field.generate_eyes) —
        # the pose/outline posture paths return blob-relative (0, 0)
        # under the same contract
        offset = (goff[0] - bx, goff[1] - by)
        if dense is None or dense.sum() < 1:
            break
        # 4x-supersampled trace approximates the reference's pixel-edge
        # ("crack") outline; pixel-center tracing biases midline_length
        # about -1px (validated against the golden fixture CSVs)
        pts = trace_boundary(np.kron(dense, np.ones((4, 4), np.uint8))) / 4.0
        if len(pts) >= 3:
            pts = resample(pts, float(s["outline_resample"]))
            mid = calculate_midline_from_outline(pts, s, movement_direction)
            if mid is not None:
                return PostureResult(outline=pts, midline=mid, offset=offset)
            if first_outline is None and len(pts):
                first_outline = pts
        threshold += 2
        if dense.sum() < minimum_pixels or threshold >= base + 100:
            break
    if first_outline is not None:
        return PostureResult(outline=first_outline, midline=None, offset=offset)
    return None


# ---------------------------------------------------------------------------
# pose-skeleton and segmentation-outline posture paths
# ---------------------------------------------------------------------------

def _ensure_circle_overlap(centers: list, radii: list):
    """Insert midpoint circles until consecutive circles overlap
    (Posture.cpp ensureCircleOverlap: intersect when the center
    distance < max(0, r1 + r2 - 2))."""
    if not centers:
        return
    merged = True
    guard = 0
    while merged and guard < 10000:
        merged = False
        guard += 1
        for i in range(len(centers) - 1):
            c0, c1 = centers[i], centers[i + 1]
            d = math.hypot(c1[0] - c0[0], c1[1] - c0[1])
            if d >= max(0.0, radii[i] + radii[i + 1] - 2):
                centers.insert(i + 1, ((c0[0] + c1[0]) * 0.5,
                                       (c0[1] + c1[1]) * 0.5))
                radii.insert(i + 1, (radii[i] + radii[i + 1]) / 2.0 + 1.0)
                merged = True
                break


def generate_outline_from_pose(points: np.ndarray, midline_indexes,
                               radius_map) -> np.ndarray:
    """Pose keypoints -> outer outline (Posture.cpp generateOutline):
    circles along the skeleton midline (pose_midline_indexes, or every
    valid point), gap-filled, filled as OpenCV's ``circle`` fills them
    (``tag_image.fill_circle``) and boundary-traced. Points with (0, 0)
    coordinates count as invalid like blob::Pose::valid(). Returns
    (N, 2) image-coordinate outline points (empty on failure)."""
    from .tag_image import fill_circle

    pts = np.asarray(points, np.float64).reshape(-1, 2)
    valid = ~((pts[:, 0] == 0) & (pts[:, 1] == 0))
    if midline_indexes:
        sel = [i for i in midline_indexes
               if 0 <= int(i) < len(pts) and valid[int(i)]]
        centers = [tuple(pts[int(i)]) for i in sel]
    else:
        centers = [tuple(p) for p, v in zip(pts, valid) if v]
    if not centers:
        return np.zeros((0, 2), np.float32)
    n = len(centers)
    if n == 1:
        radii = [(radius_map(0.0) + 1.0) if radius_map else 10.0]
    else:
        radii = [(radius_map(i / float(n - 1)) + 1.0) if radius_map
                 else 10.0 for i in range(n)]
    _ensure_circle_overlap(centers, radii)

    ca = np.asarray(centers)
    ra = np.asarray(radii)
    x0 = math.floor((ca[:, 0] - ra).min()) - 2
    y0 = math.floor((ca[:, 1] - ra).min()) - 2
    x1 = math.ceil((ca[:, 0] + ra).max()) + 2
    y1 = math.ceil((ca[:, 1] + ra).max()) + 2
    w, h = int(x1 - x0), int(y1 - y0)
    if w * h > 6000 * 6000 or w <= 0 or h <= 0:
        return np.zeros((0, 2), np.float32)
    canvas = np.zeros((h, w), np.uint8)
    for (cx, cy), r in zip(centers, radii):
        fill_circle(canvas, (int(round(cx - x0)), int(round(cy - y0))),
                    int(round(r)), 255)
    comps = label_blobs(canvas)
    if not comps:
        return np.zeros((0, 2), np.float32)
    big = max(comps, key=lambda c: c.num_pixels)
    dense = np.zeros_like(canvas)
    for y, a, b in big.lines:
        dense[y, a:b + 1] = 1
    # 4x-supersampled crack outline like the pixel path
    pts_out = trace_boundary(np.kron(dense, np.ones((4, 4),
                                                    np.uint8))) / 4.0
    if not len(pts_out):
        return np.zeros((0, 2), np.float32)
    return pts_out + np.array([x0, y0], np.float32)


def reduce_vertex_line(points: np.ndarray, epsilon: float) -> np.ndarray:
    """outline_compression: drop vertices closer than epsilon to the
    last kept vertex (gui::reduce_vertex_line role)."""
    if epsilon <= 0 or len(points) < 3:
        return points
    kept = [points[0]]
    for p in points[1:]:
        if math.hypot(p[0] - kept[-1][0], p[1] - kept[-1][1]) >= epsilon:
            kept.append(p)
    return np.asarray(kept, np.float32)


def calculate_posture_from_pose(blob: TrackBlob, pose_points, settings,
                                movement_direction=None
                                ) -> Optional[PostureResult]:
    """calculate_posture(pose) (Posture.cpp:246-275): outline from the
    pose skeleton, then the standard midline chain. Outline/midline are
    blob-local like the pixel path."""
    s = SettingsView(settings)
    x, y, w, h = blob.bounds
    m = max(5.0, (w + h) / 2.0 * 0.08)
    pts = generate_outline_from_pose(
        pose_points, [int(i) for i in (s["pose_midline_indexes"] or [])],
        lambda t: m * (1.0 - t) + 1.0)
    if len(pts) < 3:
        return None
    pts = (pts - np.array([x, y], np.float32)).astype(np.float32)
    pts = resample(pts, float(s["outline_resample"]))
    mid = calculate_midline_from_outline(pts, s, movement_direction)
    if mid is None:
        return None
    return PostureResult(outline=pts, midline=mid, offset=(0, 0))


def calculate_posture_from_outline(blob: TrackBlob, outline_points,
                                   settings, movement_direction=None
                                   ) -> Optional[PostureResult]:
    """calculate_posture(SegmentedOutlines) (Posture.cpp:277-304): the
    detection's original outline, blob-local, resampled and optionally
    compressed, then the midline chain."""
    s = SettingsView(settings)
    x, y, _, _ = blob.bounds
    pts = np.asarray(outline_points)
    if pts.ndim == 1:
        # flat int32 stream: interleaved x,y pairs
        pts = pts.reshape(-1, 2)
    pts = pts.astype(np.float32) - np.array([x, y], np.float32)
    if len(pts) < 3:
        return None
    pts = resample(pts, float(s["outline_resample"]))
    compression = float(s["outline_compression"] or 0.0)
    if compression > 0:
        pts = reduce_vertex_line(pts, compression)
    if len(pts) < 3:
        return None
    mid = calculate_midline_from_outline(pts, s, movement_direction)
    if mid is None:
        return None
    return PostureResult(outline=pts, midline=mid, offset=(0, 0))


def posture_batch(line_arrays: list, pixel_arrays: list,
                  background: np.ndarray, settings,
                  movement_dirs: Optional[np.ndarray] = None,
                  n_threads: int = 0):
    """Posture of a batch of blobs in one native call. Returns (ok (N,)
    bool, midline length (N,) in px, angle (N,), direction (N, 2)).
    Requires ``posture_closing_steps == 0``."""
    s = SettingsView(settings)
    if int(s["posture_closing_steps"]) != 0:
        raise ValueError("posture_batch: closing steps unsupported")
    n = len(line_arrays)
    if n == 0:
        z = np.zeros(0)
        return z.astype(bool), z, z, np.zeros((0, 2))
    lib = _get_native_posture()
    lines = np.ascontiguousarray(
        np.concatenate([np.asarray(a, np.int32) for a in line_arrays]))
    pixels = np.ascontiguousarray(
        np.concatenate([np.asarray(a, np.uint8) for a in pixel_arrays]))
    line_start = np.zeros(n + 1, np.int64)
    np.cumsum([len(a) for a in line_arrays], out=line_start[1:])
    pixel_start = np.zeros(n + 1, np.int64)
    np.cumsum([len(a) for a in pixel_arrays], out=pixel_start[1:])
    bg = np.ascontiguousarray(background, np.uint8)
    out_len = np.zeros(n)
    out_angle = np.zeros(n)
    out_dx = np.zeros(n)
    out_dy = np.zeros(n)
    out_ok = np.zeros(n, np.int32)
    if movement_dirs is None:
        md = np.zeros((n, 2))
        has = np.zeros(n, np.uint8)
    else:
        md = np.ascontiguousarray(movement_dirs, np.float64)
        has = np.ascontiguousarray(np.any(md != 0, axis=1).astype(np.uint8))
    lib.trex_posture_batch(
        lines.ctypes.data_as(_i32p), line_start.ctypes.data_as(_i64p),
        pixels.ctypes.data_as(_c), pixel_start.ctypes.data_as(_i64p), n,
        bg.ctypes.data_as(_c), bg.shape[1], bg.shape[0],
        int(s["track_posture_threshold"]),
        1 if s["track_threshold_is_absolute"] else 0,
        float(s["outline_resample"]), float(s["outline_smooth_samples"]),
        max(1, int(s["outline_smooth_step"])),
        int(s["outline_approximate"]),
        float(s["outline_curvature_range_ratio"]),
        1 if s["midline_invert"] else 0,
        float(s["midline_walk_offset"]),
        float(s["midline_stiff_percentage"]),
        1 if s["midline_start_with_head"] else 0,
        int(s["midline_resolution"]),
        md.ctypes.data_as(_f64p), has.ctypes.data_as(_c),
        out_len.ctypes.data_as(_f64p), out_angle.ctypes.data_as(_f64p),
        out_dx.ctypes.data_as(_f64p), out_dy.ctypes.data_as(_f64p),
        out_ok.ctypes.data_as(_i32p), int(n_threads))
    return (out_ok.astype(bool), out_len, out_angle,
            np.stack([out_dx, out_dy], axis=1))


def posture_batch_full(line_arrays: list, pixel_arrays: list,
                       background: np.ndarray, settings,
                       movement_dirs: Optional[np.ndarray] = None,
                       n_threads: int = 0,
                       outline_cap: int = 2048, seg_cap: int = 512):
    """posture_batch plus full geometry per blob (the archive/export
    path; native trex_posture_batch_full): returns a dict of arrays

        ok (N,) bool, len (N,), angle (N,), dir (N, 2),
        outline (N, outline_cap, 2) f32 crop-local, n_outline (N,) i32,
        seg (N, seg_cap, 2) f64, heights (N, seg_cap) f64,
        nseg/tail/head/inverted (N,) i32,
        off (N, 2) f64 — GLOBAL crop origin (subtract blob bounds for
        the PostureResult blob-relative offset convention),
        trunc (N,) bool — capacity exceeded; re-run those blobs through
        calculate_posture (the per-blob python chain).
    """
    s = SettingsView(settings)
    if int(s["posture_closing_steps"]) != 0:
        raise ValueError("posture_batch_full: closing steps unsupported")
    n = len(line_arrays)
    out = dict(
        ok=np.zeros(n, bool), len=np.zeros(n), angle=np.zeros(n),
        dir=np.zeros((n, 2)),
        outline=np.zeros((n, outline_cap, 2), np.float32),
        n_outline=np.zeros(n, np.int32),
        seg=np.zeros((n, seg_cap, 2)), heights=np.zeros((n, seg_cap)),
        nseg=np.zeros(n, np.int32), tail=np.zeros(n, np.int32),
        head=np.zeros(n, np.int32), inverted=np.zeros(n, np.int32),
        off=np.zeros((n, 2)), trunc=np.zeros(n, bool))
    if n == 0:
        return out
    lib = _lib()
    lines = np.ascontiguousarray(
        np.concatenate([np.asarray(a, np.int32) for a in line_arrays]))
    pixels = np.ascontiguousarray(
        np.concatenate([np.asarray(a, np.uint8) for a in pixel_arrays]))
    line_start = np.zeros(n + 1, np.int64)
    np.cumsum([len(a) for a in line_arrays], out=line_start[1:])
    pixel_start = np.zeros(n + 1, np.int64)
    np.cumsum([len(a) for a in pixel_arrays], out=pixel_start[1:])
    bg = np.ascontiguousarray(background, np.uint8)
    if movement_dirs is None:
        md = np.zeros((n, 2))
        has = np.zeros(n, np.uint8)
    else:
        md = np.ascontiguousarray(movement_dirs, np.float64)
        has = np.ascontiguousarray(
            np.any(md != 0, axis=1).astype(np.uint8))
    ok32 = np.zeros(n, np.int32)
    trunc32 = np.zeros(n, np.int32)
    dx = np.zeros(n)
    dy = np.zeros(n)
    lib.trex_posture_batch_full(
        lines.ctypes.data_as(_i32p), line_start.ctypes.data_as(_i64p),
        pixels.ctypes.data_as(_c),
        pixel_start.ctypes.data_as(_i64p), ctypes.c_int64(n),
        bg.ctypes.data_as(_c),
        ctypes.c_int32(bg.shape[1]), ctypes.c_int32(bg.shape[0]),
        ctypes.c_int32(int(s["track_posture_threshold"])),
        ctypes.c_int32(1 if s["track_threshold_is_absolute"] else 0),
        ctypes.c_double(float(s["outline_resample"])),
        ctypes.c_double(float(s["outline_smooth_samples"])),
        ctypes.c_int32(max(1, int(s["outline_smooth_step"]))),
        ctypes.c_int32(int(s["outline_approximate"])),
        ctypes.c_double(float(s["outline_curvature_range_ratio"])),
        ctypes.c_int32(1 if s["midline_invert"] else 0),
        ctypes.c_double(float(s["midline_walk_offset"])),
        ctypes.c_double(float(s["midline_stiff_percentage"])),
        ctypes.c_int32(1 if s["midline_start_with_head"] else 0),
        ctypes.c_int32(int(s["midline_resolution"])),
        md.ctypes.data_as(_f64p), has.ctypes.data_as(_c),
        out["len"].ctypes.data_as(_f64p),
        out["angle"].ctypes.data_as(_f64p),
        dx.ctypes.data_as(_f64p), dy.ctypes.data_as(_f64p),
        ok32.ctypes.data_as(_i32p),
        out["outline"].ctypes.data_as(_f32p),
        out["n_outline"].ctypes.data_as(_i32p),
        ctypes.c_int64(outline_cap),
        out["seg"].ctypes.data_as(_f64p),
        out["heights"].ctypes.data_as(_f64p), ctypes.c_int64(seg_cap),
        out["nseg"].ctypes.data_as(_i32p),
        out["tail"].ctypes.data_as(_i32p),
        out["head"].ctypes.data_as(_i32p),
        out["inverted"].ctypes.data_as(_i32p),
        out["off"].ctypes.data_as(_f64p),
        trunc32.ctypes.data_as(_i32p), ctypes.c_int32(n_threads))
    out["ok"] = ok32.astype(bool)
    out["trunc"] = trunc32.astype(bool)
    out["dir"] = np.stack([dx, dy], axis=1)
    return out
