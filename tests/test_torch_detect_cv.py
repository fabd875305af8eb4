"""The OpenCV routines of the detection and pose-posture path, rebuilt in
the port, against cv2 5.0.0 under hypothesis.

Bit for bit: `tag_image.resize_linear` (``cv2.resize`` INTER_LINEAR,
8-bit, 1 and 3 channels: 1024 -> 640, upscales, odd sizes, 1-pixel
sides), `bgr_to_gray` / `gray_to_bgr` (``cvtColor``; BGR2GRAY also over
every one of the 2^24 colours) and `fill_circle` (``cv2.circle``
filled, centres on and off the canvas).

Within a tolerance, with the NMS decisions equal:

- `rotated.min_area_rect` (``cv2.minAreaRect``): the corners within
  RECT_TOL (1e-3 px) of OpenCV's, the angle in OpenCV's [-90, 0) and
  within ANGLE_TOL (1e-4 degrees) where the width and height are the
  same, the area within 1e-5 relative. Where two of the hull's
  edge-aligned rectangles tie in area to float32 rounding (three points
  always tie), OpenCV may keep the other one: such inputs are held to
  the area alone.
- `rotated.intersection_area` (``contourArea`` of
  ``rotatedRectangleIntersection``): within AREA_TOL (5e-4) of the two
  rects' summed area. OpenCV intersects the edges in float32 and merges
  nearly equal vertices; the port clips in double. Measured over 20000
  random pairs: 2e-4.
- the rotated-rect NMS of pose detections (`compute_tile_nms_indices_
  for_rotated_rects` on `compute_pose_tile_rect` rects padded by 4 px,
  as `merge_tile_detections` builds them): the keeps equal the JAX
  package's (cv2's) on every drawn set whose IoUs all lie further than
  AREA_TOL from the threshold."""
import math

import cv2
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from trex_tpu.detect import tiling as jax_tiling
from trex_tpu_torch.detect import rotated, tiling
from trex_tpu_torch.track import tag_image as ti
from trex_tpu_torch.track.visual_field import convex_hull

RECT_TOL = 1e-3
ANGLE_TOL = 1e-4
AREA_TOL = 5e-4

HYP = settings(max_examples=150, deadline=None, derandomize=True,
               suppress_health_check=[HealthCheck.too_slow])


def _image(draw, h, w, channels):
    seed = draw(st.integers(0, 2**31))
    rng = np.random.default_rng(seed)
    shape = (h, w) if channels == 1 else (h, w, 3)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    if draw(st.booleans()):  # smooth content: weights, not noise
        img = np.clip(np.cumsum(rng.integers(-3, 4, shape), 1) + 128, 0,
                      255).astype(np.uint8)
    return img


@st.composite
def resize_cases(draw):
    h, w = draw(st.integers(1, 80)), draw(st.integers(1, 80))
    dh, dw = draw(st.integers(1, 120)), draw(st.integers(1, 120))
    return _image(draw, h, w, draw(st.sampled_from([1, 3]))), (dw, dh)


@HYP
@given(resize_cases())
def test_resize_linear_bit_for_bit(case):
    img, size = case
    assert np.array_equal(ti.resize_linear(img, size), cv2.resize(img, size))


@pytest.mark.parametrize("src,dst", [((1024, 1024), (640, 640)),
                                     ((1024, 1024), (512, 512)),
                                     ((571, 571), (640, 640)),
                                     ((1080, 1920), (360, 640)),
                                     ((1, 7), (5, 33)), ((9, 1), (1, 1))])
@pytest.mark.parametrize("channels", [1, 3])
def test_resize_linear_letterbox_sizes(src, dst, channels):
    rng = np.random.default_rng(sum(src) + channels)
    img = rng.integers(0, 256, src + ((3,) if channels == 3 else ()))
    img = img.astype(np.uint8)
    size = (dst[1], dst[0])
    assert np.array_equal(ti.resize_linear(img, size), cv2.resize(img, size))


def test_bgr_to_gray_every_colour():
    v = np.arange(256, dtype=np.uint8)
    b, g, r = np.meshgrid(v, v, v, indexing="ij")
    img = np.stack([b.ravel(), g.ravel(), r.ravel()], -1)
    for shape in ((4096, 4096, 3), (-1, 1, 3), (-1, 7, 3)):
        n = len(img) // abs(shape[1]) * abs(shape[1])
        im = img[:n].reshape(shape)
        assert np.array_equal(ti.bgr_to_gray(im),
                              cv2.cvtColor(im, cv2.COLOR_BGR2GRAY))


@HYP
@given(st.integers(1, 40), st.integers(1, 40), st.integers(0, 2**31))
def test_gray_conversions_bit_for_bit(h, w, seed):
    rng = np.random.default_rng(seed)
    bgr = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    gray = rng.integers(0, 256, (h, w)).astype(np.uint8)
    assert np.array_equal(ti.bgr_to_gray(bgr),
                          cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY))
    assert np.array_equal(ti.gray_to_bgr(gray),
                          cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR))


@HYP
@given(st.integers(1, 48), st.integers(1, 48), st.integers(-20, 70),
       st.integers(-20, 70), st.integers(0, 30))
def test_fill_circle_bit_for_bit(h, w, cx, cy, r):
    a = np.zeros((h, w), np.uint8)
    cv2.circle(a, (cx, cy), r, 255, -1)
    b = ti.fill_circle(np.zeros((h, w), np.uint8), (cx, cy), r, 255)
    assert np.array_equal(a, b)


@st.composite
def point_sets(draw):
    n = draw(st.integers(1, 9))
    seed = draw(st.integers(0, 2**31))
    rng = np.random.default_rng(seed)
    kind = draw(st.sampled_from(["grid", "cloud", "pose"]))
    if kind == "grid":
        return rng.integers(0, 20, (n, 2)).astype(np.float32)
    if kind == "cloud":
        return rng.normal(100, 30, (n, 2)).astype(np.float32)
    # keypoints along a body's long axis, as a pose model gives them
    base = rng.uniform(20, 1000, 2)
    d = rng.normal(0, 1, 2)
    d /= np.linalg.norm(d)
    along = np.linspace(0, rng.uniform(5, 40), n)
    return (base + np.outer(along, d)
            + rng.normal(0, 1.5, (n, 2))).astype(np.float32)


def corner_gap(a, b) -> float:
    pa, pb = rotated.rect_points(a), rotated.rect_points(b)
    return max(np.min(np.hypot(*(pb - p).T)) for p in pa)


def edge_rect_areas(pts):
    """The areas of the hull's edge-aligned bounding rectangles."""
    hull = convex_hull(pts).astype(np.float64)
    out = []
    for i in range(len(hull)):
        e = hull[(i + 1) % len(hull)] - hull[i]
        if not e.any():
            continue
        u = e / np.hypot(*e)
        a, b = hull @ u, hull @ np.array([-u[1], u[0]])
        out.append((a.max() - a.min()) * (b.max() - b.min()))
    return sorted(out)


@HYP
@given(point_sets())
def test_min_area_rect_within_tolerance(pts):
    want = cv2.minAreaRect(pts)
    got = rotated.min_area_rect(pts)
    area_w, area_g = want[1][0] * want[1][1], got[1][0] * got[1][1]
    assert abs(area_w - area_g) <= 1e-5 * max(1.0, area_w)
    if -90 <= want[2] < 0 or want[2] == 0:
        assert -90 <= got[2] < 0 or (got[2] == 0 and want[2] == 0)
    areas = edge_rect_areas(pts)
    tied = len(areas) > 1 and areas[1] - areas[0] <= 1e-5 * areas[0]
    if tied:
        return
    assert corner_gap(want, got) <= RECT_TOL
    if abs(want[1][0] - got[1][0]) <= RECT_TOL:
        assert abs(want[2] - got[2]) <= ANGLE_TOL


@st.composite
def rect_pairs(draw):
    rng = np.random.default_rng(draw(st.integers(0, 2**31)))
    at = draw(st.sampled_from([0.0, 500.0, 1000.0]))

    def rect():
        return ((float(at + rng.normal(50, 10)),
                 float(at + rng.normal(50, 10))),
                (float(rng.uniform(1, 40)), float(rng.uniform(1, 40))),
                float(rng.uniform(-90, 0)))

    a = rect()
    kind = draw(st.sampled_from(["random", "near", "same", "shifted"]))
    if kind == "random":
        b = rect()
    elif kind == "near":
        b = ((a[0][0] + rng.normal(0, 0.5), a[0][1] + rng.normal(0, 0.5)),
             (a[1][0] + rng.normal(0, 0.5), a[1][1]),
             a[2] + rng.normal(0, 2))
    elif kind == "same":
        b = a
    else:
        b = ((a[0][0] + a[1][0], a[0][1]), a[1], a[2])
    return a, b


def cv_area(a, b) -> float:
    res, region = cv2.rotatedRectangleIntersection(a, b)
    if res == cv2.INTERSECT_NONE or region is None:
        return 0.0
    return float(cv2.contourArea(region))


@HYP
@given(rect_pairs())
def test_rotated_intersection_area_within_tolerance(pair):
    a, b = pair
    scale = a[1][0] * a[1][1] + b[1][0] * b[1][1]
    assert abs(rotated.intersection_area(a, b) - cv_area(a, b)) \
        <= AREA_TOL * scale


def pose_rows(seed, n_fish=40, dup=0.5):
    """Pose keypoints of fish in overlapping tiles: each fish once, and
    a share of them again with a tile's jitter, as SAHI merges them."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 300, (n_fish, 2))
    d = rng.normal(0, 1, (n_fish, 2))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    length = rng.uniform(8, 30, n_fish)
    t = np.linspace(0, 1, 5)
    kp = base[:, None] + t[None, :, None] * (length[:, None, None]
                                             * d[:, None])
    kp += rng.normal(0, 0.8, kp.shape)
    again = rng.random(n_fish) < dup
    kp = np.concatenate([kp, kp[again] + rng.normal(0, 1.0, (again.sum(),
                                                            5, 2))])
    conf = rng.uniform(0.2, 1, len(kp))
    clid = rng.integers(0, 2, len(kp))
    return kp.astype(np.float32), conf, clid


def _rects(module, kp):
    out = []
    for k in kp:
        (cx, cy), (w, h), a = module.compute_pose_tile_rect(k)
        out.append(((cx, cy), (w + 4.0, h + 4.0), a))
    return out


@pytest.mark.parametrize("thr", [0.3, 0.55, 0.8])
@pytest.mark.parametrize("seed", range(6))
def test_rotated_nms_keeps_equal_jax(seed, thr):
    kp, conf, clid = pose_rows(seed)
    jr, pr = _rects(jax_tiling, kp), _rects(tiling, kp)
    want = jax_tiling.compute_tile_nms_indices_for_rotated_rects(
        jr, conf, clid, thr)
    got = tiling.compute_tile_nms_indices_for_rotated_rects(
        pr, conf, clid, thr)
    # sets whose rects or IoUs sit within the tolerance of a decision
    # are the stated exception
    near = False
    for i in range(len(jr)):
        for j in range(i + 1, len(jr)):
            if corner_gap(jr[i], pr[i]) > RECT_TOL:
                near = True
            inter = cv_area(jr[i], jr[j])
            union = jr[i][1][0] * jr[i][1][1] + jr[j][1][0] * jr[j][1][1] \
                - inter
            if inter > 0 and abs(inter / union - thr) <= AREA_TOL:
                near = True
    assert got == want or near
    assert len(want) < len(kp)  # the duplicates were merged


def test_min_area_rect_degenerate_inputs():
    for pts in (np.zeros((0, 2)), np.array([[3.5, 4.0]]),
                np.array([[0, 0], [10, 5]]), np.array([[1, 1], [1, 1]]),
                np.array([[0, 0], [1, 1], [2, 2]])):
        pts = np.asarray(pts, np.float32)
        if not len(pts):
            continue
        want = cv2.minAreaRect(pts)
        got = rotated.min_area_rect(pts)
        assert corner_gap(want, got) <= RECT_TOL
        assert math.isclose(want[1][0] * want[1][1], got[1][0] * got[1][1],
                            abs_tol=1e-6)
