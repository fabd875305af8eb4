"""The nine OpenCV routines of tag detection (trex_tpu_torch/track/
tag_image.py, native/contours.cpp) held to cv2 bit for bit: every
resize side from 1 to 96, hypothesis images and masks for the filters
and contours, random integer contours for area, arc length and the
polygon approximation. Tolerance 0 throughout."""
import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from trex_tpu_torch.track import tag_image as ti


def _images(min_side=1, max_side=40):
    return st.tuples(st.integers(min_side, max_side),
                     st.integers(min_side, max_side),
                     st.integers(0, 2 ** 32 - 1),
                     st.sampled_from(["uniform", "levels", "blobs"])).map(
        lambda a: _make_image(*a))


def _make_image(h, w, seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.integers(0, 256, (h, w), np.uint8)
    if kind == "levels":
        return (rng.integers(0, 4, (h, w)) * 70).astype(np.uint8)
    img = np.full((h, w), 200, np.uint8)
    for _ in range(rng.integers(1, 5)):
        y, x = rng.integers(0, h), rng.integers(0, w)
        r = int(rng.integers(1, 6))
        img[max(0, y - r):y + r, max(0, x - r):x + r] = rng.integers(0, 256)
    return img


def _masks():
    return st.tuples(st.integers(1, 40), st.integers(1, 40),
                     st.integers(0, 2 ** 32 - 1),
                     st.floats(0.05, 0.95)).map(lambda a: _make_mask(*a))


def _make_mask(h, w, seed, density):
    rng = np.random.default_rng(seed)
    if seed % 2:
        return (rng.random((h, w)) < density).astype(np.uint8) * 255
    # smooth blobs with holes, touching the border
    noise = (rng.random((h, w)) * 255).astype(np.uint8)
    return (cv2.GaussianBlur(noise, (5, 5), 1.5) > 255 * (1 - density)
            ).astype(np.uint8) * 255


@pytest.mark.parametrize("side", range(1, 97))
def test_resize_every_side_to_32(side):
    """prettify_blobs' squares (sides 1-96) to the 32x32 crop: upscaling
    below 32, the block mean at 64 and 96, float area weights else."""
    rng = np.random.default_rng(side)
    for kind in ("uniform", "levels", "blobs"):
        img = _make_image(side, side, int(rng.integers(1 << 30)), kind)
        np.testing.assert_array_equal(
            ti.resize_area(img, (32, 32)),
            cv2.resize(img, (32, 32), interpolation=cv2.INTER_AREA))
        mask = (img > 128).astype(np.uint8)
        np.testing.assert_array_equal(
            ti.resize_nearest(mask, (32, 32)),
            cv2.resize(mask, (32, 32), interpolation=cv2.INTER_NEAREST))


@settings(max_examples=150, deadline=None)
@given(img=_images(), w=st.integers(1, 48), h=st.integers(1, 48))
def test_resize_any_shape(img, w, h):
    """The decoder resizes crops of any shape to tags_image_size."""
    np.testing.assert_array_equal(
        ti.resize_area(img, (w, h)),
        cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA))
    np.testing.assert_array_equal(
        ti.resize_nearest(img, (w, h)),
        cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST))


@settings(max_examples=150, deadline=None)
@given(img=_images(min_side=2))
def test_laplacian(img):
    got = ti.laplacian(img)
    want = cv2.Laplacian(img, cv2.CV_64F)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@settings(max_examples=150, deadline=None)
@given(mask=_masks())
def test_erode3(mask):
    m = (mask > 0).astype(np.uint8)
    np.testing.assert_array_equal(
        ti.erode3(m), cv2.erode(m, np.ones((3, 3), np.uint8)))


@settings(max_examples=200, deadline=None)
@given(img=_images())
def test_equalize_hist(img):
    np.testing.assert_array_equal(ti.equalize_hist(img),
                                  cv2.equalizeHist(img))


def test_equalize_hist_one_value():
    img = np.full((5, 7), 93, np.uint8)
    np.testing.assert_array_equal(ti.equalize_hist(img),
                                  cv2.equalizeHist(img))


@settings(max_examples=200, deadline=None)
@given(img=_images(), c=st.integers(-20, 20), inverse=st.booleans())
def test_adaptive_threshold_mean(img, c, inverse):
    """blockSize 11 and C = -|c| as tags.py passes it."""
    got = ti.adaptive_threshold_mean(img, 255, inverse, 11, -abs(c))
    want = cv2.adaptiveThreshold(
        img, 255, cv2.ADAPTIVE_THRESH_MEAN_C,
        cv2.THRESH_BINARY_INV if inverse else cv2.THRESH_BINARY, 11,
        -abs(c))
    np.testing.assert_array_equal(got, want)


def _assert_contours_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


@settings(max_examples=300, deadline=None)
@given(mask=_masks())
def test_find_contours_external(mask):
    """Start point, direction, list order and the image border: the
    masks' components touch the border and hold holes with islands."""
    want, _ = cv2.findContours(mask, cv2.RETR_EXTERNAL,
                               cv2.CHAIN_APPROX_SIMPLE)
    _assert_contours_equal(ti.find_contours_external(mask), list(want))


@pytest.mark.parametrize("case", ["empty", "single_pixel", "full",
                                  "ring_with_island", "line"])
def test_find_contours_edge_cases(case):
    m = np.zeros((9, 11), np.uint8)
    if case == "single_pixel":
        m[4, 5] = 255
    elif case == "full":
        m[:] = 255
    elif case == "ring_with_island":
        m[1:8, 1:10] = 255
        m[2:7, 2:9] = 0
        m[4, 5] = 255
    elif case == "line":
        m[3, :] = 255
    want, _ = cv2.findContours(m, cv2.RETR_EXTERNAL,
                               cv2.CHAIN_APPROX_SIMPLE)
    _assert_contours_equal(ti.find_contours_external(m), list(want))


def test_area_arc_length_approx_on_random_contours():
    """2000 random integer contours (self-intersecting, repeated points)
    and epsilons: the plain float64 edge sum departs from cv2.arcLength
    on nearly all of them, OpenCV's batched float32 roots on none."""
    rng = np.random.default_rng(7)
    for _ in range(2000):
        n = int(rng.integers(1, 60))
        c = rng.integers(0, 100, (n, 1, 2)).astype(np.int32)
        assert ti.contour_area(c) == cv2.contourArea(c)
        assert ti.arc_length(c, True) == cv2.arcLength(c, True)
        assert ti.arc_length(c, False) == cv2.arcLength(c, False)
        eps = float(rng.uniform(0, 10))
        np.testing.assert_array_equal(ti.approx_poly_dp(c, eps, True),
                                      cv2.approxPolyDP(c, eps, True))


def test_approx_poly_dp_ties():
    """Small coordinate ranges, many equal distances and epsilons that
    hit a distance exactly."""
    rng = np.random.default_rng(11)
    checked = 0
    for _ in range(5000):
        n = int(rng.integers(3, 14))
        c = rng.integers(0, int(rng.integers(2, 8)), (n, 1, 2)
                         ).astype(np.int32)
        eps = [np.sqrt(float(rng.integers(0, 20))),
               float(rng.integers(0, 5)),
               float(rng.uniform(0, 3))][int(rng.integers(0, 3))]
        try:
            want = cv2.approxPolyDP(c, eps, True)
        except cv2.error:
            continue   # OpenCV asserts on some degenerate inputs
        np.testing.assert_array_equal(ti.approx_poly_dp(c, eps, True),
                                      want)
        checked += 1
    assert checked > 4000


@settings(max_examples=200, deadline=None)
@given(mask=_masks(), frac=st.floats(0.005, 0.1))
def test_contours_of_masks_through_the_shape_test(mask, frac):
    """The chain of _tag_shape_ok: the largest contour's area, arc
    length and polygon."""
    want, _ = cv2.findContours(mask, cv2.RETR_EXTERNAL,
                               cv2.CHAIN_APPROX_SIMPLE)
    got = ti.find_contours_external(mask)
    for a, b in zip(got, want):
        assert ti.contour_area(a) == cv2.contourArea(b)
        eps = frac * cv2.arcLength(b, True)
        assert frac * ti.arc_length(a, True) == eps
        np.testing.assert_array_equal(ti.approx_poly_dp(a, eps, True),
                                      cv2.approxPolyDP(b, eps, True))
