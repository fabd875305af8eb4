"""The port's rebuilt OpenCV routines (trex_tpu_torch/utils/imgproc.py,
the NONE chain of track/tag_image.py's contours) against cv2 5.0.0 bit for
bit under hypothesis: the box blur, the 5x5 Gaussian, the adaptive
Gaussian threshold, the ellipse element with erode and dilate, the
rectangle morphology at the pipeline's sizes (even sizes included), the
external contours with every point, fillPoly, the undistortion maps for
every distortion length cv2 takes, and the remap on 1 and 3 channels.
Then the sha256 digests that chip_smoke.py pins for the card's machine,
which has no OpenCV, recomputed with cv2 on the same seeded inputs.
Tolerance 0."""
import ast
from pathlib import Path
from types import SimpleNamespace

import cv2
import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from trex_tpu_torch.track import tag_image as ti
from trex_tpu_torch.utils import imgproc as ip

REPO = Path(__file__).resolve().parents[1]
SEEDS = st.integers(0, 2 ** 32 - 1)
SIDES = st.integers(1, 70)


def _image(h, w, seed, channels=0):
    shape = (h, w, channels) if channels else (h, w)
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _mask(h, w, seed, p=0.5):
    return (np.random.default_rng(seed).random((h, w)) < p).astype(np.uint8)


@settings(max_examples=150, deadline=None)
@given(SIDES, SIDES, SEEDS, st.integers(0, 20), st.integers(0, 20),
       st.booleans())
def test_box_blur_equals_cv2(h, w, seed, a, b, binary):
    img = _mask(h, w, seed) * 255 if binary else _image(h, w, seed)
    k = (2 * a + 1, 2 * b + 1)
    np.testing.assert_array_equal(ip.box_blur(img, k), cv2.blur(img, k))


@settings(max_examples=150, deadline=None)
@given(SIDES, SIDES, SEEDS)
def test_gaussian_blur5_equals_cv2(h, w, seed):
    img = _image(h, w, seed)
    np.testing.assert_array_equal(ip.gaussian_blur5(img),
                                  cv2.GaussianBlur(img, (5, 5), 0))


def test_gaussian_blur5_is_not_the_float_pass():
    """OpenCV's fixed point rounds ties up where a float pass rounds them
    to even: the rebuilt path is the former."""
    img = _image(256, 256, 5)
    want = cv2.GaussianBlur(img, (5, 5), 0)
    np.testing.assert_array_equal(ip.gaussian_blur5(img), want)
    k = np.array([1, 4, 6, 4, 1], np.float32) / 16
    flt = cv2.sepFilter2D(img.astype(np.float32), -1, k, k,
                          borderType=cv2.BORDER_REFLECT_101)
    assert (np.rint(flt).astype(np.uint8) != want).any()


@settings(max_examples=150, deadline=None)
@given(SIDES, SIDES, SEEDS, st.integers(7, 70), st.floats(-6, 6),
       st.sampled_from([1, 255]))
def test_adaptive_threshold_gaussian_equals_cv2(h, w, seed, half, c, mv):
    """At the pipeline's block sizes (2 max(7, min side // 16) + 1)."""
    img = _image(h, w, seed)
    block = 2 * half + 1
    np.testing.assert_array_equal(
        ip.adaptive_threshold_gaussian(img, mv, block, c),
        cv2.adaptiveThreshold(img, mv, cv2.ADAPTIVE_THRESH_GAUSSIAN_C,
                              cv2.THRESH_BINARY, block, c))


def test_adaptive_threshold_at_full_width_and_the_kernels():
    """Block 129 on a 1024^2-wide frame (the pipeline's size), and the
    Gaussian kernel of every odd size from 11 to 301."""
    img = _image(300, 1021, 11)
    np.testing.assert_array_equal(
        ip.adaptive_threshold_gaussian(img, 1, 129, -2.0),
        cv2.adaptiveThreshold(img, 1, cv2.ADAPTIVE_THRESH_GAUSSIAN_C,
                              cv2.THRESH_BINARY, 129, -2.0))
    for n in range(11, 302, 2):
        np.testing.assert_array_equal(
            ip.gaussian_kernel(n),
            cv2.getGaussianKernel(n, 0, ktype=cv2.CV_32F).ravel())


@settings(max_examples=150, deadline=None)
@given(st.integers(1, 60), st.integers(1, 60), SEEDS, st.integers(0, 12),
       st.floats(0.05, 0.95))
def test_ellipse_erode_dilate_equal_cv2(h, w, seed, r, p):
    e = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (2 * r + 1, 2 * r + 1))
    np.testing.assert_array_equal(ip.ellipse_element((2 * r + 1,) * 2), e)
    m = _mask(h, w, seed, p)
    np.testing.assert_array_equal(ip.erode(m, e), cv2.erode(m, e))
    np.testing.assert_array_equal(ip.dilate(m, e), cv2.dilate(m, e))


@settings(max_examples=150, deadline=None)
@given(st.integers(1, 60), st.integers(1, 60), SEEDS,
       st.integers(1, 9), st.floats(0.05, 0.95))
def test_rect_morphology_equals_cv2(h, w, seed, k, p):
    """The options' closing (closing_size), dilation and erosion
    (dilation_size and its negative) with k x k ones, even k included."""
    m = _mask(h, w, seed, p)
    kernel = np.ones((k, k), np.uint8)
    np.testing.assert_array_equal(
        ip.close_rect(m, k), cv2.morphologyEx(m, cv2.MORPH_CLOSE, kernel))
    np.testing.assert_array_equal(ip.dilate_rect(m, k),
                                  cv2.dilate(m, kernel))
    np.testing.assert_array_equal(ip.erode_rect(m, k), cv2.erode(m, kernel))


@settings(max_examples=150, deadline=None)
@given(st.integers(1, 60), st.integers(1, 60), SEEDS,
       st.floats(0.05, 0.95))
def test_contours_every_point_equal_cv2(h, w, seed, p):
    m = _mask(h, w, seed, p)
    want, _ = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)
    got = ti.find_contours_external(m, every_point=True)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@settings(max_examples=150, deadline=None)
@given(st.integers(1, 70), st.integers(1, 70), SEEDS,
       st.integers(3, 64), st.booleans())
def test_fill_poly_equals_cv2(h, w, seed, n, star):
    """Star polygons as the inverse EFT draws them and arbitrary ones
    that cross themselves, both reaching past the frame."""
    rng = np.random.default_rng(seed)
    if star:
        pts = chip_smoke.wo_star(rng, w, h, n)
    else:
        pts = np.stack([rng.integers(-12, w + 12, n),
                        rng.integers(-12, h + 12, n)], 1).astype(np.int32)
    got = np.zeros((h, w), np.uint8)
    want = np.zeros((h, w), np.uint8)
    ip.fill_poly(got, pts, 3)
    cv2.fillPoly(want, [pts], 3)
    np.testing.assert_array_equal(got, want)


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 700), st.integers(1, 120), SEEDS,
       st.sampled_from([4, 5, 8, 12, 14]))
def test_undistort_maps_equal_cv2(w, h, seed, nd):
    rng = np.random.default_rng(seed)
    k = np.array([[rng.uniform(100, 900), 0, rng.uniform(0, w)],
                  [0, rng.uniform(100, 900), rng.uniform(0, h)], [0, 0, 1]])
    d = rng.uniform(-0.3, 0.3, nd) * np.array([1, 1, 0.01, 0.01]
                                              + [1] * (nd - 4))
    if nd == 14:
        d[12:] *= 0.1
    np.testing.assert_array_equal(ip.invert3x3(k), cv2.invert(
        k, flags=cv2.DECOMP_LU)[1])
    want = cv2.initUndistortRectifyMap(k, d, None, k, (w, h), cv2.CV_32FC1)
    got = ip.init_undistort_maps(k, d, (w, h))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@settings(max_examples=150, deadline=None)
@given(SIDES, SIDES, st.integers(1, 60), st.integers(1, 60), SEEDS,
       st.sampled_from([0, 3]))
def test_remap_linear_equals_cv2(h, w, th, tw, seed, c):
    rng = np.random.default_rng(seed)
    img = _image(h, w, seed, c)
    mx = rng.uniform(-3, w + 2, (th, tw)).astype(np.float32)
    my = rng.uniform(-3, h + 2, (th, tw)).astype(np.float32)
    np.testing.assert_array_equal(ip.remap_linear(img, mx, my),
                                  cv2.remap(img, mx, my, cv2.INTER_LINEAR))


def test_undistortion_of_a_frame_equals_cv2():
    """The pipeline's use: maps of a 1024-wide frame, the remap of it."""
    k = np.reshape(chip_smoke.WO_CAM_MATRIX, (3, 3))
    d = np.asarray(chip_smoke.WO_UNDISTORT)
    maps = ip.init_undistort_maps(k, d, (1024, 96))
    want = cv2.initUndistortRectifyMap(k, d, None, k, (1024, 96),
                                       cv2.CV_32FC1)
    for a, b in zip(maps, want):
        np.testing.assert_array_equal(a, b)
    img = _image(96, 1024, 3)
    np.testing.assert_array_equal(ip.remap_linear(img, *maps),
                                  cv2.remap(img, *want, cv2.INTER_LINEAR))


def _cv2_ops():
    def fill_poly(img, pts, color):
        cv2.fillPoly(img, [np.asarray(pts, np.int32)], color)
        return img

    return SimpleNamespace(
        box_blur=cv2.blur,
        gaussian_blur5=lambda img: cv2.GaussianBlur(img, (5, 5), 0),
        adaptive_threshold_gaussian=lambda img, mv, block, c:
            cv2.adaptiveThreshold(img, mv, cv2.ADAPTIVE_THRESH_GAUSSIAN_C,
                                  cv2.THRESH_BINARY, block, c),
        ellipse_element=lambda k: cv2.getStructuringElement(
            cv2.MORPH_ELLIPSE, k),
        erode=cv2.erode, dilate=cv2.dilate,
        close_rect=lambda m, k: cv2.morphologyEx(
            m, cv2.MORPH_CLOSE, np.ones((k, k), np.uint8)),
        dilate_rect=lambda m, k: cv2.dilate(m, np.ones((k, k), np.uint8)),
        erode_rect=lambda m, k: cv2.erode(m, np.ones((k, k), np.uint8)),
        contours_none=lambda m: list(cv2.findContours(
            m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)[0]),
        fill_poly=fill_poly,
        init_undistort_maps=lambda k, d, size: cv2.initUndistortRectifyMap(
            k, np.asarray(d, np.float64), None, k, size, cv2.CV_32FC1),
        remap_linear=lambda img, m1, m2: cv2.remap(img, m1, m2,
                                                   cv2.INTER_LINEAR),
        imread=lambda path, colour: cv2.imread(
            str(path), cv2.IMREAD_COLOR if colour else cv2.IMREAD_GRAYSCALE))


def _pinned_digests() -> dict:
    """chip_smoke.WO_DIGESTS as the file states it, read with ast."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "WO_DIGESTS"
                for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("chip_smoke.py defines no WO_DIGESTS")


def test_pinned_digests_are_cv2s(tmp_path):
    """Each digest chip_smoke.py holds the card's host build to is the
    sha256 of cv2 5.0.0's output on the same seeded input, and the
    port's output here gives it too."""
    pinned = _pinned_digests()
    inputs = chip_smoke.wo_digest_inputs(tmp_path)
    want = {k: chip_smoke.wo_digest(*v) for k, v in
            chip_smoke.wo_outputs(_cv2_ops(), inputs).items()}
    assert pinned == want
    got = {k: chip_smoke.wo_digest(*v) for k, v in
           chip_smoke.wo_outputs(chip_smoke.wo_port_ops(), inputs).items()}
    assert got == want
