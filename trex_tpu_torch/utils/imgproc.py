"""The OpenCV routines of the conversion pipeline's detection options, its
undistortion and the arena border, without OpenCV (the machine with the
card has none). Each equals what ``cv2`` 5.0.0 computes on an x86 host
with AVX2, bit for bit (``tests/test_torch_imgproc.py`` holds them to cv2
under hypothesis); the loops over whole frames are in
``native/imgproc.cpp``:

- :func:`box_blur` (``cv2.blur(img, ksize)``, 8 bits, the default
  ``BORDER_REFLECT_101``);
- :func:`gaussian_blur5` (``cv2.GaussianBlur(img, (5, 5), 0)``, 8 bits:
  OpenCV's fixed-point path);
- :func:`adaptive_threshold_gaussian` (``cv2.adaptiveThreshold(img, max,
  ADAPTIVE_THRESH_GAUSSIAN_C, THRESH_BINARY, block, c)``: OpenCV blurs a
  float32 copy, not the 8-bit image);
- :func:`ellipse_element`, :func:`erode` and :func:`dilate`
  (``cv2.getStructuringElement(MORPH_ELLIPSE, size)``, ``cv2.erode`` /
  ``cv2.dilate`` with it);
- :func:`erode_rect`, :func:`dilate_rect` and :func:`close_rect`
  (``cv2.erode`` / ``cv2.dilate`` / ``cv2.morphologyEx(MORPH_CLOSE)``
  with ``np.ones((k, k))``; the closing is ``track/posture.py``'s
  ``close_mask``, which :func:`rect_extreme` serves);
- :func:`fill_poly` (``cv2.fillPoly(img, [pts], color)``, one int32
  polygon);
- :func:`init_undistort_maps` (``cv2.initUndistortRectifyMap(K, D, None,
  K, size, CV_32FC1)``) and :func:`remap_linear` (``cv2.remap(img, map1,
  map2, INTER_LINEAR)`` on those float maps).

The contours of the border, ``cv2.findContours(RETR_EXTERNAL,
CHAIN_APPROX_NONE)``, are ``track/tag_image.py``'s
``find_contours_external(mask, every_point=True)``.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)


def _lib():
    from ..ops.labeling import _lib as lib

    return lib()


def _u8(img) -> np.ndarray:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"expected an 8-bit image, got {img.dtype}")
    return img


def _ptr(a, kind):
    return a.ctypes.data_as(kind)


def _gray(img) -> np.ndarray:
    img = _u8(img)
    if img.ndim != 2:
        raise ValueError(f"expected a 2-D image, got {img.shape}")
    return img


def box_blur(img, ksize) -> np.ndarray:
    """``cv2.blur(img, (kw, kh))`` of a 2-D 8-bit image: the box mean
    over a ``BORDER_REFLECT_101`` border, rounded to nearest (OpenCV's
    float scale rounds the same for kernels of fewer than 16600
    pixels)."""
    img = _gray(img)
    kw, kh = (int(v) for v in ksize)
    if kw < 1 or kh < 1:
        raise ValueError(f"kernel size {ksize} must be positive")
    h, w = img.shape
    out = np.empty_like(img)
    if img.size:
        _lib().trex_box_blur_u8(_ptr(img, _u8p), h, w, kw, kh,
                                _ptr(out, _u8p))
    return out


def gaussian_blur5(img) -> np.ndarray:
    """``cv2.GaussianBlur(img, (5, 5), 0)`` of a 2-D 8-bit image: the
    taps ``[1, 4, 6, 4, 1] / 16`` a pass in OpenCV's bit-exact fixed
    point, ``BORDER_REFLECT_101``, the sum rounded half up."""
    img = _gray(img)
    h, w = img.shape
    out = np.empty_like(img)
    if img.size:
        _lib().trex_gaussian5_u8(_ptr(img, _u8p), h, w, _ptr(out, _u8p))
    return out


def gaussian_kernel(n: int) -> np.ndarray:
    """``cv2.getGaussianKernel(n, 0, ktype=CV_32F)`` for odd n >= 11 (below
    that OpenCV takes a table): ``exp(-x^2 / (2 sigma^2))`` in double with
    sigma = 0.3 ((n - 1) / 2 - 1) + 0.8, each divided by their sum,
    rounded to float32."""
    n = int(n)
    if n < 11 or n % 2 == 0:
        raise ValueError(f"kernel size {n} must be odd and at least 11")
    sigma = 0.3 * ((n - 1) * 0.5 - 1) + 0.8
    scale = -0.5 / (sigma * sigma)
    t = [math.exp(scale * (i - (n - 1) * 0.5) ** 2) for i in range(n)]
    total = sum(t)
    return np.asarray([v / total for v in t], np.float32)


def adaptive_threshold_gaussian(img, max_value, block: int,
                                c: float) -> np.ndarray:
    """``cv2.adaptiveThreshold(img, max_value, ADAPTIVE_THRESH_GAUSSIAN_C,
    THRESH_BINARY, block, c)`` for the pipeline's blocks (odd, at least
    15): the mean is OpenCV's float32 ``GaussianBlur((block, block), 0,
    BORDER_REPLICATE | BORDER_ISOLATED)`` of the image rounded half to
    even, and a pixel is `max_value` where ``src - mean > -ceil(c)``."""
    img = _gray(img)
    block = int(block)
    if block < 15 or block % 2 == 0:
        raise ValueError(f"block size {block} must be odd and at least 15")
    h, w = img.shape
    out = np.empty_like(img)
    if not img.size:
        return out
    kernel = gaussian_kernel(block)
    mv = int(max(0, min(255, round(float(max_value)))))
    _lib().trex_adaptive_gaussian_u8(
        _ptr(img, _u8p), h, w, block, _ptr(kernel, _f32p),
        int(math.ceil(float(c))), mv, _ptr(out, _u8p))
    return out


def ellipse_element(ksize) -> np.ndarray:
    """``cv2.getStructuringElement(MORPH_ELLIPSE, (kw, kh))``: row i holds
    the run ``c +- saturate_cast<int>(c sqrt((r^2 - dy^2) / r^2))``, r =
    kh // 2, c = kw // 2, dy = i - r, clipped to the element."""
    kw, kh = (int(v) for v in ksize)
    r, c = kh // 2, kw // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    e = np.zeros((kh, kw), np.uint8)
    for i in range(kh):
        dy = i - r
        if abs(dy) <= r:
            # saturate_cast<int>: to nearest, ties to even
            dx = int(round(c * math.sqrt((r * r - dy * dy) * inv_r2)))
            e[i, max(c - dx, 0):min(c + dx + 1, kw)] = 1
    return e


def _runs(element):
    """The element's rows as (offset from the anchor row, first and last
    offset from the anchor column) of one run each, the anchor at the
    centre; raises unless each run, narrowest first, holds the one
    before (an ellipse's rows do)."""
    e = np.asarray(element, np.uint8)
    kh, kw = e.shape
    ax, ay = kw // 2, kh // 2
    rows = []
    for i in range(kh):
        nz = np.flatnonzero(e[i])
        if not len(nz):
            continue
        lo, hi = int(nz[0]), int(nz[-1])
        if hi - lo + 1 != len(nz) or not lo <= ax <= hi:
            raise ValueError("the element must hold one run a row through "
                             "its anchor column")
        rows.append((i - ay, lo - ax, hi - ax))
    nested = sorted(rows, key=lambda r: r[2] - r[1])
    for (_, lo0, hi0), (_, lo1, hi1) in zip(nested, nested[1:]):
        if lo1 > lo0 or hi1 < hi0:
            raise ValueError("each row's run must hold the narrower ones")
    return rows


def _morph(img, rows, dilate: bool) -> np.ndarray:
    img = _gray(img)
    h, w = img.shape
    out = np.empty_like(img)
    if not img.size:
        return out
    if not rows:
        # an empty element leaves every pixel at the neutral value
        out[:] = 0 if dilate else 255
        return out
    dy, lo, hi = (np.ascontiguousarray(v, np.int32) for v in zip(*rows))
    _lib().trex_morph_runs_u8(_ptr(img, _u8p), h, w, _ptr(dy, _i32p),
                              _ptr(lo, _i32p), _ptr(hi, _i32p), len(dy),
                              1 if dilate else 0, _ptr(out, _u8p))
    return out


def erode(img, element) -> np.ndarray:
    """``cv2.erode(img, element)`` with an element of one run a row
    through its centre (such as :func:`ellipse_element`'s), the anchor
    at the centre: the minimum over the element, pixels outside the
    image neutral (an erode never eats in from the frame's edge)."""
    return _morph(img, _runs(element), False)


def dilate(img, element) -> np.ndarray:
    """``cv2.dilate(img, element)`` with an element of one run a row
    through its centre, the anchor at the centre: the maximum over the
    element, pixels outside the image neutral."""
    return _morph(img, _runs(element), True)


def rect_extreme(img, lo: int, hi: int, dilate: bool) -> np.ndarray:
    """The maximum (`dilate`) or minimum over the window [y + lo, y + hi]
    x [x + lo, x + hi] of every pixel (lo <= 0 <= hi), pixels outside the
    image neutral: ``cv2.dilate`` / ``cv2.erode`` with ``hi - lo + 1``
    square ones anchored at ``-lo``."""
    if not lo <= 0 <= hi:
        raise ValueError(f"window [{lo}, {hi}] must hold 0")
    return _morph(img, [(d, lo, hi) for d in range(lo, hi + 1)], dilate)


def _rect(k: int):
    k = int(k)
    if k < 1:
        raise ValueError(f"kernel size {k} must be positive")
    return -(k // 2), k - 1 - k // 2


def dilate_rect(img, k: int) -> np.ndarray:
    """``cv2.dilate(img, np.ones((k, k), np.uint8))``, even k included
    (the anchor at k // 2)."""
    return rect_extreme(img, *_rect(k), True)


def erode_rect(img, k: int) -> np.ndarray:
    """``cv2.erode(img, np.ones((k, k), np.uint8))``, even k included."""
    return rect_extreme(img, *_rect(k), False)


def close_rect(img, k: int) -> np.ndarray:
    """``cv2.morphologyEx(img, MORPH_CLOSE, np.ones((k, k), np.uint8))``:
    ``track/posture.py``'s ``close_mask`` with one step."""
    from ..track.posture import close_mask

    _rect(k)
    return close_mask(_gray(img), 1, int(k))


def fill_poly(img, pts, color: int) -> np.ndarray:
    """``cv2.fillPoly(img, [pts], color)`` of one int32 polygon on a 2-D
    8-bit image, in place (``LINE_8``, shift 0); returns the image.
    OpenCV draws each edge with its clipped 8-connected line, then fills
    scan lines from its edge table with 16-bit fixed-point x."""
    if not (isinstance(img, np.ndarray) and img.dtype == np.uint8
            and img.ndim == 2 and img.flags.c_contiguous):
        raise ValueError("fill_poly draws into a C-contiguous 2-D uint8 "
                         "array")
    p = np.ascontiguousarray(np.asarray(pts).reshape(-1, 2), np.int32)
    h, w = img.shape
    _lib().trex_fill_poly_u8(_ptr(img, _u8p), h, w, _ptr(p, _i32p), len(p),
                             int(color) & 255)
    return img


def invert3x3(m) -> np.ndarray:
    """``cv::invert(m, DECOMP_LU)`` of a 3x3 double matrix: OpenCV's
    closed form (cofactors times the reciprocal determinant)."""
    s = np.asarray(m, np.float64).reshape(3, 3)
    a = [[float(v) for v in row] for row in s]
    d = (a[0][0] * (a[1][1] * a[2][2] - a[1][2] * a[2][1])
         - a[0][1] * (a[1][0] * a[2][2] - a[1][2] * a[2][0])
         + a[0][2] * (a[1][0] * a[2][1] - a[1][1] * a[2][0]))
    if d == 0.0:
        raise ValueError("the camera matrix is singular")
    d = 1.0 / d
    t = [(a[1][1] * a[2][2] - a[1][2] * a[2][1]) * d,
         (a[0][2] * a[2][1] - a[0][1] * a[2][2]) * d,
         (a[0][1] * a[1][2] - a[0][2] * a[1][1]) * d,
         (a[1][2] * a[2][0] - a[1][0] * a[2][2]) * d,
         (a[0][0] * a[2][2] - a[0][2] * a[2][0]) * d,
         (a[0][2] * a[1][0] - a[0][0] * a[1][2]) * d,
         (a[1][0] * a[2][1] - a[1][1] * a[2][0]) * d,
         (a[0][1] * a[2][0] - a[0][0] * a[2][1]) * d,
         (a[0][0] * a[1][1] - a[0][1] * a[1][0]) * d]
    return np.asarray(t, np.float64).reshape(3, 3)


def init_undistort_maps(camera_matrix, dist, size):
    """``cv2.initUndistortRectifyMap(K, D, None, K, (w, h), CV_32FC1)``:
    the (h, w) float32 x and y maps. `dist` holds 4, 5, 8, 12 or 14
    terms (k1, k2, p1, p2[, k3[, k4, k5, k6[, s1..s4[, tau_x, tau_y]]]]),
    as cv2 accepts them."""
    k = np.ascontiguousarray(np.asarray(camera_matrix, np.float64)
                             .reshape(3, 3))
    d = np.ascontiguousarray(np.asarray(dist, np.float64).ravel())
    if len(d) not in (4, 5, 8, 12, 14):
        raise ValueError(f"distortion vector of {len(d)} terms: cv2 takes "
                         "4, 5, 8, 12 or 14")
    w, h = (int(v) for v in size)
    ir = np.ascontiguousarray(invert3x3(k))
    m1 = np.empty((h, w), np.float32)
    m2 = np.empty((h, w), np.float32)
    _lib().trex_undistort_maps_f32(_ptr(k, _f64p), _ptr(ir, _f64p),
                                   _ptr(d, _f64p), len(d), w, h,
                                   _ptr(m1, _f32p), _ptr(m2, _f32p))
    return m1, m2


def remap_linear(img, map1, map2) -> np.ndarray:
    """``cv2.remap(img, map1, map2, INTER_LINEAR)`` of a 1- or 3-channel
    8-bit image on float32 maps: OpenCV 5's float bilinear (three fused
    multiply-adds, rounded half to even), taps outside the image reading
    0 (``BORDER_CONSTANT``)."""
    img = _u8(img)
    if img.ndim == 2:
        cn = 1
    elif img.ndim == 3 and img.shape[2] in (1, 3):
        cn = img.shape[2]
    else:
        raise ValueError(f"remap_linear takes 1 or 3 channels, not "
                         f"{img.shape}")
    m1 = np.ascontiguousarray(map1, np.float32)
    m2 = np.ascontiguousarray(map2, np.float32)
    if m1.shape != m2.shape or m1.ndim != 2:
        raise ValueError("the maps must be two 2-D arrays of one shape")
    h, w = img.shape[:2]
    dh, dw = m1.shape
    out = np.empty((dh, dw) + img.shape[2:], np.uint8)
    _lib().trex_remap_linear_u8(_ptr(img, _u8p), h, w, cn, _ptr(m1, _f32p),
                                _ptr(m2, _f32p), dh, dw, _ptr(out, _u8p))
    return out
