"""The nine OpenCV routines of tag detection, rebuilt bit for bit.

``track/tags.py`` decides which blobs are tags through OpenCV; the port
takes none of it. Each routine here equals what ``cv2`` 5.0.0 computes
on 8-bit single-channel images, bit for bit
(``tests/test_torch_tag_image.py`` holds them to cv2 under hypothesis):

- :func:`resize_area` (``cv2.resize(..., INTER_AREA)``) in its three
  regimes: upscaling through linear interpolation with the area
  coefficients in fixed point, integer factors through the block mean
  (``(sum + 2) >> 2`` for a factor of 2, as OpenCV's vector path rounds
  it), other downscales through float32 area weights;
- :func:`resize_nearest` (``INTER_NEAREST``);
- :func:`laplacian` (``cv2.Laplacian(img, CV_64F)``, the 4-neighbour
  kernel, ``BORDER_REFLECT_101``) and :func:`erode3` (a 3x3 box, the
  border never erodes);
- :func:`equalize_hist` and :func:`adaptive_threshold_mean`
  (``ADAPTIVE_THRESH_MEAN_C``, a replicated border);
- :func:`find_contours_external` (``RETR_EXTERNAL``,
  ``CHAIN_APPROX_SIMPLE``), :func:`contour_area`, :func:`arc_length`
  and :func:`approx_poly_dp`: Suzuki's border following, the shoelace
  sum, OpenCV's batched float32 square roots and its Douglas-Peucker,
  in C++ (``native/contours.cpp``, built into the host library of
  ``ops/labeling.py``).

The detection path's routines live here too (``detect/yolo.py``,
``detect/base.py``, ``track/posture.py``; held in
``tests/test_torch_detect_cv.py``): :func:`resize_linear`
(``INTER_LINEAR``, 8-bit with 1 and 3 channels, and float32 with one,
OpenCV's IPP path), :func:`bgr_to_gray` and
:func:`gray_to_bgr` (``cvtColor``) and :func:`fill_circle`
(``cv2.circle`` filled).

The array routines are numpy; the arithmetic follows OpenCV's types
(float32 weights and products, round half to even).
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _u8(img) -> np.ndarray:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"expected a 2-D uint8 image, got {img.dtype} "
                         f"{img.shape}")
    return img


def _rint_u8(x: np.ndarray) -> np.ndarray:
    """``saturate_cast<uchar>`` of a float: round half to even, clamp."""
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


# --------------------------------------------------------------------------
# resize
# --------------------------------------------------------------------------

def resize_nearest(img, size) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=INTER_NEAREST)``: source
    index ``min(floor(d * scale), src - 1)`` in double, where OpenCV's
    scale is ``1 / (dst / src)``."""
    img = _u8(img)
    w, h = int(size[0]), int(size[1])
    sh, sw = img.shape
    xs = np.minimum(np.floor(np.arange(w) * _scale(sw, w)).astype(
        np.int64), sw - 1)
    ys = np.minimum(np.floor(np.arange(h) * _scale(sh, h)).astype(
        np.int64), sh - 1)
    return img[ys[:, None], xs[None, :]]


def _scale(ssize: int, dsize: int, inv: float = None) -> float:
    """OpenCV's source step a destination pixel, ``1 / inv`` with `inv`
    the resize factor, ``dst / src`` when the caller gives the size
    (which can differ from ``src / dst`` in the last bit)."""
    return 1.0 / (dsize / ssize if inv is None else inv)


def _frozen(a: np.ndarray) -> np.ndarray:
    """A cached table, read-only: every caller gets the same array."""
    a.flags.writeable = False
    return a


@lru_cache(maxsize=512)
def _area_tab(ssize: int, dsize: int, inv: float = None) -> tuple:
    """OpenCV's computeResizeAreaTab: (dst index, src index, float32
    weight) in its order."""
    scale = _scale(ssize, dsize, inv)
    tab = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1 = int(np.ceil(fsx1))
        sx2 = int(np.floor(fsx2))
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            tab.append((dx, sx1 - 1, np.float32((sx1 - fsx1) / cell)))
        for sx in range(sx1, sx2):
            tab.append((dx, sx, np.float32(1.0 / cell)))
        if fsx2 - sx2 > 1e-3:
            tab.append((dx, sx2, np.float32(
                min(min(fsx2 - sx2, 1.0), cell) / cell)))
    return tuple(tab)


@lru_cache(maxsize=512)
def _area_taps(ssize: int, dsize: int, inv: float = None) -> tuple:
    """The area table as k-th tap arrays: (index, weight, present), each
    (max taps, dsize)."""
    taps: list[list] = [[] for _ in range(dsize)]
    for d, s, a in _area_tab(ssize, dsize, inv):
        taps[d].append((s, a))
    n = max(len(t) for t in taps)
    idx = np.array([[t[k][0] if k < len(t) else 0 for t in taps]
                    for k in range(n)])
    alpha = np.array([[t[k][1] if k < len(t) else 0 for t in taps]
                      for k in range(n)], np.float32)
    has = np.array([[k < len(t) for t in taps] for k in range(n)])
    return _frozen(idx), _frozen(alpha), _frozen(has)


def _area_rows(src: np.ndarray, dsize: int, inv: float = None
               ) -> np.ndarray:
    """Apply the area table along the last axis: each output element adds
    its taps in table order, in float32."""
    idx, alpha, has = _area_taps(src.shape[-1], dsize, inv)
    out = np.zeros(src.shape[:-1] + (dsize,), np.float32)
    for k in range(len(idx)):
        term = src[..., idx[k]].astype(np.float32) * alpha[k]
        out = np.where(has[k], out + term, out)
    return out


def _area_cols(rows: np.ndarray, dsize: int, inv: float = None
               ) -> np.ndarray:
    """The vertical pass: each output row is beta0 * row0, then
    ``+= beta_j * row_j`` in table order, in float32."""
    out = np.zeros((dsize,) + rows.shape[1:], np.float32)
    seen = set()
    for d, s, b in _area_tab(rows.shape[0], dsize, inv):
        term = np.float32(b) * rows[s]
        if d in seen:
            out[d] = out[d] + term
        else:
            out[d] = term
            seen.add(d)
    return out


@lru_cache(maxsize=512)
def _linear_coefs(ssize: int, dsize: int, inv: float = None,
                  clamp: bool = True):
    """Source index and fixed-point weights of the linear resize with
    OpenCV's area coefficients (``INTER_AREA`` when upscaling), and the
    index bounds [xmin, xmax) of the two-tap outputs. OpenCV clamps a
    column's index and weight at the right edge (`clamp`), not a row's:
    a last row past the source keeps its weight on the clamped rows."""
    inv = dsize / ssize if inv is None else inv
    scale = 1.0 / inv
    xmin, xmax = 0, dsize
    ofs = np.zeros(dsize, np.int64)
    coef = np.zeros((dsize, 2), np.int64)
    for dx in range(dsize):
        sx = int(np.floor(dx * scale))
        fx = np.float32((dx + 1) - (sx + 1) * inv)
        fx = np.float32(0.0) if fx <= 0 else \
            np.float32(fx - np.float32(np.floor(fx)))
        if sx < 0 and clamp:
            xmin = dx + 1
            fx, sx = np.float32(0.0), 0
        if sx + 1 >= ssize and clamp:
            xmax = min(xmax, dx)
            if sx >= ssize - 1:
                fx, sx = np.float32(0.0), ssize - 1
        ofs[dx] = sx
        c = (np.float32(1.0) - fx, fx)
        coef[dx] = [int(np.rint(np.float32(v) * np.float32(_COEF_SCALE)))
                    for v in c]
    return _frozen(ofs), _frozen(coef), xmin, xmax


def _resize_taps(img: np.ndarray, xofs, alpha, xmax, yofs, beta
                 ) -> np.ndarray:
    """The two fixed-point passes of OpenCV's 8-bit linear resize over an
    (H, W) or (H, W, C) image: horizontal taps (a single tap times ONE
    from ``xmax`` on), then the vertical ``VResizeLinear`` cast of its
    vector path, over source rows clamped to the image."""
    sh, sw = img.shape[:2]
    src = img.astype(np.int32).reshape(sh, sw, -1)
    w, h = len(xofs), len(yofs)
    x1 = np.minimum(xofs + 1, sw - 1)
    a = alpha.astype(np.int32)
    rows = src[:, xofs] * a[None, :, :1] + src[:, x1] * a[None, :, 1:]
    one = np.arange(w) >= xmax
    rows[:, one] = src[:, xofs[one]] * _COEF_SCALE
    r0 = rows[np.clip(yofs, 0, sh - 1)] >> 4
    r1 = rows[np.clip(yofs + 1, 0, sh - 1)] >> 4
    b = beta.astype(np.int32)
    v = ((b[:, :1, None] * r0) >> 16) + ((b[:, 1:, None] * r1) >> 16) + 2
    out = np.clip(v >> 2, 0, 255).astype(np.uint8)
    return out.reshape((h, w) + img.shape[2:])


def _resize_linear_area(img: np.ndarray, w: int, h: int, inv_x=None,
                        inv_y=None) -> np.ndarray:
    sh, sw = img.shape
    xofs, alpha, _xmin, xmax = _linear_coefs(sw, w, inv_x)
    yofs, beta, _, _ = _linear_coefs(sh, h, inv_y, clamp=False)
    return _resize_taps(img, xofs, alpha, xmax, yofs, beta)


@lru_cache(maxsize=512)
def _float_coefs(ssize: int, dsize: int, clamp: bool):
    """Source index and float32 weights ``(1 - fx, fx)`` of OpenCV's
    ``INTER_LINEAR``: the source coordinate ``float((d + 0.5) * scale -
    0.5)``. Horizontally (`clamp`) a coordinate before the first pixel
    takes it whole and one past the last takes the last, with the bound
    ``xmax`` of the two-tap outputs; vertically the index and weight stay
    and the rows are clamped when read."""
    scale = _scale(ssize, dsize)
    xmax = dsize
    ofs = np.zeros(dsize, np.int64)
    coef = np.zeros((dsize, 2), np.float32)
    for d in range(dsize):
        fx = np.float32((d + 0.5) * scale - 0.5)
        sx = int(np.floor(fx))
        fx = np.float32(fx - np.float32(sx))
        if clamp:
            if sx < 0:
                fx, sx = np.float32(0.0), 0
            if sx + 1 >= ssize:
                xmax = min(xmax, d)
                if sx >= ssize - 1:
                    fx, sx = np.float32(0.0), ssize - 1
        ofs[d] = sx
        coef[d] = (np.float32(1.0) - fx, fx)
    return _frozen(ofs), _frozen(coef), xmax


@lru_cache(maxsize=512)
def _bilinear_coefs(ssize: int, dsize: int, clamp: bool):
    """:func:`_float_coefs` with the weights in 11-bit fixed point (the
    8-bit path's)."""
    ofs, coef, xmax = _float_coefs(ssize, dsize, clamp)
    fixed = np.rint(coef * np.float32(_COEF_SCALE)).astype(np.int64)
    return ofs, _frozen(fixed), xmax


def resize_linear(img, size) -> np.ndarray:
    """``cv2.resize(img, (w, h))`` (``INTER_LINEAR``) of an 8-bit image
    with 1 or 3 channels or of a float32 image with one channel.

    The same size is a copy, as OpenCV makes it. 8-bit: 11-bit weights,
    the vector path's vertical cast; an exact halving is the 2x2 block
    mean, as OpenCV takes ``INTER_AREA`` there. float32:
    :func:`_resize_linear_f32`."""
    img = np.ascontiguousarray(img)
    if img.dtype == np.float32 and img.ndim == 2:
        return _resize_linear_f32(img[None], size)[0]
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"expected an 8-bit image or a one-channel "
                         f"float32 one, got {img.dtype} {img.shape}")
    w, h = int(size[0]), int(size[1])
    sh, sw = img.shape[:2]
    if (sw, sh) == (w, h):  # OpenCV copies
        return img.copy()
    if sw == 2 * w and sh == 2 * h:
        blocks = img[:2 * h, :2 * w].astype(np.int32).reshape(
            (h, 2, w, 2) + img.shape[2:]).sum(axis=(1, 3))
        return ((blocks + 2) >> 2).astype(np.uint8)
    xofs, alpha, xmax = _bilinear_coefs(sw, w, True)
    yofs, beta, _ = _bilinear_coefs(sh, h, False)
    return _resize_taps(img, xofs, alpha, xmax, yofs, beta)


@lru_cache(maxsize=512)
def _lerp_taps(ssize: int, dsize: int) -> tuple:
    """The float32 resize's taps along one axis: source coordinate
    ``(d + 0.5) * (src / dst) - 0.5`` in double, left and right indices
    clamped to the image, and the fraction rounded to float32."""
    fx = (np.arange(dsize) + 0.5) * (ssize / dsize) - 0.5
    i0 = np.floor(fx)
    t = (fx - i0).astype(np.float32)
    i0 = i0.astype(np.int64)
    a = np.clip(i0, 0, ssize - 1).astype(np.int32)
    b = np.clip(i0 + 1, 0, ssize - 1).astype(np.int32)
    return _frozen(a), _frozen(b), _frozen(t)


def _resize_linear_f32(imgs: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, (w, h))`` of each float32 image of the stack
    `imgs` (N, H, W), as OpenCV 5.0.0 computes it.

    With both source sides at least 2 its Intel IPP layer takes the call:
    a lerp ``a + (b - a) * t`` with one fused multiply-add, along the rows
    first, then along the columns, on :func:`_lerp_taps` (an exact halving
    too); in C++ (``native/resize.cpp``, ``std::fma``). A source with a
    side of 1 takes OpenCV's own path: float32 weights from the float
    coordinate, ``s0 * (1 - fx) + s1 * fx`` without fusion, rows clamped
    when read."""
    imgs = np.ascontiguousarray(imgs, np.float32)
    w, h = int(size[0]), int(size[1])
    n, sh, sw = imgs.shape
    if (sw, sh) == (w, h):  # OpenCV copies
        return imgs.copy()
    if sh < 2 or sw < 2:
        return _resize_linear_f32_generic(imgs, w, h)
    x0, x1, tx = _lerp_taps(sw, w)
    y0, y1, ty = _lerp_taps(sh, h)
    out = np.empty((n, h, w), np.float32)
    if n == 0 or h == 0 or w == 0:
        return out
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    _native().trex_resize_linear_f32(
        imgs.ctypes.data_as(f32p), n, sh, sw, x0.ctypes.data_as(i32p),
        x1.ctypes.data_as(i32p), tx.ctypes.data_as(f32p),
        y0.ctypes.data_as(i32p), y1.ctypes.data_as(i32p),
        ty.ctypes.data_as(f32p), h, w, out.ctypes.data_as(f32p))
    return out


def _resize_linear_f32_generic(imgs: np.ndarray, w: int, h: int
                               ) -> np.ndarray:
    n, sh, sw = imgs.shape
    xofs, alpha, xmax = _float_coefs(sw, w, True)
    yofs, beta, _ = _float_coefs(sh, h, False)
    x1 = np.minimum(xofs + 1, sw - 1)
    rows = imgs[:, :, xofs] * alpha[:, 0] + imgs[:, :, x1] * alpha[:, 1]
    rows[:, :, xmax:] = imgs[:, :, xofs[xmax:]]
    r0 = rows[:, np.clip(yofs, 0, sh - 1)]
    r1 = rows[:, np.clip(yofs + 1, 0, sh - 1)]
    return (r0 * beta[:, :1] + r1 * beta[:, 1:]).astype(np.float32)


def resize_area(img, size, fx: float = None, fy: float = None
                ) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=INTER_AREA)``; with `size`
    None, ``cv2.resize(img, None, fx=fx, fy=fy, interpolation=
    INTER_AREA)``: the destination is ``fx * width`` by ``fy * height``
    rounded half to even (OpenCV's ``saturate_cast<int>``), the source
    step ``1 / fx``, and a destination of the source's size is a copy.
    Each channel of an (H, W, C) image is resized on its own, as OpenCV
    computes it."""
    img = np.ascontiguousarray(img)
    if img.ndim == 3:
        return np.stack([resize_area(img[..., c], size, fx, fy)
                         for c in range(img.shape[2])], axis=-1)
    img = _u8(img)
    sh, sw = img.shape
    if size is None:
        w, h = round(sw * fx), round(sh * fy)
        if not (w > 0 and h > 0):
            raise ValueError(f"{sw}x{sh} scaled by ({fx}, {fy}) is empty")
        if (w, h) == (sw, sh):
            return img.copy()
    else:
        w, h = int(size[0]), int(size[1])
        fx = fy = None
    scale_x, scale_y = _scale(sw, w, fx), _scale(sh, h, fy)
    if scale_x < 1 or scale_y < 1:
        return _resize_linear_area(img, w, h, fx, fy)
    ix, iy = int(round(scale_x)), int(round(scale_y))
    eps = np.finfo(np.float64).eps
    if abs(scale_x - ix) < eps and abs(scale_y - iy) < eps:
        return _area_fast(img, w, h, ix, iy)
    return _rint_u8(_area_cols(_area_rows(img, w, fx), h, fy))


def _area_fast(img: np.ndarray, w: int, h: int, ix: int, iy: int
               ) -> np.ndarray:
    """OpenCV's integer-factor area resize: a whole ix x iy block is its
    sum times ``float32(1 / (ix * iy))`` (``(sum + 2) >> 2`` for 2 x 2,
    its vector path), a block cut by the image's right or bottom edge
    ``float32(sum) / float32(count)`` of the pixels inside."""
    sh, sw = img.shape
    pad = np.zeros((h * iy, w * ix), np.int64)
    ch, cw = min(sh, h * iy), min(sw, w * ix)
    pad[:ch, :cw] = img[:ch, :cw]
    inside = np.zeros_like(pad)
    inside[:ch, :cw] = 1
    sums = pad.reshape(h, iy, w, ix).sum(axis=(1, 3))
    counts = inside.reshape(h, iy, w, ix).sum(axis=(1, 3))
    if ix == 2 and iy == 2:
        out = ((sums + 2) >> 2).astype(np.uint8)
    else:
        out = _rint_u8(sums.astype(np.float32)
                       * (np.float32(1.0) / np.float32(ix * iy)))
    cut = np.ones((h, w), bool)
    cut[:sh // iy, :sw // ix] = False
    part = _rint_u8(sums.astype(np.float32)
                    / np.maximum(counts, 1).astype(np.float32))
    return np.where(cut, part, out)


# --------------------------------------------------------------------------
# filters
# --------------------------------------------------------------------------

def laplacian(img) -> np.ndarray:
    """``cv2.Laplacian(img, cv2.CV_64F)``: ksize 1, the 4-neighbour
    kernel over a ``BORDER_REFLECT_101`` border; exact integers."""
    img = _u8(img).astype(np.float64)
    p = np.pad(img, 1, mode="reflect") if min(img.shape) > 1 else \
        np.pad(img, 1, mode="edge")
    return (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
            - 4.0 * img)


def erode3(mask) -> np.ndarray:
    """``cv2.erode(mask, np.ones((3, 3), np.uint8))``: the 3x3 minimum,
    the border at the type's maximum so that it never erodes."""
    m = _u8(mask)
    p = np.pad(m, 1, constant_values=255)
    h, w = m.shape
    out = p[1:h + 1, 1:w + 1].copy()
    for dy in range(3):
        for dx in range(3):
            np.minimum(out, p[dy:dy + h, dx:dx + w], out=out)
    return out


def equalize_hist(img) -> np.ndarray:
    """``cv2.equalizeHist``: the LUT ``rint(float32(cdf - hist[first]) *
    float32(255 / (total - hist[first])))``, zero up to the first
    non-empty bin; a one-valued image maps to itself."""
    img = _u8(img)
    hist = np.bincount(img.ravel(), minlength=256)
    first = int(np.flatnonzero(hist)[0]) if img.size else 0
    total = img.size
    if img.size == 0 or hist[first] == total:
        return img.copy()
    scale = np.float32(255.0) / np.float32(total - hist[first])
    cdf = np.cumsum(hist) - hist[first]
    lut = _rint_u8(cdf.astype(np.float32) * scale)
    lut[:first + 1] = 0
    return lut[img]


def adaptive_threshold_mean(img, max_value: int, inverse: bool,
                            block: int, c: float) -> np.ndarray:
    """``cv2.adaptiveThreshold(img, max_value, ADAPTIVE_THRESH_MEAN_C,
    THRESH_BINARY(_INV), block, c)``: the mean is the rounded box mean
    over a replicated border; a pixel is set where ``src - mean > -c``
    (``<=`` for the inverse)."""
    img = _u8(img)
    r = block // 2
    p = np.pad(img.astype(np.int64), r, mode="edge")
    cs = np.zeros((p.shape[0] + 1, p.shape[1] + 1), np.int64)
    cs[1:, 1:] = p.cumsum(0).cumsum(1)
    h, w = img.shape
    box = (cs[block:block + h, block:block + w] - cs[:h, block:block + w]
           - cs[block:block + h, :w] + cs[:h, :w])
    mean = _rint_u8(box.astype(np.float32)
                    * np.float32(1.0 / (block * block)))
    idelta = int(np.floor(c)) if inverse else int(np.ceil(c))
    diff = img.astype(np.int64) - mean.astype(np.int64)
    hit = diff <= -idelta if inverse else diff > -idelta
    return np.where(hit, np.uint8(max(0, min(255, round(max_value)))),
                    np.uint8(0)).astype(np.uint8)


# --------------------------------------------------------------------------
# colour and drawing
# --------------------------------------------------------------------------

# OpenCV 5's 15-bit luma weights of B, G and R (0.114, 0.587, 0.299)
_GRAY_BGR = (3735, 19235, 9798)


def bgr_to_gray(img) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_BGR2GRAY)`` of an 8-bit BGR image:
    ``(3735 b + 19235 g + 9798 r + 2^14) >> 15``."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an 8-bit BGR image, got {img.dtype} "
                         f"{img.shape}")
    i = img.astype(np.int32)
    cb, cg, cr = _GRAY_BGR
    return ((i[..., 0] * cb + i[..., 1] * cg + i[..., 2] * cr + (1 << 14))
            >> 15).astype(np.uint8)


def gray_to_bgr(img) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_GRAY2BGR)``: the value in each channel."""
    img = _u8(img)
    return np.repeat(img[..., None], 3, axis=-1)


def fill_circle(img, center, radius: int, value: int) -> np.ndarray:
    """``cv2.circle(img, center, radius, value, -1)`` on a 2-D 8-bit
    image, in place; returns it. OpenCV's integer midpoint walk: each
    step fills four rows' spans (inclusive), clipped to the image."""
    cx, cy = int(center[0]), int(center[1])
    r = int(radius)
    if r < 0:
        raise ValueError("radius must be >= 0")
    h, w = img.shape[:2]
    err, dx, dy, plus, minus = 0, r, 0, 1, (r << 1) - 1
    while dx >= dy:
        for y, half in ((cy - dy, dx), (cy + dy, dx), (cy - dx, dy),
                        (cy + dx, dy)):
            x0, x1 = max(cx - half, 0), min(cx + half, w - 1)
            if 0 <= y < h and x0 <= x1:
                img[y, x0:x1 + 1] = value
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return img


# --------------------------------------------------------------------------
# contours (native/contours.cpp)
# --------------------------------------------------------------------------

def _native():
    from ..ops.labeling import _lib

    return _lib()


def find_contours_external(mask, every_point: bool = False) -> list:
    """``cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)[0]``
    (``CHAIN_APPROX_NONE`` with `every_point`): the outer borders, each an
    (N, 1, 2) int32 array, in OpenCV's order and from its start point."""
    m = _u8(mask)
    h, w = m.shape
    if h == 0 or w == 0:
        return []
    lib = _native()
    cap = 4 * (h + 2) * (w + 2) + 16
    pts = np.empty((cap, 2), np.int32)
    starts = np.empty(h * w + 2, np.int64)
    n = lib.trex_find_contours_external(
        m.ctypes.data_as(ctypes.c_char_p), h, w,
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        1 if every_point else 0)
    if n < 0:
        raise RuntimeError("find_contours_external: point buffer too small")
    return [pts[starts[i]:starts[i + 1]].reshape(-1, 1, 2).copy()
            for i in range(n)]


def _points(contour) -> np.ndarray:
    c = np.ascontiguousarray(np.asarray(contour, np.int32).reshape(-1, 2))
    return c


def contour_area(contour) -> float:
    """``cv2.contourArea(contour)`` (not oriented) of integer points."""
    c = _points(contour)
    return float(_native().trex_contour_area(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(c)))


def arc_length(contour, closed: bool = True) -> float:
    """``cv2.arcLength``: float32 square roots of float32 squared edge
    lengths, taken in batches of 16 and added into a double in reverse
    order within each batch."""
    c = _points(contour)
    return float(_native().trex_arc_length(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(c),
        1 if closed else 0))


def approx_poly_dp(contour, epsilon: float, closed: bool = True
                   ) -> np.ndarray:
    """``cv2.approxPolyDP`` of integer points: the start point search,
    Douglas-Peucker on OpenCV's stack and its last pass; (M, 1, 2)
    int32."""
    c = _points(contour)
    out = np.empty_like(c)
    n = _native().trex_approx_poly_dp(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(c),
        float(epsilon), 1 if closed else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out[:n].reshape(-1, 1, 2).copy()
