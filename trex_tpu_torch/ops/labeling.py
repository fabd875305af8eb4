"""Connected-component blob extraction on the host (the replay's labeler).

Counterpart of ``trex_tpu/ops/labeling.py``, reduced to what the host
FastTracker replay calls. Binds the port's own copies of the native
sources in ``trex_tpu_torch/native/``: ``labeling.cpp`` (line-run
union-find labelling with 8-connectivity over thresholded
background-difference images, the history split's expectation and
threshold-escalation executor) and ``tracker_core.cpp`` (the automatic
mode's matching phases: caches, paired probabilities with per-clique
matching, reactivation) and ``posture_chain.cpp`` (the batched posture
chain of ``track/posture.py``, with or without the full geometry of the
archives, which calls ``labeling.cpp``'s labeler, boundary trace and
outline resample). The per-blob chain of ``track/posture.py`` binds the
boundary trace, the outline resample, the midline walk and the midline
chain one by one. ``lzo1x.cpp`` (the ``.pv`` payload codec of
``io/lzo.py``) and ``imageops.cpp`` (the background average's mean and
mode, ``io/video.py``) are built into the same library, and so is the
port's own ``warp.cpp`` (the identity crops' affine warp,
``ops/crops.py``), which the JAX package takes from OpenCV, and
``hostmath.cpp`` (the C library's ``atan2f`` over an array, the
visual-field projection's CPU angles, ``ops/raycast.py``), and
``contours.cpp`` (tag detection's border following, contour area, arc
length and polygon approximation, ``track/tag_image.py``) and
``resize.cpp`` (the float32 linear resize of ``track/tag_image.py``, the
SAM masks' and the luminance map's) and ``imgproc.cpp`` (the pipeline's
blurs, adaptive threshold, undistortion and remap, the arena border's
morphology and polygon fill, PNG's row filters; ``utils/imgproc.py``,
``io/image_decode.py``), which the JAX package also takes from OpenCV,
and ``jpeg.cpp`` (the JPEG decoder's entropy decoding, IDCT,
upsampling and colour conversion) and ``tiffcodec.cpp`` (TIFF's LZW and
PackBits) of ``io/image_decode.py``, which the JAX package takes from
OpenCV's libjpeg-turbo and libtiff.

The library is compiled with ``g++`` at first use into
``build/trex_tpu_torch/`` (a directory git ignores), under a name that
carries a hash of the sources and flags, and loaded with ``ctypes``.
The flags are the JAX package's (``native/build.py``):
``-ffp-contract=off`` keeps the float sums bit-equal to its library. A
missing compiler or a failed build raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from ..kernels import BUILD_DIR

NATIVE = Path(__file__).resolve().parents[1] / "native"
SOURCES = ("labeling.cpp", "tracker_core.cpp", "posture_chain.cpp",
           "lzo1x.cpp", "imageops.cpp", "warp.cpp", "hostmath.cpp",
           "contours.cpp", "resize.cpp", "imgproc.cpp", "jpeg.cpp",
           "tiffcodec.cpp", "mpeg4video.cpp")
HEADERS = ("simd_clones.h",)
GXX_FLAGS = ["-O3", "-ffp-contract=off", "-std=c++20", "-shared", "-fPIC"]


@dataclass
class Blob:
    """One connected component: RLE lines + raw pixel values."""

    lines: np.ndarray  # (K, 3) int32 [y, x0, x1 inclusive]
    pixels: np.ndarray  # (num_pixels,) uint8, scan order
    stats: Optional[np.ndarray] = None  # (8,) n_px, track_count, moments

    @property
    def num_pixels(self) -> int:
        return int(self.pixels.size) if self.pixels is not None else int(
            np.sum(self.lines[:, 2] - self.lines[:, 1] + 1))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((NATIVE / name).read_bytes())
    return BUILD_DIR / f"libtrexlabel_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the host labeler unless it is built already; returns the
    library's path. One g++ a source, all started together, then one
    link; a lock beside the library lets one process build while the
    others wait for it. Raises RuntimeError without g++ or on a failed
    build."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host labeler of "
                           "trex_tpu_torch cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        objs = Path(tempfile.mkdtemp(prefix=out.stem + ".", dir=BUILD_DIR))
        try:
            flags = [f for f in GXX_FLAGS if f != "-shared"]
            procs = [(name, subprocess.Popen(
                [gxx, *flags, "-c", str(NATIVE / name), "-o",
                 str(objs / f"{name}.o")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)) for name in SOURCES]
            failed = []
            for name, proc in procs:
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            if failed:
                raise RuntimeError("g++ failed for the host labeler: "
                                   + "\n".join(failed))
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            r = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp),
                                *(str(objs / f"{n}.o") for n in SOURCES)],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"g++ failed to link the host labeler "
                                   f"(exit {r.returncode}):\n{r.stdout}"
                                   f"{r.stderr}")
            os.replace(tmp, out)
        finally:
            shutil.rmtree(objs, ignore_errors=True)
    return out


_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_c = ctypes.c_char_p
_vp = ctypes.c_void_p
_i32 = ctypes.c_int32
_i64 = ctypes.c_int64
_f64 = ctypes.c_double

_f32p = ctypes.POINTER(ctypes.c_float)

# symbol -> (restype, argtypes)
_SIGNATURES = {
    "trex_label_image2": (_vp, [_c, _c, _i32, _i32, _i32, _i32, _i32,
                                _i32]),
    "trex_label_stats": (_f64p, [_vp]),
    "trex_label_n_blobs": (_i64, [_vp]),
    "trex_label_n_lines": (_i64, [_vp]),
    "trex_label_n_pixels": (_i64, [_vp]),
    "trex_label_blob_line_start": (ctypes.POINTER(ctypes.c_uint32), [_vp]),
    "trex_label_blob_pixel_start": (ctypes.POINTER(ctypes.c_uint32),
                                    [_vp]),
    "trex_label_lines": (_i32p, [_vp]),
    "trex_label_pixels": (_u8p, [_vp]),
    "trex_label_free": (None, [_vp]),
    "trex_label_fill": (None, [_vp, _i32p, _c, _i64p, _i64p, _f64p]),
    "trex_split_sizes": (None, [_c, _c, _i32, _i32, _i32p, _i32, _i32,
                                _i32, _i64p]),
    "trex_split_scan": (_i32, [_c, _c, _i32, _i32, _i32, _i32, _i32, _f64,
                               _f64, _f64, _f64p, _i32, _f64p]),
    "trex_threshold_blob": (_vp, [_i32p, _i64, _c, _c, _i32, _i32, _i32,
                                  _i32]),
    "trex_blob_stats": (None, [_i32p, _i64p, _c, _i64p, _i32, _c, _i32,
                               _i32, _i32, _i32, _f64p]),
    "trex_blob_dense": (None, [_i32p, _i64, _u8p, _i32, _i32, _i32, _i32,
                               _i32, _u8p, _u8p]),
    "trex_expectation": (None, [_f64p, _i32, _i32p, _i64p, _i64p, _f64p,
                                _i32, _f64, _i32p]),
    "trex_split_execute": (_i32, [_i32p, _i64, _c, _c, _i32, _i32, _i32,
                                  _i32, _i32, _f64, _f64, _f64, _f64p, _i32,
                                  _i32, _f64p]),
    "trex_split_execute_batch": (_i32, [_i32p, _c, _i64p, _i64p, _i64p,
                                        _i32p, _i32, _c, _i32, _i32, _i32,
                                        _i32, _f64, _f64, _f64, _f64p, _i32,
                                        _i32, _f64p, _i32p]),
    # tracker_core.cpp
    "trex_track_caches": (None, [_i32, _i64, _f64, _i64, _i64p, _f64p,
                                 _i64p, _i64p, _i32p, _i32, _i32, _f64,
                                 _f64, _i32, _i32, _f64p, _f64p]),
    "trex_track_match": (_i64, [_i32p, _i32, _f64p, _f64p, _f64p, _f64p,
                                _f64p, _f64p, _i32, _f64, _f64, _i32, _i32p,
                                _f64p, _i32p, _i32p, _f64p, _i64]),
    "trex_track_reactivate": (None, [_i32p, _i32, _c, _f64p, _f64p, _f64p,
                                     _i32p, _i32, _f64p, _f64p, _f64,
                                     _i32p]),
    # the per-blob posture chain (labeling.cpp, posture_chain.cpp)
    "trex_trace_boundary": (_i64, [_c, _i32, _i32, _f32p, _i64]),
    "trex_outline_resample": (_i64, [_f32p, _i64, _f64, _f32p, _i64]),
    "trex_midline_walk": (_i64, [_f32p, _i64, _i32, _f32p, _i64]),
    "trex_midline_chain": (_i32, [_f32p, _i64, _f64, _i32, _i32, _f64,
                                  _i32, _f64, _f64, _i32, _i32, _f64p,
                                  _f64p, _f64p, _i64, _i64p, _i32p, _i32p,
                                  _f64p, _f64p, _i32p]),
    # posture_chain.cpp: the batch chain, and with full geometry
    "trex_posture_batch_full": (None, [_i32p, _i64p, _c, _i64p, _i64, _c,
                                       _i32, _i32, _i32, _i32, _f64, _f64,
                                       _i32, _i32, _f64, _i32, _f64, _f64,
                                       _i32, _i32, _f64p, _c, _f64p, _f64p,
                                       _f64p, _f64p, _i32p, _f32p, _i32p,
                                       _i64, _f64p, _f64p, _i64, _i32p,
                                       _i32p, _i32p, _i32p, _f64p, _i32p,
                                       _i32]),
    "trex_posture_batch": (None, [_i32p, _i64p, _c, _i64p, _i64, _c, _i32,
                                  _i32, _i32, _i32, _f64, _f64, _i32, _i32,
                                  _f64, _i32, _f64, _f64, _i32, _i32, _f64p,
                                  _c, _f64p, _f64p, _f64p, _f64p, _i32p,
                                  _i32]),
    # lzo1x.cpp: the .pv frame payload codec (io/lzo.py)
    "trex_lzo1x_worst_case": (ctypes.c_size_t, [ctypes.c_size_t]),
    "trex_lzo1x_compress": (ctypes.c_int, [_c, ctypes.c_size_t, _c,
                                           ctypes.c_size_t,
                                           ctypes.POINTER(ctypes.c_size_t)]),
    "trex_lzo1x_decompress": (ctypes.c_int, [_c, ctypes.c_size_t, _c,
                                             ctypes.c_size_t,
                                             ctypes.POINTER(
                                                 ctypes.c_size_t)]),
    # imageops.cpp: the background average's mean and mode
    # (io/video.py::AveragingAccumulator)
    "trex_mean_u8": (None, [ctypes.POINTER(ctypes.c_uint32), _i64, _i64,
                            _u8p]),
    "trex_mode_u8_rows": (None, [ctypes.POINTER(_u8p), _i64, _i64, _u8p]),
    # warp.cpp: the identity crops' affine warp (ops/crops.py)
    "trex_warp_affine_u8": (None, [_u8p, _i32, _i32, _f64p, _i32, _i32,
                                   _u8p]),
    # hostmath.cpp: the visual-field projection's CPU angles
    # (ops/raycast.py)
    "trex_atan2f": (None, [_f32p, _f32p, _f32p, _i64]),
    # contours.cpp: tag detection's contour routines
    # (track/tag_image.py)
    "trex_find_contours_external": (_i64, [_c, _i32, _i32, _i32p, _i64,
                                           _i64p, _i32]),
    "trex_contour_area": (_f64, [_i32p, _i64]),
    "trex_arc_length": (_f64, [_i32p, _i64, _i32]),
    "trex_approx_poly_dp": (_i64, [_i32p, _i64, _f64, _i32, _i32p]),
    # (track/tag_image.py's float32 resize_linear)
    "trex_resize_linear_f32": (None, [_f32p, _i64, _i32, _i32, _i32p,
                                      _i32p, _f32p, _i32p, _i32p, _f32p,
                                      _i32, _i32, _f32p]),
    # imgproc.cpp: the pipeline's, the decoder's and the border's image
    # routines (utils/imgproc.py, io/image_decode.py)
    "trex_box_blur_u8": (None, [_u8p, _i32, _i32, _i32, _i32, _u8p]),
    "trex_gaussian5_u8": (None, [_u8p, _i32, _i32, _u8p]),
    "trex_adaptive_gaussian_u8": (None, [_u8p, _i32, _i32, _i32, _f32p,
                                         _i32, ctypes.c_uint8, _u8p]),
    "trex_morph_runs_u8": (None, [_u8p, _i32, _i32, _i32p, _i32p, _i32p,
                                  _i32, _i32, _u8p]),
    "trex_fill_poly_u8": (None, [_u8p, _i32, _i32, _i32p, _i32,
                                 ctypes.c_uint8]),
    "trex_undistort_maps_f32": (None, [_f64p, _f64p, _f64p, _i32, _i32,
                                       _i32, _f32p, _f32p]),
    "trex_remap_linear_u8": (None, [_u8p, _i32, _i32, _i32, _f32p, _f32p,
                                    _i32, _i32, _u8p]),
    "trex_png_unfilter": (_i32, [_u8p, _i64, _i64, _i32]),
    # jpeg.cpp and tiffcodec.cpp: the JPEG and TIFF decoders
    # (io/image_decode.py)
    "trex_jpeg_scan": (_i64, [_c, _i64, _i64, _c, _i32, _i32, _i32p,
                              ctypes.POINTER(_vp), _i32, _i32, _i32, _i32,
                              _i32, _i32, _i32, _i32]),
    "trex_jpeg_idct": (None, [ctypes.POINTER(ctypes.c_int16), _i32, _i32,
                              _i32, ctypes.POINTER(ctypes.c_uint16), _u8p,
                              _i64]),
    "trex_jpeg_output": (_i32, [ctypes.POINTER(_vp), _i32p, _i32, _i32,
                                _i32, _i32, _i32, _i32, _u8p]),
    "trex_tiff_chunks": (_i64, [_c, _i64, _i64p, _i64p, _i64p, _i64,
                                _i32, _u8p]),
    "trex_tiff_predict": (None, [_u8p, _i64, _i64, _i32, _i32, _i32]),
    # mpeg4video.cpp: the video decoders' MPEG-4 Part 2, MJPEG IDCT and
    # colour conversion (io/video_decode.py)
    "trex_m4v_new": (_vp, [_i32]),
    "trex_m4v_free": (None, [_vp]),
    "trex_m4v_flush": (None, [_vp]),
    "trex_m4v_headers": (_i32, [_vp, _c, _i64, _i32p]),
    "trex_m4v_decode": (_i32, [_vp, _c, _i64, _u8p, _i64, _u8p, _u8p, _i64,
                               _i32, _i32, _i32p]),
    "trex_mjpeg_idct": (None, [ctypes.POINTER(ctypes.c_int16), _i32, _i32,
                               _i32, ctypes.POINTER(ctypes.c_uint16), _u8p,
                               _i64]),
    "trex_yuv420_bgr": (None, [_u8p, _i64, _u8p, _i64, _u8p, _i64, _i32,
                               _i32, _i32, _i32, _u8p]),
    # mpeg4video.cpp: the MPEG-4 Part 2 encoder (io/video_encode.py)
    "trex_m4v_enc_new": (_vp, [_i32, _i32, _i32, _i32, _i32]),
    "trex_m4v_enc_free": (None, [_vp]),
    "trex_m4v_enc_headers": (_i64, [_vp, _u8p, _i64]),
    "trex_m4v_enc_capacity": (_i64, [_vp]),
    "trex_m4v_enc_frame": (_i64, [_vp, _u8p, _i64, _i32, _u8p, _i32p]),
    "trex_m4v_enc_recon": (None, [_vp, _u8p, _i64, _u8p, _u8p, _i64]),
}

_lib_obj = None
_lock = threading.Lock()


def _lib() -> ctypes.CDLL:
    """The loaded host labeler, built first if needed."""
    global _lib_obj
    with _lock:
        if _lib_obj is None:
            lib = ctypes.CDLL(str(build()))
            for sym, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, sym)
                fn.restype = res
                fn.argtypes = args
            _lib_obj = lib
    return _lib_obj


def _bg_ptr(background, shape):
    if background is None:
        return None, None
    background = np.ascontiguousarray(background, dtype=np.uint8)
    if background.shape != shape:
        raise ValueError(f"background shape {background.shape} != image "
                         f"{shape}")
    return background, background.ctypes.data_as(_c)


def split_scan(image: np.ndarray, background: Optional[np.ndarray],
               initial: int, absolute: bool, expected: int,
               cm_sqr: float, max_shrink: float, shrink_limit: float,
               ranges) -> tuple[int, float]:
    """Native threshold-escalation scan with the SplitBlob evaluation
    fused in (early stop at the first keep/abort). Returns
    (best_threshold or -1, first_size in cm^2)."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w = image.shape
    background, bg = _bg_ptr(background, image.shape)
    r = np.ascontiguousarray(ranges if ranges is not None and len(ranges)
                             else [], np.float64).reshape(-1, 2)
    first_size = ctypes.c_double(0.0)
    thr = _lib().trex_split_scan(
        image.ctypes.data_as(_c), bg, w, h, int(initial),
        1 if absolute else 0, int(expected), float(cm_sqr),
        float(max_shrink), float(shrink_limit), r.ctypes.data_as(_f64p),
        r.shape[0], ctypes.byref(first_size))
    return int(thr), float(first_size.value)


def split_sizes(image: np.ndarray, background: Optional[np.ndarray],
                thresholds, absolute: bool = True,
                top_k: int = 16) -> np.ndarray:
    """Component-size scan over several thresholds. Returns int64
    (n_thr, 2 + top_k): per threshold [n_components, total_fg_pixels,
    top_k sizes descending (0-padded)]."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w = image.shape
    background, bg = _bg_ptr(background, image.shape)
    thr = np.ascontiguousarray(thresholds, dtype=np.int32)
    out = np.zeros((thr.size, 2 + top_k), np.int64)
    _lib().trex_split_sizes(
        image.ctypes.data_as(_c), bg, w, h, thr.ctypes.data_as(_i32p),
        thr.size, 1 if absolute else 0, top_k, out.ctypes.data_as(_i64p))
    return out


def _label_ctx(image, background, threshold, absolute, track_threshold,
               track_absolute):
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim != 2:
        raise ValueError("the labeler expects a single-channel image")
    h, w = image.shape
    background, bg = _bg_ptr(background, image.shape)
    lib = _lib()
    return lib, lib.trex_label_image2(
        image.ctypes.data_as(_c), bg, w, h, int(threshold),
        1 if absolute else 0, int(track_threshold),
        1 if track_absolute else 0)


def label_blobs_raw(image: np.ndarray,
                    background: Optional[np.ndarray] = None,
                    threshold: int = 0, absolute: bool = True,
                    track_threshold: int = 0,
                    track_absolute: bool = True) -> dict:
    """The labeler's flat arrays, the FastTracker's input:
    {lines (L,3) i32, pixels (P,) u8, line_start (N+1,) i64,
    pixel_start (N+1,) i64, stats (N,8) f64}."""
    lib, ctx = _label_ctx(image, background, threshold, absolute,
                          track_threshold, track_absolute)
    try:
        n_blobs = lib.trex_label_n_blobs(ctx)
        lines = np.empty((lib.trex_label_n_lines(ctx), 3), np.int32)
        pixels = np.empty(lib.trex_label_n_pixels(ctx), np.uint8)
        line_start = np.empty(n_blobs + 1, np.int64)
        pixel_start = np.empty(n_blobs + 1, np.int64)
        stats = np.empty((n_blobs, 8), np.float64)
        lib.trex_label_fill(
            ctx, lines.ctypes.data_as(_i32p), pixels.ctypes.data_as(_c),
            line_start.ctypes.data_as(_i64p),
            pixel_start.ctypes.data_as(_i64p), stats.ctypes.data_as(_f64p))
    finally:
        lib.trex_label_free(ctx)
    return {"lines": lines, "pixels": pixels, "line_start": line_start,
            "pixel_start": pixel_start, "stats": stats}


def label_blobs(image: np.ndarray, background: Optional[np.ndarray] = None,
                threshold: int = 0, absolute: bool = True,
                track_threshold: int = 0,
                track_absolute: bool = True) -> list[Blob]:
    """Connected components of a grayscale image, one :class:`Blob` each.

    threshold <= 0: components of nonzero pixels of `image`.
    background given: foreground test is |img-bg| >= threshold (absolute)
    or (bg-img) >= threshold (signed, darker than the background).
    Returned pixel values are the raw `image` values under the mask."""
    lib, ctx = _label_ctx(image, background, threshold, absolute,
                          track_threshold, track_absolute)
    return _blobs_from_ctx(lib, ctx)


def threshold_blob_native(lines: np.ndarray, pixels: np.ndarray,
                          background: np.ndarray, threshold: int,
                          absolute: bool) -> list[Blob]:
    """pixel::threshold_blob in one native call: rasterize the blob crop
    with background fill, label at `threshold`, return children with
    image-space lines and shifted stats."""
    lines = np.ascontiguousarray(lines, np.int32)
    pixels = np.ascontiguousarray(pixels, np.uint8)
    background = np.ascontiguousarray(background, np.uint8)
    lib = _lib()
    ctx = lib.trex_threshold_blob(
        lines.ctypes.data_as(_i32p), len(lines), pixels.ctypes.data_as(_c),
        background.ctypes.data_as(_c), background.shape[1],
        background.shape[0], int(threshold), 1 if absolute else 0)
    return _blobs_from_ctx(lib, ctx)


def _blobs_from_ctx(lib, ctx) -> list[Blob]:
    try:
        n_blobs = lib.trex_label_n_blobs(ctx)
        n_lines = lib.trex_label_n_lines(ctx)
        n_pixels = lib.trex_label_n_pixels(ctx)
        if n_blobs == 0:
            return []
        line_start = np.ctypeslib.as_array(
            lib.trex_label_blob_line_start(ctx), (n_blobs + 1,)).copy()
        pixel_start = np.ctypeslib.as_array(
            lib.trex_label_blob_pixel_start(ctx), (n_blobs + 1,)).copy()
        lines = np.ctypeslib.as_array(
            lib.trex_label_lines(ctx), (n_lines, 3)).copy() \
            if n_lines else np.zeros((0, 3), np.int32)
        pixels = np.ctypeslib.as_array(
            lib.trex_label_pixels(ctx), (n_pixels,)).copy() \
            if n_pixels else np.zeros((0,), np.uint8)
        stats = np.ctypeslib.as_array(
            lib.trex_label_stats(ctx), (n_blobs, 8)).copy()
    finally:
        lib.trex_label_free(ctx)
    return [Blob(lines=lines[line_start[b]:line_start[b + 1]],
                 pixels=pixels[pixel_start[b]:pixel_start[b + 1]],
                 stats=stats[b]) for b in range(n_blobs)]


def blob_stats(lines: np.ndarray, line_start: np.ndarray,
               pixels: np.ndarray, pixel_start: np.ndarray,
               background: np.ndarray, track_threshold: int,
               absolute: bool) -> np.ndarray:
    """The labeler's (N, 8) per-blob statistics for blobs given as
    concatenated lines and pixels (``trex_blob_stats``)."""
    n = len(line_start) - 1
    stats = np.zeros((n, 8))
    h, w = background.shape[:2]
    _lib().trex_blob_stats(
        np.ascontiguousarray(lines, np.int32).ctypes.data_as(_i32p),
        np.ascontiguousarray(line_start, np.int64).ctypes.data_as(_i64p),
        np.ascontiguousarray(pixels, np.uint8).ctypes.data_as(_c),
        np.ascontiguousarray(pixel_start, np.int64).ctypes.data_as(_i64p),
        n, np.ascontiguousarray(background, np.uint8).ctypes.data_as(_c),
        w, h, int(track_threshold), 1 if absolute else 0,
        stats.ctypes.data_as(_f64p))
    return stats


def _ranges_array(ranges) -> np.ndarray:
    return np.ascontiguousarray(
        ranges if ranges is not None and len(ranges) else [],
        np.float64).reshape(-1, 2)


def expectation_native(fish: np.ndarray, lines: np.ndarray,
                       row_lo: np.ndarray, row_hi: np.ndarray,
                       bounds: np.ndarray, max_d: float) -> np.ndarray:
    """History-split expectation counts (``trex_expectation``: bbox
    proximity, grid-point sampling, mask distances, clique conflict
    resolution). fish (F, 2) float64; lines (L, 3) int32; row_lo/row_hi
    (N,) int64 per-blob ranges into `lines`; bounds (N, 4) float64
    [x0, y0, x1, y1]. Returns (N,) int32."""
    fish = np.ascontiguousarray(fish, np.float64)
    lines = np.ascontiguousarray(lines, np.int32)
    row_lo = np.ascontiguousarray(row_lo, np.int64)
    row_hi = np.ascontiguousarray(row_hi, np.int64)
    bounds = np.ascontiguousarray(bounds, np.float64)
    out = np.zeros(len(bounds), np.int32)
    if len(fish) == 0 or len(bounds) == 0:
        return out
    _lib().trex_expectation(
        fish.ctypes.data_as(_f64p), len(fish), lines.ctypes.data_as(_i32p),
        row_lo.ctypes.data_as(_i64p), row_hi.ctypes.data_as(_i64p),
        bounds.ctypes.data_as(_f64p), len(bounds), float(max_d),
        out.ctypes.data_as(_i32p))
    return out


def split_execute(lines: np.ndarray, pixels: np.ndarray,
                  background: np.ndarray, initial: int, absolute: bool,
                  expected: int, cm_sqr: float, max_shrink: float,
                  shrink_limit: float, ranges,
                  max_pieces: int = 64) -> np.ndarray:
    """One-shot native blob split (``trex_split_execute``: escalation
    scan, then the winning components). Returns (n_pieces, 7) float64
    rows [num_pixels, x0, y0, x1, y1, sum_x, sum_y] in frame
    coordinates, size-descending; empty when no split is acceptable."""
    return SplitExecutor(background, ranges, max_pieces).run(
        lines, pixels, initial, absolute, expected, cm_sqr, max_shrink,
        shrink_limit)


class SplitExecutor:
    """``split_execute`` bound to one background and size filter: the
    history split calls it for many blobs a frame."""

    def __init__(self, background: np.ndarray, ranges,
                 max_pieces: int = 64):
        self._lib = _lib()
        self._bg = np.ascontiguousarray(background, np.uint8)
        self._h, self._w = self._bg.shape
        self._r = _ranges_array(ranges)
        self._max_pieces = max_pieces
        self._out = np.empty((max_pieces, 7))

    def run(self, lines: np.ndarray, pixels: np.ndarray, initial: int,
            absolute: bool, expected: int, cm_sqr: float,
            max_shrink: float, shrink_limit: float) -> np.ndarray:
        lines = np.ascontiguousarray(lines, np.int32)
        pixels = np.ascontiguousarray(pixels, np.uint8)
        n = self._lib.trex_split_execute(
            lines.ctypes.data_as(_i32p), len(lines),
            pixels.ctypes.data_as(_c), self._bg.ctypes.data_as(_c),
            self._w, self._h, int(initial), 1 if absolute else 0,
            int(expected), float(cm_sqr), float(max_shrink),
            float(shrink_limit), self._r.ctypes.data_as(_f64p),
            self._r.shape[0], self._max_pieces,
            self._out.ctypes.data_as(_f64p))
        return self._out[:n].copy()

    def run_batch(self, lines: np.ndarray, pixels: np.ndarray,
                  line_lo, line_hi, pixel_lo, expected,
                  initial: int, absolute: bool, cm_sqr: float,
                  max_shrink: float, shrink_limit: float) -> list:
        """Every table-backed split of a frame in one native call
        (``trex_split_execute_batch``): job j splits
        lines[line_lo[j]:line_hi[j]] with its pixels at pixel_lo[j].
        Returns one (n_j, 7) float64 array per job, equal to `run`'s."""
        lines = np.ascontiguousarray(lines, np.int32)
        pixels = np.ascontiguousarray(pixels, np.uint8)
        lo = np.ascontiguousarray(line_lo, np.int64)
        hi = np.ascontiguousarray(line_hi, np.int64)
        plo = np.ascontiguousarray(pixel_lo, np.int64)
        exp = np.ascontiguousarray(expected, np.int32)
        n_jobs = len(lo)
        out = np.empty((n_jobs, self._max_pieces, 7))
        counts = np.empty(n_jobs, np.int32)
        self._lib.trex_split_execute_batch(
            lines.ctypes.data_as(_i32p), pixels.ctypes.data_as(_c),
            lo.ctypes.data_as(_i64p), hi.ctypes.data_as(_i64p),
            plo.ctypes.data_as(_i64p), exp.ctypes.data_as(_i32p), n_jobs,
            self._bg.ctypes.data_as(_c), self._w, self._h, int(initial),
            1 if absolute else 0, float(cm_sqr), float(max_shrink),
            float(shrink_limit), self._r.ctypes.data_as(_f64p),
            self._r.shape[0], self._max_pieces, out.ctypes.data_as(_f64p),
            counts.ctypes.data_as(_i32p))
        return [out[j, :counts[j]].copy() for j in range(n_jobs)]


def atan2f(y: np.ndarray, x: np.ndarray) -> np.ndarray:
    """The C library's float32 atan2, element by element (hostmath.cpp)."""
    y = np.ascontiguousarray(y, np.float32)
    x = np.ascontiguousarray(x, np.float32)
    if y.shape != x.shape:
        raise ValueError(f"atan2f: shapes {y.shape} and {x.shape} differ")
    out = np.empty_like(y)
    _lib().trex_atan2f(y.ctypes.data_as(_f32p), x.ctypes.data_as(_f32p),
                       out.ctypes.data_as(_f32p), y.size)
    return out
