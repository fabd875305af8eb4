"""Posture on the host: the batched native chain the engines call.

Counterpart of the parts of ``trex_tpu/track/posture.py`` and
``trex_tpu/track/archive.py`` that the host FastTracker and the
DeviceTracker's host posture span run: ``posture_batch``, one call of
``trex_posture_batch`` (the port's copy of ``native/posture_chain.cpp``)
per frame (crop, threshold escalation, biggest component, supersampled
boundary trace, resample, smoothing, elliptic Fourier approximation,
curvature peaks, midline walk, post-processing and normalisation), and
``compute_posture_rows`` over it.

Archive mode (full posture records) and posture from pose or outline
predictions are later slices of the port; ``compute_posture_rows``
raises ``EngineUnsupported`` naming them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..ops.labeling import _c, _f64p, _i32p, _i64p, _lib


def _get_native_posture():
    """The port's host library with the posture chain bound (``ctypes``
    signatures in ``ops/labeling.py``); raises when it cannot be built."""
    return _lib()


def posture_batch(line_arrays: list, pixel_arrays: list,
                  background: np.ndarray, settings,
                  movement_dirs: Optional[np.ndarray] = None,
                  n_threads: int = 0):
    """Posture of a batch of blobs in one native call. Returns (ok (N,)
    bool, midline length (N,) in px, angle (N,), direction (N, 2)).
    Requires ``posture_closing_steps == 0``."""
    s = settings
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


def compute_posture_rows(settings, background, line_arrays, pixel_arrays,
                         preds, md, want_recs: bool = False):
    """Posture of one frame's assigned rows: the shared core of
    ``FastTracker._run_posture_batch`` and the DeviceTracker's host
    posture span, through the native batch chain.

    Returns (ok, lens, angles, out_dirs, recs, dir_reset) like the JAX
    package's: recs is a list of None (no records without archive mode),
    dir_reset all False (only outline predictions reset a direction)."""
    from .engine import EngineUnsupported

    if want_recs:
        raise EngineUnsupported(
            "posture records of archive mode (keep_individuals; ported "
            "with the archive slice)")
    if preds is not None and any(p is not None for p in preds):
        raise EngineUnsupported(
            "posture from pose or outline predictions (ported with the "
            "YOLO slice)")
    n = len(line_arrays)
    ok, lens, angles, out_dirs = posture_batch(
        line_arrays, pixel_arrays, background, settings, movement_dirs=md)
    return (np.asarray(ok, bool).copy(), lens, angles, out_dirs, [None] * n,
            np.zeros(n, bool))
