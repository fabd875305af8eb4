"""Video recording without OpenCV: :class:`VideoWriter` writes what
``cv2.VideoWriter(path, fourcc("mp4v"), fps, (w, h), is_color)`` writes for
``save_raw_movie``, an MPEG-4 Part 2 stream in an MP4 file, with the same
interface (``write``, ``release``).

- The codec (``native/mpeg4video.cpp``'s encoder): Simple Profile, one
  rectangular progressive VOL with H.263 quantisation, an I-VOP every 12
  frames (cv2 leaves FFmpeg's GOP) and P-VOPs between (no B-VOPs, no VOP
  that is not
  coded), one half-pel vector a macroblock, not-coded macroblocks where
  the vector is 0 and no coefficient survives, no user data (the stream
  claims no encoder, so FFmpeg applies no workaround). Every macroblock is
  read back by the port's own decoder as it is written, so the encoder's
  reference pictures are what ``io/video_decode.py`` and cv2 5.0.0 decode
  (``tests/test_torch_video_encode.py`` holds the three equal bit for
  bit).
- The rate control aims at cv2's budget, ``w * h`` bits a frame (its bit
  rate is ``w * h * fps``), slowly: the quantiser of each VOP is
  ``3 + 28 * excess / (30 s of budget)``, rounded, where ``excess`` is
  the bits written so far less the budget of the frames written so far,
  kept within the range that maps to [2, 31] (a stream long under its
  budget banks nothing). Deterministic: the same frames give the same
  bytes on any host (integer and IEEE arithmetic only).
- The colour: BGR to YUV 4:2:0 in BT.601 limited range (the inverse of
  ``io/video_decode.py::yuv420_bgr``), chroma averaged over each 2x2
  block; grey frames map to Y alone, chroma 128, so that a grey read
  (``VideoFile.read(i, color=False)``) gives the frame back within the
  codec's error.
- The container: ``io/containers.py::Mp4Writer``, the frame rate a
  rational (``vop_time_increment_resolution`` its numerator), so that 25,
  30, 30000/1001 or 7.5 come back exactly as ``CAP_PROP_FPS``.
"""
from __future__ import annotations

import ctypes
from fractions import Fraction
from typing import Optional

import numpy as np

from .containers import Mp4Writer, mp4_timescale

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)


def rate_fraction(frame_rate: float) -> tuple:
    """(numerator, denominator) of `frame_rate`, both at most 65535
    (``vop_time_increment_resolution`` has 16 bits): the closest such
    fraction, so that 30000/1001 given as a float comes back as
    30000/1001."""
    fps = float(frame_rate)
    if not 1 / 65535 <= fps <= 65535:
        raise ValueError(f"a frame rate of {frame_rate} cannot be recorded")
    f = Fraction(fps).limit_denominator(min(65535, int(65535 / fps)))
    if f.numerator > 65535:
        f = Fraction(round(fps))
    return f.numerator, f.denominator


class VideoWriter:
    """An ``mp4v`` MP4 of `size` = (w, h) frames at `frame_rate` frames a
    second: BGR frames (h, w, 3) where `is_color`, else grey (h, w), uint8.
    As cv2's writer, it drops the last column of an odd width and the last
    row of an odd height (:attr:`coded_size`). `_quantiser` is a test
    hook, not part of the interface: 0 (the default) runs the rate control;
    2-31 fixes the quantiser of every VOP, which short clips under the rate
    control rarely reach."""

    def __init__(self, path, frame_rate: float, size, is_color: bool = True,
                 *, _quantiser: int = 0):
        from ..ops.labeling import _lib

        self._enc = self._mux = None
        self.path = str(path)
        self.width, self.height = (int(v) for v in size)
        self.coded_size = (self.width & ~1, self.height & ~1)
        self.is_color = bool(is_color)
        self.res, self.inc = rate_fraction(frame_rate)
        self._lib = _lib()
        cw, ch = self.coded_size
        self._enc = self._lib.trex_m4v_enc_new(
            cw, ch, self.res, self.inc, int(_quantiser)) if cw and ch \
            else None
        if not self._enc:
            raise ValueError(f"{self.path}: an MPEG-4 Part 2 stream of "
                             f"{self.width}x{self.height} at {frame_rate} "
                             f"frames/s with quantiser {_quantiser} cannot "
                             f"be written")
        head = np.zeros(256, np.uint8)
        n = self._lib.trex_m4v_enc_headers(self._enc, head.ctypes.data_as(
            _U8P), head.size)
        self._out = np.empty(self._lib.trex_m4v_enc_capacity(self._enc),
                             np.uint8)
        self.info = np.zeros(2, np.int32)  # the last VOP: I-VOP, quantiser
        timescale, delta = mp4_timescale(self.res, self.inc)
        self._mux: Optional[Mp4Writer] = Mp4Writer(
            self.path, cw, ch, timescale, delta, head[:n].tobytes())

    def __len__(self) -> int:
        """Frames written."""
        return 0 if self._mux is None else len(self._mux)

    def write(self, img: np.ndarray):
        """Encode one frame. Raises ValueError for a frame of another size
        or channel count than the writer's, or after :meth:`release`."""
        if self._mux is None:
            raise ValueError(f"{self.path}: write after release")
        img = np.asarray(img)
        want = (self.height, self.width) + ((3,) if self.is_color else ())
        if img.ndim == 3 and img.shape[2] == 1 and not self.is_color:
            img = img[:, :, 0]
        if img.shape != want or img.dtype != np.uint8:
            raise ValueError(f"{self.path}: a {img.dtype} frame of shape "
                             f"{img.shape}, the writer takes uint8 {want}")
        cw, ch = self.coded_size
        img = np.ascontiguousarray(img)[:ch, :cw]
        n = self._lib.trex_m4v_enc_frame(
            self._enc, img.ctypes.data_as(_U8P), img.strides[0],
            3 if self.is_color else 1, self._out.ctypes.data_as(_U8P),
            self.info.ctypes.data_as(_I32P))
        if n < 0:
            raise RuntimeError(f"{self.path}: the MPEG-4 encoder failed "
                               f"(error {n}) on frame {len(self)}")
        self._mux.add(self._out[:n].tobytes(), bool(self.info[0]))

    def reconstruction(self) -> tuple:
        """The last frame as a decoder returns it: its (y, u, v) planes
        at :attr:`coded_size` (w, h), y (h, w), u and v (h / 2, w / 2)."""
        if self._enc is None:
            raise ValueError(f"{self.path}: the writer is released")
        w, h = self.coded_size
        y = np.empty((h, w), np.uint8)
        u = np.empty((h // 2, w // 2), np.uint8)
        v = np.empty((h // 2, w // 2), np.uint8)
        self._lib.trex_m4v_enc_recon(
            self._enc, y.ctypes.data_as(_U8P), w, u.ctypes.data_as(_U8P),
            v.ctypes.data_as(_U8P), w // 2)
        return y, u, v

    def release(self):
        """Finish the file; a second call does nothing."""
        if self._mux is not None:
            mux, self._mux = self._mux, None
            mux.close()
        if self._enc is not None:
            self._lib.trex_m4v_enc_free(self._enc)
            self._enc = None

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass
