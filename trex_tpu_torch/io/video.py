"""Video sources: mp4/avi, image sequences (printf/glob patterns), pv re-read.

Re-creates the acquisition layer of the reference
(core/AbstractVideoSource.h:172-287, VideoVideoSource, PVVideoSource and
commons VideoSource/AveragingAccumulator): uniform `get(index)` /
iteration over grayscale-or-color frames plus the background averaging
accumulator (mean/mode/max/min, grabber default_config.cpp:72-133).
Decode is host-side: PNG, BMP, JPEG and TIFF image sequences through the
port's own decoder (``io/image_decode.py``, the pixels ``cv2.imread``
gives), video files, the webcam and the JPEG and TIFF variants that
decoder refuses (named from their headers) through OpenCV, imported only
where such a source needs it; device transfer happens downstream.
"""
from __future__ import annotations

import ctypes as _c
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from ..track.tag_image import bgr_to_gray
from .image_decode import can_decode, imread, refused_variant
from .patharray import has_pattern, resolve_paths

_cv2_mod = None


def _cv2(purpose: str):
    """OpenCV, imported at the first use that needs it: video-file and
    webcam decode, image files of other formats and the JPEG and TIFF
    variants :func:`~.image_decode.refused_variant` names. In-memory and
    ``.pv`` sources and PNG, BMP, JPEG or TIFF image sequences never call
    this, so they run without OpenCV installed."""
    global _cv2_mod
    if _cv2_mod is None:
        try:
            import cv2
        except ImportError as e:
            raise RuntimeError(f"OpenCV is required for {purpose}") from e
        # single-threaded OpenCV: the decode workers already
        # parallelize at the frame level
        try:
            cv2.setNumThreads(0)
        except Exception:
            pass
        _cv2_mod = cv2
    return _cv2_mod


class VideoSource:
    """Uniform frame access. Accepts:
    - a video file path (mp4/avi/mov...)
    - a printf-style image sequence pattern (frame_%03d.jpg)
    - a glob pattern (frame_*.jpg) or directory
    - a list of image paths
    """

    VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm", ".m4v",
                  ".mpg", ".mpeg", ".wmv")

    def __init__(self, source, color: bool = False):
        self.color = color
        self._cap = None
        self._files: Optional[list[str]] = None
        self._cap_pos = 0
        self._live = False
        self._videos: Optional[list[str]] = None  # multi-video chain
        # stateful decoder access (seek + read) must serialize: the
        # Segmenter's worker pool calls get() concurrently
        self._seek_lock = threading.Lock()
        self._video_caps: list = []
        self._video_offsets: Optional[np.ndarray] = None
        self._video_idx = -1
        if isinstance(source, (list, tuple)):
            self._files = [str(s) for s in source]
        else:
            s = str(source)
            if s == "webcam":
                # commons PathArray "webcam" sentinel -> live capture
                # from `webcam_index` (grabber default_config)
                cv2 = _cv2("webcam capture")
                from ..config import global_settings

                idx = int(global_settings().get("webcam_index", 0) or 0)
                self._cap = cv2.VideoCapture(idx)
                self._live = True
                if not self._cap.isOpened():
                    raise RuntimeError(
                        f"cannot open webcam device {idx}")
            elif has_pattern(s):
                # printf patterns (%start[.end].digits), star globs and
                # explicit ["a","b"] path arrays — one predicate shared
                # with commons PathArray (io/patharray.py)
                self._files = resolve_paths(s)
            elif Path(s).is_dir():
                exts = (".jpg", ".jpeg", ".png", ".bmp", ".tiff", ".tif")
                self._files = sorted(
                    str(p) for p in Path(s).iterdir() if p.suffix.lower() in exts
                )
            else:
                cv2 = _cv2("video decode")
                self._cap = cv2.VideoCapture(s)
                if not self._cap.isOpened():
                    raise FileNotFoundError(f"cannot open video source {s!r}")
        if self._files is not None and not self._files:
            raise FileNotFoundError(f"no frames found for {source!r}")
        if self._files and all(
                Path(f).suffix.lower() in self.VIDEO_EXTS
                for f in self._files):
            # a path array of VIDEO files plays back as one concatenated
            # stream (commons VideoSource over a multi-video PathArray;
            # BASELINE config 5 "batched multi-video ingest")
            cv2 = _cv2("video decode")
            self._videos = self._files
            self._files = None
            lengths = []
            for f in self._videos:
                cap = cv2.VideoCapture(f)
                if not cap.isOpened():
                    raise FileNotFoundError(f"cannot open video {f!r}")
                lengths.append(int(cap.get(cv2.CAP_PROP_FRAME_COUNT)))
                self._video_caps.append(cap)
            self._video_offsets = np.concatenate(
                [[0], np.cumsum(lengths)]).astype(np.int64)

    def __len__(self) -> int:
        if self._videos is not None:
            return int(self._video_offsets[-1])
        if self._files is not None:
            return len(self._files)
        if self._live:
            return 1 << 30  # unbounded live stream
        return int(self._cap.get(_cv2("video decode").CAP_PROP_FRAME_COUNT))

    @property
    def frame_rate(self) -> float:
        cap = self._video_caps[0] if self._videos is not None else self._cap
        if cap is not None:
            fps = cap.get(_cv2("video decode").CAP_PROP_FPS)
            return fps if fps and fps > 0 else 25.0
        return 25.0  # image sequences carry no timing; reference default

    @property
    def size(self):
        """(width, height)"""
        frame = self.get(0)
        return (frame.shape[1], frame.shape[0])

    def get(self, index: int) -> np.ndarray:
        """Fetch frame `index` as uint8 (h, w) gray or (h, w, 3) BGR."""
        if self._files is not None:
            if not 0 <= index < len(self._files):
                raise IndexError(index)
            path = self._files[index]
            variant = Path(path).suffix or path
            if can_decode(path):
                # the headers decide, never a failed decode: an error in a
                # file the port decodes propagates
                variant = refused_variant(path)
                if variant is None:
                    return imread(path, self.color)
            cv2 = _cv2(f"image decode ({variant})")
            flag = cv2.IMREAD_COLOR if self.color else cv2.IMREAD_GRAYSCALE
            img = cv2.imread(path, flag)
            if img is None:
                raise IOError(f"failed to decode {path}")
            return img
        cv2 = _cv2("video decode")
        if self._videos is not None:
            if not 0 <= index < len(self):
                raise IndexError(index)
            vi = int(np.searchsorted(self._video_offsets, index,
                                     side="right")) - 1
            local = index - int(self._video_offsets[vi])
            cap = self._video_caps[vi]
            with self._seek_lock:
                if vi != self._video_idx or local != self._cap_pos:
                    cap.set(cv2.CAP_PROP_POS_FRAMES, local)
                ok, img = cap.read()
                self._video_idx = vi
                self._cap_pos = local + 1
            if not ok:
                raise IndexError(index)
            if not self.color and img.ndim == 3:
                img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
            return img
        with self._seek_lock:
            if not self._live and index != self._cap_pos:
                self._cap.set(cv2.CAP_PROP_POS_FRAMES, index)
                self._cap_pos = index
            ok, img = self._cap.read()
            self._cap_pos = index + 1
        if not ok:
            raise IndexError(index)
        if not self.color and img.ndim == 3:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        return img

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(len(self)):
            yield self.get(i)

    def close(self):
        if self._cap is not None:
            self._cap.release()
            self._cap = None
        for cap in self._video_caps:
            cap.release()
        self._video_caps = []


class BaslerVideoSource:
    """Basler/Pylon industrial camera source.

    The reference runtime-loads the Pylon SDK (grabber
    BaslerVideoSource + BaslerRuntimeLoader: the SDK is optional and
    probed at startup); here the equivalent optional dependency is
    `pypylon`, probed at construction. Exposes the same uniform
    get/iterate surface as VideoSource so `source = "basler"` flows
    through the conversion pipeline unchanged.
    """

    def __init__(self, index: int = 0, color: bool = False):
        try:
            from pypylon import pylon  # type: ignore
        except ImportError as e:  # pragma: no cover - SDK not in image
            raise RuntimeError(
                "Basler support requires the optional pypylon package "
                "(Pylon SDK); install it or use source=webcam/video"
            ) from e
        self.color = color
        factory = pylon.TlFactory.GetInstance()
        devices = factory.EnumerateDevices()
        if not devices:
            raise RuntimeError("no Basler camera found")
        self._cam = pylon.InstantCamera(
            factory.CreateDevice(devices[min(index, len(devices) - 1)]))
        self._cam.Open()
        self._cam.StartGrabbing(pylon.GrabStrategy_LatestImageOnly)
        self._pylon = pylon
        self._live = True

    def __len__(self):
        return 1 << 30  # unbounded live stream

    @property
    def frame_rate(self) -> float:
        try:
            return float(self._cam.ResultingFrameRate.GetValue())
        except Exception:
            return 25.0

    @property
    def size(self):
        return (int(self._cam.Width.GetValue()),
                int(self._cam.Height.GetValue()))

    def get(self, index: int = 0) -> np.ndarray:
        res = self._cam.RetrieveResult(
            5000, self._pylon.TimeoutHandling_ThrowException)
        try:
            if not res.GrabSucceeded():
                raise IOError(f"grab failed: {res.ErrorDescription}")
            img = np.asarray(res.Array)
        finally:
            res.Release()
        if not self.color and img.ndim == 3:
            img = bgr_to_gray(img)
        return img

    def __iter__(self):
        while True:
            yield self.get()

    def close(self):
        if self._cam is not None:
            self._cam.StopGrabbing()
            self._cam.Close()
            self._cam = None


class PVVideoSource:
    """Re-read a .pv file as a frame source (core/PVVideoSource.h):
    reconstructs each frame by stamping stored blob pixels onto the
    background average."""

    def __init__(self, path):
        from .encoding import decode_background
        from .pv import PVFile

        self._file = PVFile.open(path)
        h = self._file.header
        self._bg = decode_background(h.average, h.encoding)

    def __len__(self):
        return self._file.header.num_frames

    @property
    def frame_rate(self) -> float:
        td = self._file.header.average_tdelta
        return 1e6 / td if td else 25.0

    @property
    def size(self):
        h = self._file.header
        return (h.width, h.height)

    def get(self, index: int) -> np.ndarray:
        from .encoding import storage_to_gray

        fr = self._file.read_frame(index)
        img = self._bg.copy() if self._bg is not None else np.zeros(
            (self._file.header.height, self._file.header.width), np.uint8)
        enc = self._file.header.encoding
        for i in range(fr.n):
            px = fr.pixels[i]
            if px is None:
                continue
            if enc in ("rgb8", "r3g3b2"):
                px = storage_to_gray(np.asarray(px).reshape(-1, 3)
                                     if enc == "rgb8"
                                     else np.asarray(px), enc)
            off = 0
            for y, x0, x1 in fr.masks[i]:
                n = x1 - x0 + 1
                img[y, x0 : x1 + 1] = px[off : off + n]
                off += n
        return img

    def __iter__(self):
        for i in range(len(self)):
            yield self.get(i)

    def close(self):
        self._file.close()


class AveragingAccumulator:
    """Background-image accumulator (commons video/AveragingAccumulator.h).

    methods: mean (running float mean), mode (per-pixel histogram argmax),
    max, min.
    """

    def __init__(self, method: str = "mean"):
        if method not in ("mean", "mode", "max", "min"):
            raise ValueError(f"unknown averaging_method {method!r}")
        self.method = method
        self._acc = None
        self._samples: list[np.ndarray] = []
        self._count = 0

    def add(self, frame: np.ndarray):
        frame = np.asarray(frame)
        if frame.ndim == 3 and frame.shape[2] == 1:
            frame = frame[:, :, 0]
        self._count += 1
        if self.method == "mode":
            # quantized samples kept; per-pixel histogram argmax at finalize
            self._samples.append(frame.copy())
            return
        if self._acc is None:
            # mean: exact integer sum (uint8 * count fits in uint32 for
            # <= 16M samples), divided once at finalize
            self._acc = frame.astype(np.uint32) if self.method == "mean" \
                else frame.copy()
        elif self.method == "mean":
            self._acc += frame
        elif self.method == "max":
            np.maximum(self._acc, frame, out=self._acc)
        else:
            np.minimum(self._acc, frame, out=self._acc)

    def finalize(self) -> np.ndarray:
        if self._count == 0:
            raise RuntimeError("no samples accumulated")
        if self.method in ("max", "min"):
            return self._acc.astype(np.uint8)
        from ..ops.labeling import _lib

        lib = _lib()
        u8p = _c.POINTER(_c.c_uint8)
        if self.method == "mean":
            acc = np.ascontiguousarray(self._acc, np.uint32)
            out = np.empty(acc.size, np.uint8)
            lib.trex_mean_u8(
                acc.ctypes.data_as(_c.POINTER(_c.c_uint32)),
                _c.c_int64(acc.size), _c.c_int64(self._count),
                out.ctypes.data_as(u8p))
            return out.reshape(self._acc.shape)
        # mode: per-pixel most frequent value
        shape = self._samples[0].shape
        samples = [np.ascontiguousarray(f) for f in self._samples]
        p = int(np.prod(shape))
        rows = (u8p * len(samples))(
            *[f.ctypes.data_as(u8p) for f in samples])
        out = np.empty(p, np.uint8)
        lib.trex_mode_u8_rows(
            rows, _c.c_int64(len(samples)), _c.c_int64(p),
            out.ctypes.data_as(u8p))
        return out.reshape(shape)
