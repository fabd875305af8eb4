"""Video sources: mp4/avi, image sequences (printf/glob patterns), pv re-read.

Re-creates the acquisition layer of the reference
(core/AbstractVideoSource.h:172-287, VideoVideoSource, PVVideoSource and
commons VideoSource/AveragingAccumulator): uniform `get(index)` /
iteration over grayscale-or-color frames plus the background averaging
accumulator (mean/mode/max/min, grabber default_config.cpp:72-133).
Decode is host-side and needs no OpenCV for PNG, BMP, JPEG and TIFF image
sequences (``io/image_decode.py``, the pixels ``cv2.imread`` gives) and
for MP4/MOV and AVI files of MPEG-4 Part 2, MJPEG or raw video
(``io/video_decode.py``, the frames ``cv2.VideoCapture`` gives). The
webcam, other video formats and the image and video variants those
decoders refuse (named from their headers) go through OpenCV, imported
only where such a source needs it; device transfer happens downstream.
"""
from __future__ import annotations

import ctypes as _c
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from ..track.tag_image import bgr_to_gray
from . import video_decode
from .image_decode import can_decode, imread, refused_variant
from .patharray import has_pattern, resolve_paths

_cv2_mod = None


def _cv2(purpose: str):
    """OpenCV, imported at the first use that needs it: webcam decode,
    image and video files of other formats and the variants
    :func:`~.image_decode.refused_variant` and
    :func:`~.video_decode.refused_variant` name. In-memory and ``.pv``
    sources, PNG, BMP, JPEG or TIFF image sequences and the video files
    :mod:`.video_decode` decodes never call this, so they run without
    OpenCV installed."""
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
        # a VideoFile or a _Capture; several for a multi-video chain
        self._cap = None
        self._files: Optional[list[str]] = None
        self._live = False
        self._videos: Optional[list[str]] = None  # multi-video chain
        # stateful decoder access (seek + read) must serialize: the
        # Segmenter's worker pool calls get() concurrently
        self._seek_lock = threading.Lock()
        self._video_caps: list = []
        self._video_offsets: Optional[np.ndarray] = None
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
                cap = cv2.VideoCapture(idx)
                self._live = True
                if not cap.isOpened():
                    raise RuntimeError(
                        f"cannot open webcam device {idx}")
                self._cap = _Capture(cv2, cap, live=True)
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
                self._cap = _open_video(s)
        if self._files is not None and not self._files:
            raise FileNotFoundError(f"no frames found for {source!r}")
        if self._files and all(
                Path(f).suffix.lower() in self.VIDEO_EXTS
                for f in self._files):
            # a path array of VIDEO files plays back as one concatenated
            # stream (commons VideoSource over a multi-video PathArray;
            # BASELINE config 5 "batched multi-video ingest")
            self._videos = self._files
            self._files = None
            lengths = []
            for f in self._videos:
                cap = _open_video(f)
                lengths.append(len(cap))
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
        return len(self._cap)

    @property
    def frame_rate(self) -> float:
        cap = self._video_caps[0] if self._videos is not None else self._cap
        if cap is not None:
            fps = cap.frame_rate
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
        cap = self._cap
        if self._videos is not None:
            if not 0 <= index < len(self):
                raise IndexError(index)
            vi = int(np.searchsorted(self._video_offsets, index,
                                     side="right")) - 1
            index -= int(self._video_offsets[vi])
            cap = self._video_caps[vi]
        with self._seek_lock:
            return cap.read(index, self.color)

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(len(self)):
            yield self.get(i)

    def close(self):
        if self._cap is not None:
            self._cap.close()
            self._cap = None
        for cap in self._video_caps:
            cap.close()
        self._video_caps = []


def _open_video(path: str):
    """A :class:`~.video_decode.VideoFile` of `path`, or a :class:`_Capture`
    where the port does not decode it (named from its headers) or it is
    no file (a device or a stream URL)."""
    if not Path(path).is_file():
        variant = f"{path}, which is not a file"
    elif video_decode.can_decode(path):
        stream = video_decode.probe(path)
        variant = stream.refused
        if variant is None:
            return video_decode.VideoFile(path, stream)
    else:
        variant = f"{Path(path).suffix or path} files"
    cv2 = _cv2(f"video decode ({variant})")
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video source {path!r}")
    return _Capture(cv2, cap)


class _Capture:
    """An OpenCV capture behind :class:`~.video_decode.VideoFile`'s
    interface: a webcam, or a video the port does not decode. A read at
    another index than the next seeks (``CAP_PROP_POS_FRAMES``); a live
    capture never seeks."""

    def __init__(self, cv2, cap, live: bool = False):
        self._cv2, self._cap, self._live = cv2, cap, live
        self._next = 0

    def __len__(self) -> int:
        return int(self._cap.get(self._cv2.CAP_PROP_FRAME_COUNT))

    @property
    def frame_rate(self) -> float:
        return float(self._cap.get(self._cv2.CAP_PROP_FPS))

    def read(self, index: int, color: bool) -> np.ndarray:
        cv2 = self._cv2
        if not self._live and index != self._next:
            self._cap.set(cv2.CAP_PROP_POS_FRAMES, index)
        ok, img = self._cap.read()
        self._next = index + 1
        if not ok:
            raise IndexError(index)
        if not color and img.ndim == 3:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        return img

    def close(self):
        self._cap.release()


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
